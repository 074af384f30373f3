"""Public wrappers around the kernels (port of ``kernels/ops.py``).

The reference chose Pallas interpret mode whenever the backend was not a
TPU.  Here the tensor's device decides: a CPU tensor takes the kernel's
plain PyTorch version, a CUDA tensor launches the CUDA kernel or raises.
Nothing falls back silently.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional, Sequence

import torch

from repro_torch.core.backward import (GRAD_NODE, backward_networks,
                                       grad_input_network)
from repro_torch.core.contraction import as_matrices, execute_path
from repro_torch.core.paths import CandidatePath, find_topk_paths
from repro_torch.core.tensor_network import TensorNetwork

from . import fused_path as _fused
from . import streaming_tt as _streaming
from . import tt_gemm as _tt_gemm


def gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    dataflow: str = "OS",
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
    differentiable: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Dataflow-configurable GEMM for any (M, K, N); ragged edges are
    masked inside the kernel.  Operands are fp32 or bf16, folded in fp32
    and cast once to ``out_dtype`` (default: ``a``'s dtype).
    ``differentiable=True`` routes through :func:`tt_gemm.tt_gemm_vjp`,
    whose backward GEMMs run the same kernel."""
    kernel = _tt_gemm.tt_gemm_vjp if differentiable else _tt_gemm.tt_gemm
    return kernel(a, b, dataflow=dataflow, block_m=block_m,
                  block_k=block_k, block_n=block_n, out_dtype=out_dtype)


def tt_linear(
    x: torch.Tensor,
    cores: Sequence[torch.Tensor],
    tn: TensorNetwork,
    path: CandidatePath,
    block_tokens: int = 256,
    differentiable: bool = False,
    bwd_steps: Optional[Mapping[str, Sequence[tuple[int, int]]]] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Streaming TT-linear over any token count (the last block is masked).
    x and the cores are fp32 or bf16, every step folds in fp32 and the
    result is cast once to ``out_dtype`` (default: x's dtype).

    ``differentiable=True`` routes through
    :func:`streaming_tt.streaming_tt_linear_vjp` (dx streams through the
    same kernel, weight gradients contract their backward networks on
    ``tt_gemm``); ``bwd_steps`` optionally pins the searched backward path
    per gradient.
    """
    if differentiable:
        return _streaming.streaming_tt_linear_vjp(
            x, cores, tn, path, bwd_steps=bwd_steps, block_tokens=block_tokens,
            out_dtype=out_dtype)
    return _streaming.streaming_tt_linear(x, cores, tn, path,
                                          block_tokens=block_tokens,
                                          out_dtype=out_dtype)


def fused_segment(
    work,
    steps,
    block_tokens: int = 256,
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
    out_dtype: Optional[torch.dtype] = None,
):
    """Execute a chain run of contraction-path steps in one launch.

    ``work`` is the live ``execute_path`` work list and ``steps`` the
    current-index pairs of the segment.  Returns ``(result_edges,
    result)``: the entry the per-step route would have appended, cast
    from the fp32 interior to ``out_dtype`` (default: the batch-carrying
    operand's dtype).
    """
    return _fused.fused_segment_contract(
        work, steps, block_tokens=block_tokens, block_m=block_m,
        block_k=block_k, block_n=block_n, out_dtype=out_dtype)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def clamp_block(block: int, dim: int) -> int:
    """Shrink a compile-time block to the runtime dim (power of two, >= 8).

    The DSE tiles for its search-time shapes; a runtime call may carry
    fewer tokens (decode) or contract a smaller intermediate.
    """
    return max(8, min(block, _next_pow2(dim)))


def gemm_contract(
    dataflow: str = "OS",
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
):
    """A per-step ``contract_fn`` for ``core.contraction.execute_path`` that
    lowers each pairwise contraction to the dataflow GEMM kernel.

    Operands are permuted to (free..., shared...) / (shared..., free...)
    and flattened to (M, K) @ (K, N); the result keeps tensordot's axis
    order (A's free axes then B's).  Blocks are clamped to the runtime
    dims.  Each step's result takes its operand's dtype, as the
    reference's ``gemm_contract`` does (so a bf16 path rounds per step).
    Operands behind a leading batch axis (``lead=1``, the experts' axis:
    the reference's ``jax.vmap``) run as one :func:`tt_gemm.tt_gemm_batched`
    call over ``(E, M, K) @ (E, K, N)``, each item the unbatched step's
    bits.
    """

    def contract(ta: torch.Tensor, tb: torch.Tensor, axes,
                 lead: int = 0) -> torch.Tensor:
        a2, b2, shape = as_matrices(ta, tb, axes, lead)
        (m, k), n = a2.shape[-2:], b2.shape[-1]
        blocks = dict(dataflow=dataflow, block_m=clamp_block(block_m, m),
                      block_k=clamp_block(block_k, k),
                      block_n=clamp_block(block_n, n))
        c2 = (_tt_gemm.tt_gemm_batched(a2, b2, **blocks) if lead
              else gemm(a2, b2, **blocks))
        return c2.reshape(shape)

    return contract


class GradRoute(NamedTuple):
    """How :func:`tt_linear_backward` contracts one gradient network."""

    #: contraction steps over the gradient network; ``None`` takes its
    #: MAC-optimal path
    steps: Optional[tuple[tuple[int, int], ...]]
    #: ``"jnp"`` (plain executor), ``"streaming_tt"`` (dx only) or
    #: ``"tt_gemm"``
    backend: str
    #: ``tt_gemm``'s per-step contraction (:func:`gemm_contract`, blocks set)
    contract_fn: Optional[Callable] = None
    #: K1's token block when dx streams
    block_tokens: int = 256


def tt_linear_backward(
    tn: TensorNetwork,
    x: torch.Tensor,
    dy: torch.Tensor,
    cores: Sequence[torch.Tensor],
    routes: Mapping[str, GradRoute],
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Gradients of one TT projection by contracting its gradient networks
    (:mod:`repro_torch.core.backward`), each along ``routes[wrt]``.

    The one backward of the port: the planned executor and
    :class:`streaming_tt.StreamingTTLinearVJP` both call it.  ``tn`` is the
    layer's forward network at any token count (its streamed node is
    rebound to ``x``'s), ``x: (tokens, d_in)``, ``dy: (tokens, d_out)``,
    ``cores`` in node order.  dx on ``streaming_tt`` streams ``dy`` through
    K1 over the grad-input network; every other gradient runs
    ``execute_path`` over the whole batch with the route's ``contract_fn``.
    Returns ``(dx, dcores)``.

    An ``x (E, tokens, d_in)`` with ``dy (E, tokens, d_out)`` and every
    core stacked ``(E,) + dims`` carries the experts' leading axis: each
    gradient network runs once for all of them (batched K1 for dx, one
    batched product a step for the rest), and the gradients carry it too.
    """
    lead = tuple(x.shape[:-2])
    tokens = x.shape[-2]
    tn = _streaming._rebatch(tn, tokens)
    x_node = _streaming._stream_node(tn)
    core_names = [n.name for n in tn.nodes if n.kind != "input"]
    named = dict(zip(core_names, cores))
    node_edges = {n.name: n.edges for n in tn.nodes}
    dy = dy.to(x.dtype).contiguous()

    dx = None
    dcores: dict[str, torch.Tensor] = {}
    for wrt, net in backward_networks(tn):
        route = routes[wrt]
        if wrt == "dx" and route.backend == "streaming_tt":
            net_block = grad_input_network(
                _streaming._rebatch(tn, route.block_tokens))
            path = _streaming._path_for(net_block, route.steps)
            dx = (_streaming.streaming_tt_linear_batched(
                      dy, list(cores), net_block, path) if lead
                  else _streaming.streaming_tt_linear(
                      dy, list(cores), net_block, path,
                      block_tokens=route.block_tokens))
            continue
        tensors = {n.name: named[n.name] for n in net.nodes
                   if n.name in named}
        if wrt != "dx":
            tensors[x_node.name] = x.reshape(lead + x_node.dims)
        grad_node = next(n for n in net.nodes if n.name == GRAD_NODE)
        tensors[GRAD_NODE] = dy.reshape(lead + grad_node.dims)
        steps = (route.steps if route.steps is not None
                 else find_topk_paths(net, k=1)[0].steps)
        out_edges = node_edges[x_node.name if wrt == "dx" else wrt]
        g = execute_path(net, steps, tensors, out_edges=out_edges,
                         preferred_dtype=torch.float32,
                         contract_fn=route.contract_fn)
        if wrt == "dx":
            dx = g.reshape(lead + (tokens, -1))
        else:
            dcores[wrt] = g.to(named[wrt].dtype)
    if dx is None:
        raise RuntimeError("no dx among the backward networks")
    return dx.to(x.dtype), tuple(dcores[name] for name in core_names)
