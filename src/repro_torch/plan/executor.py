"""Planned execution: route a TT contraction through its LayerPlan backend.

Port of ``src/repro/plan/executor.py``.  Entry point is
:func:`planned_tt_linear`, called by ``repro_torch.nn.linear`` when a plan
entry with a kernel backend (forward or backward) is installed for the
projection; :func:`planned_tt_linear_batched` runs one projection of every
expert of an MoE layer at once (the reference's ``jax.vmap`` of it).
Backends (the plan's wire names):

- ``jnp``          the plain PyTorch executor (``kernels/ref.py``) along the
                   plan's path steps: the numerical ground truth;
- ``streaming_tt`` the streaming CUDA kernel (``kernels/streaming_tt.py``);
- ``tt_gemm``      every pairwise step of the path lowered to the dataflow
                   GEMM kernel (``kernels/tt_gemm.py``) with the plan's
                   OS/WS/IS dataflow and <T_M, T_K, T_N> blocks; a plan's
                   fused ``segments`` run each chain of >= 2 steps in one
                   launch of the fused-segment kernel
                   (``kernels/fused_path.py``).

Training.  The kernels have no autograd rule, so a layer with a kernel
backend runs under a ``torch.autograd.Function`` whose backward contracts
the layer's gradient networks (:mod:`repro_torch.core.backward`), dL/dx
and one dL/dG_k per core, along the plan's searched backward paths (schema
v2 ``backward`` entries; plans without them take the MAC-optimal path per
gradient).  Each backward contraction runs on its planned kernel: dx may
stream through K1, weight gradients lower to ``tt_gemm``.

Execution log.  Every planned call appends one record per forward, one
per gradient in the backward pass and one per fusion segment.  JAX
appended one per *trace*; this eager port appends one per *call*, so a
long serving run fills the ring of :data:`_EXEC_LOG_MAX` records within a
few hundred decode steps and the dropped counter says how many aged out.
Compare runs by their set of distinct records, not by counts.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, Optional, Sequence

import torch

from repro_torch.core import fusion
from repro_torch.core.backward import backward_networks
from repro_torch.core.contraction import core_tensors, execute_path
from repro_torch.core.paths import CandidatePath, find_topk_paths
from repro_torch.core.tensor_network import TensorNetwork, tt_linear_network
from repro_torch.kernels import ops, ref, streaming_tt

from .schema import BackwardOp, LayerPlan

# ---------------------------------------------------------------------------
# execution log
# ---------------------------------------------------------------------------

#: ring capacity: the newest records are kept, the drop counter
#: (:func:`execution_log_dropped`) counts the ones that aged out
_EXEC_LOG_MAX = 4096

_EXEC_LOG: list[dict] = []
_EXEC_DROPPED = 0

#: serving-stream tag stack (:func:`execution_stream`)
_STREAM: list[str] = []

#: shard-execution stack (:func:`shard_execution`): records appended inside
#: a rank's per-shard call carry the mesh layout and the per-shard shape
_SHARD: list[tuple[str, tuple[int, ...]]] = []


def reset_execution_log() -> None:
    global _EXEC_DROPPED
    _EXEC_LOG.clear()
    _EXEC_DROPPED = 0


def execution_log() -> tuple[dict, ...]:
    """Records of planned executions since the last reset (newest
    :data:`_EXEC_LOG_MAX` at most)."""
    return tuple(_EXEC_LOG)


def execution_log_dropped() -> int:
    """Records evicted from the ring since the last reset."""
    return _EXEC_DROPPED


@contextlib.contextmanager
def execution_stream(name: str) -> Iterator[None]:
    """Tag every execution record appended inside with ``stream=name``.

    The serve engine wraps each prefill/decode call in
    ``execution_stream("prefill"/"decode")``, so the log shows which
    serving stream (and therefore which plan of a pair) ran each call.
    """
    _STREAM.append(str(name))
    try:
        yield
    finally:
        _STREAM.pop()


@contextlib.contextmanager
def shard_execution(mesh: str, shard_shape: tuple[int, ...]) -> Iterator[None]:
    """Tag records appended inside with their placement on the ranks' mesh.

    ``mesh`` is a readable axis layout (``"data=2"`` or
    ``"data=2+reduce(model=2)"``); ``shard_shape`` is the per-rank
    ``(tokens, d_in)`` the kernel actually sees.  The sharded dispatcher
    (:mod:`repro_torch.plan.sharded`) runs each rank's block inside this
    context.  Single-device records carry ``mesh=""``/``shard_shape=None``.
    """
    _SHARD.append((str(mesh), tuple(int(d) for d in shard_shape)))
    try:
        yield
    finally:
        _SHARD.pop()


def record_execution(
    lp: LayerPlan,
    tokens: int,
    *,
    phase: str = "fwd",
    backend: Optional[str] = None,
    wrt: Optional[str] = None,
    path_steps=None,
    tiling=None,
    segment: Optional[tuple[int, int]] = None,
) -> None:
    """Append one planned-execution record (one per call).

    Field for field the reference's record.  ``tiling`` defaults to the
    layer's forward tiling; backward records (``phase="bwd"``) pass the
    gradient op's backend, ``wrt``, steps and tiling.  ``segment`` marks
    the per-segment records of a fusion-segmented layer.  ``mesh`` and
    ``shard_shape`` come from the innermost :func:`shard_execution`.
    """
    global _EXEC_DROPPED
    rec = {
        "name": lp.name,
        "backend": backend if backend is not None else lp.backend,
        "dataflow": lp.dataflow,
        "path_index": lp.path_index,
        "path_steps": lp.path_steps if path_steps is None else path_steps,
        "tokens": tokens,
        "phase": phase,
        "stream": _STREAM[-1] if _STREAM else "",
        "mesh": _SHARD[-1][0] if _SHARD else "",
        "shard_shape": list(_SHARD[-1][1]) if _SHARD else None,
        "tiling": (lp.tiling if tiling is None else tiling).to_json(),
    }
    if wrt is not None:
        rec["wrt"] = wrt
    if segment is not None:
        rec["segment"] = [int(segment[0]), int(segment[1])]
    if len(_EXEC_LOG) >= _EXEC_LOG_MAX:
        del _EXEC_LOG[0]
        _EXEC_DROPPED += 1
    _EXEC_LOG.append(rec)


# ---------------------------------------------------------------------------
# path plumbing
# ---------------------------------------------------------------------------

def has_kernel_backward(lp: LayerPlan) -> bool:
    """Whether any of the plan's backward ops names a kernel backend (the
    reference's ``has_pallas_backward``).

    The compiler can pair a ``jnp`` forward (small forward GEMMs) with
    kernel backward ops (the weight-gradient GEMMs reduce over the whole
    batch); such layers still need the autograd-Function route.
    """
    return any(op.backend != "jnp" for op in lp.backward)


def as_candidate_path(tn: TensorNetwork, steps) -> CandidatePath:
    """Reconstruct a CandidatePath (with GEMM shapes) from raw plan steps."""
    steps = tuple(tuple(s) for s in steps)
    gemms = tuple(tn.gemm_sequence(steps))
    return CandidatePath(steps, sum(g.macs for g in gemms), gemms)


@functools.lru_cache(maxsize=1024)
def _network_and_path(batch: int, in_modes: tuple[int, ...],
                      out_modes: tuple[int, ...], ranks: tuple[int, ...],
                      steps) -> tuple[TensorNetwork, CandidatePath]:
    """The layer network at ``batch`` tokens and the plan's path over it,
    built once per shape (the eager counterpart of JAX's trace-time work)."""
    tn = tt_linear_network(batch, in_modes, out_modes, ranks)
    return tn, as_candidate_path(tn, steps)


def _gemm_contract(lp: LayerPlan, tiling):
    """``tt_gemm`` ``contract_fn`` with the plan's dataflow and blocks."""
    return ops.gemm_contract(dataflow=lp.dataflow, block_m=tiling.block_m,
                             block_k=tiling.block_k, block_n=tiling.block_n)


def _bwd_token_bucket(tokens: int) -> int:
    """Power-of-two bucket for the backward-path cache key: the
    MAC-optimal backward contraction order is stable within a bucket, and
    the cached steps are index pairs valid at any batch size."""
    p = 1
    while p < max(1, tokens):
        p *= 2
    return p


@functools.lru_cache(maxsize=256)
def _default_bwd_steps(
    batch: int,
    in_modes: tuple[int, ...],
    out_modes: tuple[int, ...],
    ranks: tuple[int, ...],
) -> tuple[tuple[str, tuple[tuple[int, int], ...]], ...]:
    """MAC-optimal backward path per gradient (plans without ``backward``
    entries).  ``batch`` is a :func:`_bwd_token_bucket` value, so the cache
    stays small when the token count changes from call to call."""
    tn = tt_linear_network(batch, in_modes, out_modes, ranks)
    return tuple(
        (wrt, find_topk_paths(net, k=1)[0].steps)
        for wrt, net in backward_networks(tn)
    )


def _resolve_backward_ops(
    lp: LayerPlan,
    tokens: int,
    in_modes: tuple[int, ...],
    out_modes: tuple[int, ...],
    ranks: tuple[int, ...],
) -> tuple[BackwardOp, ...]:
    """The plan's backward ops, with defaults for the gradients it lacks.

    Defaults: the MAC-optimal path per gradient; dx inherits the forward
    backend, weight gradients lower to ``tt_gemm`` (two streamed operands
    cannot use the streaming kernel), everything stays ``jnp`` under a
    ``jnp`` forward.
    """
    planned = {op.wrt: op for op in lp.backward}
    if lp.backend == "jnp":
        dx_backend = grad_backend = "jnp"
    else:
        dx_backend = lp.backend
        grad_backend = "tt_gemm"
    return tuple(
        planned.get(wrt) or BackwardOp(
            wrt=wrt,
            path_index=0,
            path_steps=steps,
            backend=dx_backend if wrt == "dx" else grad_backend,
            tiling=lp.tiling,
        )
        for wrt, steps in _default_bwd_steps(
            _bwd_token_bucket(tokens), in_modes, out_modes, ranks)
    )


# ---------------------------------------------------------------------------
# fusion-segmented execution (tt_gemm backend with LayerPlan.segments)
# ---------------------------------------------------------------------------

def _execute_segmented(
    lp: LayerPlan,
    tn: TensorNetwork,
    tensors: dict,
    out_edges: tuple[str, ...],
    tokens: int,
    record: bool = True,
) -> torch.Tensor:
    """Walk the plan's fusion segments over the live work list.

    Multi-step segments run as one launch of the fused-segment kernel
    with on-chip fp32 intermediates; singleton segments keep the per-step
    ``tt_gemm`` route, so the result is bit-identical to the unsegmented
    execution.  Each segment appends its own record (``segment=(s, e)``)
    beside the layer-level record :func:`planned_tt_linear` wrote (with
    ``record``; the experts' per-expert walks record the first expert's).
    """
    steps = tuple(tuple(s) for s in lp.path_steps)
    contract = _gemm_contract(lp, lp.tiling)
    work: list = [(n.edges, tensors[n.name]) for n in tn.nodes]
    bt = ops.clamp_block(lp.tiling.block_tokens, tokens)
    for (s, e) in lp.segments:
        if record:
            record_execution(lp, tokens, path_steps=steps[s:e], segment=(s, e))
        if e - s >= 2:
            ec, val = ops.fused_segment(
                work, steps[s:e], block_tokens=bt,
                block_m=lp.tiling.block_m, block_k=lp.tiling.block_k,
                block_n=lp.tiling.block_n)
            # replay the per-step removals; the chain consumes every
            # interior placeholder, only the final result survives
            for (i, j) in steps[s:e]:
                work = [w for k, w in enumerate(work) if k not in (i, j)]
                work.append(None)
            work[-1] = (ec, val)
        else:
            i, j = steps[s]
            (ea, ta), (eb, tb) = work[i], work[j]
            shared = [x for x in ea if x in eb]
            ax_a = tuple(ea.index(x) for x in shared)
            ax_b = tuple(eb.index(x) for x in shared)
            val = contract(ta, tb, (ax_a, ax_b))
            ec = tuple(x for x in ea if x not in shared) + tuple(
                x for x in eb if x not in shared)
            work = [w for k, w in enumerate(work) if k not in (i, j)]
            work.append((ec, val))
    ec, val = work[-1]
    if tuple(ec) != tuple(out_edges):
        val = val.permute(tuple(ec.index(x) for x in out_edges))
    return val


# ---------------------------------------------------------------------------
# forward and backward bodies
# ---------------------------------------------------------------------------

def _forward_planned(
    lp: LayerPlan,
    x2d: torch.Tensor,
    cores: Sequence[torch.Tensor],
    in_modes: tuple[int, ...],
    out_modes: tuple[int, ...],
    ranks: tuple[int, ...],
) -> torch.Tensor:
    """The plan's forward contraction: ``(tokens, d_in) -> (tokens, d_out)``.

    An ``x2d (E, tokens, d_in)`` with every core stacked ``(E,) + dims``
    carries the experts' leading axis.  K1, the unfused ``tt_gemm`` path
    and the plain executor run each step once for all experts; fused
    segments (K5) run expert by expert, every expert, one record set."""
    lead = tuple(x2d.shape[:-2])
    tokens = x2d.shape[-2]
    if lp.backend == "streaming_tt":
        bt = ops.clamp_block(lp.tiling.block_tokens, tokens)
        tn_block, path = _network_and_path(bt, in_modes, out_modes, ranks,
                                           lp.path_steps)
        if lead:
            return streaming_tt.streaming_tt_linear_batched(
                x2d, list(cores), tn_block, path)
        return ops.tt_linear(x2d, list(cores), tn_block, path, block_tokens=bt)

    tn, path = _network_and_path(tokens, in_modes, out_modes, ranks,
                                 lp.path_steps)
    if lp.backend == "tt_gemm":
        out_edges = ("b",) + tuple(f"i{t + 1}" for t in range(len(out_modes)))
        if fusion.has_fused(lp.segments):
            def segmented(x, cs, record):
                tensors = {"X": x.reshape((tokens,) + tuple(in_modes))}
                tensors.update(core_tensors(tn, list(cs)))
                return _execute_segmented(lp, tn, tensors, out_edges, tokens,
                                          record).reshape(tokens, -1)

            if not lead:
                return segmented(x2d, cores, True)
            return torch.stack([segmented(x2d[e], [c[e] for c in cores], e == 0)
                                for e in range(lead[0])])
        tensors = {"X": x2d.reshape(lead + (tokens,) + tuple(in_modes))}
        tensors.update(core_tensors(tn, list(cores)))
        y = execute_path(tn, path, tensors, out_edges=out_edges,
                         contract_fn=_gemm_contract(lp, lp.tiling))
        return y.reshape(lead + (tokens, -1))

    # "jnp": the plain executor along the planned steps
    return ref.tt_linear_ref(x2d, list(cores), tn, path)


def _backward_planned(
    lp: LayerPlan,
    x2d: torch.Tensor,
    cores: Sequence[torch.Tensor],
    dy2d: torch.Tensor,
    in_modes: tuple[int, ...],
    out_modes: tuple[int, ...],
    ranks: tuple[int, ...],
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Contract the layer's gradient networks along the planned backward
    paths, each on its planned backend (:func:`ops.tt_linear_backward`).
    Returns ``(dx2d, dcores)``.  Operands behind the experts' leading axis
    run each gradient network once for all experts, one record each (the
    reference's trace under ``jax.vmap``)."""
    tokens = x2d.shape[-2]
    routes = {}
    for op in _resolve_backward_ops(lp, tokens, in_modes, out_modes, ranks):
        record_execution(lp, tokens, phase="bwd", backend=op.backend,
                         wrt=op.wrt, path_steps=op.path_steps,
                         tiling=op.tiling)
        routes[op.wrt] = ops.GradRoute(
            op.path_steps, op.backend,
            _gemm_contract(lp, op.tiling) if op.backend == "tt_gemm" else None,
            ops.clamp_block(op.tiling.block_tokens, tokens))
    tn = tt_linear_network(tokens, in_modes, out_modes, ranks)
    return ops.tt_linear_backward(tn, x2d, dy2d, cores, routes)


class _PlannedTTLinear(torch.autograd.Function):
    """A kernel-backed planned projection under autograd: the forward runs
    the plan's forward route, the backward :func:`_backward_planned`
    (over the experts' leading axis where ``x2d`` has one, every gradient
    landing in its stacked leaf)."""

    @staticmethod
    def forward(ctx, x2d, lp, geometry, *cores):
        ctx.save_for_backward(x2d, *cores)
        ctx.lp, ctx.geometry = lp, geometry
        # the rank's placement: the backward runs after the sharded call's
        # shard_execution has closed (on the card, on another thread)
        ctx.shard = _SHARD[-1] if _SHARD else None
        return _forward_planned(lp, x2d, cores, *geometry)

    @staticmethod
    def backward(ctx, dy2d):
        x2d, *cores = ctx.saved_tensors
        with (shard_execution(*ctx.shard) if ctx.shard is not None
              else contextlib.nullcontext()):
            dx2d, dcores = _backward_planned(ctx.lp, x2d, cores, dy2d,
                                             *ctx.geometry)
        # row-major, as the sharded route's gathered dx is: a dx that
        # ``execute_path`` leaves transposed would make the reductions
        # downstream (a norm's scale gradient) sum in another order
        return (dx2d.contiguous(), None, None, *dcores)


# ---------------------------------------------------------------------------
# the planned TT-linear entry point
# ---------------------------------------------------------------------------

def planned_tt_linear(
    lp: LayerPlan,
    x2d: torch.Tensor,
    cores: Sequence[torch.Tensor],
    in_modes: tuple[int, ...],
    out_modes: tuple[int, ...],
    ranks: tuple[int, ...],
) -> torch.Tensor:
    """Apply one planned TT projection to ``x2d: (tokens, d_in)``.

    Returns ``(tokens, d_out)``.  The plan's ``path_steps`` are replayed
    verbatim; the backend decides how each step runs.  Differentiable: a
    layer with a kernel backend, forward or backward, runs under
    :class:`_PlannedTTLinear`; a ``jnp`` layer with no kernel backward
    keeps native autograd through the plain executor.
    """
    geometry = (tuple(in_modes), tuple(out_modes), tuple(ranks))
    record_execution(lp, x2d.shape[0])
    x2d = x2d.contiguous()
    if lp.backend == "jnp" and not has_kernel_backward(lp):
        return _forward_planned(lp, x2d, cores, *geometry)
    return _PlannedTTLinear.apply(x2d, lp, geometry, *cores)


def planned_tt_linear_batched(
    lp: LayerPlan,
    x: torch.Tensor,
    cores: Sequence[torch.Tensor],
    in_modes: tuple[int, ...],
    out_modes: tuple[int, ...],
    ranks: tuple[int, ...],
) -> torch.Tensor:
    """One planned TT projection of every expert at once: ``x (E, tokens,
    d_in) -> (E, tokens, d_out)``, each core stacked ``(E,) + dims`` (the
    leaves as the MoE holds them).

    The port of the reference's ``jax.vmap`` of :func:`planned_tt_linear`
    over the stacked expert axis (``src/repro/nn/moe.py:148``): K1 and
    the WS ``tt_gemm`` steps launch once for all experts, forward and
    backward, and each gradient lands in its stacked leaf.  One record per
    call at ``tokens`` and one per backward op, as the reference's trace
    under ``vmap`` writes; expert ``e``'s values are
    ``planned_tt_linear(lp, x[e], [c[e] for c in cores], ...)``'s.
    """
    if x.dim() != 3:
        raise ValueError(f"{lp.name}: x must be (experts, tokens, d_in), got "
                         f"{tuple(x.shape)}")
    geometry = (tuple(in_modes), tuple(out_modes), tuple(ranks))
    record_execution(lp, x.shape[1])
    x = x.contiguous()
    if lp.backend == "jnp" and not has_kernel_backward(lp):
        return _forward_planned(lp, x, cores, *geometry)
    return _PlannedTTLinear.apply(x, lp, geometry, *cores)
