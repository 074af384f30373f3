"""Public wrappers around the kernels (port of ``kernels/ops.py``).

The reference chose Pallas interpret mode whenever the backend was not a
TPU.  Here the tensor's device decides: a CPU tensor takes the kernel's
plain PyTorch version, a CUDA tensor launches the CUDA kernel or raises.
Nothing falls back silently.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core.paths import CandidatePath
from repro_torch.core.tensor_network import TensorNetwork

from . import streaming_tt as _streaming
from . import tt_gemm as _tt_gemm


def gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    dataflow: str = "OS",
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """Dataflow-configurable GEMM for any (M, K, N); ragged edges are
    masked inside the kernel."""
    return _tt_gemm.tt_gemm(a, b, dataflow=dataflow, block_m=block_m,
                            block_k=block_k, block_n=block_n)


def tt_linear(
    x: torch.Tensor,
    cores: Sequence[torch.Tensor],
    tn: TensorNetwork,
    path: CandidatePath,
    block_tokens: int = 256,
) -> torch.Tensor:
    """Streaming TT-linear over any token count (the last block is masked)."""
    return _streaming.streaming_tt_linear(x, cores, tn, path,
                                          block_tokens=block_tokens)


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
    dims.
    """

    def contract(ta: torch.Tensor, tb: torch.Tensor, axes) -> torch.Tensor:
        ax_a, ax_b = axes
        a_free = [i for i in range(ta.dim()) if i not in ax_a]
        b_free = [i for i in range(tb.dim()) if i not in ax_b]
        a_dims = [ta.shape[i] for i in a_free]
        b_dims = [tb.shape[i] for i in b_free]
        m = math.prod(a_dims)
        n = math.prod(b_dims)
        k = math.prod(ta.shape[i] for i in ax_a)
        a2 = ta.permute(a_free + list(ax_a)).reshape(m, k).contiguous()
        b2 = tb.permute(list(ax_b) + b_free).reshape(k, n).contiguous()
        c2 = gemm(a2, b2, dataflow=dataflow,
                  block_m=clamp_block(block_m, m),
                  block_k=clamp_block(block_k, k),
                  block_n=clamp_block(block_n, n))
        return c2.reshape(tuple(a_dims) + tuple(b_dims))

    return contract
