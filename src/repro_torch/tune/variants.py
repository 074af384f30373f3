"""Feasible kernel-variant enumeration for the autotuner.

Port of ``src/repro/tune/variants.py`` (no JAX), copied: the variant
space, and so every plan emitted from a cache, is the reference's.  The
budget is the compiler's ``VMEM_BUDGET_BYTES`` (the reference's 8 MiB),
not a size of the H100.  On the CUDA kernels ``block_m``/``block_n`` cap
the tiles of K2-K4's grids and ``block_k`` orders their fold; K1 builds
one program whatever ``block_tokens`` says, so its sweep times one launch
many times over (the spread is the measurement's noise).

The heuristic plan compiler derives one tiling per layer from the path's
dominant GEMM (``plan/compiler._tiling_for_path``); the autotuner instead
*measures* a sweep of feasible variants and keeps the argmin.  The sweep
space mirrors what the runtime can actually execute:

- GEMM blocks come from the same power-of-two ladder ``ops.clamp_block``
  resolves against at trace time, clamped per dimension — a variant
  never exceeds the next power of two above the dimension (larger blocks
  only pad with zeros, see ``kernels/tt_gemm``'s automatic padding);
- streaming token blocks are power-of-two sweeps additionally filtered
  by the VMEM feasibility predicate (``plan.compiler.streaming_fits``) —
  a measured ``block_tokens`` never violates the budget the backend
  choice assumed.

The heuristic default is always injected into the sweep, so a measured
tiling can tie the heuristic but never lose to it (up to measurement
noise on the machine doing the tuning).
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.kernels.ops import clamp_block
from repro_torch.plan.compiler import VMEM_BUDGET_BYTES, streaming_fits
from repro_torch.core.tensor_network import TensorNetwork

#: power-of-two block caps swept per GEMM dimension; each is clamped to
#: the dimension (``clamp_block``) and the set deduped, so small dims
#: contribute one candidate and large dims up to ``len(GEMM_BLOCK_CAPS)``
GEMM_BLOCK_CAPS = (64, 128, 256, 512)

#: token-block caps swept for the streaming kernel (clamped + VMEM-filtered)
STREAM_BLOCK_CAPS = (32, 64, 128, 256, 512, 1024)


def block_candidates(dim: int,
                     caps: Sequence[int] = GEMM_BLOCK_CAPS) -> list[int]:
    """Deduped feasible blocks for one dimension (pow2, >= 8, <= ~dim)."""
    return sorted({clamp_block(c, dim) for c in caps})


def gemm_variants(
    M: int, K: int, N: int,
    *,
    caps: Sequence[int] = GEMM_BLOCK_CAPS,
    include: Sequence[tuple[int, int, int]] = (),
) -> list[tuple[int, int, int]]:
    """Feasible ``(block_m, block_k, block_n)`` sweep for one GEMM shape.

    ``include`` injects extra variants (the compiler's heuristic tiling)
    so the measured argmin is never worse than the default.  The list is
    sorted for deterministic measurement order.
    """
    out = {
        (bm, bk, bn)
        for bm in block_candidates(M, caps)
        for bk in block_candidates(K, caps)
        for bn in block_candidates(N, caps)
    }
    for bm, bk, bn in include:
        out.add((clamp_block(int(bm), M), clamp_block(int(bk), K),
                 clamp_block(int(bn), N)))
    return sorted(out)


def streaming_variants(
    tn: TensorNetwork,
    steps,
    tokens: int,
    *,
    caps: Sequence[int] = STREAM_BLOCK_CAPS,
    budget_bytes: int = VMEM_BUDGET_BYTES,
    include: Sequence[int] = (),
) -> list[int]:
    """Feasible ``block_tokens`` sweep for one streaming-layer problem.

    Candidates are clamped to the streamed token count, then filtered by
    the same VMEM-fit predicate the plan compiler's backend choice uses —
    every returned value can actually execute as a fused in-VMEM block.
    ``include`` injects the heuristic default (kept even if the dominant
    sweep dedups it away).
    """
    cands = {clamp_block(c, tokens) for c in caps}
    for bt in include:
        cands.add(clamp_block(int(bt), tokens))
    return sorted(
        bt for bt in cands
        if streaming_fits(tn, steps, bt, budget_bytes=budget_bytes)
    )


def fused_token_variants(
    tn: TensorNetwork,
    steps,
    segments,
    tokens: int,
    *,
    caps: Sequence[int] = STREAM_BLOCK_CAPS,
    budget_bytes: int = VMEM_BUDGET_BYTES,
    include: Sequence[int] = (),
) -> list[int]:
    """Feasible ``block_tokens`` sweep for one fused-segment problem.

    Candidates are clamped to the streamed token count and filtered to
    the blocks at which the greedy segmentation *reproduces exactly the
    given segments* — a measured variant always executes the same fused
    chain runs the cost model priced, never a re-segmented layout.
    ``include`` injects the compiler's heuristic default.
    """
    from repro_torch.core import fusion

    steps = tuple(tuple(s) for s in steps)
    segments = tuple((int(s), int(e)) for s, e in segments)
    cands = {clamp_block(c, tokens) for c in caps}
    for bt in include:
        cands.add(clamp_block(int(bt), tokens))
    return sorted(
        bt for bt in cands
        if fusion.segment_path(tn, steps, block_tokens=bt,
                               budget_bytes=budget_bytes) == segments
    )


def dominant_gemm(path) -> tuple[int, int, int]:
    """The (M, K, N) of a candidate path's highest-MAC GEMM."""
    g = max(path.gemms, key=lambda g: g.macs)
    return (int(g.M), int(g.K), int(g.N))


def network_signature(tn: TensorNetwork, steps) -> str:
    """A stable, human-greppable identity for a streaming-layer problem.

    Encodes every node's edges/dims/kind plus the contraction order —
    two layers with the same signature contract identically, so they
    share one cache entry (the same dedup the cost-table engine applies
    to repeated transformer blocks).
    """
    nodes = ";".join(
        f"{n.name}[{','.join(n.edges)}|{','.join(map(str, n.dims))}|{n.kind}]"
        for n in tn.nodes
    )
    order = ",".join(f"{i}-{j}" for i, j in steps)
    return f"{nodes}@{order}"


def dominant_gemm_of_steps(tn: TensorNetwork, steps) -> tuple[int, int, int]:
    """The dominant (M, K, N) of raw plan steps replayed on ``tn``."""
    gemms = tuple(tn.gemm_sequence(tuple(tuple(s) for s in steps)))
    g = max(gemms, key=lambda g: g.macs)
    return (int(g.M), int(g.K), int(g.N))
