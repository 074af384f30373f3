"""Fusion analysis: partition a contraction path into chain segments whose
intermediates can stay resident in VMEM.

Framework-neutral copy of ``src/repro/core/fusion.py`` (the port never imports
the JAX package).

The ``tt_gemm`` backend lowers every pairwise contraction of a searched
path to its own ``pallas_call``, so each interior intermediate round-trips
through HBM between steps.  A *fusable segment* is a maximal contiguous run
of path steps that forms a chain — each step after the first consumes the
previous step's result — whose working set (streamed input block, pinned
operands, fp32 interior intermediates, output block) fits the on-chip
buffer budget.  Such a run can execute inside ONE ``pallas_call``
(``repro_torch.kernels.fused_path``) with interior intermediates in VMEM
scratch, paying a single kernel-launch overhead and zero HBM bytes for the
interior tensors.

Chain rules (checked per step of a multi-step segment):

  * exactly one operand carries the batch edge (the streamed chain); the
    other operand is batch-free and pinned whole in VMEM;
  * for every step after the segment's first, the batch-carrying operand
    is the previous step's result (current-index ``n0 - t - 1``, mirroring
    ``TensorNetwork.contract_pair``'s append-at-end bookkeeping).

Core-core contractions (no batch edge) are deliberately left as singleton
segments: fusing them would recompute a batch-independent product once per
token block instead of once per call.

This module is consumed by both the plan compiler (stamping
``LayerPlan.segments``) and the cost-table engine (fused traffic
accounting), so it lives in ``core`` and depends only on the tensor
network — not on the plan schema.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .tensor_network import TensorNetwork

#: batch (streamed-token) edge label of the standard TT-linear network
BATCH_EDGE = "b"

#: interior intermediates are carried in fp32 VMEM scratch
INTERIOR_BYTES = 4

Segment = tuple[int, int]  # half-open step range [s, e)


@dataclasses.dataclass(frozen=True)
class StepRole:
    """How one path step participates in its segment (cost-model view)."""

    segment: Segment
    #: "a"/"b" when that operand is the VMEM-resident chain (zero HBM
    #: reads); ``None`` for singleton segments / segment-opening steps
    chain_operand: str | None
    #: the step's result stays in VMEM scratch (zero HBM writes)
    interior_output: bool


def _entry_dims(tn: TensorNetwork, block_tokens: int | None,
                batch_edge: str) -> list[tuple[tuple[str, ...], tuple[int, ...]]]:
    """Initial work-list (edges, dims) with the batch dim re-blocked."""
    entries = []
    for n in tn.nodes:
        dims = tuple(
            block_tokens if (block_tokens is not None and e == batch_edge)
            else d
            for e, d in zip(n.edges, n.dims))
        entries.append((n.edges, dims))
    return entries


def _merge(ea, da, eb, db):
    """Result (edges, dims) of contracting A with B (A free then B free)."""
    shared = set(ea) & set(eb)
    ec = tuple(e for e in ea if e not in shared) + tuple(
        e for e in eb if e not in shared)
    dc = tuple(d for e, d in zip(ea, da) if e not in shared) + tuple(
        d for e, d in zip(eb, db) if e not in shared)
    return ec, dc


def _nbytes(dims: Sequence[int], itemsize: int) -> int:
    return math.prod(dims) * itemsize


def segment_path(
    tn: TensorNetwork,
    steps: Sequence[tuple[int, int]],
    *,
    block_tokens: int,
    budget_bytes: int,
    batch_edge: str = BATCH_EDGE,
    input_bytes: int = 4,
) -> tuple[Segment, ...]:
    """Greedy maximal segmentation of ``steps`` under ``budget_bytes``.

    Returns contiguous half-open ``(s, e)`` ranges covering
    ``[0, len(steps))``.  A range with ``e - s >= 2`` is a fused segment;
    singletons keep the per-step route.  ``block_tokens`` re-blocks the
    batch edge (the fused kernel streams that block per grid step);
    ``input_bytes`` is the element size of the streamed/pinned operands
    (interior intermediates are always counted at fp32).
    """
    steps = tuple(steps)
    if not steps:
        return ()
    work = _entry_dims(tn, block_tokens, batch_edge)
    n0 = len(work)

    segments: list[Segment] = []
    seg_start = 0
    # working-set bytes of the tentative segment [seg_start, t)
    in_bytes = 0       # streamed block + pinned operands, counted once
    interior_bytes = 0  # fp32 scratch for already-chained intermediates
    out_bytes = 0      # the segment's current (fp32) result block

    def close(end: int) -> None:
        nonlocal seg_start, in_bytes, interior_bytes, out_bytes
        segments.append((seg_start, end))
        seg_start = end
        in_bytes = interior_bytes = out_bytes = 0

    for t, (i, j) in enumerate(steps):
        (ea, da), (eb, db) = work[i], work[j]
        ec, dc = _merge(ea, da, eb, db)
        prev = n0 - t - 1  # index of step t-1's result (appended at end)
        a_batch = batch_edge in ea
        b_batch = batch_edge in eb

        if t > seg_start:
            chain_is_a = (i == prev)
            chain_is_b = (j == prev)
            chain_e, chain_d = (ea, da) if chain_is_a else (eb, db)
            other_e, other_d = (eb, db) if chain_is_a else (ea, da)
            extendable = (
                (chain_is_a or chain_is_b)
                and batch_edge in chain_e
                and batch_edge not in other_e
            )
            if extendable:
                new_in = in_bytes + _nbytes(other_d, input_bytes)
                new_interior = interior_bytes + out_bytes
                new_out = _nbytes(dc, INTERIOR_BYTES)
                if new_in + new_interior + new_out <= budget_bytes:
                    in_bytes = new_in
                    interior_bytes = new_interior
                    out_bytes = new_out
                else:
                    close(t)
            else:
                close(t)

        if t == seg_start:
            # a fresh segment opens at t; it only becomes fused if a later
            # step chains onto it, which requires exactly one batch operand
            if a_batch != b_batch:
                in_bytes = _nbytes(da, input_bytes) + _nbytes(db, input_bytes)
                out_bytes = _nbytes(dc, INTERIOR_BYTES)
                if in_bytes + out_bytes > budget_bytes:
                    # even the opening working set overflows: never extend
                    in_bytes = out_bytes = 0
                    # mark unfusable by closing immediately after this step
                    work = [w for s_, w in enumerate(work)
                            if s_ not in (i, j)] + [(ec, dc)]
                    close(t + 1)
                    continue
            else:
                # core-core (or degenerate) step: singleton by construction
                work = [w for s_, w in enumerate(work)
                        if s_ not in (i, j)] + [(ec, dc)]
                close(t + 1)
                continue

        work = [w for s_, w in enumerate(work) if s_ not in (i, j)]
        work.append((ec, dc))

    if seg_start < len(steps):
        close(len(steps))
    return tuple(segments)


def has_fused(segments: Sequence[Segment] | None) -> bool:
    """True when at least one segment spans more than one step."""
    return bool(segments) and any(e - s >= 2 for s, e in segments)


def step_roles(
    n_nodes: int,
    steps: Sequence[tuple[int, int]],
    segments: Sequence[Segment],
) -> list[StepRole]:
    """Per-step fusion roles for the cost model.

    ``n_nodes`` is the initial work-list size (``len(tn.nodes)``); chain
    operands are recovered purely from current-index arithmetic — before
    step ``t`` the list holds ``n_nodes - t`` entries, so step ``t-1``'s
    result sits at index ``n_nodes - t - 1``.
    """
    roles: list[StepRole] = []
    by_step: dict[int, Segment] = {}
    for seg in segments:
        for t in range(seg[0], seg[1]):
            by_step[t] = seg
    for t, (i, j) in enumerate(steps):
        seg = by_step.get(t, (t, t + 1))
        s, e = seg
        fused = e - s >= 2
        chain = None
        if fused and t > s:
            prev = n_nodes - t - 1
            chain = "a" if i == prev else ("b" if j == prev else None)
        roles.append(StepRole(
            segment=seg,
            chain_operand=chain,
            interior_output=fused and t < e - 1,
        ))
    return roles


def chain_problems(
    tn: TensorNetwork,
    steps: Sequence[tuple[int, int]],
    segments: Sequence[Segment],
    batch_edge: str = BATCH_EDGE,
) -> list[str]:
    """Why ``segments``' fused runs cannot execute on ``tn`` (empty = OK).

    Structural check only (chain shape + batch-edge placement, no VMEM
    budget): a plan's recorded segmentation may have been produced under
    a different budget, but a fused range that is not a batch-carrying
    chain can never execute as one ``pallas_call``.  Used by
    ``plan.compiler.validate_plan``.
    """
    try:
        validate_segments(segments, len(steps))
    except ValueError as e:
        return [str(e)]
    problems: list[str] = []
    seg_of: dict[int, Segment] = {}
    for seg in segments:
        for t in range(seg[0], seg[1]):
            seg_of[t] = seg
    work = [n.edges for n in tn.nodes]
    n0 = len(work)
    for t, (i, j) in enumerate(steps):
        if i == j or not (0 <= i < len(work) and 0 <= j < len(work)):
            problems.append(f"step {t} indices ({i}, {j}) out of range")
            break
        ea, eb = work[i], work[j]
        s, e = seg_of[t]
        if e - s >= 2:
            a_batch = batch_edge in ea
            b_batch = batch_edge in eb
            if t == s:
                if a_batch == b_batch:
                    problems.append(
                        f"segment ({s}, {e}) opens at step {t} with "
                        f"{int(a_batch) + int(b_batch)} batch-carrying "
                        "operands (need exactly one)")
            else:
                prev = n0 - t - 1
                if i != prev and j != prev:
                    problems.append(
                        f"segment ({s}, {e}) step {t} does not consume "
                        "the previous step's result (not a chain)")
                else:
                    chain_e = ea if i == prev else eb
                    other_e = eb if i == prev else ea
                    if batch_edge not in chain_e or batch_edge in other_e:
                        problems.append(
                            f"segment ({s}, {e}) step {t}: the batch edge "
                            "must ride the chain operand")
        shared = set(ea) & set(eb)
        ec = tuple(x for x in ea if x not in shared) + tuple(
            x for x in eb if x not in shared)
        work = [w for k, w in enumerate(work) if k not in (i, j)]
        work.append(ec)
    return problems


def validate_segments(
    segments: Sequence[Segment], n_steps: int
) -> None:
    """Raise ``ValueError`` unless ``segments`` is a contiguous ascending
    cover of ``[0, n_steps)`` (the wire-format invariant)."""
    if not segments:
        raise ValueError("segments must be non-empty when present")
    pos = 0
    for s, e in segments:
        if s != pos or e <= s:
            raise ValueError(
                f"segments must contiguously cover [0, {n_steps}): "
                f"got {tuple(segments)}")
        pos = e
    if pos != n_steps:
        raise ValueError(
            f"segments cover [0, {pos}) but the path has {n_steps} steps")
