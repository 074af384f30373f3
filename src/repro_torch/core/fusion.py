"""Fusion segments of a contraction path (port of part of
``src/repro/core/fusion.py``).

A *fused segment* is a contiguous run of path steps that forms a chain:
each step after the first consumes the previous step's result, and
exactly one operand of each step carries the batch edge.  Such a run
executes as one kernel launch (``kernels/fused_path.py``) with the
interior intermediates on chip.  The plan compiler stamps
``LayerPlan.segments``; the port reads them: :func:`has_fused` and
:func:`chain_problems` for the executor and the plan guard,
:func:`step_roles` for the per-step view.  ``segment_path`` (the greedy
segmentation the compiler runs) comes with the planning stack
(ROADMAP.md, Queue A item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .tensor_network import TensorNetwork

#: batch (streamed-token) edge label of the standard TT-linear network
BATCH_EDGE = "b"

#: interior intermediates are carried in fp32 on chip
INTERIOR_BYTES = 4

Segment = tuple[int, int]  # half-open step range [s, e)


@dataclasses.dataclass(frozen=True)
class StepRole:
    """How one path step takes part in its segment."""

    segment: Segment
    #: "a"/"b" when that operand is the on-chip chain; ``None`` for
    #: singleton segments and segment-opening steps
    chain_operand: str | None
    #: the step's result stays on chip
    interior_output: bool


def has_fused(segments: Sequence[Segment] | None) -> bool:
    """True when at least one segment spans more than one step."""
    return bool(segments) and any(e - s >= 2 for s, e in segments)


def step_roles(
    n_nodes: int,
    steps: Sequence[tuple[int, int]],
    segments: Sequence[Segment],
) -> list[StepRole]:
    """Per-step fusion roles.  ``n_nodes`` is the initial work-list size;
    before step ``t`` the list holds ``n_nodes - t`` entries, so step
    ``t-1``'s result sits at index ``n_nodes - t - 1``."""
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

    Structural check only (chain shape and batch-edge placement, no
    on-chip budget); the plan guard runs it.
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


def validate_segments(segments: Sequence[Segment], n_steps: int) -> None:
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
