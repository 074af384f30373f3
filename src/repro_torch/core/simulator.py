"""Analytic systolic-array latency simulator (paper 3.3, simulator of [18]).

Framework-neutral copy of ``src/repro/core/simulator.py`` (the port never imports
the JAX package).

SCALE-Sim-style closed-form model of a parameterizable ``R x C`` systolic
array with IS / OS / WS dataflows, double-buffered scratchpads and a DRAM
bandwidth roof.  Every target is a ``repro_torch.hw.HardwareConfig``: the
paper-faithful FPGA setup (32x32 PEs @ 200 MHz, INT8), the TPU-v5e
adaptation, and every candidate of the searched architecture space
(``repro_torch.hw.space``) all drive this one model.

Per-GEMM latency = max(compute_cycles, dram_traffic / bandwidth): each GEMM
is either pipeline-bound or memory-bound, which is exactly the asymmetry
that makes the MAC-optimal contraction path differ from the latency-optimal
one (paper Fig. 3).

Core partitioning (paper 4.2): the array may be split into two half-cores
(``1x2``: two R x C/2, ``2x1``: two R/2 x C).  Independent contraction
branches run concurrently on the halves; dependent stages run *jointly*,
each half-core taking half of the widest GEMM dimension.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Sequence

import numpy as np

from ..hw.config import HardwareConfig
from ..hw.targets import FPGA_VU9P
from .paths import CandidatePath
from .tensor_network import GemmShape


class Dataflow(str, enum.Enum):
    IS = "IS"  # input-stationary
    OS = "OS"  # output-stationary
    WS = "WS"  # weight-stationary


#: the paper's dataflow space D_l
ALL_DATAFLOWS: tuple[Dataflow, ...] = (Dataflow.IS, Dataflow.OS, Dataflow.WS)

#: core-partitioning options C_all = {1x1, 1x2, 2x1} (rows_split, cols_split)
Partitioning = tuple[int, int]
ALL_PARTITIONINGS: tuple[Partitioning, ...] = ((1, 1), (1, 2), (2, 1))

#: global strategy space H (paper 3.2): each strategy constrains C to C_h
STRATEGY_SPACE: dict[str, tuple[Partitioning, ...]] = {
    "monolithic": ((1, 1),),
    "split": ((1, 2), (2, 1)),
}


@dataclasses.dataclass(frozen=True)
class GemmReport:
    cycles: float
    compute_cycles: float
    traffic_words: float
    utilization: float  # MACs / (cycles * array MACs/cycle)


def _cdiv(a, b):
    """Exact ceil-division; elementwise over Python ints or integer ndarrays."""
    return -(-a // b)


def _reads(operand_words, reuse_folds, hw: HardwareConfig):
    """DRAM words read for an operand reused across ``reuse_folds`` passes.

    If the operand fits on-chip it is read once; otherwise every pass
    re-streams it (double-buffered, so no write-back cost for read operands).
    Elementwise over Python ints or integer ndarrays.
    """
    if isinstance(operand_words, np.ndarray):
        return np.where(
            operand_words * hw.bytes_per_word <= hw.sram_input_bytes,
            operand_words,
            operand_words * reuse_folds,
        )
    if operand_words * hw.bytes_per_word <= hw.sram_input_bytes:
        return operand_words
    return operand_words * reuse_folds


def gemm_cost_model(M, K, N, df: Dataflow, R, C, hw: HardwareConfig):
    """The closed-form per-GEMM cost model, expressed exactly once.

    Elementwise over Python ints (the scalar oracle, ``gemm_latency``) or
    int64 ndarrays (the batched engine, ``repro_torch.core.cost_table``);
    ``tpu_cost.TPU_V5E`` re-parameterizes the same model via
    ``HardwareConfig`` constants.

    Returns ``(cycles, compute_cycles, traffic_words)`` as float64, where
    cycles = max(compute, traffic / bandwidth) + per-GEMM overhead — the
    pipeline-vs-memory roof of paper 3.3.
    """
    a_words, b_words, c_words = M * K, K * N, M * N
    if df is Dataflow.OS:
        # each PE owns one output; K streams through the array
        compute = _cdiv(M, R) * _cdiv(N, C) * (K + R + C - 2)
        traffic = (
            _reads(a_words, _cdiv(N, C), hw)
            + _reads(b_words, _cdiv(M, R), hw)
            + c_words  # written once
        )
    elif df is Dataflow.WS:
        # a K x N weight tile is pinned; M activations stream past it
        # (R-cycle weight preload per fold)
        compute = _cdiv(K, R) * _cdiv(N, C) * (R + M + C - 1)
        traffic = (
            _reads(a_words, _cdiv(N, C), hw)
            + b_words  # each weight element loaded exactly once
            # partial outputs spill/reload once per extra K fold
            + c_words * (2 * _cdiv(K, R) - 1)
        )
    elif df is Dataflow.IS:
        # an M x K input tile is pinned; N weight columns stream past it
        compute = _cdiv(M, R) * _cdiv(K, C) * (R + N + C - 1)
        traffic = (
            a_words  # each input element loaded exactly once
            + _reads(b_words, _cdiv(M, R), hw)
            + c_words * (2 * _cdiv(K, C) - 1)
        )
    else:  # pragma: no cover
        raise ValueError(df)
    if isinstance(compute, np.ndarray):
        compute = np.asarray(compute, np.float64)
        traffic = np.asarray(traffic, np.float64)
        mem_cycles = traffic / hw.dram_words_per_cycle
        cycles = np.maximum(compute, mem_cycles) + hw.gemm_overhead_cycles
        return cycles, compute, traffic
    # Python-int fast path (the per-cell scalar oracle): the same IEEE
    # double ops as the array path, so results stay bit-identical
    compute = float(compute)
    traffic = float(traffic)
    cycles = max(compute, traffic / hw.dram_words_per_cycle) + hw.gemm_overhead_cycles
    return cycles, compute, traffic


def gemm_latency(
    g: GemmShape,
    df: Dataflow,
    hw: HardwareConfig,
    rows: int | None = None,
    cols: int | None = None,
) -> GemmReport:
    """Closed-form latency of one (M x K) @ (K x N) GEMM on an R x C array."""
    R = rows if rows is not None else hw.pe_rows
    C = cols if cols is not None else hw.pe_cols
    cycles, compute, traffic = gemm_cost_model(g.M, g.K, g.N, df, R, C, hw)
    cycles = float(cycles)
    util = g.macs / (cycles * R * C) if cycles > 0 else 0.0
    return GemmReport(cycles, float(compute), float(traffic), util)


# ---------------------------------------------------------------------------
# Path-level scheduling with core partitioning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerReport:
    cycles: float
    seconds: float
    macs: int
    utilization: float
    traffic_words: float
    n_parallel_stages: int  # stages where both half-cores ran distinct GEMMs


def _split_gemm(g: GemmShape, part: Partitioning) -> GemmShape:
    """Half of a GEMM executed jointly by both half-cores.

    ``1x2`` splits the N dimension (column halves), ``2x1`` splits M.
    """
    if part == (1, 2):
        return GemmShape(g.M, g.K, math.ceil(g.N / 2), g.a_is_input, g.b_is_input)
    if part == (2, 1):
        return GemmShape(math.ceil(g.M / 2), g.K, g.N, g.a_is_input, g.b_is_input)
    return g


def _dependency_levels(path: CandidatePath, n_leaves: int) -> list[list[int]]:
    """Group path steps into dependency levels (steps in a level are
    mutually independent).  Step t contracts two entries of the current
    node list; merged results are appended, mirroring
    ``TensorNetwork.contract_pair``.
    """
    # node id -> producing step (None for leaves); current list holds ids
    current: list[tuple[int, int | None]] = [(i, None) for i in range(n_leaves)]
    next_id = n_leaves
    dep_of_step: list[set[int]] = []
    producer: dict[int, int] = {}
    for t, (i, j) in enumerate(path.steps):
        (_, pa), (_, pb) = current[i], current[j]
        deps = set()
        if pa is not None:
            deps.add(pa)
        if pb is not None:
            deps.add(pb)
        dep_of_step.append(deps)
        producer[next_id] = t
        current = [c for s, c in enumerate(current) if s not in (i, j)]
        current.append((next_id, t))
        next_id += 1
    # longest-path level of each step
    level = [0] * len(path.steps)
    for t in range(len(path.steps)):
        level[t] = 1 + max((level[d] for d in dep_of_step[t]), default=-1)
    levels: list[list[int]] = [[] for _ in range(max(level, default=-1) + 1)]
    for t, lv in enumerate(level):
        levels[lv].append(t)
    return levels


def layer_latency(
    path: CandidatePath,
    df: Dataflow,
    part: Partitioning,
    hw: HardwareConfig,
    n_leaves: int | None = None,
) -> LayerReport:
    """End-to-end latency of a contraction path under (dataflow, partition).

    Monolithic (1,1): GEMMs run sequentially on the full array.
    Split (1,2)/(2,1): per dependency level, independent GEMMs pair up on
    the two half-cores (concurrent); leftovers run jointly (dimension split
    across both halves) — paper 4.2 semantics.
    """
    if n_leaves is None:
        n_leaves = len(path.steps) + 1
    gemms = path.gemms
    total_macs = sum(g.macs for g in gemms)
    traffic = 0.0

    if part == (1, 1):
        cycles = 0.0
        for g in gemms:
            rep = gemm_latency(g, df, hw)
            cycles += rep.cycles
            traffic += rep.traffic_words
        util = total_macs / (cycles * hw.macs_per_cycle) if cycles else 0.0
        return LayerReport(cycles, cycles / hw.freq_hz, total_macs, util, traffic, 0)

    rsplit, csplit = part
    half_rows = hw.pe_rows // rsplit
    half_cols = hw.pe_cols // csplit
    levels = _dependency_levels(path, n_leaves)
    cycles = 0.0
    n_parallel = 0
    for level in levels:
        # pair up independent GEMMs on the two half-cores
        idx = 0
        while idx + 1 < len(level):
            ga = gemms[level[idx]]
            gb = gemms[level[idx + 1]]
            ra = gemm_latency(ga, df, hw, half_rows, half_cols)
            rb = gemm_latency(gb, df, hw, half_rows, half_cols)
            cycles += max(ra.cycles, rb.cycles)
            traffic += ra.traffic_words + rb.traffic_words
            n_parallel += 1
            idx += 2
        if idx < len(level):  # leftover runs jointly, split across halves
            g = gemms[level[idx]]
            half = _split_gemm(g, part)
            rep = gemm_latency(half, df, hw, half_rows, half_cols)
            cycles += rep.cycles
            traffic += 2 * rep.traffic_words
    util = total_macs / (cycles * hw.macs_per_cycle) if cycles else 0.0
    return LayerReport(cycles, cycles / hw.freq_hz, total_macs, util, traffic, n_parallel)


def simulate(
    path: CandidatePath,
    part: Partitioning,
    df: Dataflow,
    hw: HardwareConfig = FPGA_VU9P,
) -> float:
    """Latency in seconds — the ``Simulate(p, c, d)`` oracle of Algorithm 1."""
    return layer_latency(path, df, part, hw).seconds


# ---------------------------------------------------------------------------
# fused-segment accounting (repro_torch.core.fusion chain runs)
# ---------------------------------------------------------------------------

def fused_segment_cost(
    gemms: Sequence[GemmShape],
    roles: Sequence,            # Sequence[fusion.StepRole] slice
    hw: HardwareConfig,
) -> tuple[float, float]:
    """``(cycles, traffic_words)`` of one fused chain run.

    Every step inside a fused run executes OS-style (the fused kernel's
    in-VMEM fallback, see ``kernels/fused_path.py``): compute is the OS
    pipeline term per step, but the HBM traffic drops the terms the
    fusion keeps on-chip — the chain operand's reads (it is the previous
    step's VMEM-resident result) and every interior output's writes
    (fp32 VMEM scratch).  The whole run pays ONE per-GEMM launch
    overhead, not one per step.
    """
    R, C = hw.pe_rows, hw.pe_cols
    compute = 0.0
    traffic = 0.0
    for g, role in zip(gemms, roles):
        compute += float(_cdiv(g.M, R) * _cdiv(g.N, C) * (g.K + R + C - 2))
        a = (0.0 if role.chain_operand == "a"
             else float(_reads(g.M * g.K, _cdiv(g.N, C), hw)))
        b = (0.0 if role.chain_operand == "b"
             else float(_reads(g.K * g.N, _cdiv(g.M, R), hw)))
        c = 0.0 if role.interior_output else float(g.M * g.N)
        traffic += a + b + c
    cycles = (max(compute, traffic / hw.dram_words_per_cycle)
              + hw.gemm_overhead_cycles)
    return cycles, traffic


def fused_layer_latency(
    path: CandidatePath,
    df: Dataflow,
    hw: HardwareConfig,
    segments: Sequence[tuple[int, int]],
    roles: Sequence,            # Sequence[fusion.StepRole], one per step
) -> LayerReport:
    """Monolithic-layer latency under a fusion segmentation.

    Singleton segments keep the per-step model with dataflow ``df``
    (their kernels run stand-alone, exactly as in :func:`layer_latency`);
    fused runs use :func:`fused_segment_cost`.  Only the monolithic
    ``(1, 1)`` partitioning is modeled — fused runs serialize a chain, so
    half-core pairing never applies inside one.
    """
    gemms = path.gemms
    total_macs = sum(g.macs for g in gemms)
    cycles = 0.0
    traffic = 0.0
    for (s, e) in segments:
        if e - s >= 2:
            cyc, tra = fused_segment_cost(gemms[s:e], roles[s:e], hw)
        else:
            rep = gemm_latency(gemms[s], df, hw)
            cyc, tra = rep.cycles, rep.traffic_words
        cycles += cyc
        traffic += tra
    util = total_macs / (cycles * hw.macs_per_cycle) if cycles else 0.0
    return LayerReport(cycles, cycles / hw.freq_hz, total_macs, util,
                       traffic, 0)
