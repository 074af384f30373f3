"""Batched cost-table engine — Algorithm 1 line 2, vectorized.

Framework-neutral copy of ``src/repro/core/cost_table.py`` (the port never imports
the JAX package).

``dse.build_cost_table`` populates ``T[l, p, c, d]`` over every (layer,
path, partitioning, dataflow) tuple.  The scalar engine calls
``simulate()`` once per cell: a Python quadruple loop that re-walks each
path's dependency structure and re-evaluates each GEMM for every cell.
This module replaces it with three passes that exploit the structure of
the space:

1. **Dedup.** Candidate paths of the same layer share most GEMM shapes,
   identical layers repeat across the model (transformer stacks), and a
   split partitioning evaluates every GEMM on the same half-core geometry
   — so the set of *unique* ``(M, K, N, R, C)`` evaluations is far
   smaller than ``L x P x C x D x steps``.  Layers with identical
   candidate-path sets collapse to one representative.
2. **Batch evaluation.** All unique rows go through the shared
   closed-form model (``simulator.gemm_cost_model``) as int64 arrays —
   one vectorized NumPy evaluation per dataflow instead of per-cell
   Python calls.
3. **Assembly.** Each (path, partitioning) is compiled once into a short
   program of ``seq`` / ``pair`` / ``joint`` ops over registry row ids
   (mirroring ``simulator.layer_latency``'s scheduling exactly), then
   replayed with gather views vectorized over the dataflow axis.  The
   accumulation order matches the scalar oracle op for op, so the table
   is bit-identical to ``simulate()``.

The engine also returns per-cell DRAM traffic and per-path MACs, which
the ``repro_torch.dse`` CLI combines into the energy-delay-product objective.

**Hardware axis.**  The same three passes batch over *hardware
candidates* (``build_cost_tables_hw``): candidates sharing an array
geometry share compiled programs, candidates sharing a memory profile
(SRAM capacity, bandwidth, word width, per-GEMM overhead) share one
vectorized model evaluation, and each program is replayed once over the
``(profile, dataflow)`` axes.  Per candidate the result is bit-identical
to a scalar ``simulate()`` sweep with that candidate — the joint
(architecture, path, dataflow) search of ``dse.global_search(hw_space=
...)`` therefore inherits the exhaustive-optimality guarantee.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Sequence

import numpy as np

from . import fusion
from .paths import CandidatePath
from .simulator import (
    ALL_DATAFLOWS,
    ALL_PARTITIONINGS,
    Dataflow,
    HardwareConfig,
    Partitioning,
    _dependency_levels,
    _split_gemm,
    fused_layer_latency,
    gemm_cost_model,
)

#: cost-table key — (layer, path_index, partitioning, dataflow)
Key = tuple[int, int, Partitioning, Dataflow]

# ---------------------------------------------------------------------------
# energy constants for the EDP objective (rough INT8-era figures: a MAC is
# ~0.3 pJ in 16 nm, DRAM access ~15 pJ/byte — the *ratio* is what steers
# the argmin, and it matches the common "DRAM is ~50-100x a MAC" rule)
# ---------------------------------------------------------------------------
MAC_ENERGY_J = 0.3e-12
DRAM_ENERGY_J_PER_BYTE = 15e-12


@dataclasses.dataclass(frozen=True)
class CostTables:
    """Vectorized build output: the latency table plus EDP ingredients."""

    seconds: dict[Key, float]
    traffic_words: dict[Key, float]
    macs: dict[tuple[int, int], int]  # (l, p) -> total path MACs
    build_seconds: float
    n_cells: int
    n_unique_gemm_evals: int
    n_unique_layers: int

    def energy_joules(self, key: Key, hw: HardwareConfig) -> float:
        """Energy of one configuration under the simple MAC+DRAM model."""
        return (
            self.macs[key[:2]] * MAC_ENERGY_J
            + self.traffic_words[key] * hw.bytes_per_word * DRAM_ENERGY_J_PER_BYTE
        )

    def edp(self, hw: HardwareConfig) -> dict[Key, float]:
        """Energy-delay product table over the same keys as ``seconds``."""
        return {
            k: s * self.energy_joules(k, hw) for k, s in self.seconds.items()
        }


class _GemmRegistry:
    """Deduplicated (M, K, N, R, C) rows, batch-evaluated per dataflow."""

    def __init__(self) -> None:
        self._index: dict[tuple[int, int, int, int, int], int] = {}
        self.rows: list[tuple[int, int, int, int, int]] = []

    def add(self, M: int, K: int, N: int, R: int, C: int) -> int:
        key = (M, K, N, R, C)
        idx = self._index.get(key)
        if idx is None:
            idx = len(self.rows)
            self._index[key] = idx
            self.rows.append(key)
        return idx

    def evaluate(
        self,
        dataflows: Sequence[Dataflow],
        profiles: Sequence[HardwareConfig],
    ) -> tuple[np.ndarray, np.ndarray]:
        """(cycles, traffic_words) as [n_rows, n_profiles, n_dataflows].

        A *profile* is a representative hw candidate for everything the
        per-GEMM model reads besides the array geometry (which lives in
        the rows): SRAM capacity, word width, bandwidth, overhead.
        """
        rows = np.asarray(self.rows, dtype=np.int64).reshape(-1, 5)
        M, K, N, R, C = (rows[:, i] for i in range(5))
        cyc = np.empty((rows.shape[0], len(profiles), len(dataflows)))
        tra = np.empty_like(cyc)
        for p_idx, prof_hw in enumerate(profiles):
            for d_idx, df in enumerate(dataflows):
                cycles, _, traffic = gemm_cost_model(M, K, N, df, R, C,
                                                     prof_hw)
                cyc[:, p_idx, d_idx] = cycles
                tra[:, p_idx, d_idx] = traffic
        return cyc, tra


# one compiled op: ("seq", row) | ("pair", row_a, row_b) | ("joint", row)
_Program = list[tuple]


def _compile_path(
    path: CandidatePath,
    part: Partitioning,
    hw: HardwareConfig,
    reg: _GemmRegistry,
) -> _Program:
    """Compile one (path, partitioning) into registry-id ops.

    Mirrors ``simulator.layer_latency``: monolithic runs GEMMs in path
    order on the full array; split pairs up independent GEMMs per
    dependency level on the half-cores, leftovers run jointly on a
    dimension-split shape.
    """
    gemms = path.gemms
    if part == (1, 1):
        R, C = hw.pe_rows, hw.pe_cols
        return [("seq", reg.add(g.M, g.K, g.N, R, C)) for g in gemms]
    rsplit, csplit = part
    R, C = hw.pe_rows // rsplit, hw.pe_cols // csplit
    ops: _Program = []
    for level in _dependency_levels(path, len(path.steps) + 1):
        idx = 0
        while idx + 1 < len(level):
            ga, gb = gemms[level[idx]], gemms[level[idx + 1]]
            ops.append(
                ("pair", reg.add(ga.M, ga.K, ga.N, R, C),
                 reg.add(gb.M, gb.K, gb.N, R, C))
            )
            idx += 2
        if idx < len(level):
            h = _split_gemm(gemms[level[idx]], part)
            ops.append(("joint", reg.add(h.M, h.K, h.N, R, C)))
    return ops


def _layer_key(paths: Sequence[CandidatePath]) -> tuple:
    """Identity of a layer's DSE subproblem: path structure + GEMM shapes."""
    return tuple(
        (p.steps, tuple(g.as_tuple() for g in p.gemms)) for p in paths
    )


def build_cost_tables_hw(
    layer_paths: Sequence[Sequence[CandidatePath]],
    hw_list: Sequence[HardwareConfig],
    partitionings: Sequence[Partitioning] = ALL_PARTITIONINGS,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
) -> tuple[CostTables, ...]:
    """Populate T[l, p, c, d] for every hardware candidate in one build.

    The hw axis shares all three passes: candidates with the same array
    geometry ``(pe_rows, pe_cols)`` share compiled programs and registry
    rows, candidates with the same memory profile share one vectorized
    model evaluation, and each program replays once over the
    ``(profile, dataflow)`` axes before broadcasting to the candidates.
    Returns one :class:`CostTables` per candidate, aligned with
    ``hw_list`` — each bit-identical to a scalar ``simulate()`` sweep of
    that candidate.  ``build_seconds`` / ``n_unique_gemm_evals`` report
    the *shared* batched build on every element.
    """
    t0 = time.perf_counter()
    hw_list = tuple(hw_list)
    if not hw_list:
        raise ValueError("hw_list must name at least one hardware candidate")
    partitionings = tuple(partitionings)
    dataflows = tuple(dataflows)

    # pass 1 — dedup layers; compile programs once per array geometry
    unique_layers: dict[tuple, list[int]] = {}
    for l, paths in enumerate(layer_paths):
        unique_layers.setdefault(_layer_key(paths), []).append(l)

    geom_index: dict[tuple[int, int], int] = {}
    geom_reps: list[HardwareConfig] = []
    geom_of_hw: list[int] = []
    for hw in hw_list:
        g = (hw.pe_rows, hw.pe_cols)
        if g not in geom_index:
            geom_index[g] = len(geom_reps)
            geom_reps.append(hw)
        geom_of_hw.append(geom_index[g])
    hw_by_geom: dict[int, list[int]] = {}
    for h, g in enumerate(geom_of_hw):
        hw_by_geom.setdefault(g, []).append(h)

    reg = _GemmRegistry()
    # programs[key][p_idx][part][g_idx] -> _Program
    programs: dict[tuple, list[dict[Partitioning, list[_Program]]]] = {}
    for key, members in unique_layers.items():
        paths = layer_paths[members[0]]
        programs[key] = [
            {part: [_compile_path(path, part, rep, reg) for rep in geom_reps]
             for part in partitionings}
            for path in paths
        ]

    # pass 2 — one vectorized model evaluation per (memory profile,
    # dataflow); the array geometry is part of the registry rows
    prof_index: dict[tuple, int] = {}
    prof_reps: list[HardwareConfig] = []
    prof_of_hw: list[int] = []
    for hw in hw_list:
        p = (hw.sram_input_bytes, hw.bytes_per_word,
             hw.dram_words_per_cycle, hw.gemm_overhead_cycles)
        if p not in prof_index:
            prof_index[p] = len(prof_reps)
            prof_reps.append(hw)
        prof_of_hw.append(prof_index[p])
    cyc, tra = reg.evaluate(dataflows, prof_reps)

    # pass 3 — replay programs (vectorized over (profile, dataflow),
    # scalar-ordered accumulation so every candidate's table is
    # bit-identical to its sequential oracle), broadcast per candidate
    seconds: list[dict[Key, float]] = [{} for _ in hw_list]
    traffic: list[dict[Key, float]] = [{} for _ in hw_list]
    macs: list[dict[tuple[int, int], int]] = [{} for _ in hw_list]
    for key, members in unique_layers.items():
        paths = layer_paths[members[0]]
        for p_idx, per_part in enumerate(programs[key]):
            for part, per_geom in per_part.items():
                for g_idx, prog in enumerate(per_geom):
                    tot_c = np.zeros((len(prof_reps), len(dataflows)))
                    tot_t = np.zeros_like(tot_c)
                    for op in prog:
                        if op[0] == "seq":
                            tot_c = tot_c + cyc[op[1]]
                            tot_t = tot_t + tra[op[1]]
                        elif op[0] == "pair":
                            tot_c = tot_c + np.maximum(cyc[op[1]], cyc[op[2]])
                            tot_t = tot_t + (tra[op[1]] + tra[op[2]])
                        else:  # joint: both half-cores stream the split GEMM
                            tot_c = tot_c + cyc[op[1]]
                            tot_t = tot_t + 2.0 * tra[op[1]]
                    for h in hw_by_geom[g_idx]:
                        secs = tot_c[prof_of_hw[h]] / hw_list[h].freq_hz
                        tw = tot_t[prof_of_hw[h]]
                        for d_idx, d in enumerate(dataflows):
                            s, t = float(secs[d_idx]), float(tw[d_idx])
                            for l in members:
                                seconds[h][(l, p_idx, part, d)] = s
                                traffic[h][(l, p_idx, part, d)] = t
            for h in range(len(hw_list)):
                for l in members:
                    macs[h][(l, p_idx)] = paths[p_idx].macs

    build_s = time.perf_counter() - t0
    return tuple(
        CostTables(
            seconds=seconds[h],
            traffic_words=traffic[h],
            macs=macs[h],
            build_seconds=build_s,
            n_cells=len(seconds[h]),
            n_unique_gemm_evals=len(reg.rows),
            n_unique_layers=len(unique_layers),
        )
        for h in range(len(hw_list))
    )


def fused_cost_tables(
    layer_paths: Sequence[Sequence[CandidatePath]],
    layer_networks: Sequence,        # Sequence[TensorNetwork], aligned
    hw: HardwareConfig,
    *,
    block_tokens: int,
    budget_bytes: int,
    partitionings: Sequence[Partitioning] = ALL_PARTITIONINGS,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
    base: Optional[CostTables] = None,
) -> CostTables:
    """Fusion-aware cost tables: fused chain runs charge no interior HBM.

    For every (layer, path) whose steps segment into at least one fused
    chain run under ``budget_bytes`` (``repro_torch.core.fusion.segment_path``
    at ``block_tokens`` — the same rule the plan compiler stamps
    ``LayerPlan.segments`` with), the monolithic ``(1, 1)`` cells are
    replaced by :func:`simulator.fused_layer_latency`: interior
    intermediates charge zero HBM bytes, the chain operand's reads are
    free, and each run pays one launch overhead.  Split-partitioning
    cells and unfusable paths keep the spill-per-step numbers, so the
    result is a drop-in ``global_search(table=...)`` override — paths
    that *segment well* win cells they would otherwise lose to
    lower-MAC but spill-heavy orders.

    ``layer_networks`` supplies the edge structure the segmentation
    reads (any batch size — the batch dim is re-blocked to
    ``block_tokens``).  Pass ``base`` to reuse an already-built
    spill-always table.
    """
    t0 = time.perf_counter()
    partitionings = tuple(partitionings)
    dataflows = tuple(dataflows)
    if len(layer_paths) != len(layer_networks):
        raise ValueError(
            f"{len(layer_paths)} path lists vs {len(layer_networks)} networks")
    if base is None:
        base = build_cost_tables(layer_paths, hw, partitionings, dataflows)
    seconds = dict(base.seconds)
    traffic = dict(base.traffic_words)

    # identical layers share the segmentation (and the fused cells): the
    # segmentation depends only on the re-blocked entry dims and the steps
    seg_cache: dict[tuple, tuple] = {}
    for l, (paths, tn) in enumerate(zip(layer_paths, layer_networks)):
        entries = tuple(fusion._entry_dims(tn, block_tokens,
                                           fusion.BATCH_EDGE))
        for p_idx, path in enumerate(paths):
            ck = (entries, tuple(path.steps))
            segs = seg_cache.get(ck)
            if segs is None:
                segs = fusion.segment_path(
                    tn, path.steps, block_tokens=block_tokens,
                    budget_bytes=budget_bytes)
                seg_cache[ck] = segs
            if not fusion.has_fused(segs):
                continue
            roles = fusion.step_roles(len(tn.nodes), path.steps, segs)
            for d in dataflows:
                rep = fused_layer_latency(path, d, hw, segs, roles)
                if (1, 1) in partitionings:
                    seconds[(l, p_idx, (1, 1), d)] = rep.seconds
                    traffic[(l, p_idx, (1, 1), d)] = rep.traffic_words
    return CostTables(
        seconds=seconds,
        traffic_words=traffic,
        macs=dict(base.macs),
        build_seconds=base.build_seconds + (time.perf_counter() - t0),
        n_cells=base.n_cells,
        n_unique_gemm_evals=base.n_unique_gemm_evals,
        n_unique_layers=base.n_unique_layers,
    )


def shard_streamed_tokens(tokens: int, n_shards: int) -> int:
    """Per-device token count for an ``n_shards`` data-parallel mesh.

    The shard_map executor (``repro_torch.plan.sharded``) streams
    ``tokens / n_shards`` rows per device, so cost tables and tilings
    must be evaluated at this count for the searched mapping to match
    what executes.  Non-divisible counts floor (the executor would fall
    back to the jnp path for those, but the search still wants the
    closest per-shard problem); never below 1.
    """
    if n_shards <= 1:
        return tokens
    return max(1, tokens // n_shards)


def build_cost_tables(
    layer_paths: Sequence[Sequence[CandidatePath]],
    hw: HardwareConfig,
    partitionings: Sequence[Partitioning] = ALL_PARTITIONINGS,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
) -> CostTables:
    """Populate T[l, p, c, d] (plus traffic/MACs) with batched evaluation."""
    return build_cost_tables_hw(layer_paths, (hw,), partitionings,
                                dataflows)[0]


def build_cost_table_vectorized(
    layer_paths: Sequence[Sequence[CandidatePath]],
    hw: HardwareConfig,
    partitionings: Sequence[Partitioning] = ALL_PARTITIONINGS,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
) -> dict[Key, float]:
    """Drop-in replacement for the scalar ``dse.build_cost_table`` loop."""
    return build_cost_tables(layer_paths, hw, partitionings, dataflows).seconds


def table_cells(
    layer_paths: Sequence[Sequence[CandidatePath]],
    partitionings: Sequence[Partitioning] = ALL_PARTITIONINGS,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
) -> int:
    """Number of T[l, p, c, d] cells one architecture's table holds.

    The evaluation-accounting unit of the guided search: an exhaustive
    co-search reads ``len(space) * table_cells(...)`` cells, a budgeted
    one stops early.  Counting cells (not batched GEMM evaluations, which
    dedup across repeated layers) keeps the unit comparable between the
    exhaustive and guided drivers regardless of layer dedup.
    """
    per_layer = len(partitionings) * len(dataflows)
    return sum(len(paths) * per_layer for paths in layer_paths)


# ---------------------------------------------------------------------------
# training cost tables: fwd + bwd + grad-update (paper's training objective)
# ---------------------------------------------------------------------------

#: backward-table key — (layer, partitioning, dataflow); the backward term
#: is independent of the *forward* path choice (gradients contract directly
#: from X / dY / cores, no stashed forward intermediates)
BwdKey = tuple[int, Partitioning, Dataflow]


@dataclasses.dataclass(frozen=True)
class BackwardChoice:
    """Argmin path for one backward problem under a fixed (c, d)."""

    wrt: str                      # "dx" | core node name
    path_index: int
    path: CandidatePath
    latency_s: float


@dataclasses.dataclass(frozen=True)
class TrainCostTables:
    """Fwd + bwd + update decomposition of the training-latency objective.

    ``fwd`` is the usual inference table; ``bwd_seconds[(l, c, d)]`` is the
    sum over the layer's backward problems of each problem's best candidate
    path, evaluated on the *same* partitioning/dataflow as the forward (one
    hardware configuration per layer per step — the per-problem *path* is
    free, the dataflow is the layer's).  ``bwd_choices`` records those
    per-problem argmin paths; ``update_seconds[l]`` is the DRAM-bound
    optimizer update.  ``bwd_traffic_words`` mirrors the forward table's
    traffic field (the EDP ingredient) so a train-EDP objective can be
    assembled without rebuilding; nothing consumes it yet.
    """

    fwd: CostTables
    bwd_seconds: dict[BwdKey, float]
    bwd_traffic_words: dict[BwdKey, float]
    bwd_choices: dict[BwdKey, tuple[BackwardChoice, ...]]
    bwd_macs: dict[int, int]           # l -> sum of each problem's min-MAC path
    update_seconds: dict[int, float]
    weights: "TrainCostWeights"
    build_seconds: float

    def train_seconds(self) -> dict[Key, float]:
        """The joint objective over the forward table's key space:

        ``T[l, p, c, d] = w_f * fwd + w_b * bwd(l, c, d) + w_u * update(l)``
        """
        w = self.weights
        return {
            (l, p, c, d): (w.fwd * s
                           + w.bwd * self.bwd_seconds[(l, c, d)]
                           + w.update * self.update_seconds[l])
            for (l, p, c, d), s in self.fwd.seconds.items()
        }


def _flatten_backwards(
    layer_backwards: Sequence,
) -> tuple[list[Sequence[CandidatePath]], list[tuple[int, int]]]:
    """(layer, problem) -> pseudo-layer rows for the batched engine."""
    flat_paths: list[Sequence[CandidatePath]] = []
    flat_owner: list[tuple[int, int]] = []     # (layer, problem index)
    for l, lb in enumerate(layer_backwards):
        for m, prob in enumerate(lb.problems):
            flat_paths.append(prob.paths)
            flat_owner.append((l, m))
    return flat_paths, flat_owner


def _assemble_bwd(
    layer_backwards: Sequence,
    flat_owner: Sequence[tuple[int, int]],
    bwd_tables: CostTables,
    partitionings: Sequence[Partitioning],
    dataflows: Sequence[Dataflow],
) -> tuple[dict[BwdKey, float], dict[BwdKey, float],
           dict[BwdKey, tuple[BackwardChoice, ...]]]:
    """Per (layer, c, d): sum of each backward problem's argmin path."""
    bwd_seconds: dict[BwdKey, float] = {}
    bwd_traffic: dict[BwdKey, float] = {}
    bwd_choices: dict[BwdKey, tuple[BackwardChoice, ...]] = {}
    for c in partitionings:
        for d in dataflows:
            per_layer: dict[int, list[BackwardChoice]] = {}
            per_layer_traffic: dict[int, float] = {}
            for flat_l, (l, m) in enumerate(flat_owner):
                prob = layer_backwards[l].problems[m]
                lat, q = min(
                    (bwd_tables.seconds[(flat_l, q, c, d)], q)
                    for q in range(len(prob.paths))
                )
                per_layer.setdefault(l, []).append(
                    BackwardChoice(prob.wrt, q, prob.paths[q], lat))
                per_layer_traffic[l] = (
                    per_layer_traffic.get(l, 0.0)
                    + bwd_tables.traffic_words[(flat_l, q, c, d)])
            for l, choices in per_layer.items():
                key = (l, c, d)
                bwd_seconds[key] = sum(ch.latency_s for ch in choices)
                bwd_choices[key] = tuple(choices)
                bwd_traffic[key] = per_layer_traffic[l]
    return bwd_seconds, bwd_traffic, bwd_choices


def build_train_cost_tables_hw(
    layer_paths: Sequence[Sequence[CandidatePath]],
    layer_backwards: Sequence,            # Sequence[backward.LayerBackward]
    hw_list: Sequence[HardwareConfig],
    partitionings: Sequence[Partitioning] = ALL_PARTITIONINGS,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
    weights: Optional["TrainCostWeights"] = None,
) -> tuple[TrainCostTables, ...]:
    """The training-latency decomposition for every hardware candidate.

    The forward and (flattened) backward tables are built hw-batched —
    shared registry rows, one vectorized evaluation per memory profile —
    then assembled per candidate (the per-problem backward argmin and
    the DRAM-bound update term both depend on the candidate).
    """
    from .backward import TrainCostWeights, update_seconds as _upd

    t0 = time.perf_counter()
    if len(layer_paths) != len(layer_backwards):
        raise ValueError(
            f"{len(layer_paths)} forward layers vs "
            f"{len(layer_backwards)} backward layer problems")
    hw_list = tuple(hw_list)
    weights = weights or TrainCostWeights()
    partitionings = tuple(partitionings)
    dataflows = tuple(dataflows)

    fwd_list = build_cost_tables_hw(layer_paths, hw_list, partitionings,
                                    dataflows)
    flat_paths, flat_owner = _flatten_backwards(layer_backwards)
    bwd_list = build_cost_tables_hw(flat_paths, hw_list, partitionings,
                                    dataflows)

    bwd_macs: dict[int, int] = {}
    for l, lb in enumerate(layer_backwards):
        bwd_macs[l] = sum(
            min(p.macs for p in prob.paths) for prob in lb.problems)

    assembled = []
    for h, hw in enumerate(hw_list):
        bwd_seconds, bwd_traffic, bwd_choices = _assemble_bwd(
            layer_backwards, flat_owner, bwd_list[h], partitionings,
            dataflows)
        upd = {l: _upd(lb.n_params, hw)
               for l, lb in enumerate(layer_backwards)}
        assembled.append((fwd_list[h], bwd_seconds, bwd_traffic,
                          bwd_choices, upd))
    build_s = time.perf_counter() - t0
    return tuple(
        TrainCostTables(
            fwd=fwd,
            bwd_seconds=bwd_seconds,
            bwd_traffic_words=bwd_traffic,
            bwd_choices=bwd_choices,
            bwd_macs=dict(bwd_macs),
            update_seconds=upd,
            weights=weights,
            build_seconds=build_s,
        )
        for fwd, bwd_seconds, bwd_traffic, bwd_choices, upd in assembled
    )


def build_train_cost_tables(
    layer_paths: Sequence[Sequence[CandidatePath]],
    layer_backwards: Sequence,            # Sequence[backward.LayerBackward]
    hw: HardwareConfig,
    partitionings: Sequence[Partitioning] = ALL_PARTITIONINGS,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
    weights: Optional["TrainCostWeights"] = None,
) -> TrainCostTables:
    """Populate the training-latency decomposition with batched evaluation.

    Backward problems are flattened into one pseudo-layer list and pushed
    through the same vectorized engine as the forward table, so identical
    backward networks across a transformer stack (and across problems)
    dedup exactly like forward layers do.
    """
    return build_train_cost_tables_hw(
        layer_paths, layer_backwards, (hw,), partitionings, dataflows,
        weights=weights)[0]
