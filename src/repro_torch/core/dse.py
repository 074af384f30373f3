"""Global latency-driven design-space exploration (paper Algorithm 1).

Framework-neutral copy of ``src/repro/core/dse.py`` (the port never imports
the JAX package).

Stage 1 — design-space construction: per layer, the MAC-guided top-K path
search yields P_l; the partitioning space C_all and dataflow space D are
global.  Stage 2 — a cost table T[l, p, c, d] is populated by the latency
simulator.  Stage 3 — hierarchical search: for each global hardware
strategy h (which constrains C to C_h), the problem decomposes into
independent per-layer argmins; the best strategy wins.  This is exhaustive
over the (pruned) space, so the returned configuration is optimal within
it — matching the paper's "mathematically guaranteeing the optimal
solution with minimal overhead".

**Hardware co-search.**  ``global_search(hw_space=...)`` adds an outer
loop over architecture candidates (``repro_torch.hw.ArchSpace``): the
architecture is shared by every layer (non-separable), so each feasible
candidate gets its own hierarchical argmin over a cost table built by
the hw-batched engine (``cost_table.build_cost_tables_hw`` — shared
registry rows, one vectorized evaluation per memory profile), and the
best (architecture, per-layer choices) pair wins.  The outer loop is
exhaustive over the candidate list, so the optimality guarantee extends
to the joint (arch, path, partitioning, dataflow) space — for the
``latency`` and ``train-latency`` objectives alike.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Mapping, Sequence

from .paths import CandidatePath, find_topk_paths
from .simulator import (
    ALL_DATAFLOWS,
    STRATEGY_SPACE,
    Dataflow,
    HardwareConfig,
    FPGA_VU9P,
    Partitioning,
    simulate,
)
from .tensor_network import TensorNetwork


@dataclasses.dataclass(frozen=True)
class LayerChoice:
    """Optimal (p, c, d) for one layer under the winning strategy.

    Under the ``train-latency`` objective, ``latency_s`` is the combined
    per-step cost and the decomposition + per-gradient backward path
    choices are populated; under inference objectives the backward fields
    stay empty.
    """

    layer: int
    path_index: int
    path: CandidatePath
    partitioning: Partitioning
    dataflow: Dataflow
    latency_s: float
    backward: tuple = ()              # tuple[cost_table.BackwardChoice, ...]
    fwd_latency_s: float = 0.0
    bwd_latency_s: float = 0.0
    update_latency_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class HwCandidateResult:
    """One architecture candidate's best configuration (hw co-search)."""

    hw: HardwareConfig
    strategy: str
    total_latency_s: float


@dataclasses.dataclass(frozen=True)
class DSEResult:
    strategy: str
    choices: tuple[LayerChoice, ...]
    total_latency_s: float
    cost_table: Mapping[tuple[int, int, Partitioning, Dataflow], float]
    objective: str = "latency"
    #: the architecture the choices were evaluated on (the winning
    #: candidate under ``hw_space=``, else the fixed target)
    hw: HardwareConfig | None = None
    #: per-candidate outcomes when ``hw_space=`` was searched (aligned
    #: with the candidate list for exhaustive searches; the *visited*
    #: candidates, in refinement order, for guided searches)
    hw_candidates: tuple[HwCandidateResult, ...] = ()
    #: search provenance: ``"exhaustive"`` (Algorithm 1's full sweep) or
    #: ``"guided"`` (the budgeted explorer of ``repro_torch.search``)
    search: str = "exhaustive"
    #: cost-model evaluations performed — unique (arch, layer, path,
    #: partitioning, dataflow) cells read.  Exhaustive searches evaluate
    #: every cell of every candidate; guided searches stop at the budget.
    evals: int = 0
    #: the evaluation count at which the returned optimum was first found
    found_at_eval: int = 0

    @property
    def per_layer_latency(self) -> tuple[float, ...]:
        return tuple(c.latency_s for c in self.choices)


def build_cost_table(
    layer_paths: Sequence[Sequence[CandidatePath]],
    hw: HardwareConfig,
    partitionings: Sequence[Partitioning],
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
    simulate_fn: Callable[[CandidatePath, Partitioning, Dataflow, HardwareConfig], float] = simulate,
    engine: str = "auto",
) -> dict[tuple[int, int, Partitioning, Dataflow], float]:
    """T[l, p, c, d] <- Simulate(p, c, d) for all valid configs (Alg. 1, l.2).

    ``engine="vectorized"`` uses the batched NumPy engine
    (``repro_torch.core.cost_table``), bit-identical to the scalar loop;
    ``"scalar"`` forces the per-cell oracle; ``"auto"`` picks the
    vectorized engine whenever the default ``simulate`` oracle is in use
    (a custom ``simulate_fn`` must go through the scalar loop).
    """
    if engine not in ("auto", "scalar", "vectorized"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "vectorized" and simulate_fn is not simulate:
        raise ValueError(
            "engine='vectorized' evaluates the built-in closed-form model; "
            "a custom simulate_fn requires engine='scalar'"
        )
    if engine == "vectorized" or (engine == "auto" and simulate_fn is simulate):
        from .cost_table import build_cost_table_vectorized

        return build_cost_table_vectorized(layer_paths, hw, partitionings, dataflows)
    table: dict[tuple[int, int, Partitioning, Dataflow], float] = {}
    for l, paths in enumerate(layer_paths):
        for p_idx, path in enumerate(paths):
            for c in partitionings:
                for d in dataflows:
                    table[(l, p_idx, c, d)] = simulate_fn(path, c, d, hw)
    return table


def replay_paths(
    layer_paths: Sequence[Sequence[CandidatePath]],
    networks: Sequence[TensorNetwork],
) -> list[tuple[CandidatePath, ...]]:
    """Re-cost each layer's candidate paths against new tensor networks.

    The serving throughput objective evaluates one contraction order at
    two activation shapes (prefill tokens vs per-step decode tokens).
    A candidate's *steps* are shape-independent; this replays them on
    ``networks`` (one per layer, same order as ``layer_paths``) so the
    same ``(layer, path_index)`` keys index both phase cost tables.
    """
    if len(layer_paths) != len(networks):
        raise ValueError(
            f"{len(layer_paths)} layers of candidate paths but "
            f"{len(networks)} replacement networks")
    out: list[tuple[CandidatePath, ...]] = []
    for paths, tn in zip(layer_paths, networks):
        replayed = []
        for p in paths:
            gemms = tuple(tn.gemm_sequence(p.steps))
            replayed.append(CandidatePath(
                steps=p.steps, macs=sum(g.macs for g in gemms), gemms=gemms))
        out.append(tuple(replayed))
    return out


def combine_phase_tables(
    prefill_table: Mapping[tuple[int, int, Partitioning, Dataflow], float],
    decode_table: Mapping[tuple[int, int, Partitioning, Dataflow], float],
    *,
    w_prefill: float = 1.0,
    w_decode: float = 1.0,
    calibration=None,
    prefill_paths: Sequence[Sequence[CandidatePath]] | None = None,
    decode_paths: Sequence[Sequence[CandidatePath]] | None = None,
) -> dict[tuple[int, int, Partitioning, Dataflow], float]:
    """Decode-weighted combined serving cost: ``w_p*T_pre + w_d*T_dec``.

    Both tables must index the identical (layer, path, partitioning,
    dataflow) key set — build the decode table over
    :func:`replay_paths`-ed candidates so path indices line up.  The
    serving weight is typically ``w_decode = gen_tokens / n_slots``: one
    admission's prefill amortized against its share of fixed-width
    decode steps.

    ``calibration`` applies the autotuner's measured correction
    (:func:`apply_calibration`) to *each phase table separately, at that
    phase's own GEMM shapes*, before combining: a shape-aware
    ``CostCorrection`` resolves the prefill cells against
    ``prefill_paths`` and the decode cells against ``decode_paths``
    (decode GEMMs are much skinnier, so one shared scale would mislead
    exactly where the phases disagree).  The calibrated combined table
    should then feed ``global_search(..., calibration=None)`` — the
    correction is already inside.
    """
    if prefill_table.keys() != decode_table.keys():
        raise ValueError(
            "phase tables index different (layer, path, partitioning, "
            "dataflow) keys; build the decode table over "
            "replay_paths(layer_paths, decode_networks)")
    if calibration is not None:
        prefill_table = apply_calibration(prefill_table, calibration,
                                          layer_paths=prefill_paths)
        decode_table = apply_calibration(decode_table, calibration,
                                         layer_paths=decode_paths)
    return {
        k: w_prefill * prefill_table[k] + w_decode * decode_table[k]
        for k in prefill_table
    }


def _hierarchical_argmin(
    layer_paths: Sequence[Sequence[CandidatePath]],
    table: Mapping[tuple[int, int, Partitioning, Dataflow], float],
    strategy_space: Mapping[str, Sequence[Partitioning]],
    dataflows: Sequence[Dataflow],
    train=None,
) -> tuple[str, tuple[LayerChoice, ...], float]:
    """Strategy loop + independent per-layer argmins over a built table."""
    best_cost = float("inf")
    best: tuple[str, tuple[LayerChoice, ...]] | None = None
    for h, c_h in strategy_space.items():
        choices: list[LayerChoice] = []
        cost_h = 0.0
        for l, paths in enumerate(layer_paths):
            lat, arg = min(
                ((table[(l, p, c, d)], (p, c, d))
                 for p in range(len(paths))
                 for c in c_h
                 for d in dataflows),
                key=lambda t: t[0],
            )
            p, c, d = arg
            if train is not None:
                w = train.weights
                choices.append(LayerChoice(
                    l, p, paths[p], c, d, lat,
                    backward=train.bwd_choices[(l, c, d)],
                    fwd_latency_s=w.fwd * train.fwd.seconds[(l, p, c, d)],
                    bwd_latency_s=w.bwd * train.bwd_seconds[(l, c, d)],
                    update_latency_s=w.update * train.update_seconds[l],
                ))
            else:
                choices.append(LayerChoice(l, p, paths[p], c, d, lat))
            cost_h += lat
        if cost_h < best_cost:
            best_cost = cost_h
            best = (h, tuple(choices))
    assert best is not None
    return best[0], best[1], best_cost


def _global_search_hw(
    layer_paths: Sequence[Sequence[CandidatePath]],
    hw_space: Sequence[HardwareConfig],
    strategy_space: Mapping[str, Sequence[Partitioning]],
    dataflows: Sequence[Dataflow],
    objective: str,
    layer_backwards: Sequence | None,
    train_weights,
    hw_tables,
    hw_train_tables,
    calibration: Mapping | None = None,
) -> DSEResult:
    """Outer architecture loop: per-candidate argmin, best candidate wins.

    Ties resolve to the earliest candidate — architecture spaces list the
    base target first, so equality means "the default was already
    optimal".
    """
    hw_space = tuple(hw_space)
    if not hw_space:
        raise ValueError("hw_space must contain at least one candidate")
    all_parts = sorted({c for cs in strategy_space.values() for c in cs})
    trains = None
    if objective == "train-latency":
        if hw_train_tables is not None:
            trains = tuple(hw_train_tables)
        else:
            if layer_backwards is None:
                raise ValueError(
                    "objective='train-latency' requires layer_backwards "
                    "(see repro_torch.core.backward.memoised_layer_backwards) "
                    "or pre-built hw_train_tables")
            from .cost_table import build_train_cost_tables_hw

            trains = build_train_cost_tables_hw(
                layer_paths, layer_backwards, hw_space, all_parts,
                dataflows, weights=train_weights)
        if len(trains) != len(hw_space):
            raise ValueError(
                f"{len(trains)} train tables vs {len(hw_space)} candidates")
        tables = [t.train_seconds() for t in trains]
    elif hw_tables is not None:
        tables = list(hw_tables)
        if len(tables) != len(hw_space):
            raise ValueError(
                f"{len(tables)} hw_tables vs {len(hw_space)} candidates")
    else:
        from .cost_table import build_cost_tables_hw

        tables = [t.seconds for t in
                  build_cost_tables_hw(layer_paths, hw_space, all_parts,
                                       dataflows)]
    if calibration is not None:
        # measured rescale per candidate (ROADMAP gap c, closed): the
        # measured/analytic disagreement is a property of the cost model
        # vs the machine, so the same per-(shape-bucket, dataflow) scales
        # apply to every candidate's analytic table
        tables = [apply_calibration(t, calibration, dataflows,
                                    layer_paths=layer_paths)
                  for t in tables]

    candidates: list[HwCandidateResult] = []
    best_cost = float("inf")
    best: tuple[int, str, tuple[LayerChoice, ...]] | None = None
    for i, hw_i in enumerate(hw_space):
        strategy, choices, cost = _hierarchical_argmin(
            layer_paths, tables[i], strategy_space, dataflows,
            trains[i] if trains is not None else None)
        candidates.append(HwCandidateResult(hw_i, strategy, cost))
        if cost < best_cost:
            best_cost = cost
            best = (i, strategy, choices)
    assert best is not None
    i, strategy, choices = best
    n_evals = sum(len(t) for t in tables)
    return DSEResult(strategy, choices, best_cost, tables[i], objective,
                     hw=hw_space[i], hw_candidates=tuple(candidates),
                     search="exhaustive", evals=n_evals,
                     found_at_eval=n_evals)


def _normalize_calibration(
    calibration: Mapping, dataflows: Sequence[Dataflow]
) -> dict[Dataflow, float]:
    """Key a measured-latency calibration table by :class:`Dataflow`."""
    out: dict[Dataflow, float] = {}
    for k, v in calibration.items():
        d = k if isinstance(k, Dataflow) else Dataflow(str(k))
        s = float(v)
        if not s > 0:
            raise ValueError(
                f"calibration scale for {d.value} must be positive, got {v!r}")
        out[d] = s
    unknown = set(out) - set(dataflows)
    if unknown:
        raise ValueError(
            f"calibration names dataflows outside the search space: "
            f"{sorted(d.value for d in unknown)}")
    return out


def apply_calibration(
    table: Mapping[tuple[int, int, Partitioning, Dataflow], float],
    calibration,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
    *,
    layer_paths: Sequence[Sequence[CandidatePath]] | None = None,
) -> dict[tuple[int, int, Partitioning, Dataflow], float]:
    """Rescale a cost table by measured/analytic factors.

    ``calibration`` is either

    - a mapping from dataflow (``Dataflow`` or its string value) to a
      positive scale — ``repro_torch.tune.measured_calibration``'s geometric-
      mean measured/analytic ratio per dataflow (the flat model), or
    - a shape-aware correction model (``repro_torch.tune.CostCorrection`` —
      anything exposing ``scale(M, K, N, dataflow)``), fit from the
      persistent tuning cache per (GEMM-shape bucket, dataflow).  This
      form needs ``layer_paths`` to resolve each table cell's dominant
      GEMM shape.

    A uniform table cannot move any argmin; *relative* disagreement
    between the analytic model and the machine can, which is exactly the
    signal wall-clock measurements carry.
    """
    if not isinstance(calibration, Mapping) and hasattr(calibration, "scale"):
        if layer_paths is None:
            raise ValueError(
                "a shape-aware correction model rescales per dominant GEMM "
                "shape; pass layer_paths so each (layer, path) cell can be "
                "resolved to its shape bucket")
        dom: dict[tuple[int, int], tuple[int, int, int]] = {}
        for l, paths in enumerate(layer_paths):
            for p, path in enumerate(paths):
                g = max(path.gemms, key=lambda g: g.macs)
                dom[(l, p)] = (int(g.M), int(g.K), int(g.N))
        scales: dict[tuple[tuple[int, int, int], Dataflow], float] = {}
        out = {}
        for k, v in table.items():
            shape = dom[k[:2]]
            s = scales.get((shape, k[3]))
            if s is None:
                s = float(calibration.scale(*shape, k[3]))
                if not s > 0:
                    raise ValueError(
                        f"correction scale for shape {shape} / {k[3].value} "
                        f"must be positive, got {s!r}")
                scales[(shape, k[3])] = s
            out[k] = v * s
        return out
    cal = _normalize_calibration(calibration, dataflows)
    return {k: v * cal.get(k[3], 1.0) for k, v in table.items()}


def global_search(
    layer_paths: Sequence[Sequence[CandidatePath]],
    hw: HardwareConfig = FPGA_VU9P,
    strategy_space: Mapping[str, Sequence[Partitioning]] = STRATEGY_SPACE,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
    simulate_fn: Callable[[CandidatePath, Partitioning, Dataflow, HardwareConfig], float] = simulate,
    engine: str = "auto",
    table: Mapping[tuple[int, int, Partitioning, Dataflow], float] | None = None,
    *,
    objective: str = "latency",
    layer_backwards: Sequence | None = None,
    train_weights=None,
    train_tables=None,
    hw_space: Sequence[HardwareConfig] | None = None,
    hw_tables: Sequence[Mapping] | None = None,
    hw_train_tables: Sequence | None = None,
    calibration: Mapping | None = None,
) -> DSEResult:
    """Algorithm 1: global strategy loop + independent per-layer argmins.

    ``table`` may supply a pre-built cost table (any per-config objective,
    e.g. the EDP table from ``cost_table.CostTables.edp``); by default the
    latency table is built with the selected ``engine``.

    ``calibration`` rescales the (built or supplied) cost table by
    measured/analytic factors (:func:`apply_calibration`) before the
    argmin — the measured-latency feedback loop of ``repro_torch.tune``: when
    wall-clock measurements rank dataflows (or shape buckets, for a
    ``CostCorrection`` model) differently than the analytic model, the
    argmin genuinely moves.  Composes with fixed-target *and*
    architecture co-searches (each candidate's table is rescaled before
    its argmin); the training decomposition is still analytic-only (open
    item in ROADMAP.md).

    ``objective="train-latency"`` jointly optimizes the forward *and*
    backward passes: per cell, the cost is ``w_f * fwd + w_b * bwd +
    w_u * update`` where the backward term takes, for each gradient's
    contraction network, its best candidate path under the layer's
    (partitioning, dataflow).  ``layer_backwards`` (one
    ``backward.LayerBackward`` per layer — see
    ``backward.memoised_layer_backwards``) is required; the returned
    choices carry the per-gradient backward paths and the
    fwd/bwd/update latency decomposition.

    ``hw_space`` turns on the joint architecture co-search: the fixed
    ``hw`` target is ignored, every candidate is evaluated through the
    hw-batched cost-table engine (``hw_tables`` / ``hw_train_tables``
    may supply pre-built per-candidate tables, aligned with the space),
    and the result records the winning architecture (``result.hw``) plus
    every candidate's outcome (``result.hw_candidates``).
    """
    if objective not in ("latency", "train-latency", "throughput"):
        raise ValueError(
            f"unknown objective {objective!r}; have "
            "('latency', 'train-latency', 'throughput')"
            " — EDP goes through the ``table`` argument")
    if objective == "throughput":
        if hw_space is not None:
            raise ValueError(
                "objective='throughput' selects over a pre-combined phase "
                "table; the architecture co-search rebuilds tables per "
                "candidate and cannot consume one (open item, ROADMAP.md)")
        if table is None:
            raise ValueError(
                "objective='throughput' requires a pre-built combined "
                "phase table — combine_phase_tables(prefill, decode, "
                "w_decode=gen/slots) over replay_paths-aligned candidates "
                "(repro_torch.dse --objective throughput builds it)")
    if calibration is not None and objective == "train-latency":
        raise ValueError(
            "calibration rescales the inference table; the training "
            "decomposition is analytic-only for now (ROADMAP.md)")
    if hw_space is not None:
        if table is not None or train_tables is not None:
            raise ValueError(
                "hw_space builds one table per candidate; pass per-candidate "
                "tables via hw_tables / hw_train_tables instead of "
                "table / train_tables")
        if simulate_fn is not simulate or engine == "scalar":
            raise ValueError(
                "hw_space is evaluated through the batched closed-form "
                "engine; custom simulate_fn / engine='scalar' are not "
                "supported")
        if train_weights is not None and hw_train_tables is not None:
            raise ValueError(
                "train_weights must be baked into hw_train_tables at build "
                "time; passing both is ambiguous")
        if objective == "train-latency" and hw_tables is not None:
            raise ValueError(
                "objective='train-latency' consumes hw_train_tables; "
                "hw_tables would be silently ignored")
        if objective != "train-latency" and hw_train_tables is not None:
            raise ValueError(
                "hw_train_tables requires objective='train-latency'; "
                "it would be silently ignored")
        return _global_search_hw(
            layer_paths, hw_space, strategy_space, dataflows, objective,
            layer_backwards, train_weights, hw_tables, hw_train_tables,
            calibration)
    if hw_tables is not None or hw_train_tables is not None:
        raise ValueError("hw_tables / hw_train_tables require hw_space")

    all_parts = sorted({c for cs in strategy_space.values() for c in cs})
    train = None
    if objective == "train-latency":
        if table is not None:
            raise ValueError(
                "objective='train-latency' builds its own combined table; "
                "a pre-built ``table`` cannot be decomposed "
                "(pass ``train_tables`` instead)")
        if train_tables is not None:
            if train_weights is not None:
                raise ValueError(
                    "train_weights must be baked into train_tables at build "
                    "time (build_train_cost_tables(weights=...)); passing "
                    "both is ambiguous")
            train = train_tables
        else:
            if layer_backwards is None:
                raise ValueError(
                    "objective='train-latency' requires layer_backwards "
                    "(see repro_torch.core.backward.memoised_layer_backwards) "
                    "or a pre-built train_tables")
            from .cost_table import build_train_cost_tables

            train = build_train_cost_tables(
                layer_paths, layer_backwards, hw, all_parts, dataflows,
                weights=train_weights)
        table = train.train_seconds()
    elif table is None:
        table = build_cost_table(
            layer_paths, hw, all_parts, dataflows, simulate_fn, engine
        )
    if calibration is not None:
        table = apply_calibration(table, calibration, dataflows,
                                  layer_paths=layer_paths)

    strategy, choices, best_cost = _hierarchical_argmin(
        layer_paths, table, strategy_space, dataflows, train)
    return DSEResult(strategy, choices, best_cost, table, objective, hw=hw,
                     search="exhaustive", evals=len(table),
                     found_at_eval=len(table))


def brute_force_search(
    layer_paths: Sequence[Sequence[CandidatePath]],
    hw: HardwareConfig = FPGA_VU9P,
    strategy_space: Mapping[str, Sequence[Partitioning]] = STRATEGY_SPACE,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
    simulate_fn: Callable[[CandidatePath, Partitioning, Dataflow, HardwareConfig], float] = simulate,
) -> float:
    """Exhaustive cross-product search — test oracle for ``global_search``.

    Exponential in L; only usable for tiny models in tests.
    """
    best = float("inf")
    for h, c_h in strategy_space.items():
        per_layer_opts = []
        for paths in layer_paths:
            per_layer_opts.append([
                (p, c, d)
                for p in range(len(paths))
                for c in c_h
                for d in dataflows
            ])
        for combo in itertools.product(*per_layer_opts):
            cost = sum(
                simulate_fn(layer_paths[l][p], c, d, hw)
                for l, (p, c, d) in enumerate(combo)
            )
            best = min(best, cost)
    return best


def explore_model(
    networks: Sequence[TensorNetwork],
    hw: HardwareConfig = FPGA_VU9P,
    top_k: int = 4,
    strategy_space: Mapping[str, Sequence[Partitioning]] = STRATEGY_SPACE,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
    engine: str = "auto",
    objective: str = "latency",
    hw_space: Sequence[HardwareConfig] | None = None,
) -> DSEResult:
    """End-to-end DSE for a model given per-layer tensor networks."""
    layer_paths = [find_topk_paths(tn, k=top_k) for tn in networks]
    layer_backwards = None
    if objective == "train-latency":
        from .backward import memoised_layer_backwards

        layer_backwards = memoised_layer_backwards(networks, k=top_k)
    return global_search(layer_paths, hw, strategy_space, dataflows,
                         engine=engine, objective=objective,
                         layer_backwards=layer_backwards, hw_space=hw_space)


def pareto_front(points: Sequence[tuple[float, float]]) -> list[int]:
    """Indices of the Pareto-optimal (cost1, cost2) points (both minimised)."""
    order = sorted(range(len(points)), key=lambda i: (points[i][0], points[i][1]))
    front: list[int] = []
    best_y = float("inf")
    for i in order:
        if points[i][1] < best_y:
            front.append(i)
            best_y = points[i][1]
    return front
