"""Budgeted guided search over the joint (arch, path, dataflow) space.

Framework-neutral copy of ``src/repro/search/guided.py`` (the port
never imports the JAX package).

The exhaustive co-search (``core/dse.global_search(hw_space=...)``)
reads every cell of every candidate's cost table — optimal, and the
permanent test oracle, but its evaluation count multiplies with each new
axis.  This driver spends a *fixed evaluation budget* instead:

- **Evaluation unit**: one unique ``(arch, layer, path, partitioning,
  dataflow)`` cell read.  The exhaustive search reads
  ``len(space) * table_cells(...)`` of them; the guided search stops at
  ``budget``.  Cells are charged once — re-reading is free — so a
  generous budget costs *at most* the exhaustive count.
- **Exact per-architecture refinement**: an architecture is "refined" by
  running the very same hierarchical argmin the exhaustive search runs,
  over the same lazily built vectorized table (charging all its cells).
  The returned optimum only ever comes from refined architectures, so
  every guided result is the *exact* optimum of the architectures it
  visited — and with budget for all of them, exactly the exhaustive
  result, tie-breaks included (the differential-oracle property
  ``tests/test_search_oracle.py`` asserts).
- **Genome-guided ordering**: which architecture to refine next is
  steered by an evolutionary population of :class:`~.encoding.Genome`
  proposals, scored by cheap table reads (one cell per layer); winners'
  choices migrate to unrefined neighboring architectures via
  mutation/crossover.  The base target refines first, so the guided
  search inherits the "never worse than the fixed target" guarantee
  after its very first refinement.
- **Budget-independent evaluation stream**: the operation sequence is a
  pure function of the seed — the budget only cuts it off (an operation
  that would exceed it raises and the partial work is discarded).  A
  larger budget therefore replays the same prefix and can only improve
  the result: budget-monotonicity holds by construction, and the same
  seed yields a bit-identical ``DSEResult``.
"""

from __future__ import annotations

import random
from typing import Mapping, Optional, Sequence

from repro_torch.core.dse import (
    DSEResult,
    HwCandidateResult,
    _hierarchical_argmin,
    apply_calibration,
)
from repro_torch.core.paths import CandidatePath
from repro_torch.core.simulator import (
    ALL_DATAFLOWS,
    STRATEGY_SPACE,
    Dataflow,
    HardwareConfig,
    Partitioning,
)

from .encoding import Genome, JointSpace

#: evolutionary population size (proposal pool per refinement round)
POPULATION = 16

#: default budget fraction of the exhaustive count for co-searches —
#: matches the acceptance bar "within 2% of exhaustive best latency at
#: <= 25% of the exhaustive evaluation count"
DEFAULT_BUDGET_FRACTION = 0.25


class BudgetExhausted(Exception):
    """Raised inside the driver when an operation would exceed the budget."""


class _TableStore:
    """Lazily built per-architecture cost tables + unique-cell accounting.

    ``read``/``charge_all`` charge each table cell at most once against
    the budget; an operation that would cross it raises
    :class:`BudgetExhausted` *before* charging, so ``spent <= budget``
    is an invariant and partially charged operations cannot exist.
    """

    def __init__(
        self,
        layer_paths: Sequence[Sequence[CandidatePath]],
        hw_space: Sequence[HardwareConfig],
        all_parts: Sequence[Partitioning],
        dataflows: Sequence[Dataflow],
        objective: str,
        layer_backwards,
        train_weights,
        calibration,
        budget: int,
    ) -> None:
        self.layer_paths = layer_paths
        self.hw_space = tuple(hw_space)
        self.all_parts = tuple(all_parts)
        self.dataflows = tuple(dataflows)
        self.objective = objective
        self.layer_backwards = layer_backwards
        self.train_weights = train_weights
        self.calibration = calibration
        self.budget = budget
        self.spent = 0
        self._tables: dict[int, Mapping] = {}
        self._trains: dict[int, object] = {}
        self._charged: dict[int, set] = {}

    def table(self, a: int) -> Mapping:
        t = self._tables.get(a)
        if t is None:
            hw = self.hw_space[a]
            if self.objective == "train-latency":
                from repro_torch.core.cost_table import build_train_cost_tables_hw

                train = build_train_cost_tables_hw(
                    self.layer_paths, self.layer_backwards, (hw,),
                    self.all_parts, self.dataflows,
                    weights=self.train_weights)[0]
                self._trains[a] = train
                t = train.train_seconds()
            else:
                from repro_torch.core.cost_table import build_cost_tables_hw

                t = build_cost_tables_hw(
                    self.layer_paths, (hw,), self.all_parts,
                    self.dataflows)[0].seconds
            if self.calibration is not None:
                t = apply_calibration(t, self.calibration, self.dataflows,
                                      layer_paths=self.layer_paths)
            self._tables[a] = t
        return t

    def train(self, a: int):
        return self._trains.get(a)

    def _charge(self, a: int, keys) -> None:
        charged = self._charged.setdefault(a, set())
        fresh = [k for k in keys if k not in charged]
        if self.spent + len(fresh) > self.budget:
            raise BudgetExhausted
        charged.update(fresh)
        self.spent += len(fresh)

    def read(self, a: int, keys) -> float:
        """Charge + sum the given cells of architecture ``a``'s table."""
        t = self.table(a)
        self._charge(a, keys)
        return sum(t[k] for k in keys)

    def charge_all(self, a: int) -> Mapping:
        """Charge every cell of architecture ``a`` (exact refinement)."""
        t = self.table(a)
        self._charge(a, t.keys())
        return t


def guided_search(
    layer_paths: Sequence[Sequence[CandidatePath]],
    hw: HardwareConfig,
    strategy_space: Mapping[str, Sequence[Partitioning]] = STRATEGY_SPACE,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
    *,
    objective: str = "latency",
    hw_space: Sequence[HardwareConfig] | None = None,
    budget: Optional[int] = None,
    seed: int = 0,
    layer_backwards: Sequence | None = None,
    train_weights=None,
    calibration=None,
    population: int = POPULATION,
) -> DSEResult:
    """Budgeted guided joint search; same contract as ``global_search``.

    Accepts the ``global_search`` argument surface for the ``latency``
    and ``train-latency`` objectives (EDP/throughput consume pre-built
    tables the driver cannot rebuild per architecture — keep those on
    the exhaustive path).  Without ``hw_space`` the single fixed target
    is refined exactly (the guided search degenerates to Algorithm 1 —
    same result, ``search="guided"`` provenance).  ``budget`` defaults
    to the full table for fixed targets and to
    ``DEFAULT_BUDGET_FRACTION`` of the exhaustive count for co-searches.
    """
    if objective not in ("latency", "train-latency"):
        raise ValueError(
            f"guided search supports objectives ('latency', "
            f"'train-latency'); got {objective!r} — EDP and throughput "
            "tables are pre-built and stay on the exhaustive path")
    if objective == "train-latency":
        if layer_backwards is None:
            raise ValueError(
                "objective='train-latency' requires layer_backwards "
                "(see repro_torch.core.backward.memoised_layer_backwards)")
        if calibration is not None:
            raise ValueError(
                "calibration rescales the inference table; the training "
                "decomposition is analytic-only for now (ROADMAP.md)")

    archs = tuple(hw_space) if hw_space is not None else (hw,)
    if not archs:
        raise ValueError("hw_space must contain at least one candidate")
    all_parts = sorted({c for cs in strategy_space.values() for c in cs})
    from repro_torch.core.cost_table import table_cells

    n_cells = table_cells(layer_paths, all_parts, dataflows)
    exhaustive_evals = len(archs) * n_cells
    if budget is None:
        budget = (n_cells if hw_space is None else
                  max(n_cells,
                      int(exhaustive_evals * DEFAULT_BUDGET_FRACTION)))
    if budget < n_cells:
        raise ValueError(
            f"budget {budget} cannot refine even one architecture "
            f"(one table holds {n_cells} cells)")

    store = _TableStore(layer_paths, archs, all_parts, dataflows, objective,
                        layer_backwards, train_weights, calibration, budget)
    rng = random.Random(seed)
    space = JointSpace(layer_paths, archs, strategy_space, dataflows)

    refined: dict[int, tuple[str, tuple, float]] = {}
    best: tuple[float, int] | None = None       # (cost, arch) — tie to base
    found_at = 0

    def refine(a: int) -> None:
        nonlocal best, found_at
        table = store.charge_all(a)
        strategy, choices, cost = _hierarchical_argmin(
            layer_paths, table, strategy_space, dataflows, store.train(a))
        refined[a] = (strategy, choices, cost)
        if best is None or (cost, a) < best:
            best = (cost, a)
            found_at = store.spent

    try:
        # the base target (candidate 0) always refines first: one table
        # in, the guided result already can't lose to the fixed target
        refine(0)
        if len(archs) > 1:
            base_genome = space.encode_choices(0, refined[0][0],
                                               refined[0][1])
            # probe sweep: the base optimum's genome costs one cell per
            # layer on each candidate — a cheap global proxy ranking
            # (the per-arch cost surfaces share shape, so a config that
            # is fast on the base tends to rank its neighbors honestly)
            proxy: dict[int, float] = {}
            for a in range(len(archs)):
                proxy[a] = store.read(a, base_genome.keys())
            pop = [base_genome]
            while len(pop) < population:
                pop.append(space.random_genome(rng))
            while len(refined) < len(archs):
                scored = [(store.read(g.arch, g.keys()), i, g)
                          for i, g in enumerate(pop)]
                scored.sort(key=lambda t: (t[0], t[1]))
                for s, _, g in scored:
                    if s < proxy.get(g.arch, float("inf")):
                        proxy[g.arch] = s
                # next refinement: the unrefined arch with the best
                # proxy seen so far (probe or population proposal)
                nxt = min((a for a in range(len(archs))
                           if a not in refined),
                          key=lambda a: (proxy.get(a, float("inf")), a))
                refine(nxt)
                # evolve: elites survive, offspring = crossover+mutate,
                # plus one migrant — the freshly refined optimum pushed
                # toward an unrefined neighbor
                elites = [g for _, _, g in scored[:max(2, population // 2)]]
                nxt_s, nxt_c, _ = refined[nxt]
                migrant = space.mutate(
                    space.encode_choices(nxt, nxt_s, nxt_c), rng)
                pop = list(elites) + [migrant]
                while len(pop) < population:
                    a_p = elites[rng.randrange(len(elites))]
                    b_p = elites[rng.randrange(len(elites))]
                    pop.append(space.mutate(
                        space.crossover(a_p, b_p, rng), rng))
    except BudgetExhausted:
        pass

    assert best is not None  # budget >= n_cells covers the base refinement
    cost, a = best
    strategy, choices, _ = refined[a]
    return DSEResult(
        strategy, choices, cost, store.table(a), objective, hw=archs[a],
        hw_candidates=(tuple(
            HwCandidateResult(archs[i], s, c)
            for i, (s, _, c) in refined.items())
            if hw_space is not None else ()),
        search="guided", evals=store.spent, found_at_eval=found_at)
