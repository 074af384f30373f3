"""Joint (decomposition, path, partitioning, dataflow) frontier search.

Framework-neutral copy of ``src/repro/rank/search.py`` (the port
never imports the JAX package).

Each rank candidate re-derives the model's per-layer tensor networks
under its factorizations and reuses the *existing* DSE machinery —
top-K path search, batched cost tables, the hierarchical global argmin
(or the guided explorer, or the hw-batched architecture co-search)
— to get its end-to-end latency.  Together with the accuracy proxy
(``repro_torch.rank.proxy``) every candidate becomes a (latency, compression,
accuracy) triple; the result reports the (latency, accuracy) Pareto
frontier and a chosen candidate:

- no ``accuracy_budget``: the lowest-latency candidate whose proxy is
  no worse than the frozen decomposition's — "free" speedups only;
- with ``accuracy_budget=EPS``: the lowest-latency candidate with proxy
  <= EPS (ValueError if none qualifies — the budget is infeasible).

``python -m repro_torch.dse --rank-search budget`` drives this and embeds the
chosen factorizations in the emitted v4 plan.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

from repro_torch.core import ALL_PARTITIONINGS, build_cost_tables, global_search
from repro_torch.core.dse import pareto_front

from .proxy import candidate_proxy, family_proxy
from .space import RankCandidate, RankSpace, vision_rank_space

RANK_SEARCH_MODES = ("off", "budget")

#: proxy comparisons tolerate float noise up to this slack
PROXY_EPS = 1e-12


@dataclasses.dataclass
class CandidateEval:
    """One evaluated rank candidate."""

    candidate: RankCandidate
    named: list                    # [(instance name, TensorNetwork)]
    res: object                    # repro_torch.core.dse.DSEResult
    total_latency_s: float
    accuracy_proxy: float
    family_proxies: dict[str, float]
    eval_seconds: float


@dataclasses.dataclass
class RankSearchResult:
    """Frontier + chosen candidate of one rank search."""

    arch: str
    tokens: int
    evals: list[CandidateEval]
    frontier: tuple[int, ...]      # indices into evals, latency-sorted
    chosen: int
    frozen: int
    accuracy_budget: Optional[float]
    param_budget_ratio: float

    @property
    def chosen_eval(self) -> CandidateEval:
        return self.evals[self.chosen]

    @property
    def frozen_eval(self) -> CandidateEval:
        return self.evals[self.frozen]

    @property
    def dominates_frozen(self) -> bool:
        """True when some non-frozen candidate is strictly faster at
        equal-or-better accuracy proxy than the frozen decomposition."""
        fz = self.frozen_eval
        return any(
            e.total_latency_s < fz.total_latency_s
            and e.accuracy_proxy <= fz.accuracy_proxy + PROXY_EPS
            for i, e in enumerate(self.evals) if i != self.frozen
        )

    @property
    def improvement_pct(self) -> Optional[float]:
        fz = self.frozen_eval
        if fz.total_latency_s <= 0:
            return None
        return 100.0 * (1.0 - self.chosen_eval.total_latency_s
                        / fz.total_latency_s)


def _evaluate(
    named: list,
    hw_cfg,
    *,
    top_k: int,
    hw_space=None,
    search: str = "exhaustive",
    search_budget: Optional[int] = None,
    search_seed: int = 0,
):
    """One candidate through the existing DSE stack; returns DSEResult."""
    from repro_torch.dse_cli import model_layer_paths

    layer_paths = model_layer_paths(named, top_k)
    if search == "guided":
        from repro_torch.search import guided_search

        return guided_search(
            layer_paths, hw_cfg, objective="latency",
            hw_space=hw_space, budget=search_budget, seed=search_seed)
    if hw_space is not None:
        from repro_torch.core import build_cost_tables_hw

        per_hw = build_cost_tables_hw(layer_paths, hw_space,
                                      ALL_PARTITIONINGS)
        return global_search(layer_paths, hw_space=hw_space,
                             hw_tables=[t.seconds for t in per_hw])
    tables = build_cost_tables(layer_paths, hw_cfg, ALL_PARTITIONINGS)
    return global_search(layer_paths, hw_cfg, table=tables.seconds)


def _candidate_layers(arch, cfg, cand: RankCandidate, tokens: int) -> list:
    """Per-layer problems for one candidate.

    Config archs rebuild every tensorized projection under the
    candidate's explicit factorizations; vision archs rebuild through
    ``model_layers(rank=...)`` (their mode splits are structural).
    """
    from repro_torch.dse_cli import VISION_ARCHS, model_dse_layers

    if arch in VISION_ARCHS:
        from repro_torch.models.vision import model_layers

        model, dataset = arch.split("/")
        return [(l.name, l.tt_network)
                for l in model_layers(model, dataset, batch=max(1, tokens),
                                      rank=cand.rank)]
    return model_dse_layers(cfg, tokens,
                            factorizations=cand.factorization_map())


def rank_search(
    arch: str,
    hw_cfg,
    *,
    top_k: int = 4,
    tokens: Optional[int] = None,
    smoke: bool = False,
    hw_space=None,
    search: str = "exhaustive",
    search_budget: Optional[int] = None,
    search_seed: int = 0,
    accuracy_budget: Optional[float] = None,
    param_budget_ratio: Optional[float] = None,
    calibration_weights=None,
    space: Optional[RankSpace] = None,
) -> RankSearchResult:
    """Search the decomposition axis jointly with the mapping axes.

    ``hw_space`` (a sequence of HardwareConfig candidates) composes the
    rank search with the architecture co-search — each rank candidate
    picks its own best architecture; ``search="guided"`` routes each
    candidate through the budgeted explorer.  ``space`` overrides the
    default candidate grid (tests shrink it); ``calibration_weights``
    (from :func:`repro_torch.rank.proxy.activation_calibration`) reweights
    the accuracy proxy by measured activation RMS.
    """
    from repro_torch.configs import get_config
    from repro_torch.dse_cli import VISION_ARCHS

    if accuracy_budget is not None and accuracy_budget <= 0:
        raise ValueError("accuracy_budget must be positive "
                         "(a relative Frobenius error)")
    kw = {}
    if param_budget_ratio is not None:
        kw["param_budget_ratio"] = param_budget_ratio
    if arch in VISION_ARCHS:
        cfg = None
        tokens = 1 if tokens is None else tokens
        if space is None:
            space = vision_rank_space(arch, **kw)
    else:
        cfg = get_config(arch, smoke=smoke)
        tokens = 1024 if tokens is None else tokens
        if space is None:
            space = RankSpace.from_config(cfg, **kw)

    evals: list[CandidateEval] = []
    for cand in space.candidates():
        t0 = time.perf_counter()
        named = _candidate_layers(arch, cfg, cand, tokens)
        res = _evaluate(named, hw_cfg, top_k=top_k, hw_space=hw_space,
                        search=search, search_budget=search_budget,
                        search_seed=search_seed)
        evals.append(CandidateEval(
            candidate=cand,
            named=named,
            res=res,
            total_latency_s=res.total_latency_s,
            accuracy_proxy=candidate_proxy(cand, calibration_weights),
            family_proxies={f.name: family_proxy(f)
                            for f in cand.families},
            eval_seconds=time.perf_counter() - t0,
        ))

    frozen = 0  # RankSpace always yields the frozen candidate first
    front = pareto_front([(e.total_latency_s, e.accuracy_proxy)
                          for e in evals])
    cap = (accuracy_budget if accuracy_budget is not None
           else evals[frozen].accuracy_proxy)
    eligible = [i for i, e in enumerate(evals)
                if e.accuracy_proxy <= cap + PROXY_EPS]
    if not eligible:
        best = min(e.accuracy_proxy for e in evals)
        raise ValueError(
            f"--accuracy-budget {accuracy_budget:g} is infeasible: the "
            f"best candidate proxy is {best:.6g}")
    chosen = min(eligible,
                 key=lambda i: (evals[i].total_latency_s,
                                evals[i].candidate.name))
    return RankSearchResult(
        arch=arch,
        tokens=tokens,
        evals=evals,
        frontier=tuple(front),
        chosen=chosen,
        frozen=frozen,
        accuracy_budget=accuracy_budget,
        param_budget_ratio=space.param_budget_ratio,
    )
