"""Accuracy-aware rank search: the TT decomposition as a searched axis.

Framework-neutral copy of ``src/repro/rank/__init__.py`` (the port
never imports the JAX package).

The DSE's first three axes — contraction path, partitioning, dataflow —
all map a *fixed* decomposition onto hardware.  This subsystem makes
the decomposition itself (modes per side x TT rank, per projection
family) the fourth axis:

- :mod:`repro_torch.rank.space` enumerates candidate factorizations around
  the frozen ``TTConfig`` under a parameter budget;
- :mod:`repro_torch.rank.proxy` scores each candidate's accuracy by TT-SVD
  reconstruction error against deterministic reference weights
  (optionally activation-RMS weighted);
- :mod:`repro_torch.rank.search` evaluates every candidate through the
  existing cost-table/argmin stack and reports the (latency, accuracy)
  Pareto frontier plus a budget-constrained chosen candidate.

Driven by ``python -m repro_torch.dse --rank-search budget
[--accuracy-budget EPS]``; the chosen factorizations ride in the v4
plan schema down to the executor (``repro_torch.plan`` / ``launch/serve.py``).
"""

from .space import (
    DEFAULT_PARAM_BUDGET_RATIO,
    MODES_PER_SIDE,
    RANK_LADDER_FACTORS,
    FamilyFactorization,
    RankCandidate,
    RankSpace,
    clip_ranks,
    vision_rank_space,
)
from .proxy import (
    NOISE_FLOOR,
    REFERENCE_COMPONENTS,
    SPECTRUM_DECAY,
    activation_calibration,
    candidate_proxy,
    family_proxy,
    reconstruction_proxy,
    reference_weight,
)
from .search import (
    PROXY_EPS,
    RANK_SEARCH_MODES,
    CandidateEval,
    RankSearchResult,
    rank_search,
)

__all__ = [
    "DEFAULT_PARAM_BUDGET_RATIO", "MODES_PER_SIDE", "RANK_LADDER_FACTORS",
    "FamilyFactorization", "RankCandidate", "RankSpace", "clip_ranks",
    "vision_rank_space",
    "NOISE_FLOOR", "REFERENCE_COMPONENTS", "SPECTRUM_DECAY",
    "activation_calibration", "candidate_proxy", "family_proxy",
    "reconstruction_proxy", "reference_weight",
    "PROXY_EPS", "RANK_SEARCH_MODES", "CandidateEval", "RankSearchResult",
    "rank_search",
]
