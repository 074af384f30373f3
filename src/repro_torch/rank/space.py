"""Candidate grid for the rank search: per-family TT factorizations.

Framework-neutral copy of ``src/repro/rank/space.py`` (the port
never imports the JAX package).

The frozen TTConfig (``d`` modes per side, scalar ``rank``) is one point
in a much larger decomposition space.  :class:`RankSpace` enumerates the
neighbourhood the search explores — a (modes-per-side x rank-ladder)
grid applied uniformly across the model's tensorized projection
families, filtered to a parameter budget relative to the frozen
baseline.  Candidate 0 is always the frozen decomposition itself, so
the searched frontier degrades gracefully to "keep what you had".

Per-family heterogeneous grids would square the space; the paper's DSE
treats the decomposition as a model-level knob, and so do we — each
candidate is one (d, rank) pair instantiated per family through the
same :func:`repro_torch.core.tensor_network.factorize` mode split the frozen
models use, so the frozen candidate's networks are bit-identical to an
unsearched run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.tensor_network import factorize

#: scalar-rank multipliers tried around the frozen rank (dedup'd after
#: rounding and full-rank clipping)
RANK_LADDER_FACTORS = (0.25, 0.5, 0.75, 1.0, 1.5, 2.0)

#: modes-per-side counts tried around the frozen ``TTConfig.d``.
#: d=1 is the degenerate TT — a plain low-rank factorization W ~= A @ B
#: with a single (middle) cut: fewer contraction steps AND no side-cut
#: truncation loss, so it can genuinely dominate deeper TTs at equal
#: rank when the weight spectrum decays fast
MODES_PER_SIDE = (1, 2, 3, 4)

#: default parameter budget: candidates may spend at most this multiple
#: of the frozen decomposition's TT parameters
DEFAULT_PARAM_BUDGET_RATIO = 2.0


def clip_ranks(modes: Sequence[int], rank: int) -> tuple[int, ...]:
    """Interior TT ranks for ``modes``, clipped to the full-rank bound
    at each cut (the same rule as ``LinearSpec.tt_ranks`` / TT-SVD)."""
    ranks = []
    left, right = 1, math.prod(modes)
    for k in range(len(modes) - 1):
        left *= modes[k]
        right //= modes[k]
        ranks.append(min(rank, left, right))
    return tuple(ranks)


@dataclasses.dataclass(frozen=True)
class FamilyFactorization:
    """One projection family under one candidate decomposition."""

    name: str
    d_out: int
    d_in: int
    out_modes: tuple[int, ...]
    in_modes: tuple[int, ...]
    ranks: tuple[int, ...]
    instances: int = 1            # repeated transformer layers / experts
    token_scale: float = 1.0      # MoE capacity fraction (provenance only)

    def __post_init__(self):
        if math.prod(self.out_modes) != self.d_out:
            raise ValueError(
                f"{self.name}: out_modes {self.out_modes} do not factor "
                f"d_out={self.d_out}")
        if math.prod(self.in_modes) != self.d_in:
            raise ValueError(
                f"{self.name}: in_modes {self.in_modes} do not factor "
                f"d_in={self.d_in}")
        want = len(self.out_modes) + len(self.in_modes) - 1
        if len(self.ranks) != want:
            raise ValueError(
                f"{self.name}: need {want} interior ranks, got "
                f"{len(self.ranks)}")

    @property
    def triple(self) -> tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...]]:
        return (self.out_modes, self.in_modes, self.ranks)

    @property
    def n_params(self) -> int:
        """TT core parameters of ONE instance."""
        modes = self.out_modes + self.in_modes
        ranks = (1,) + self.ranks + (1,)
        return sum(ranks[k] * modes[k] * ranks[k + 1]
                   for k in range(len(modes)))

    @property
    def dense_params(self) -> int:
        return self.d_out * self.d_in

    @property
    def compression(self) -> float:
        return self.dense_params / self.n_params


@dataclasses.dataclass(frozen=True)
class RankCandidate:
    """One point of the decomposition axis: a (d, rank) pair expanded
    into per-family factorizations."""

    name: str                     # "frozen" or "d{d}_r{rank}"
    d: int
    rank: int
    families: tuple[FamilyFactorization, ...]

    @property
    def n_params(self) -> int:
        """Model-wide TT parameters (instance-weighted)."""
        return sum(f.n_params * f.instances for f in self.families)

    @property
    def dense_params(self) -> int:
        return sum(f.dense_params * f.instances for f in self.families)

    @property
    def compression(self) -> float:
        return self.dense_params / self.n_params

    def factorization_map(self) -> dict[str, tuple]:
        """name -> (out_modes, in_modes, ranks), the ``model_dse_layers``
        / ``LinearSpec.with_factorization`` override format."""
        return {f.name: f.triple for f in self.families}

    def _key(self) -> tuple:
        return tuple((f.name,) + f.triple for f in self.families)


def _candidate(bases: Sequence[tuple], name: str, d: int,
               rank: int) -> RankCandidate:
    fams = tuple(
        FamilyFactorization(
            name=fname, d_out=d_out, d_in=d_in,
            out_modes=factorize(d_out, d), in_modes=factorize(d_in, d),
            ranks=clip_ranks(factorize(d_out, d) + factorize(d_in, d), rank),
            instances=instances, token_scale=token_scale)
        for fname, d_out, d_in, instances, token_scale in bases
    )
    return RankCandidate(name=name, d=d, rank=rank, families=fams)


class RankSpace:
    """The searched decomposition grid for one model.

    ``families`` is a sequence of ``(name, d_out, d_in, instances,
    token_scale)`` tuples — one per tensorized projection family.  The
    grid is ``mode_counts x`` the rank ladder around ``base_rank``,
    dedup'd (rank clipping collapses distinct ladder points on small
    models) and filtered to ``param_budget_ratio x`` the frozen
    candidate's TT parameters.  The frozen candidate survives the filter
    by construction and is always first.
    """

    def __init__(
        self,
        families: Sequence[tuple],
        *,
        base_d: int,
        base_rank: int,
        param_budget_ratio: float = DEFAULT_PARAM_BUDGET_RATIO,
        ladder: Sequence[float] = RANK_LADDER_FACTORS,
        mode_counts: Sequence[int] = MODES_PER_SIDE,
    ):
        if not families:
            raise ValueError("rank space needs at least one tensorized "
                             "projection family")
        if param_budget_ratio <= 0:
            raise ValueError("param_budget_ratio must be positive")
        self.families = tuple(tuple(f) for f in families)
        self.base_d = int(base_d)
        self.base_rank = int(base_rank)
        self.param_budget_ratio = float(param_budget_ratio)
        self.ladder = tuple(ladder)
        self.mode_counts = tuple(mode_counts)
        self.frozen = _candidate(self.families, "frozen", self.base_d,
                                 self.base_rank)

    def candidates(self) -> list[RankCandidate]:
        budget = self.param_budget_ratio * self.frozen.n_params
        out = [self.frozen]
        seen = {self.frozen._key()}
        for d in self.mode_counts:
            for f in self.ladder:
                rank = max(1, round(self.base_rank * f))
                cand = _candidate(self.families, f"d{d}_r{rank}", d, rank)
                if cand._key() in seen:
                    continue
                seen.add(cand._key())
                if cand.n_params > budget:
                    continue
                out.append(cand)
        return out

    @classmethod
    def from_config(
        cls,
        cfg,
        *,
        param_budget_ratio: float = DEFAULT_PARAM_BUDGET_RATIO,
        ladder: Sequence[float] = RANK_LADDER_FACTORS,
        mode_counts: Sequence[int] = MODES_PER_SIDE,
    ) -> "RankSpace":
        """Rank space over ``cfg``'s tensorized projection families
        (the same enumeration the DSE problems are built from)."""
        from repro_torch.dse_cli import _block_specs

        families = [
            (spec.name, spec.d_out, spec.d_in, count, scale)
            for spec, count, scale in _block_specs(cfg)
            if spec.tensorized
        ]
        if not families:
            raise ValueError(
                f"config {cfg.name!r} has no tensorized projections to "
                f"rank-search (tt.enabled={cfg.tt.enabled})")
        return cls(families, base_d=cfg.tt.d, base_rank=cfg.tt.rank,
                   param_budget_ratio=param_budget_ratio,
                   ladder=ladder, mode_counts=mode_counts)


def vision_rank_space(
    arch: str,
    *,
    base_rank: int = 16,
    param_budget_ratio: float = DEFAULT_PARAM_BUDGET_RATIO,
    ladder: Sequence[float] = RANK_LADDER_FACTORS,
) -> RankSpace:
    """Rank space for a vision workload (``resnet18/...``, ``vit_ti4/...``).

    Vision layers are rebuilt by ``repro_torch.models.vision.model_layers(rank=r)``
    — the mode split is structural (d=2 linear splits, 5-core TT-conv), so
    only the scalar rank varies; the per-family factorizations here drive
    the accuracy proxy and the parameter budget, approximating conv layers
    by the TT-SVD of their im2col matrix.
    """
    from repro_torch.models.vision import model_layers

    model, dataset = arch.split("/")
    families = []
    for layer in model_layers(model, dataset, batch=1, rank=base_rank):
        w = next(n for n in layer.dense_network.nodes if n.kind != "input")
        d_in, d_out = w.dims
        families.append((layer.name, d_out, d_in, 1, 1.0))
    return RankSpace(families, base_d=2, base_rank=base_rank,
                     param_budget_ratio=param_budget_ratio,
                     ladder=ladder, mode_counts=(2,))
