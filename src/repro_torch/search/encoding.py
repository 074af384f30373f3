"""Candidate encoding + variation operators for the guided joint search.

Framework-neutral copy of ``src/repro/search/encoding.py`` (the port
never imports the JAX package).

A :class:`Genome` is one point of the joint design space — the
architecture candidate index, the global partitioning strategy, and one
``(path index, partitioning, dataflow)`` gene per layer.  It is exactly
the coordinate system of the exhaustive search's cost table
``T[arch][l, p, c, d]`` restricted to a strategy, which is what makes a
genome *scoreable* by pure table reads: no new simulator machinery, the
guided driver and the exhaustive oracle consume the same numbers.

:class:`JointSpace` owns the variation operators:

- ``random_genome`` — uniform draw (population seeding);
- ``mutate`` — local moves: an architecture step to a *neighboring*
  candidate (L1-nearest in ``hw.arch_coordinates`` — the searched knobs
  are geometric, so adjacent grid points have similar cost surfaces), a
  strategy flip, and per-layer gene redraws;
- ``crossover`` — uniform per-layer gene mix of two parents under one
  parent's (arch, strategy).

Every operator *repairs* as it goes — a gene's partitioning is always
drawn from the genome's own strategy's ``C_h`` — so genomes are valid
table coordinates by construction and scoring never needs a feasibility
check.  All randomness flows through the caller's ``random.Random``;
the same seed replays the same proposal sequence bit-for-bit
(determinism is a tested property of the driver).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Mapping, Sequence

from repro_torch.core.paths import CandidatePath
from repro_torch.core.simulator import (
    ALL_DATAFLOWS,
    STRATEGY_SPACE,
    Dataflow,
    Partitioning,
)
from repro_torch.hw import HardwareConfig, arch_coordinates

#: how many L1-nearest candidates count as an architecture's neighborhood
ARCH_NEIGHBORS = 4

#: one layer's gene: (path index, partitioning, dataflow)
LayerGene = tuple  # tuple[int, Partitioning, Dataflow]


@dataclasses.dataclass(frozen=True)
class Genome:
    """One joint-space point: architecture + strategy + per-layer genes."""

    arch: int
    strategy: str
    genes: tuple[LayerGene, ...]

    def keys(self):
        """The cost-table cells this genome's score sums over."""
        return [(l, p, c, d) for l, (p, c, d) in enumerate(self.genes)]


class JointSpace:
    """The searched joint space + its mutation/crossover operators."""

    def __init__(
        self,
        layer_paths: Sequence[Sequence[CandidatePath]],
        hw_space: Sequence[HardwareConfig],
        strategy_space: Mapping[str, Sequence[Partitioning]] = STRATEGY_SPACE,
        dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
    ) -> None:
        if not hw_space:
            raise ValueError("hw_space must contain at least one candidate")
        if not all(paths for paths in layer_paths):
            raise ValueError("every layer needs at least one candidate path")
        self.layer_paths = tuple(tuple(p) for p in layer_paths)
        self.hw_space = tuple(hw_space)
        self.strategy_space = {h: tuple(cs)
                               for h, cs in strategy_space.items()}
        self.strategies = tuple(self.strategy_space)
        self.dataflows = tuple(dataflows)
        # L1-nearest candidates per architecture (ties to the lower index)
        coords = arch_coordinates(self.hw_space)
        self.arch_neighbors: tuple[tuple[int, ...], ...] = tuple(
            tuple(sorted(
                (j for j in range(len(coords)) if j != i),
                key=lambda j: (sum(abs(a - b)
                                   for a, b in zip(coords[i], coords[j])), j),
            )[:ARCH_NEIGHBORS])
            for i in range(len(coords))
        )

    # -- construction ------------------------------------------------------
    def _random_gene(self, l: int, c_h: Sequence[Partitioning],
                     rng: random.Random) -> LayerGene:
        return (rng.randrange(len(self.layer_paths[l])),
                c_h[rng.randrange(len(c_h))],
                self.dataflows[rng.randrange(len(self.dataflows))])

    def random_genome(self, rng: random.Random) -> Genome:
        strategy = self.strategies[rng.randrange(len(self.strategies))]
        c_h = self.strategy_space[strategy]
        genes = tuple(self._random_gene(l, c_h, rng)
                      for l in range(len(self.layer_paths)))
        return Genome(rng.randrange(len(self.hw_space)), strategy, genes)

    def encode_choices(self, arch: int, strategy: str, choices) -> Genome:
        """Re-encode a refined result's per-layer choices as a genome."""
        genes = tuple((c.path_index, c.partitioning, c.dataflow)
                      for c in choices)
        return Genome(arch, strategy, genes)

    # -- variation ---------------------------------------------------------
    def _repair(self, genes, strategy: str,
                rng: random.Random) -> tuple[LayerGene, ...]:
        c_h = self.strategy_space[strategy]
        out = []
        for l, (p, c, d) in enumerate(genes):
            if c not in c_h:
                c = c_h[rng.randrange(len(c_h))]
            out.append((p, c, d))
        return tuple(out)

    def mutate(self, g: Genome, rng: random.Random) -> Genome:
        arch, strategy, genes = g.arch, g.strategy, list(g.genes)
        r = rng.random()
        if r < 0.4 and len(self.hw_space) > 1:
            # local architecture step; occasionally a uniform jump so the
            # search cannot get trapped in one grid region
            nbrs = self.arch_neighbors[arch]
            if rng.random() < 0.75 and nbrs:
                arch = nbrs[rng.randrange(len(nbrs))]
            else:
                arch = rng.randrange(len(self.hw_space))
        elif r < 0.6 and len(self.strategies) > 1:
            others = [h for h in self.strategies if h != strategy]
            strategy = others[rng.randrange(len(others))]
        # always perturb one layer's gene: each component redrawn by coin
        l = rng.randrange(len(genes))
        p, c, d = genes[l]
        c_h = self.strategy_space[strategy]
        if rng.random() < 0.5:
            p = rng.randrange(len(self.layer_paths[l]))
        if rng.random() < 0.5:
            c = c_h[rng.randrange(len(c_h))]
        if rng.random() < 0.5:
            d = self.dataflows[rng.randrange(len(self.dataflows))]
        genes[l] = (p, c, d)
        return Genome(arch, strategy, self._repair(genes, strategy, rng))

    def crossover(self, a: Genome, b: Genome,
                  rng: random.Random) -> Genome:
        lead, other = (a, b) if rng.random() < 0.5 else (b, a)
        genes = tuple(
            ga if rng.random() < 0.5 else gb
            for ga, gb in zip(lead.genes, other.genes)
        )
        return Genome(lead.arch, lead.strategy,
                      self._repair(genes, lead.strategy, rng))
