"""Parameterized hardware-architecture space under a resource budget.

Framework-neutral copy of ``src/repro/hw/space.py`` (the port never imports
the JAX package).

The paper's claim is that contraction path, dataflow mapping *and* the
hardware architecture are coupled and must be searched jointly.  This
module makes the architecture a first-class searched axis: an
:class:`ArchSpace` enumerates every *feasible* variant of a base target
under a fixed MAC/DSP budget —

- **PE array shape** ``R x C``: power-of-two dimensions whose product
  stays within the MAC budget (the DSP count of the paper's VU9P board,
  32 x 32 = 1024 by default) and does not waste more than half of it;
  extreme aspect ratios are rejected (wiring/fan-out infeasible).
- **SRAM split**: the board's total on-chip buffer is fixed; the
  input/output split point moves (the paper's 3072/1024 KiB is the 0.75
  point).
- **DRAM-bandwidth tier**: words/cycle at or below the board's pin
  bandwidth (a searched architecture cannot exceed the package).

Frequency, word width and per-GEMM overhead are inherited from the base
target — they are process/board constants, not architectural choices.
The base target itself is always candidate 0, so a joint
(architecture, path, dataflow) search over the space can never be worse
than the fixed-target search (the guarantee
``tests/test_hw.py`` asserts for every registered target).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Sequence

from .config import HardwareConfig
from .targets import FPGA_VU9P


def _pow2s(lo: int, hi: int) -> list[int]:
    out, p = [], 1
    while p <= hi:
        if p >= lo:
            out.append(p)
        p *= 2
    return out


@dataclasses.dataclass(frozen=True)
class ArchSpace:
    """Feasible architecture variants of ``base`` under a MAC/DSP budget.

    ``mac_budget`` defaults to the base target's own PE count — the
    search then *re-shapes* the same silicon rather than adding any.
    ``sram_total_bytes`` likewise defaults to the base target's total
    buffer; only the split point is searched.
    """

    base: HardwareConfig = FPGA_VU9P
    mac_budget: Optional[int] = None          # R*C <= budget (DSP count)
    min_pe_dim: int = 8
    max_pe_dim: int = 256
    max_aspect: int = 16                      # max(R,C)/min(R,C) cap
    min_budget_util: float = 0.5              # R*C >= util * budget
    sram_total_bytes: Optional[int] = None
    sram_input_fracs: tuple[float, ...] = (0.5, 0.625, 0.75, 0.875)
    min_sram_output_bytes: int = 64 * 1024
    bw_tiers: Optional[tuple[float, ...]] = None  # words/cycle, <= base

    def __post_init__(self) -> None:
        if self.mac_budget is None:
            object.__setattr__(self, "mac_budget", self.base.macs_per_cycle)
        if self.sram_total_bytes is None:
            object.__setattr__(self, "sram_total_bytes",
                               self.base.sram_total_bytes)
        if self.bw_tiers is None:
            bw = self.base.dram_words_per_cycle
            object.__setattr__(self, "bw_tiers", (bw / 4.0, bw / 2.0, bw))
        elif max(self.bw_tiers) > self.base.dram_words_per_cycle:
            raise ValueError(
                f"bw_tiers {self.bw_tiers} exceed the base target's pin "
                f"bandwidth ({self.base.dram_words_per_cycle:g} words/cycle)"
                " — every grid candidate would be infeasible")
        if self.mac_budget < self.min_pe_dim * self.min_pe_dim:
            raise ValueError(
                f"mac_budget {self.mac_budget} cannot fit a "
                f"{self.min_pe_dim}x{self.min_pe_dim} array")

    # -- feasibility ------------------------------------------------------
    def resource_problems(self, hw: HardwareConfig) -> list[str]:
        """*Hard* resource violations: the candidate does not fit the
        board.  (Distinct from the efficiency preferences below, which
        only prune the generated grid.)"""
        problems = []
        r, c = hw.pe_rows, hw.pe_cols
        if r * c > self.mac_budget:
            problems.append(f"{r}x{c} PEs exceed the MAC budget "
                            f"{self.mac_budget}")
        if hw.sram_input_bytes + hw.sram_output_bytes > self.sram_total_bytes:
            problems.append("SRAM split exceeds the total buffer budget")
        if hw.sram_output_bytes < self.min_sram_output_bytes:
            problems.append("output SRAM below the minimum buffer")
        if hw.dram_words_per_cycle > self.base.dram_words_per_cycle:
            problems.append("bandwidth tier exceeds the board's pins")
        return problems

    def feasibility(self, hw: HardwareConfig) -> list[str]:
        """Resource violations plus efficiency-preference problems
        (budget utilization, dim bounds, aspect ratio) — empty = ok."""
        problems = self.resource_problems(hw)
        r, c = hw.pe_rows, hw.pe_cols
        if r * c < self.min_budget_util * self.mac_budget:
            problems.append(f"{r}x{c} PEs waste more than "
                            f"{1 - self.min_budget_util:.0%} of the budget")
        if not (self.min_pe_dim <= r <= self.max_pe_dim
                and self.min_pe_dim <= c <= self.max_pe_dim):
            problems.append(f"array dim outside [{self.min_pe_dim}, "
                            f"{self.max_pe_dim}]")
        if max(r, c) > self.max_aspect * min(r, c):
            problems.append(f"aspect ratio {max(r, c) // min(r, c)} exceeds "
                            f"{self.max_aspect}")
        return problems

    def feasible(self, hw: HardwareConfig) -> bool:
        return not self.feasibility(hw)

    # -- enumeration ------------------------------------------------------
    def _grid(self) -> Iterator[HardwareConfig]:
        dims = _pow2s(self.min_pe_dim, self.max_pe_dim)
        for r in dims:
            for c in dims:
                for frac in self.sram_input_fracs:
                    sram_in = int(self.sram_total_bytes * frac)
                    sram_out = self.sram_total_bytes - sram_in
                    for bw in self.bw_tiers:
                        yield dataclasses.replace(
                            self.base,
                            name=(f"{self.base.name}@{r}x{c}"
                                  f"_s{frac:g}_bw{bw:g}"),
                            pe_rows=r,
                            pe_cols=c,
                            sram_input_bytes=sram_in,
                            sram_output_bytes=sram_out,
                            dram_words_per_cycle=bw,
                        )

    def candidates(self) -> tuple[HardwareConfig, ...]:
        """All feasible candidates; the base target is always first.

        The base is exempt from the efficiency *preferences* (it only
        has to fit the board's resources): it is the reference point, and
        dropping it — e.g. under an enlarged ``mac_budget`` where its PE
        count falls below ``min_budget_util`` — would break the
        "co-searched optimum <= fixed optimum" guarantee and every
        consumer of the report's ``fixed`` row.  Grid points that
        duplicate the base target's parameters under a different name are
        dropped, so ties in a joint search resolve to the base
        architecture.
        """
        def params(hw: HardwareConfig) -> tuple:
            return dataclasses.astuple(dataclasses.replace(hw, name=""))

        out: list[HardwareConfig] = []
        seen: set[tuple] = set()
        if not self.resource_problems(self.base):
            out.append(self.base)
            seen.add(params(self.base))
        for hw in self._grid():
            if params(hw) in seen or not self.feasible(hw):
                continue
            seen.add(params(hw))
            out.append(hw)
        if not out:
            raise ValueError(
                f"architecture space for {self.base.name!r} under budget "
                f"{self.mac_budget} has no feasible candidate")
        return tuple(out)

    def describe(self, hw: HardwareConfig) -> dict:
        """JSON-friendly summary of one candidate (CLI / benchmark rows)."""
        return {
            "name": hw.name,
            "pe_rows": hw.pe_rows,
            "pe_cols": hw.pe_cols,
            "sram_input_kib": hw.sram_input_bytes // 1024,
            "sram_output_kib": hw.sram_output_bytes // 1024,
            "dram_words_per_cycle": hw.dram_words_per_cycle,
        }


def arch_coordinates(
    hw_list: Sequence[HardwareConfig],
) -> tuple[tuple[float, ...], ...]:
    """Embed candidates in a metric space for neighborhood-based mutation.

    One coordinate vector per candidate: (log2 PE rows, log2 PE cols,
    input-SRAM fraction of the total buffer, log2 bandwidth tier).  The
    searched knobs are all geometric (pow2 dims, bw halvings), so log2
    makes "one grid step" a unit distance on each axis; the SRAM split is
    already a fraction.  Guided mutation uses L1 distance in this space
    to propose *adjacent* architectures instead of uniform jumps — the
    cost surface is smooth along each knob (halving bandwidth roughly
    doubles DRAM time), which is what makes local moves informative.
    """
    coords = []
    for hw in hw_list:
        total = hw.sram_input_bytes + hw.sram_output_bytes
        coords.append((
            math.log2(hw.pe_rows),
            math.log2(hw.pe_cols),
            hw.sram_input_bytes / total if total else 0.0,
            math.log2(hw.dram_words_per_cycle)
            if hw.dram_words_per_cycle > 0 else 0.0,
        ))
    return tuple(coords)
