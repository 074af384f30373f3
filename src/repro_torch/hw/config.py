"""The hardware-architecture description shared by every cost model.

Framework-neutral copy of ``src/repro/hw/config.py`` (the port never imports
the JAX package).

:class:`HardwareConfig` is the single parameterization of the closed-form
systolic cost model (``repro_torch.core.simulator.gemm_cost_model``): the
paper's FPGA target, the TPU-v5e reading, and every candidate in the
searched architecture space (``repro_torch.hw.space``) are all instances of
this one dataclass.  It lives here — below ``repro_torch.core`` — so the
simulator, the cost-table engine, the plan schema (which embeds the
winning architecture since format v3) and the architecture-space
generator can all share it without import cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    """Systolic target description.  Defaults = the paper's FPGA setup."""

    name: str = "fpga_vu9p"
    pe_rows: int = 32
    pe_cols: int = 32
    freq_hz: float = 200e6
    sram_input_bytes: int = 3072 * 1024   # inputs + filters (paper 5.1)
    sram_output_bytes: int = 1024 * 1024
    dram_words_per_cycle: float = 256.0   # paper: "bandwidth of 256"
    bytes_per_word: int = 1               # INT8
    gemm_overhead_cycles: int = 64        # per-GEMM reconfig/drain constant

    @property
    def macs_per_cycle(self) -> int:
        return self.pe_rows * self.pe_cols

    @property
    def peak_macs_per_s(self) -> float:
        return self.macs_per_cycle * self.freq_hz

    @property
    def sram_total_bytes(self) -> int:
        return self.sram_input_bytes + self.sram_output_bytes

    # -- JSON embedding (plan schema v3) ----------------------------------
    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Mapping) -> "HardwareConfig":
        return cls(
            name=str(d["name"]),
            pe_rows=int(d["pe_rows"]),
            pe_cols=int(d["pe_cols"]),
            freq_hz=float(d["freq_hz"]),
            sram_input_bytes=int(d["sram_input_bytes"]),
            sram_output_bytes=int(d["sram_output_bytes"]),
            dram_words_per_cycle=float(d["dram_words_per_cycle"]),
            bytes_per_word=int(d["bytes_per_word"]),
            gemm_overhead_cycles=int(d["gemm_overhead_cycles"]),
        )
