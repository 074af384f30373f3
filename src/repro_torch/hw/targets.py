"""The hardware-target registry — single source of truth for ``--hw``.

Framework-neutral copy of ``src/repro/hw/targets.py`` (the port never imports
the JAX package).

Named, fixed accelerator descriptions live here: the paper's FPGA setup
(``fpga_vu9p``) and the TPU-v5e MXU reading (``tpu_v5e``).  Everything
that needs to resolve a target by name — ``python -m repro_torch.dse --hw``,
plan migration (v2 → v3 embeds the named target), benchmarks — goes
through :func:`get_target`, so adding a target is a one-line
:func:`register_target` call.

TPU-v5e derivation: the MXU *is* a 128x128 systolic array, so the same
closed-form model applies with TPU constants:

  * peak 197 TFLOP/s bf16 per chip  ->  98.5e12 MAC/s
  * on a 128x128 array that is an effective 6.01 GHz MAC issue rate
    (the real chip reaches it with multiple MXU passes per clock; the
    effective-frequency abstraction preserves the peak roofline)
  * HBM 819 GB/s  ->  819e9 / 2 B (bf16) / 6.01e9 Hz ~= 68 words/cycle
  * VMEM ~128 MiB split ~3:1 between operand and output buffering,
    mirroring the paper's 3072/1024 KiB SRAM split.
"""

from __future__ import annotations

from .config import HardwareConfig

# the paper's simulator settings (5.1) are HardwareConfig's defaults
FPGA_VU9P = HardwareConfig()

_PEAK_FLOPS_BF16 = 197e12
_MXU = 128
_EFF_FREQ = (_PEAK_FLOPS_BF16 / 2.0) / (_MXU * _MXU)  # ~6.01e9
_HBM_BYTES_PER_S = 819e9
_BYTES_PER_WORD = 2  # bf16

TPU_V5E = HardwareConfig(
    name="tpu_v5e",
    pe_rows=_MXU,
    pe_cols=_MXU,
    freq_hz=_EFF_FREQ,
    sram_input_bytes=96 * 1024 * 1024,
    sram_output_bytes=32 * 1024 * 1024,
    dram_words_per_cycle=_HBM_BYTES_PER_S / _BYTES_PER_WORD / _EFF_FREQ,
    bytes_per_word=_BYTES_PER_WORD,
    gemm_overhead_cycles=256,  # kernel-dispatch / pipeline-warmup constant
)

#: interconnect constants used by the roofline analysis (per chip)
ICI_BYTES_PER_S_PER_LINK = 50e9
HBM_BYTES_PER_S = _HBM_BYTES_PER_S
PEAK_FLOPS_BF16 = _PEAK_FLOPS_BF16
VMEM_BYTES = 128 * 1024 * 1024
HBM_CAPACITY_BYTES = 16 * 1024**3


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

#: name -> HardwareConfig; the one mapping ``--hw`` resolves against
HW_TARGETS: dict[str, HardwareConfig] = {}


def register_target(hw: HardwareConfig) -> HardwareConfig:
    """Register a named target (idempotent for identical configs)."""
    existing = HW_TARGETS.get(hw.name)
    if existing is not None and existing != hw:
        raise ValueError(
            f"hardware target {hw.name!r} already registered with "
            "different parameters")
    HW_TARGETS[hw.name] = hw
    return hw


def get_target(name: str) -> HardwareConfig:
    """Resolve a target by name; unknown names list the valid choices."""
    try:
        return HW_TARGETS[name]
    except KeyError:
        raise KeyError(
            f"unknown hw {name!r}; have {sorted(HW_TARGETS)}") from None


def list_targets() -> tuple[str, ...]:
    return tuple(sorted(HW_TARGETS))


register_target(FPGA_VU9P)
register_target(TPU_V5E)
