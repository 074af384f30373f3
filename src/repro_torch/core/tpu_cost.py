"""TPU-v5e target — compatibility shim over ``repro_torch.hw.targets``.

Framework-neutral copy of ``src/repro/core/tpu_cost.py`` (the port never imports
the JAX package).

The TPU-v5e re-parameterization of the systolic latency model (and the
roofline interconnect constants) moved to :mod:`repro_torch.hw.targets`, the
hardware-target registry.  This module re-exports them so existing
imports (``repro_torch.core.tpu_cost.TPU_V5E``) keep working; new code should
use ``repro_torch.hw.get_target("tpu_v5e")`` or ``repro_torch.hw.TPU_V5E``.
"""

from __future__ import annotations

from ..hw.targets import (  # noqa: F401  (re-exports)
    HBM_BYTES_PER_S,
    HBM_CAPACITY_BYTES,
    ICI_BYTES_PER_S_PER_LINK,
    PEAK_FLOPS_BF16,
    TPU_V5E,
    VMEM_BYTES,
)
