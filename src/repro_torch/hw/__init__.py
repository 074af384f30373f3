"""Hardware-architecture subsystem: targets, registry, searched space.

Framework-neutral copy of ``src/repro/hw/__init__.py`` (the port never imports
the JAX package).

Three layers:

- :mod:`repro_torch.hw.config` — :class:`HardwareConfig`, the single
  parameterization of the closed-form systolic cost model (JSON-embeddable
  since plan schema v3);
- :mod:`repro_torch.hw.targets` — the named-target registry (``fpga_vu9p``,
  ``tpu_v5e``) behind ``python -m repro_torch.dse --hw`` / ``--list-hw``;
- :mod:`repro_torch.hw.space` — :class:`ArchSpace`, the feasible architecture
  variants of a target under a MAC/DSP budget, searched jointly with
  contraction paths and dataflows by
  ``repro_torch.core.dse.global_search(hw_space=...)``.
"""

from .config import HardwareConfig
from .targets import (
    FPGA_VU9P,
    HW_TARGETS,
    TPU_V5E,
    get_target,
    list_targets,
    register_target,
)
from .space import ArchSpace, arch_coordinates

__all__ = [
    "ArchSpace",
    "arch_coordinates",
    "FPGA_VU9P",
    "HW_TARGETS",
    "HardwareConfig",
    "TPU_V5E",
    "get_target",
    "list_targets",
    "register_target",
]
