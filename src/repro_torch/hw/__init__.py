"""Hardware descriptions a plan embeds (schema v3): config + target registry."""

from .config import HardwareConfig
from .targets import (
    FPGA_VU9P,
    HW_TARGETS,
    TPU_V5E,
    get_target,
    list_targets,
    register_target,
)

__all__ = [
    "FPGA_VU9P",
    "HW_TARGETS",
    "HardwareConfig",
    "TPU_V5E",
    "get_target",
    "list_targets",
    "register_target",
]
