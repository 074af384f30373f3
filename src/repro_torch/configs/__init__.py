"""Config registry: ``get_config("<arch>")`` / ``--arch <id>``.

Port of ``src/repro/configs/__init__.py`` for the architectures the port
runs so far (tt-lm-100m, FULL and SMOKE).  The reference's other
architectures are named so that asking for one says it is not ported yet.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

#: architectures the port runs
ARCH_IDS = ("tt-lm-100m",)

#: the reference's other architectures, still to port (ROADMAP.md Queue A
#: item 9d; their model families, item 12)
NOT_PORTED = (
    "zamba2-1.2b",
    "phi3-medium-14b",
    "chatglm3-6b",
    "glm4-9b",
    "qwen1.5-110b",
    "seamless-m4t-medium",
    "grok-1-314b",
    "qwen2-moe-a2.7b",
    "internvl2-2b",
    "rwkv6-7b",
)

_MODULES = {"tt-lm-100m": "tt_lm_100m"}


def get_config(name: str, tt: bool = True, smoke: bool = False) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet "
            "(ROADMAP.md, Queue A item 9d); ported: "
            f"{sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg: ModelConfig = mod.SMOKE if smoke else mod.FULL
    if not tt:
        cfg = cfg.with_(tt=cfg.tt.__class__(enabled=False))
    return cfg


__all__ = ["ARCH_IDS", "NOT_PORTED", "ModelConfig", "get_config"]
