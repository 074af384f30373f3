"""Config registry: ``get_config("<arch>")`` / ``--arch <id>``.

Framework-neutral copy of ``src/repro/configs/__init__.py`` (the port
never imports the JAX package).  Every assigned architecture has one
module defining FULL (the exact assigned dims) and SMOKE (a reduced
same-family variant for CPU tests).  ``get_config(name, tt=...,
smoke=...)`` is the single entry point; the default is the TT-enabled
deployment configuration (the paper's technique); ``tt=False`` gives the
dense baseline.  The DSE plans every architecture, and the port's model
code serves and trains every family: the causal LMs (dense, moe, hybrid,
rwkv, vlm) through ``launch.serve`` and ``launch.train``, the
encoder-decoder through the step builders of ``launch.steps``
(``examples/serve_decode_torch.py`` serves it).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig, shape_applicable

ARCH_IDS = (
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

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
_MODULES["tt-lm-100m"] = "tt_lm_100m"


def get_config(name: str, tt: bool = True, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg: ModelConfig = mod.SMOKE if smoke else mod.FULL
    if not tt:
        cfg = cfg.with_(tt=cfg.tt.__class__(enabled=False))
    return cfg


def all_arch_ids() -> tuple[str, ...]:
    return ARCH_IDS


__all__ = [
    "ARCH_IDS", "get_config", "all_arch_ids",
    "SHAPES", "ModelConfig", "ShapeConfig", "shape_applicable",
]
