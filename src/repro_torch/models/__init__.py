"""Model API (port of ``models/__init__.py::api`` for the dense family).

``api(cfg)`` returns uniform callables.  ``init_params`` takes a
``torch.Generator`` or an int seed; parameters and caches live on
``device``, ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import lm as _lm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init_params: Callable
    #: (params, {"tokens", "labels"}) -> scalar loss, differentiable
    train_loss: Callable
    decode_step: Callable
    init_caches: Callable
    #: full-logits prefill: (params, batch, max_seq) -> ((B, S, V), caches)
    prefill_full: Callable


_PLAN_UNSET = object()  # sentinel: "plan argument not given"


def api(cfg: ModelConfig, plan=_PLAN_UNSET, *, device="cuda") -> ModelAPI:
    """Family-dispatched model API.

    ``plan`` (an ``ExecutionPlan``) is installed into the TT linear layers;
    omitting it leaves the installed plan untouched, ``plan=None`` clears
    it.
    """
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet "
            "(ROADMAP.md, Queue A item 12)")
    if plan is not _PLAN_UNSET:
        from repro_torch.nn import install_plan

        install_plan(plan)

    def init_params(generator):
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        return _lm.init_params(cfg, generator, device=device)

    return ModelAPI(
        init_params=init_params,
        train_loss=lambda p, b: _lm.train_loss(cfg, p, b),
        decode_step=lambda p, t, c, pos: _lm.decode_step(cfg, p, t, c, pos),
        init_caches=lambda batch, max_seq: _lm.init_caches(
            cfg, batch, max_seq, device=device),
        prefill_full=lambda p, b, max_seq: _lm.prefill_full(cfg, p, b, max_seq),
    )


__all__ = ["ModelConfig", "ModelAPI", "api"]
