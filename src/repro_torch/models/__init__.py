"""Model API (port of ``models/__init__.py::api``): the causal-LM
families dense, moe, hybrid, rwkv and vlm; encdec is not ported yet.

``api(cfg)`` returns uniform callables.  ``init_params`` takes a
``torch.Generator`` or an int seed; parameters and caches live on
``device``, ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from . import lm as _lm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init_params: Callable
    #: (params, {"tokens", "labels"}) -> scalar loss, differentiable (the
    #: dense family; the others raise)
    train_loss: Callable
    #: last-token prefill: (params, batch, max_seq) -> ((B, V), caches)
    prefill: Callable
    decode_step: Callable
    init_caches: Callable
    #: full-logits prefill: (params, batch, max_seq) -> ((B, S, V), caches);
    #: a VLM batch may carry its ``frontend`` prefix
    prefill_full: Callable


_PLAN_UNSET = object()  # sentinel: "plan argument not given"


def api(cfg: ModelConfig, plan=_PLAN_UNSET, *,
        plan_backend: Optional[str] = None, device="cuda") -> ModelAPI:
    """Family-dispatched model API.

    ``plan`` (an ``ExecutionPlan`` or a plan-file path) is installed into
    the TT linear layers; omitting it leaves the installed plan untouched,
    ``plan=None`` clears it.  ``plan_backend`` forces one executor for all
    layers, with the reference's checks (``models/__init__.py:57-75``).
    """
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet "
            "(ROADMAP.md, Queue A item 12b)")
    if plan_backend is not None:
        from repro_torch.plan.schema import BACKENDS

        if plan_backend not in BACKENDS:
            raise ValueError(
                f"unknown plan_backend {plan_backend!r}; have {BACKENDS}")
    if plan is not _PLAN_UNSET or plan_backend is not None:
        from repro_torch.nn import install_plan

        if plan is _PLAN_UNSET or plan is None:
            if plan_backend is not None:
                raise ValueError(
                    "plan_backend given without a plan to apply it to")
            plan = None
        if isinstance(plan, str):
            from repro_torch.plan import load_plan

            plan = load_plan(plan)
        install_plan(plan, force_backend=plan_backend)

    def init_params(generator):
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        return _lm.init_params(cfg, generator, device=device)

    return ModelAPI(
        init_params=init_params,
        train_loss=lambda p, b: _lm.train_loss(cfg, p, b),
        prefill=lambda p, b, max_seq: _lm.prefill(cfg, p, b, max_seq),
        decode_step=lambda p, t, c, pos: _lm.decode_step(cfg, p, t, c, pos),
        init_caches=lambda batch, max_seq: _lm.init_caches(
            cfg, batch, max_seq, device=device),
        prefill_full=lambda p, b, max_seq: _lm.prefill_full(cfg, p, b, max_seq),
    )


__all__ = ["ModelConfig", "ModelAPI", "api"]
