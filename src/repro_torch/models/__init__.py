"""Model API (port of ``models/__init__.py``): every family, the causal
LMs dense, moe, hybrid, rwkv and vlm, and the encoder-decoder (encdec).

``api(cfg)`` returns uniform callables.  ``init_params`` takes a
``torch.Generator`` or an int seed; parameters and caches live on
``device``, ``cuda`` unless the caller passes ``device="cpu"``.
``input_specs(cfg, shape)`` gives meta tensors (shape and dtype, no
storage) for every input of a cell's step, where the reference gives
``jax.ShapeDtypeStruct``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.sharding import use_rules

from . import encdec as _encdec
from . import lm as _lm
from .config import SHAPES, ModelConfig, ShapeConfig, shape_applicable

ENC_LEN_CAP = 4096   # encoder frame length for enc-dec decode shapes


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init_params: Callable
    #: (params, {"tokens", "labels"[, "frontend"]}) -> scalar loss,
    #: differentiable: the (chunked) cross-entropy plus the weighted aux loss
    train_loss: Callable
    #: last-token prefill: (params, batch, max_seq) -> ((B, V), caches)
    prefill: Callable
    decode_step: Callable
    init_caches: Callable
    #: full-logits prefill: (params, batch, max_seq) -> ((B, S, V), caches);
    #: a VLM batch may carry its ``frontend`` prefix.  The serve scheduler
    #: slices the last real token of a bucket-padded prompt from it.
    #: ``None`` for the encdec, as in the reference (``models.encdec.
    #: prefill_full`` gives its every position's logits)
    prefill_full: Optional[Callable] = None
    #: batch -> whether the installed rules split a step's sequence on it
    #: (SP: ``lm.seq_block``; the encoder-decoder's frames or tokens)
    seq_split: Callable = lambda batch: False


_PLAN_UNSET = object()  # sentinel: "plan argument not given"


def api(cfg: ModelConfig, plan=_PLAN_UNSET, *,
        plan_backend: Optional[str] = None, device="cuda") -> ModelAPI:
    """Family-dispatched model API.

    ``plan`` (an ``ExecutionPlan`` or a plan-file path) is installed into
    the TT linear layers; omitting it leaves the installed plan untouched,
    ``plan=None`` clears it.  ``plan_backend`` forces one executor for all
    layers, with the reference's checks (``models/__init__.py:57-75``).
    """
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

    family = _encdec if cfg.family == "encdec" else _lm

    def init_params(generator):
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        return family.init_params(cfg, generator, device=device)

    if cfg.family == "encdec":
        return ModelAPI(
            init_params=init_params,
            train_loss=lambda p, b: _encdec.train_loss(cfg, p, b),
            prefill=lambda p, b, max_seq: _encdec.prefill(cfg, p, b, max_seq),
            decode_step=lambda p, t, c, pos: _encdec.decode_step(cfg, p, t, c, pos),
            init_caches=lambda batch, max_seq: _encdec.init_caches(
                cfg, batch, max_seq, min(ENC_LEN_CAP, max_seq), device=device),
            seq_split=lambda b: _encdec.splits_batch_sequence(cfg, b),
        )
    return ModelAPI(
        init_params=init_params,
        train_loss=lambda p, b: _lm.train_loss(cfg, p, b),
        prefill=lambda p, b, max_seq: _lm.prefill(cfg, p, b, max_seq),
        decode_step=lambda p, t, c, pos: _lm.decode_step(cfg, p, t, c, pos),
        init_caches=lambda batch, max_seq: _lm.init_caches(
            cfg, batch, max_seq, device=device),
        prefill_full=lambda p, b, max_seq: _lm.prefill_full(cfg, p, b, max_seq),
        seq_split=lambda b: _lm.splits_batch_sequence(cfg, b),
    )


def decode_cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """The positions of a decode cell's caches: its sequence, plus a VLM's
    image prefix."""
    return shape.seq_len + (cfg.n_frontend_tokens or (256 if cfg.family == "vlm" else 0))


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Meta tensors (shape and dtype, no storage) for every input of the
    cell's step, the reference's ``ShapeDtypeStruct`` stand-ins.

    train:   {tokens, labels[, frontend]}
    prefill: {tokens[, frontend]}
    decode:  {token, cache_pos, caches}
    """
    gb, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    def frontend_spec(seq: int):
        if cfg.family == "vlm":
            return spec((gb, cfg.n_frontend_tokens or 256, cfg.d_model), dt)
        if cfg.family == "encdec":
            return spec((gb, min(ENC_LEN_CAP, seq), cfg.d_model), dt)
        return None

    if shape.step in ("train", "prefill"):
        batch = {"tokens": spec((gb, s))}
        if shape.step == "train":
            batch["labels"] = spec((gb, s))
        fe = frontend_spec(s)
        if fe is not None:
            batch["frontend"] = fe
        return batch
    if shape.step == "decode":
        max_seq = decode_cache_len(cfg, shape)
        with use_rules(None):   # the whole caches, as the reference's specs
            caches = api(cfg, device="meta").init_caches(gb, max_seq)
        return {"token": spec((gb, 1)), "cache_pos": spec(()), "caches": caches}
    raise ValueError(shape.step)


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "shape_applicable",
    "ModelAPI", "api", "decode_cache_len", "input_specs", "ENC_LEN_CAP",
]
