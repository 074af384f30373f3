"""Step builders: train, prefill, decode and eval (port of
``src/repro/launch/steps.py``).

PyTorch runs eagerly, so each builder returns a plain function; there is
nothing to jit.  The prefill and decode steps are the one-batch serving
form every family takes (the encoder-decoder's only one:
``examples/serve_decode_torch.py``); the continuous-batching engine of the
causal LMs lives in ``serve/engine.py``.

Each step runs under the installed sharding rules: under their
``batch_split`` the batch it is handed is the rank's block, the loss the
rank's share, and the train step sums the gradients over the batch axes
(:func:`loss_and_grads`), where the reference's XLA step sums them inside
the jitted step, before the clip.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.models import ModelConfig, api
from repro_torch.models.lm import whole_logits
from repro_torch.optim import adamw_update, clip_by_global_norm, compress_decompress
from repro_torch.plan.sharded import batch_axes_split, collective
from repro_torch.sharding import get_rules
from repro_torch.tree import leaves, map_tree


def _data_group():
    """The process group of the batch axes when the installed rules split
    the step's batch over them, else None."""
    split = batch_axes_split(get_rules())
    return split[0] if split is not None else None


def global_loss(loss: torch.Tensor) -> torch.Tensor:
    """The loss over the global batch, detached: the sum of the ranks'
    shares under ``batch_split`` (one all-reduce), else ``loss``."""
    group = _data_group()
    loss = loss.detach()
    if group is None:
        return loss
    return collective("all_reduce", loss.clone(), group)


def sum_batch_grads(grads: Any) -> Any:
    """``grads`` summed over the batch axes' group under the installed
    rules' ``batch_split`` (in place; one all-reduce (SUM) a dtype, of one
    flat buffer in :func:`leaves` order, counted as ``grad_all_reduce``),
    as they are otherwise."""
    group = _data_group()
    if group is None:
        return grads
    flat = leaves(grads)
    for dtype in dict.fromkeys(g.dtype for g in flat):
        part = [g for g in flat if g.dtype == dtype]
        summed = collective("grad_all_reduce",
                             torch.cat([g.reshape(-1) for g in part]),
                             group, backward=True)
        for g, s in zip(part, summed.split([g.numel() for g in part])):
            g.copy_(s.view_as(g))
    return grads


def loss_and_grads(m, params, batch) -> tuple[torch.Tensor, Any]:
    """``m.train_loss`` and its gradient tree: ``(global loss, grads)``.

    A leaf that took no part in the loss (an expert no token reached) gets
    a zero gradient, as ``jax.grad`` gives.  Under ``batch_split`` the
    gradients are summed over the batch axes after the backward
    (:func:`sum_batch_grads`) and the loss reported is the sum of the
    ranks' shares (:func:`global_loss`).  ``params``' ``.grad`` are
    cleared.
    """
    for p in leaves(params):
        p.grad = None
    loss = m.train_loss(params, batch)
    loss.backward()
    grads = map_tree(
        lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
        params)
    for p in leaves(params):
        p.grad = None
    return global_loss(loss), sum_batch_grads(grads)


def make_train_step(
    cfg: ModelConfig,
    lr: Callable | float = 3e-4,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    grad_compress: bool = False,
    shards=None,
):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``loss.backward()`` and, under ``batch_split``, the gradients summed
    over the batch axes (:func:`loss_and_grads`), then clip by the global
    norm, then AdamW; the metrics are ``{"loss", "grad_norm"}`` (0-d
    tensors; the loss over the global batch, the norm the one before
    clipping).  ``params`` leaves must require grad; they and the
    optimizer state are updated in place and returned.  With
    ``grad_compress`` the optimizer state is ``(AdamWState,
    CompressState)`` and the clipped gradients round-trip through int8
    error feedback before AdamW.  Across ranks, ``shards``
    (:class:`repro_torch.launch.mesh.ParamShards`) splits the AdamW state
    (:func:`repro_torch.optim.adamw_update`); the compression's residual
    stays whole on every rank.
    """
    m = api(cfg)

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(m, params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        if grad_compress:
            adam_state, comp_state = opt_state
            grads, comp_state = compress_decompress(grads, comp_state)
            params, adam_state = adamw_update(grads, adam_state, params, lr,
                                              weight_decay=weight_decay,
                                              shards=shards)
            opt_state = (adam_state, comp_state)
        else:
            params, opt_state = adamw_update(grads, opt_state, params, lr,
                                             weight_decay=weight_decay,
                                             shards=shards)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def make_prefill_step(cfg: ModelConfig, max_seq: Optional[int] = None):
    """``(params, batch) -> (last-token logits, primed caches)``, without
    building the autograd graph; the caches hold ``max_seq`` positions
    (default: the prompt's length), the rank's blocks under the installed
    rules, and the logits the whole vocab (a vocab split over the model
    axis gathered: ``lm.whole_logits``)."""
    m = api(cfg)

    def step(params, batch):
        s = batch["tokens"].shape[1]
        with torch.no_grad():
            logits, caches = m.prefill(params, batch, max_seq or s)
            return whole_logits(logits, cfg.vocab), caches

    return step


def make_decode_step(cfg: ModelConfig):
    """``(params, token, caches, cache_pos) -> (logits, new caches)``,
    without building the autograd graph; the logits and caches as
    :func:`make_prefill_step`'s."""
    m = api(cfg)

    def step(params, token, caches, cache_pos):
        with torch.no_grad():
            logits, caches = m.decode_step(params, token, caches, cache_pos)
            return whole_logits(logits, cfg.vocab), caches

    return step


def make_eval_loss(cfg: ModelConfig):
    """``(params, batch) -> loss`` over the global batch, without building
    the autograd graph."""
    m = api(cfg)

    def step(params, batch):
        with torch.no_grad():
            return global_loss(m.train_loss(params, batch))

    return step
