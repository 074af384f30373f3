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
the jitted step, before the clip.  Where SP splits a step's sequence
(``models/lm.py::seq_block``) the model takes the rank's block of the
positions itself, its loss is the rank's share of them too, and the sums
run over the batch axes and the sequence's axis (an encoder-decoder's
step splits where its frames or its tokens take the axis).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.models import ModelConfig, api
from repro_torch.models.lm import whole_logits
from repro_torch.optim import adamw_update, clip_by_global_norm, compress_decompress
from repro_torch.plan.sharded import collective, split_group
from repro_torch.sharding import get_rules
from repro_torch.tree import leaves, map_tree


def _data_group(seq: bool = False):
    """The process group of the ranks whose losses are shares of one step's
    loss: the batch axes when the installed rules split the step's batch
    over them, and the sequence's axis when ``seq`` (the model splits the
    step's sequence); None when neither."""
    rules = get_rules()
    if rules is None:
        return None
    return split_group(dataclasses.replace(rules, seq_split=seq))


def global_loss(loss: torch.Tensor, seq: bool = False) -> torch.Tensor:
    """The loss over the global batch, detached: the sum of the ranks'
    shares (one all-reduce) under ``batch_split`` or a split sequence
    (``seq``), else ``loss``."""
    group = _data_group(seq)
    loss = loss.detach()
    if group is None:
        return loss
    return collective("all_reduce", loss.clone(), group)


def sum_batch_grads(grads: Any, seq: bool = False) -> Any:
    """``grads`` summed over the group of :func:`_data_group` (in place; one
    all-reduce (SUM) a dtype, of one flat buffer in :func:`leaves` order,
    counted as ``grad_all_reduce``), as they are where there is none."""
    group = _data_group(seq)
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
    a zero gradient, as ``jax.grad`` gives.  Under ``batch_split``, and
    where SP splits the step's sequence (``m.seq_split``), the gradients
    are summed over the batch axes and the sequence's axis after the
    backward (:func:`sum_batch_grads`) and the loss reported is the sum of
    the ranks' shares (:func:`global_loss`).  ``params``' ``.grad`` are
    cleared.
    """
    seq = m.seq_split(batch)
    for p in leaves(params):
        p.grad = None
    loss = m.train_loss(params, batch)
    loss.backward()
    grads = map_tree(
        lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
        params)
    for p in leaves(params):
        p.grad = None
    return global_loss(loss, seq), sum_batch_grads(grads, seq)


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
    axis gathered: ``lm.whole_logits``) at the prompt's last position (under
    SP the rank that holds it sends it: ``lm.prefill``)."""
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
    :func:`make_prefill_step`'s.  Caches split over their positions
    (SP) are read under rules that say so (``lm.cache_rules``)."""
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
            return global_loss(m.train_loss(params, batch), m.seq_split(batch))

    return step
