"""Step builders: train, prefill, decode and eval (port of
``src/repro/launch/steps.py``).

PyTorch runs eagerly, so each builder returns a plain function; there is
nothing to jit.  The prefill and decode steps are the one-batch serving
form every family takes (the encoder-decoder's only one:
``examples/serve_decode_torch.py``); the continuous-batching engine of the
causal LMs lives in ``serve/engine.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import ModelConfig, api
from repro_torch.optim import adamw_update, clip_by_global_norm, compress_decompress
from repro_torch.tree import leaves, map_tree


def make_train_step(
    cfg: ModelConfig,
    lr: Callable | float = 3e-4,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    grad_compress: bool = False,
    shards=None,
):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``loss.backward()``, then clip by the global norm, then AdamW; the
    metrics are ``{"loss", "grad_norm"}`` (0-d tensors; the norm is the
    one before clipping).  ``params`` leaves must require grad; they and
    the optimizer state are updated in place and returned.  With
    ``grad_compress`` the optimizer state is ``(AdamWState,
    CompressState)`` and the clipped gradients round-trip through int8
    error feedback before AdamW.  A leaf that took no part in the loss (an
    expert no token reached) gets a zero gradient, as ``jax.grad`` gives.
    Across ranks, ``shards`` (:class:`repro_torch.launch.mesh.ParamShards`)
    splits the AdamW state (:func:`repro_torch.optim.adamw_update`); the
    compression's residual stays whole on every rank.
    """
    m = api(cfg)

    def step(params, opt_state, batch):
        for p in leaves(params):
            p.grad = None
        loss = m.train_loss(params, batch)
        loss.backward()
        grads = map_tree(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            params)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        for p in leaves(params):
            p.grad = None
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
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def make_prefill_step(cfg: ModelConfig, max_seq: Optional[int] = None):
    """``(params, batch) -> (last-token logits, primed caches)``, without
    building the autograd graph; the caches hold ``max_seq`` positions
    (default: the prompt's length)."""
    m = api(cfg)

    def step(params, batch):
        s = batch["tokens"].shape[1]
        with torch.no_grad():
            return m.prefill(params, batch, max_seq or s)

    return step


def make_decode_step(cfg: ModelConfig):
    """``(params, token, caches, cache_pos) -> (logits, new caches)``,
    without building the autograd graph."""
    m = api(cfg)

    def step(params, token, caches, cache_pos):
        with torch.no_grad():
            return m.decode_step(params, token, caches, cache_pos)

    return step


def make_eval_loss(cfg: ModelConfig):
    """``(params, batch) -> loss`` without building the autograd graph."""
    m = api(cfg)

    def step(params, batch):
        with torch.no_grad():
            return m.train_loss(params, batch)

    return step
