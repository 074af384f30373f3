"""Step builders: train and eval (port of part of ``src/repro/launch/steps.py``).

PyTorch runs eagerly, so each builder returns a plain function; there is
nothing to jit.  The serving steps live in ``serve/engine.py``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import ModelConfig, api
from repro_torch.optim import adamw_update, clip_by_global_norm
from repro_torch.tree import leaves, map_tree


def make_train_step(
    cfg: ModelConfig,
    lr: Callable | float = 3e-4,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``loss.backward()``, then clip by the global norm, then AdamW; the
    metrics are ``{"loss", "grad_norm"}`` (0-d tensors; the norm is the
    one before clipping).  ``params`` leaves must require grad; they and
    the optimizer state are updated in place and returned.
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
        params, opt_state = adamw_update(grads, opt_state, params, lr,
                                         weight_decay=weight_decay)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def make_eval_loss(cfg: ModelConfig):
    """``(params, batch) -> loss`` without building the autograd graph."""
    m = api(cfg)

    def step(params, batch):
        with torch.no_grad():
            return m.train_loss(params, batch)

    return step
