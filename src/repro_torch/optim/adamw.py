"""AdamW with decoupled weight decay; fp32 moments over any parameter dtype.

Port of ``src/repro/optim/adamw.py`` as plain functions on the port's
parameter trees, with the reference's b1/b2/eps and weight decay on every
leaf.  ``torch.optim.AdamW`` is not used: its step arithmetic is not the
reference's, and the parity tests compare loss curves.

Unlike the reference (pure functions over immutable arrays), the update
works in place: :func:`adamw_update` writes the new values into the
parameter and moment tensors it is given and returns those same tensors,
so a step allocates no second copy of the model.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, map_tree


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any               # fp32 tree like params
    v: Any               # fp32 tree like params


def adamw_init(params: Any) -> AdamWState:
    first = leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=map_tree(zeros, params),
        v=map_tree(zeros, params),
    )


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """``(grads scaled to global norm <= max_norm, the norm before)``."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    clipped = map_tree(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads)
    return clipped, norm


@torch.no_grad()
def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    lr: Callable[[torch.Tensor], torch.Tensor] | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> tuple[Any, AdamWState]:
    """Returns ``(params, state)``, both updated in place."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=step.device)
    s = step.to(torch.float32)
    b1c = 1.0 - b1 ** s
    b2c = 1.0 - b2 ** s
    for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                          leaves(params)):
        g32 = g.to(torch.float32)
        m_new = b1 * m + (1.0 - b1) * g32
        v_new = b2 * v + (1.0 - b2) * torch.square(g32)
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr_t * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
    return params, AdamWState(step=step, m=state.m, v=state.v)
