"""AdamW with decoupled weight decay; fp32 moments over any parameter dtype.

Port of ``src/repro/optim/adamw.py`` as plain functions on the port's
parameter trees, with the reference's b1/b2/eps and weight decay on every
leaf.  ``torch.optim.AdamW`` is not used: its step arithmetic is not the
reference's, and the parity tests compare loss curves.

Unlike the reference (pure functions over immutable arrays), the update
works in place: :func:`adamw_update` writes the new values into the
parameter and moment tensors it is given and returns those same tensors,
so a step allocates no second copy of the model.

Across ranks (``shards``, a :class:`repro_torch.launch.mesh.ParamShards`),
the moments of a leaf that ``param_shardings`` splits hold only this
rank's block of it: the rank updates that block of the parameter and
all-gathers it back whole (every rank computes with whole parameters).
AdamW is elementwise, so the result is the unsplit update's, bit for bit.
Leaves the specs replicate keep whole moments on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, map_indexed, map_tree


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any               # fp32 tree like params
    v: Any               # fp32 tree like params


def adamw_init(params: Any, shards=None) -> AdamWState:
    """Zero moments: whole leaves, or this rank's blocks under ``shards``."""
    first = leaves(params)[0]

    def zeros(i, p):
        shape = (shards.block_shape(i) if shards is not None and shards.split(i)
                 else p.shape)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=map_indexed(zeros, params),
        v=map_indexed(zeros, params),
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
    shards=None,
) -> tuple[Any, AdamWState]:
    """Returns ``(params, state)``, both updated in place; under ``shards``
    each split leaf's block is updated here and gathered back whole."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=step.device)
    s = step.to(torch.float32)
    b1c = 1.0 - b1 ** s
    b2c = 1.0 - b2 ** s
    for i, (g, m, v, whole) in enumerate(zip(
            leaves(grads), leaves(state.m), leaves(state.v), leaves(params))):
        split = shards is not None and shards.split(i)
        p = shards.block(i, whole) if split else whole
        g32 = (shards.block(i, g) if split else g).to(torch.float32)
        m_new = b1 * m + (1.0 - b1) * g32
        v_new = b2 * v + (1.0 - b2) * torch.square(g32)
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(torch.float32)
        new = (p.to(torch.float32) - lr_t * delta).to(p.dtype)
        whole.copy_(shards.gather(i, new) if split else new)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, AdamWState(step=step, m=state.m, v=state.v)
