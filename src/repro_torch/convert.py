"""Carry the reference's parameters across to the port.

The reference initialises with ``jax.random``, which torch cannot replay,
so the parity tests build weights with the JAX package's ``init_params``,
turn every leaf into a numpy array, and hand the tree to
:func:`params_from_jax`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_torch(tree, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_from_jax(tree: dict, device="cpu") -> dict:
    """The port's parameters from the reference's ``init_params`` tree.

    ``tree`` holds numpy leaves.  Key names (``core{k}``, ``w``, ``b``,
    ``table``, ``scale``) stay as they are; the blocks, stacked on a
    leading layer axis in the reference (``models/lm.py:88``), become a
    list of per-layer dicts.
    """
    out = {k: _to_torch(v, device) for k, v in tree.items() if k != "blocks"}
    stacked = tree["blocks"]

    def layer(t, i):
        if isinstance(t, dict):
            return {k: layer(v, i) for k, v in t.items()}
        return t[i]

    def n_layers(t):
        return n_layers(next(iter(t.values()))) if isinstance(t, dict) else len(t)

    out["blocks"] = [_to_torch(layer(stacked, i), device)
                     for i in range(n_layers(stacked))]
    return out
