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


#: top-level keys whose leaves carry a leading layer axis in the reference
LAYER_STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _to_torch(tree, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_from_jax(tree: dict, device="cpu") -> dict:
    """The port's parameters from the reference's ``init_params`` tree.

    ``tree`` holds numpy leaves.  Key names stay the reference's
    (``core{k}``, ``w``, ``b``, ``table``, ``scale``; the MoE's ``router``,
    ``eu``/``eg``/``ed`` and ``shared``; the SSM's ``A_log``, ``D``,
    ``dt_bias``, ``conv_w``/``conv_b``; RWKV's mixers, LoRA and channel-mix
    leaves; the hybrid's top-level ``shared_attn``; the encoder-decoder's
    ``enc_ln_f`` and each decoder layer's ``lnx`` and ``xattn``).  The
    layer stacks (``blocks``, and the encoder-decoder's ``enc_blocks`` and
    ``dec_blocks``), stacked on a leading layer axis in the reference
    (``models/lm.py:88``, ``models/encdec.py:89-91``), become lists of
    per-layer dicts; inside a layer the experts' leaves keep their leading
    expert axis (``nn/moe.py:80``).
    """
    out = {k: _to_torch(v, device) for k, v in tree.items()
           if k not in LAYER_STACKS}

    def layer(t, i):
        if isinstance(t, dict):
            return {k: layer(v, i) for k, v in t.items()}
        return t[i]

    def n_layers(t):
        return n_layers(next(iter(t.values()))) if isinstance(t, dict) else len(t)

    for key in LAYER_STACKS:
        if key in tree:
            stacked = tree[key]
            out[key] = [_to_torch(layer(stacked, i), device)
                        for i in range(n_layers(stacked))]
    return out
