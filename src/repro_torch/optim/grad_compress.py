"""INT8 error-feedback gradient compression (port of
``src/repro/optim/grad_compress.py``).

Per-tensor symmetric int8 quantization with an error-feedback residual:
the quantization error is carried to the next step, so the compression
is unbiased over time (Seide et al. 2014, Karimireddy et al. 2019).
``compress_decompress`` simulates the wire format inside a train step:
each gradient round-trips through int8 before the optimizer, and the
fp32 residual is threaded beside the optimizer state.

"Per tensor" is per leaf of the reference's tree, whose layers are
stacked on a leading axis: the port's list of per-layer dicts
(``params["blocks"]``) shares one scale per leaf across its layers, as
the reference's stacked leaf does.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import is_layer_stack, map_tree


class CompressState(NamedTuple):
    residual: Any    # fp32 tree like grads


def compress_init(params: Any) -> CompressState:
    return CompressState(residual=map_tree(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def int8_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale fp32).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _round_trip(tree: Any) -> Any:
    """Each reference tensor of ``tree`` through int8 and back; a layer
    stack's leaves are quantized stacked (one scale per leaf)."""
    if isinstance(tree, dict):
        return {k: _round_trip(v) for k, v in tree.items()}
    if is_layer_stack(tree):
        stacked = _round_trip(map_tree(lambda *xs: torch.stack(xs), *tree))
        return type(tree)(map_tree(lambda x, i=i: x[i], stacked)
                          for i in range(len(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_round_trip(v) for v in tree)
    return int8_dequantize(*int8_quantize(tree))


@torch.no_grad()
def compress_decompress(grads: Any, state: CompressState) -> tuple[Any, CompressState]:
    """Error-feedback int8 round-trip of every gradient tensor."""
    g32 = map_tree(lambda g, r: g.to(torch.float32) + r, grads, state.residual)
    deq = _round_trip(g32)
    return (map_tree(lambda d, g: d.to(g.dtype), deq, grads),
            CompressState(residual=map_tree(torch.sub, g32, deq)))
