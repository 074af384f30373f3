"""The paper's own benchmark models as per-layer tensor networks.

Framework-neutral copy of ``src/repro/models/vision.py`` (the port never imports
the JAX package).

ResNet-18 (CIFAR-10 / Tiny-ImageNet) and ViT-Ti/4 (CIFAR-10) are the
workloads of paper Tables 1-4 and Figs. 3/5.  For the DSE experiments we
need each layer as a contraction problem: TT-conv layers follow eq. (3)-(4)
(5 cores, im2col unfolding), TT-linear layers eq. (2).  The dense
baselines are single-GEMM networks over the same shapes.

These are *cost-model* workloads (the paper's FPGA experiments); the
trainable LM examples live in ``repro_torch.models.lm``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.tensor_network import (
    TensorNetwork,
    dense_linear_network,
    factorize,
    tt_conv_network,
    tt_linear_network,
)


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    """One network layer: TT network + dense baseline + metadata."""

    name: str
    tt_network: TensorNetwork
    dense_network: TensorNetwork
    dense_macs: int


def _conv_layer(
    name: str,
    c_in: int,
    c_out: int,
    k: int,
    h_out: int,
    w_out: int,
    batch: int,
    rank: int,
) -> LayerDesc:
    patches = h_out * w_out * batch
    in_modes = factorize(c_in, 2)
    out_modes = factorize(c_out, 2)
    # rank clipping at each TT cut (boundary full-rank bounds)
    r1 = min(rank, out_modes[0])
    r2 = min(rank, out_modes[0] * out_modes[1])
    r3 = min(rank, in_modes[1] * k * k)
    r4 = min(rank, k * k)
    tt = tt_conv_network(patches, (in_modes[0], in_modes[1]),
                         (out_modes[0], out_modes[1]), k * k, (r1, r2, r3, r4))
    dense = dense_linear_network(patches, c_in * k * k, c_out)
    return LayerDesc(name, tt, dense, patches * c_in * k * k * c_out)


def _linear_layer(name: str, d_in: int, d_out: int, tokens: int, rank: int,
                  d: int = 3) -> LayerDesc:
    in_modes = factorize(d_in, d)
    out_modes = factorize(d_out, d)
    modes = out_modes + in_modes
    ranks = []
    left, right = 1, math.prod(modes)
    for i in range(len(modes) - 1):
        left *= modes[i]
        right //= modes[i]
        ranks.append(min(rank, left, right))
    tt = tt_linear_network(tokens, in_modes, out_modes, tuple(ranks))
    dense = dense_linear_network(tokens, d_in, d_out)
    return LayerDesc(name, tt, dense, tokens * d_in * d_out)


def resnet18_layers(dataset: str = "cifar10", batch: int = 1,
                    rank: int = 16) -> list[LayerDesc]:
    """ResNet-18 conv backbone (CIFAR-style stem) as contraction problems.

    Spatial sizes: CIFAR-10 starts at 32x32, Tiny-ImageNet at 64x64.
    Downsampling at stages 2-4; two 3x3 convs per basic block.
    """
    side = {"cifar10": 32, "tiny_imagenet": 64}[dataset]
    layers: list[LayerDesc] = []
    layers.append(_conv_layer("stem", 16, 64, 3, side, side, batch, rank))
    stage_ch = [64, 128, 256, 512]
    s = side
    c_prev = 64
    for st, c in enumerate(stage_ch):
        if st > 0:
            s //= 2
        for blk in range(2):
            c_in = c_prev if blk == 0 else c
            layers.append(_conv_layer(f"s{st+1}b{blk+1}c1", c_in, c, 3, s, s, batch, rank))
            layers.append(_conv_layer(f"s{st+1}b{blk+1}c2", c, c, 3, s, s, batch, rank))
            c_prev = c
    layers.append(_linear_layer("fc", 512, 512, batch, rank, d=2))
    return layers


def vit_ti4_layers(batch: int = 1, rank: int = 16,
                   image: int = 32) -> list[LayerDesc]:
    """ViT-Ti/4 on CIFAR-10: 12 blocks, d=192, heads=3, mlp=768.

    Per block: fused QKV (192->576), attn out (192->192), MLP up/down.
    Attention itself (softmax(QK^T)V) is not a weight contraction — the
    DSE operates on weight-bearing layers, as in the paper.
    """
    tokens = (image // 4) ** 2 + 1
    t = tokens * batch
    layers: list[LayerDesc] = []
    for blk in range(12):
        layers.append(_linear_layer(f"b{blk}.qkv", 192, 576, t, rank, d=2))
        layers.append(_linear_layer(f"b{blk}.proj", 192, 192, t, rank, d=2))
        layers.append(_linear_layer(f"b{blk}.fc1", 192, 768, t, rank, d=2))
        layers.append(_linear_layer(f"b{blk}.fc2", 768, 192, t, rank, d=2))
    layers.append(_linear_layer("head", 192, 192, batch, rank, d=2))
    return layers


def model_layers(model: str, dataset: str, batch: int = 1,
                 rank: int = 16) -> list[LayerDesc]:
    if model == "resnet18":
        return resnet18_layers(dataset, batch, rank)
    if model == "vit_ti4":
        return vit_ti4_layers(batch, rank)
    raise ValueError(model)
