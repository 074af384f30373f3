"""The dry run's depth extrapolation against a direct full-depth count,
on the CPU (port-only: the reference counts its scanned model once per
scan body, so it has no full-depth count to compare).

Smoke width, ``meta`` tensors: the dense, moe, rwkv and vlm families
here, the two-number depths (the hybrid's groups, the encoder-decoder's
two stacks) in ``test_torch_dryrun_depth_stacks.py``.  The variants and
``extrapolate`` are the reference's (``test_torch_dryrun.py`` holds them
to it); here their result is held to the FLOPs of the full-depth step
counted with the variants' settings (unrolled layers, one query chunk, no
loss chunking), exactly.
"""

from __future__ import annotations

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ShapeConfig

#: one smoke arch of each family
FAMILIES = {"dense": "glm4-9b", "moe": "qwen2-moe-a2.7b", "hybrid": "zamba2-1.2b",
            "rwkv": "rwkv6-7b", "vlm": "internvl2-2b",
            "encdec": "seamless-m4t-medium"}
#: the families whose depth is one number of layers
LAYER_STACKS = ("dense", "moe", "rwkv", "vlm")
TRAIN = ShapeConfig("t", 32, 2, "train")
ONE_DEVICE = Mesh({"data": 1, "model": 1}, {"data": 0, "model": 0}, {})


def variant_base(cfg, shape):
    """The variants' settings (unrolled, one query chunk, no loss chunking)."""
    return dict(scan_layers=False, q_chunk=max(shape.seq_len, cfg.q_chunk),
                loss_chunk=0)


def count(cfg) -> float:
    return dryrun.trace_step(cfg, TRAIN, ONE_DEVICE)["flops"]


def extrapolated(cfg) -> float:
    return dryrun.extrapolate(cfg, {label: count(vcfg) for label, vcfg, _ in
                                    dryrun._cost_variants(cfg, TRAIN)})


@pytest.mark.parametrize("family", LAYER_STACKS)
def test_extrapolated_flops_equal_a_full_depth_count(family):
    """The depth variants solve exactly for homogeneous stacks: their
    extrapolation equals the full-depth step counted with the variants'
    settings."""
    cfg = get_config(FAMILIES[family], smoke=True).with_(n_layers=3)
    direct = count(cfg.with_(**variant_base(cfg, TRAIN)))
    assert direct > 0
    assert extrapolated(cfg) == direct
