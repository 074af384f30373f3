"""What the dry run's ``meta`` trace counts, against the same step on
real CPU tensors (port-only), at smoke width and small shapes: the FLOPs
(``FlopCounterMode`` over the whole step, backward included) and the
argument bytes, one arch of each family; and the AdamW state a rank keeps
on a mesh, with the all-gathers of its split leaves.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, _param_pspec
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.models import api, input_specs
from repro_torch.models.config import ShapeConfig
from repro_torch.nn import moe
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves

torch.set_num_threads(2)

#: one smoke arch of each family
FAMILIES = {"dense": "glm4-9b", "moe": "qwen2-moe-a2.7b", "hybrid": "zamba2-1.2b",
            "rwkv": "rwkv6-7b", "vlm": "internvl2-2b",
            "encdec": "seamless-m4t-medium"}
TRAIN = ShapeConfig("t", 32, 2, "train")
PREFILL = ShapeConfig("p", 32, 2, "prefill")
DECODE = ShapeConfig("d", 32, 2, "decode")
#: the MoE's train batch: with these tokens every expert of every layer
#: gets a token (checked in ``test_meta_counts_equal_the_cpu_steps``)
MOE_TRAIN = ShapeConfig("t", 32, 8, "train")
ONE_DEVICE = Mesh({"data": 1, "model": 1}, {"data": 0, "model": 0}, {})


def _real_inputs(cfg, shape, rng) -> dict:
    """CPU tensors of the step's input specs, from ``rng``."""
    specs = input_specs(cfg, shape)
    if shape.step == "decode":
        return {"token": torch.from_numpy(rng.integers(
                    0, cfg.vocab, tuple(specs["token"].shape))).to(torch.int32),
                "cache_pos": torch.zeros((), dtype=torch.int32),
                "caches": api(cfg, device="cpu").init_caches(
                    shape.global_batch, shape.seq_len)}
    out = {}
    for k, spec in specs.items():
        if spec.dtype.is_floating_point:
            out[k] = torch.from_numpy(rng.normal(size=tuple(spec.shape))).to(spec.dtype)
        else:
            out[k] = torch.from_numpy(rng.integers(
                0, cfg.vocab, tuple(spec.shape))).to(spec.dtype)
    return out


def _cpu_step(cfg, shape, rng):
    """(params, opt or None, inputs, step function) on the CPU."""
    params = api(cfg, device="cpu").init_params(0)
    batch = _real_inputs(cfg, shape, rng)
    if shape.step == "train":
        for p in leaves(params):
            p.requires_grad_(True)
        opt = adamw_init(params)
        step = make_train_step(cfg)
        return params, opt, batch, lambda: step(params, opt, batch)
    if shape.step == "prefill":
        step = make_prefill_step(cfg, max_seq=shape.seq_len)
        return params, None, batch, lambda: step(params, batch)
    step = make_decode_step(cfg)
    return params, None, batch, lambda: step(params, batch["token"], batch["caches"],
                                             batch["cache_pos"])


CPU_CASES = [(f, MOE_TRAIN if f == "moe" else TRAIN) for f in FAMILIES] + [
    ("dense", PREFILL), ("dense", DECODE), ("hybrid", PREFILL),
    ("hybrid", DECODE), ("rwkv", DECODE), ("encdec", PREFILL)]


@pytest.mark.parametrize("family,shape", CPU_CASES,
                         ids=[f"{f}-{s.step}" for f, s in CPU_CASES])
def test_meta_counts_equal_the_cpu_steps(family, shape, monkeypatch):
    """The ``meta`` trace's FLOPs are the CPU step's, exactly, and its
    argument bytes are the CPU tree's (parameters, AdamW state, inputs)."""
    cfg = get_config(FAMILIES[family], smoke=True)
    active = []
    experts_ffn = moe._experts_ffn

    def recorded(spec, params, x, act):
        active.append(list(act))
        return experts_ffn(spec, params, x, act)

    monkeypatch.setattr(moe, "_experts_ffn", recorded)
    params, opt, batch, step = _cpu_step(cfg, shape, np.random.default_rng(0))
    with FlopCounterMode(display=False) as fc:
        step()
    if family == "moe":   # these tokens reach every expert in every layer
        assert active and all(a == list(range(cfg.moe_experts)) for a in active)
    got = dryrun.trace_step(cfg, shape, ONE_DEVICE)
    assert got["flops"] > 0
    assert got["flops"] == fc.get_total_flops()

    tree = [params, opt, batch] if opt is not None else [params, batch]
    want = sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))
    mem = got["memory"]
    assert mem["argument_bytes"] == want
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["output_bytes"] > want
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert mem["alias_bytes"] == 0


def test_split_adamw_state_and_its_gathers():
    """On a data=2 x model=2 mesh a train step keeps this rank's block of
    each moment the specs split and all-gathers each split leaf whole:
    the argument bytes lose 3/4 of those moments, and the all-gather
    bytes are the split leaves' whole bytes."""
    # a vocabulary whose embedding is large enough to split
    cfg = get_config("glm4-9b", tt=False, smoke=True).with_(vocab=4096)
    mesh = Mesh({"data": 2, "model": 2}, {"data": 0, "model": 0}, {})
    params = api(cfg, device="meta").init_params(0)
    split = [p for p in leaves(params) if any(
        e is not None for e in _param_pspec(tuple(p.shape), dict(mesh.shape)))]
    assert split
    whole = dryrun.trace_step(cfg, TRAIN, ONE_DEVICE)
    sharded = dryrun.trace_step(cfg, TRAIN, mesh)
    split_bytes = sum(p.numel() * p.element_size() for p in split)
    moments = 2 * sum(p.numel() * 4 for p in split)
    assert whole["memory"]["argument_bytes"] - sharded["memory"]["argument_bytes"] \
        == moments - moments // 4
    assert sharded["collectives"]["all-gather"] == split_bytes
    assert sharded["collectives"]["total"] == split_bytes
    assert whole["collectives"]["total"] == 0
    assert sharded["flops"] == whole["flops"]
