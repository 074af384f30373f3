"""The port's sharding rules, mesh policy and shard decisions against the
reference, on the CPU (no process group: the multi-rank runs are in
``tests/test_torch_shard_exec.py``).

Framework-neutral code is held by exact equality: ``ShardingRules``'s
resolution, ``partition_spec`` (its tuple of entries makes the
reference's ``PartitionSpec``), ``shard_decision`` / ``describe``,
``make_test_mesh``'s axis sizes, ``sp_enabled`` and ``make_rules``.  The
reference's decisions only test ``rules.mesh is None``, so a stand-in mesh
object serves both packages.  Attention's form switch (repeated-KV flat
heads when the model axis does not divide the group size) is held against
the reference's attention under rules at fp32 1e-5; the reference runs
under rules on a one-device ``jax`` mesh whose axis sizes the rules
overstate (``model=2``), which changes its form and none of its values.
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import repro.launch.mesh as ref_mesh
from repro.configs import get_config as ref_get_config
from repro.models.blocks import attn_spec as ref_attn_spec
from repro.models.config import SHAPES as REF_SHAPES
from repro.nn import attention as ref_attention
from repro.nn import install_plan as ref_install_plan
from repro.plan.sharded import ShardDecision as RefShardDecision
from repro.plan.sharded import shard_decision as ref_shard_decision
from repro.sharding import ShardingRules as RefRules
from repro.sharding import use_rules as ref_use_rules
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh
from repro_torch.models.blocks import attn_spec
from repro_torch.models.config import SHAPES
from repro_torch.nn import attention, install_plan
from repro_torch.plan import ShardDecision, shard_decision
from repro_torch.sharding import (ShardingRules, get_rules, set_rules, shard,
                                  use_rules)

AXIS_SIZES = [
    {"data": 1, "model": 1}, {"data": 2, "model": 1}, {"data": 4, "model": 2},
    {"data": 2, "model": 2}, {"data": 8, "model": 1}, {"data": 1, "model": 4},
    {"pod": 2, "data": 4, "model": 2}, {"pod": 2, "data": 1, "model": 16},
]
FIELDS = [  # (batch_axes, model_axis, seq_axis)
    (("data",), "model", None), (("data",), "model", "model"),
    (("pod", "data"), "model", None), (("pod", "data"), "model", "model"),
    (("data",), None, None),
]
LOGICAL = ["batch", "seq", "model", "tokens", None]


def _pair(axis_sizes, fields, reduce=False, mesh_obj="stand-in"):
    batch, model, seq = fields
    kw = dict(axis_sizes=dict(axis_sizes), batch_axes=batch, model_axis=model,
              seq_axis=seq, mesh=mesh_obj, tt_model_reduce=reduce)
    return ShardingRules(**kw), RefRules(**kw)


@pytest.mark.parametrize("axis_sizes", AXIS_SIZES)
@pytest.mark.parametrize("fields", FIELDS)
def test_resolution_matches_reference(axis_sizes, fields):
    port, ref = _pair(axis_sizes, fields)
    for logical in LOGICAL:
        assert port.resolve(logical) == ref.resolve(logical)
    for tokens in (1, 2, 3, 4, 6, 8, 12, 16, 32, 64, 100):
        assert port.token_shard_axes(tokens) == ref.token_shard_axes(tokens)
        assert port.n_token_shards(tokens) == ref.n_token_shards(tokens)
    with pytest.raises(ValueError):
        port.resolve("heads")


@pytest.mark.parametrize("axis_sizes", AXIS_SIZES)
@pytest.mark.parametrize("fields", FIELDS)
def test_partition_spec_matches_reference(axis_sizes, fields):
    port, ref = _pair(axis_sizes, fields)
    shapes = [(8, 16, 4), (3, 32, 2), (16, 6, 8), (64, 8)]
    for shape in shapes:
        for names in itertools.product(LOGICAL, repeat=len(shape)):
            got = port.partition_spec(shape, names)
            # the reference's entries, as its PartitionSpec holds them (this
            # jax stores a one-axis "tokens" tuple as the bare axis name)
            assert PartitionSpec(*got) == ref.partition_spec(shape, names)
            assert len(got) == len(shape)


def test_rules_install_and_shard_checks_rank():
    x = torch.ones(2, 3)
    assert get_rules() is None
    assert shard(x, "batch") is x  # no rules: no check, as the reference
    rules, _ = _pair({"data": 2, "model": 1}, FIELDS[0])
    with use_rules(rules):
        assert get_rules() is rules
        assert shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="rank-2"):
            shard(x, "batch")
        with use_rules(None):
            assert get_rules() is None
        assert get_rules() is rules
    assert get_rules() is None
    set_rules(rules)
    set_rules(None)
    assert get_rules() is None


# ---------------------------------------------------------------------------
# shard_decision: the reference's own cases, then a grid
# ---------------------------------------------------------------------------

def _rules(axis_sizes, *, mesh_obj="not-none", seq_axis=None, reduce=False):
    return ShardingRules(axis_sizes=dict(axis_sizes), mesh=mesh_obj,
                         seq_axis=seq_axis, tt_model_reduce=reduce)


def test_no_rules_or_no_mesh_declines():
    assert shard_decision(None, 64, (8, 8)) is None
    assert shard_decision(_rules({"data": 4, "model": 2}, mesh_obj=None),
                          64, (8, 8)) is None


def test_token_dp_decision():
    rules = _rules({"data": 4, "model": 2})
    d = shard_decision(rules, 64, (8, 8))
    assert d == ShardDecision(("data",), 4)
    assert d.describe(rules.axis_sizes, "model") == "data=4"
    assert shard_decision(rules, 3, (8, 8)) is None


def test_sp_axis_joins_token_shards():
    d = shard_decision(_rules({"data": 4, "model": 2}, seq_axis="model"),
                       64, (8, 8))
    assert d is not None and d.axes == ("data", "model") and d.n_shards == 8


def test_model_reduce_is_opt_in():
    d = shard_decision(_rules({"data": 4, "model": 2}), 64, (8, 8))
    assert d is not None and not d.model_reduce
    d = shard_decision(_rules({"data": 4, "model": 2}, reduce=True), 64, (8, 8))
    assert d is not None and d.model_reduce and d.tp == 2
    assert d.describe({"data": 4, "model": 2}, "model") == \
        "data=4+reduce(model=2)"
    d = shard_decision(_rules({"data": 4, "model": 2}, reduce=True), 64, (7, 8))
    assert d is not None and not d.model_reduce
    # model reduction alone when the tokens do not divide
    d = shard_decision(_rules({"data": 4, "model": 2}, reduce=True), 3, (8, 8))
    assert d == ShardDecision((), 1, True, 2)
    assert d.describe({"data": 4, "model": 2}, "model") == "reduce(model=2)"


def test_single_axis_mesh_replicated_model():
    d = shard_decision(_rules({"data": 8, "model": 1}), 64, (8, 8))
    assert d is not None and d.axes == ("data",) and d.n_shards == 8


@pytest.mark.parametrize("axis_sizes", AXIS_SIZES)
@pytest.mark.parametrize("fields", FIELDS)
@pytest.mark.parametrize("reduce", [False, True])
def test_shard_decision_matches_reference(axis_sizes, fields, reduce):
    port, ref = _pair(axis_sizes, fields, reduce)
    for tokens, in_modes in itertools.product(
            (1, 2, 3, 4, 8, 12, 64), ((8, 8), (7, 8), (12, 8, 8), (2,), ())):
        got = shard_decision(port, tokens, in_modes)
        want = ref_shard_decision(ref, tokens, in_modes)
        if want is None:
            assert got is None
            continue
        assert (got.axes, got.n_shards, got.model_reduce, got.tp) == (
            want.axes, want.n_shards, want.model_reduce, want.tp)
        assert got.describe(port.axis_sizes, port.model_axis) == want.describe(
            ref.axis_sizes, ref.model_axis)
    assert isinstance(RefShardDecision(("data",), 2), RefShardDecision)


# ---------------------------------------------------------------------------
# the mesh and the policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_test_mesh_axis_sizes_match_reference(multi_pod, monkeypatch):
    monkeypatch.setattr(ref_mesh, "_mesh", lambda shape, axes: (shape, axes))
    for n in range(1, 17):
        assert mesh.small_mesh_shape(n, multi_pod) == \
            ref_mesh.make_test_mesh(n, multi_pod), n
    assert ref_mesh.make_production_mesh() == ((16, 16), ("data", "model"))


def test_one_process_mesh_is_the_one_device_mesh():
    m = mesh.make_test_mesh()
    assert m.shape == {"data": 1, "model": 1}
    assert m.coords == {"data": 0, "model": 0} and m.groups == {}
    assert m.index(("data", "model")) == 0
    with pytest.raises(ValueError, match="256 ranks"):
        mesh.make_production_mesh()


class _StandInMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sp_enabled_and_make_rules_match_reference(arch):
    for smoke in (False, True):
        cfg, rcfg = get_config(arch, smoke=smoke), ref_get_config(arch, smoke=smoke)
        for name, shape in SHAPES.items():
            rshape = REF_SHAPES[name]
            for tp, dp in itertools.product((1, 2, 3, 4, 16), (1, 2, 16)):
                assert mesh.sp_enabled(cfg, shape, tp, dp) == \
                    ref_mesh.sp_enabled(rcfg, rshape, tp, dp), (name, tp, dp)
                assert mesh._decode_cache_gib(cfg, shape, dp) == \
                    ref_mesh._decode_cache_gib(rcfg, rshape, dp)
            for sizes in AXIS_SIZES:
                m = _StandInMesh(sizes)
                got = mesh.make_rules(cfg, shape, m)
                want = ref_mesh.make_rules(rcfg, rshape, m)
                assert (got.axis_sizes, got.batch_axes, got.model_axis,
                        got.seq_axis, got.tt_model_reduce) == (
                    want.axis_sizes, want.batch_axes, want.model_axis,
                    want.seq_axis, want.tt_model_reduce), (name, sizes)
                assert got.mesh is m


# ---------------------------------------------------------------------------
# attention's form under rules
# ---------------------------------------------------------------------------

def _attention_pair(n_heads: int, n_kv: int):
    rcfg = ref_get_config("tt-lm-100m", smoke=True).with_(
        n_heads=n_heads, n_kv_heads=n_kv)
    cfg = get_config("tt-lm-100m", smoke=True).with_(
        n_heads=n_heads, n_kv_heads=n_kv)
    ref_install_plan(None)
    install_plan(None)
    rspec, spec = ref_attn_spec(rcfg), attn_spec(cfg)
    rparams = ref_attention.attention_init(jax.random.PRNGKey(4), rspec)
    params = params_from_jax({"blocks": jax.tree.map(
        lambda a: np.asarray(a)[None], rparams)})["blocks"][0]
    return rspec, spec, rparams, params


def _ref_rules(model: int) -> RefRules:
    one = ref_mesh._mesh((1, 1), ("data", "model"))  # Auto axes
    return RefRules(axis_sizes={"data": 1, "model": model}, mesh=one)


@pytest.mark.parametrize("heads,kv,tp,form", [
    (6, 2, 2, "repeated"),   # g = 3 on a 2-way model axis, as tt-lm-100m's 12/4
    (12, 4, 2, "repeated"),
    (8, 2, 2, "grouped"),    # g = 4 divides the model axis
    (6, 2, 1, "grouped"),
])
def test_attention_form_under_rules_matches_reference(heads, kv, tp, form):
    rspec, spec, rparams, params = _attention_pair(heads, kv)
    x = np.random.default_rng(8).normal(size=(2, 40, spec.d_model)).astype(np.float32)
    with ref_use_rules(_ref_rules(tp)):
        want, _ = ref_attention.attention_apply(rspec, rparams, jnp.asarray(x))
    rules = ShardingRules(axis_sizes={"data": 1, "model": tp}, mesh="stand-in")
    calls = []
    real = attention._repeat_kv

    def spy(t, n_rep):
        calls.append(n_rep)
        return real(t, n_rep)

    attention._repeat_kv = spy
    try:
        with use_rules(rules):
            got, _ = attention.attention_apply(spec, params, torch.from_numpy(x))
        plain, _ = attention.attention_apply(spec, params, torch.from_numpy(x))
    finally:
        attention._repeat_kv = real
    assert bool(calls) == (form == "repeated")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # either form computes the same function
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-6)


def test_repeat_kv_interleaves_like_the_reference():
    x = np.random.default_rng(2).normal(size=(2, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        attention._repeat_kv(torch.from_numpy(x), 3).numpy(),
        np.asarray(ref_attention._repeat_kv(jnp.asarray(x), 3)))
    assert attention._repeat_kv(torch.from_numpy(x), 1).shape == x.shape
