"""The model axis of the reference's layout in the port, on the CPU.

On a ``data=2 x model=2`` mesh of 4 ``gloo`` ranks (one spawn of
``tests/_torch_shard_ranks.py``'s ``model_axis`` body, with its own time
limit) each rank of a model group holds and computes only its block of the
attention heads and the KV cache, d_ff and the vocab
(``repro_torch.sharding.head_layout``, ``model_dim``), and the values stay
the reference's on one device (its plain path, the weights carried over by
``params_from_jax``):

* smoke tt-lm (``kv_major``: 1 of 2 kv heads a rank) under the ``auto``
  and ``tt_gemm`` plans, with and without ``tt_model_reduce``; one
  ``q_block`` config (1 kv head: 2 of 4 query heads a rank) and one
  ``whole`` config (one head), each under ``auto`` with the reduce.  A
  2-lane serve engine gives the reference's greedy first tokens, and its
  prefill and decode logits are within 1e-4 x max |logit|; train step 0 on
  the split batch gives the loss and grad norm within rel 1e-4 and every
  gradient leaf within 1e-4 (rtol and atol) of ``jax.grad``; every rank
  holds the same gradients;
* each rank's cache leaves have exactly the block shapes of
  ``cache_shardings``;
* a decode step's and a train step's collectives equal the formula of
  ``PERF.md`` (section 6), ``chip_smoke.py``'s ``step_collectives``;
* one forward of the moe, hybrid and encdec smoke configs on the spawn
  (the reference's seed-0 weights) against the reference's logits within
  1e-4 x max |logit|;
* on ``meta``: the dense smoke train cell's attention-score and PV FLOPs a
  rank at ``model=2`` are exactly half those at ``model=1``.
"""

from __future__ import annotations

import functools
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api

from _torch_shard_ranks import (FAMILY_ARCHS, FAMILY_BATCH, LANE_MAX_SEQ,
                                LANE_PROMPT_LEN, MODEL_AXIS_CASES, MODEL_AXIS_CONFIGS,
                                MODEL_AXIS_PLANS, PLANS, _model_batch, family_inputs,
                                lane_prompts, model_axis_cfg, spawn)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (LayoutBlocks, Mesh, applied_cache_shardings,
                                     batch_layout, cache_shardings, describe_layout,
                                     make_rules)
from repro_torch.models import api
from repro_torch.models.config import ShapeConfig
from repro_torch.nn import attention
from repro_torch.plan import load_plan
from repro_torch.sharding import ShardingRules, head_layout, model_dim, use_rules
from repro_torch.tree import leaves

TOL = dict(rtol=1e-4, atol=1e-4)
#: time limit of the spawn, seconds (its bodies take ~25 s on one core a rank)
SPAWN_TIMEOUT_S = 150
CASES = [f"{label}:{pair}:{reduce}" for label, pair, reduce in MODEL_AXIS_CASES]
TP = 2
ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the spawn and the reference
# ---------------------------------------------------------------------------

def _ref_cfg(label: str):
    return ref_get_config("tt-lm-100m", smoke=True).with_(**MODEL_AXIS_CONFIGS[label])


@functools.lru_cache(maxsize=None)
def _ref_params(label: str):
    return ref_api(_ref_cfg(label)).init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def four(tmp_path_factory) -> list[dict]:
    weights = tmp_path_factory.mktemp("weights")
    paths = {}
    for label in MODEL_AXIS_CONFIGS:
        params = params_from_jax(jax.tree.map(np.asarray, _ref_params(label)))
        paths[label] = str(weights / f"{label}.pt")
        torch.save(params, paths[label])
    for arch in FAMILY_ARCHS:
        params = params_from_jax(jax.tree.map(np.asarray, _ref_family(arch)[0]))
        paths[arch] = str(weights / f"{arch}.pt")
        torch.save(params, paths[arch])
    return spawn("model_axis", 4, {"params": paths}, tmp_path_factory.mktemp("four"),
                 timeout=SPAWN_TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def _ref_serve(label: str):
    """The reference's greedy first tokens of both lane prompts, their
    last-token prefill logits and one decode step's logits."""
    rm = ref_api(_ref_cfg(label))
    prompts = jnp.asarray(lane_prompts(_ref_cfg(label).vocab))

    @jax.jit
    def run(params, prompts):
        logits, caches = rm.prefill_full(params, {"tokens": prompts}, LANE_MAX_SEQ)
        first = jnp.argmax(logits[:, -1], axis=-1)
        step, _ = rm.decode_step(params, first[:, None].astype(jnp.int32), caches,
                                 jnp.full((2,), LANE_PROMPT_LEN, jnp.int32))
        return first, logits[:, -1], step

    first, rows, step = run(_ref_params(label), prompts)
    return [int(t) for t in first], np.asarray(rows), np.asarray(step)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}[{i}]").items()}
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _ref_train(label: str):
    rcfg = _ref_cfg(label)
    batch = {k: jnp.asarray(v.astype(np.int32))
             for k, v in _model_batch(rcfg, "split").items()}
    loss, grads = jax.jit(jax.value_and_grad(ref_api(rcfg).train_loss))(
        _ref_params(label), batch)
    return float(loss), {k: v.numpy() for k, v in _flat(params_from_jax(
        jax.tree.map(np.asarray, grads))).items()}


def _close(got, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# serving and training against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_model_axis_serves_like_the_reference(four, case):
    first, rows, step = _ref_serve(case.split(":")[0])
    for rank in four:
        got = rank["model_axis"]["cases"][case]
        assert got["first"] == first
        _close(got["prefill"], rows)
        _close(got["decode"], step)


@pytest.mark.parametrize("case", CASES)
def test_model_axis_trains_like_the_reference(four, case):
    loss, want = _ref_train(case.split(":")[0])
    norm = math.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want.values()))
    for rank in four:
        got = rank["model_axis"]["cases"][case]
        assert got["loss"] == pytest.approx(loss, rel=1e-4)
        assert sorted(got["grads"]) == sorted(want)
        got_norm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                                 for g in got["grads"].values()))
        assert got_norm == pytest.approx(norm, rel=1e-4)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[name], **TOL, err_msg=name)
    # the model group's ranks, and the data group's, end with one gradient
    for rank in four[1:]:
        for name, g in rank["model_axis"]["cases"][case]["grads"].items():
            assert torch.equal(g, four[0]["model_axis"]["cases"][case]["grads"][name])


# ---------------------------------------------------------------------------
# the caches and the collectives
# ---------------------------------------------------------------------------

def _mesh(coords: dict) -> Mesh:
    return Mesh({"data": 2, "model": TP}, coords, {})


def _rules(cfg, shape, coords=None, reduce=False) -> ShardingRules:
    import dataclasses

    rules = make_rules(cfg, shape, _mesh(coords or {"data": 0, "model": 0}))
    return dataclasses.replace(rules, tt_model_reduce=reduce)


@pytest.mark.parametrize("case", CASES)
def test_cache_leaves_are_the_blocks_of_cache_shardings(four, case):
    """Each rank's cache leaves: the 2 lanes of the engine at 16 positions,
    split as ``cache_shardings`` (the reference's specs) splits them: the
    lanes over ``data``, the kv heads over ``model`` where they divide."""
    label = case.split(":")[0]
    cfg = model_axis_cfg(label)
    whole = api(cfg, device="meta").init_caches(2, LANE_MAX_SEQ)
    for rank in four:
        rules = _rules(cfg, ShapeConfig("t", LANE_MAX_SEQ, 2, "decode"),
                       rank["model_axis"]["coords"])
        specs = cache_shardings(cfg, whole, rules)
        # the port applies every entry of these caches' specs
        assert applied_cache_shardings(cfg, whole, rules) == specs
        want = [tuple(t.shape) for t in leaves(LayoutBlocks(specs, rules).block(whole))]
        assert all(s[:3] == (1, LANE_MAX_SEQ, cfg.n_kv_heads // TP
                             if label == "kv_major" else cfg.n_kv_heads) for s in want)
        assert rank["model_axis"]["cases"][case]["cache_shapes"] == want


def _step_collectives():
    """``chip_smoke.py``'s formula of a step's collectives (one copy, which
    the chip run holds the card's ranks to as well)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke.step_collectives


step_collectives = _step_collectives()


@pytest.mark.parametrize("case", CASES)
def test_step_collectives_equal_the_formula(four, case):
    label, pair, reduce = case.split(":")
    cfg = model_axis_cfg(label)
    serve_plan, train_plan = (load_plan(str(PLANS / f)) for f in MODEL_AXIS_PLANS[pair])
    for rank in four:
        got = rank["model_axis"]["cases"][case]
        assert got["decode_collectives"] == step_collectives(
            cfg, serve_plan, None, "decode", 2, LANE_MAX_SEQ, reduce == "True")
        assert got["train_collectives"] == step_collectives(
            cfg, train_plan, None, "train", 2, 16, reduce == "True")


def test_the_kv_major_decode_formula_at_smoke_width():
    """Smoke tt-lm under its K1 plan: without the reduce an all-gather of
    each layer's attention output and of its d_ff block, the vocab's and
    the lanes'; with it ``wd`` takes its block, and each of the 7 TT
    projections of a layer all-reduces (the tied head is the embedding's)."""
    cfg = model_axis_cfg("kv_major")
    plan = load_plan(str(PLANS / MODEL_AXIS_PLANS["auto"][0]))
    assert step_collectives(cfg, plan, None, "decode", 2, LANE_MAX_SEQ, False) == {
        "all_gather": 2 + 2 * cfg.n_layers, "all_reduce": 0, "grad_all_reduce": 0}
    assert step_collectives(cfg, plan, None, "decode", 2, LANE_MAX_SEQ, True) == {
        "all_gather": 2 + cfg.n_layers, "all_reduce": 7 * cfg.n_layers,
        "grad_all_reduce": 0}


@functools.lru_cache(maxsize=None)
def _ref_family(arch: str):
    """The reference's seed-0 weights of ``arch``'s smoke config and its
    logits on :func:`family_inputs` on one device: every position's from
    ``prefill_full`` for the causal LMs, the last position's from the
    encoder-decoder's ``prefill``."""
    rcfg = ref_get_config(arch, smoke=True)
    rm = ref_api(rcfg, plan=None)
    params = jax.jit(rm.init_params)(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v.numpy().astype(np.int32 if k == "tokens" else np.float32))
             for k, v in family_inputs(get_config(arch, smoke=True)).items()}
    run = rm.prefill if rcfg.family == "encdec" else rm.prefill_full
    logits, _ = jax.jit(lambda p, b: run(p, b, FAMILY_BATCH[1]))(params, batch)
    return params, np.asarray(logits)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_on_the_model_axis_matches_the_reference(four, arch):
    """Zamba2's shared attention, qwen2-moe's shared MLP and seamless's
    encoder and decoder attention and MLPs split over ``model`` on every
    rank: the logits within 1e-4 x max |logit| of the reference's."""
    _, want = _ref_family(arch)
    for rank in four:
        _close(rank["model_axis"]["families"][arch], want)


# ---------------------------------------------------------------------------
# the layout's decisions, without ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads,kv,tp,layout", [
    (12, 4, 2, "kv_major"),   # full-width tt-lm-100m: 2 of 4 kv heads a rank
    (4, 2, 2, "kv_major"),
    (4, 1, 2, "q_block"),
    (6, 3, 2, "q_block"),
    (3, 1, 2, "whole"),
    (4, 4, 16, "whole"),      # the smoke sweep's model=16
    (4, 2, 1, "whole"),
])
def test_head_layout(heads, kv, tp, layout):
    rules = ShardingRules(axis_sizes={"data": 2, "model": tp},
                          mesh=Mesh({"data": 2, "model": tp}, {"data": 0, "model": 0}, {}))
    with use_rules(rules):
        assert head_layout(heads, kv) == layout
    assert head_layout(heads, kv) == "whole"      # no rules: one device


def test_model_dim_follows_partition_spec():
    """d_ff splits unless SP's sequence takes the axis first; the logits'
    vocab splits under SP too (``("batch", None, "model")``), the chunked
    loss's does not where the tokens take the axis."""
    mesh = Mesh({"data": 2, "model": 2}, {"data": 0, "model": 0}, {})
    plain = ShardingRules(axis_sizes=dict(mesh.shape), mesh=mesh)
    sp = ShardingRules(axis_sizes=dict(mesh.shape), mesh=mesh, seq_axis="model")
    with use_rules(plain):
        assert model_dim((2, 16, 256), "batch", "seq", "model") == 2
        assert model_dim((2, 16, 255), "batch", "seq", "model") is None
        assert model_dim((32, 512), "tokens", "model") == 1
    with use_rules(sp):
        assert model_dim((2, 16, 256), "batch", "seq", "model") == 1   # the sequence
        assert model_dim((2, 15, 256), "batch", "seq", "model") == 2
        assert model_dim((2, 16, 512), "batch", None, "model") == 2
        assert model_dim((32, 512), "tokens", "model") is None
    with use_rules(ShardingRules(axis_sizes=dict(mesh.shape), mesh=None)):
        assert model_dim((2, 16, 256), "batch", "seq", "model") is None


@pytest.mark.parametrize("layout_name,heads,kv,tp", [
    ("q_block", 16, 2, 16),     # one query head a rank: its kv head selected
    ("q_block", 8, 2, 4),       # two a rank, both kv heads
    ("kv_major", 8, 4, 4),
    ("kv_major", 12, 4, 2),
])
def test_a_rank_attends_its_heads_as_the_whole_layer_does(layout_name, heads, kv, tp):
    """For every rank coordinate of a model axis of ``tp``: the rank's heads
    (``_local_heads`` and, under ``q_block``, the kv head each of its query
    heads reads) through the chunked attention give exactly its heads of
    the whole layer's output, in either form."""
    spec = attention.AttentionSpec("a", 32, heads, kv, 8, q_chunk=4)
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 8, n, 8)).astype(np.float32))
               for n in (heads, kv, kv))
    for grouped in (True, False):
        whole = attention._chunked_attention(q, k, v, True, 4, grouped)
        g = heads // kv
        rows = []
        for index in range(tp):
            split = (None, index, tp)
            if layout_name == "kv_major":
                ql = q.reshape(2, 8, g, kv, 8)[:, :, :, index * kv // tp:(index + 1) * kv // tp]
                kl = k[:, :, index * kv // tp:(index + 1) * kv // tp]
                vl = v[:, :, index * kv // tp:(index + 1) * kv // tp]
                out = attention._chunked_attention(ql.reshape(2, 8, -1, 8), kl, vl,
                                                   True, 4, grouped)
                rows.append(out.reshape(2, 8, g, -1, 8))
            else:
                n = heads // tp
                ql = q[:, :, index * n:(index + 1) * n]
                kl, vl = attention._kv_for_heads(spec, layout_name, split, n, k, v)
                rows.append(attention._chunked_attention(ql, kl, vl, True, 4, grouped))
        dim = 3 if layout_name == "kv_major" else 2
        got = torch.cat(rows, dim=dim).reshape(whole.shape)
        torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)


def test_layout_lines_name_the_model_split():
    cfg = model_axis_cfg("kv_major")
    full = cfg.with_(n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32_000)
    rules = batch_layout(_rules(full, ShapeConfig("t", 256, 8, "train")), 8)
    assert describe_layout(rules, 8, "sequences", full, 256) == (
        "batch split over data=2: 4 of 8 sequences a rank; heads kv_major over "
        "model=2: 2 of 4 kv heads a rank, d_ff 1024 of 2048 a rank, vocab 16000 "
        "of 32000 a rank")
    q = model_axis_cfg("q_block")
    rules = batch_layout(_rules(q, ShapeConfig("t", 16, 2, "train")), 2)
    # 1 kv head turns SP on: the sequence takes the model axis, every head,
    # d_ff and the vocab stay whole on the rank's positions
    assert describe_layout(rules, 2, "sequences", q, 16).endswith(
        "sequence 8 of 16 a rank, heads whole over model=2, d_ff whole, "
        "vocab whole")
    one = ShardingRules(axis_sizes={"data": 2, "model": 1}, mesh=_mesh({"data": 0}))
    assert "model" not in describe_layout(batch_layout(one, 2), 2, "sequences", cfg)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dryrun_attention_flops_halve_on_the_model_axis(monkeypatch):
    """Dense tt-lm-smoke's train step on the shape-only test meshes of 2
    (``data=2``) and 4 (``data=2 x model=2``) ranks, a sequence a data
    rank: the projections stay whole, so the FLOPs a rank differ by
    exactly half the attention's (scores and PV, forward and backward:
    12 B H S^2 Dh a layer at model=1), and the peak a rank falls."""
    cfg = get_config("tt-lm-100m", tt=False, smoke=True)
    shape = ShapeConfig("t", 32, 4, "train")
    out = {}
    for n in (2, 4):
        monkeypatch.setenv("REPRO_DRYRUN_DEVICES", str(n))
        mesh = dryrun.shape_mesh(test_mesh=True)
        with use_rules(batch_layout(make_rules(cfg, shape, mesh), 4)):
            out[n] = dryrun.trace_step(cfg, shape, mesh)
    attention_flops = 12 * 2 * cfg.n_heads * 32 ** 2 * cfg.hd * cfg.n_layers
    assert out[2]["flops"] - out[4]["flops"] == attention_flops // 2
    assert out[4]["memory"]["peak_bytes"] < out[2]["memory"]["peak_bytes"]
