"""The SP sequence split of the reference's layout in the port, on the CPU.

On a ``data=1 x model=4`` mesh of 4 ``gloo`` ranks (one spawn of
``tests/_torch_shard_ranks.py``'s ``seq_parallel`` body, with its own time
limit) ``make_rules`` turns SP on for chatglm3-smoke (dense), grok-smoke
(MoE) and internvl2-smoke (VLM): their 2 kv heads do not divide the
model axis.  Each rank then holds its block of the positions (after the
VLM's image prefix: rank 0 holds prefix rows alone), attention gathers K
and V, every head, d_ff and the vocab stay whole, and the values stay the
reference's on one device (its plain path on its seed-0 weights, carried
over by ``params_from_jax``), each config under its smoke K1 plans:

* the prefill logits of every position within 1e-4 x max |logit|, and
  each planned record at the rank's rows (``model=4``);
* train step 0 gives the loss and grad norm within rel 1e-4 and every
  gradient leaf within 1e-4 (rtol and atol) of the reference's unsharded
  ``jax.grad``, the same on every rank; chatglm3's under ``remat="full"``
  is the same bit for bit, its recompute gathering K and V again;
* two lanes served under the policy of a decode cell that splits the KV
  cache's positions: each rank's cache is its quarter of the positions,
  the greedy first tokens are the reference's, the prefill and decode
  logits within 1e-4 x max |logit| of its one device;
* the prefill's, the decode step's and step 0's collectives equal
  ``chip_smoke.py``'s ``step_collectives``.

Without ranks: ``make_rules`` and the input and cache specs of every
arch on ``data=1 x model=4`` against the reference's; the policy and the
cache specs of full-width chatglm3-6b there (the 28-layer config's 16 x
32 768 decode cell turns SP on, 14.0 GiB of cache a device); the dry
run's dense smoke train cell traces a quarter of one device's FLOPs
exactly, and its SP decode cell a quarter of the KV cache's bytes.
"""

from __future__ import annotations

import contextlib
import functools
import io
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api

from _torch_shard_ranks import (LANE_MAX_SEQ, LANE_PROMPT_LEN, SP_ARCHS, SP_BATCH,
                                SP_DECODE_CELL, lane_prompts, sp_batch, spawn)
from test_torch_batch_layout import ARCHS as BATCH_ARCHS
from test_torch_batch_layout import _cache_names, _port_named, _ref_specs
from test_torch_model_axis import TOL, _close, _flat, step_collectives
from repro_torch import dse_cli
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (LayoutBlocks, Mesh, _decode_cache_gib,
                                     applied_cache_shardings, batch_layout,
                                     batch_shardings, cache_shardings, describe_layout,
                                     make_rules)
from repro_torch.models import api, decode_cache_len, input_specs, shape_applicable
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.plan import load_plan
from repro_torch.sharding import kv_layout, splits_sequence, use_rules
from repro_torch.tree import leaves

#: time limit of the spawn, seconds (its body takes ~15 s on one core a rank)
SPAWN_TIMEOUT_S = 150
TP = 4
MESH = (1, TP)


def _mesh(coords=None) -> Mesh:
    return Mesh({"data": 1, "model": TP}, coords or {"data": 0, "model": 0}, {})


# ---------------------------------------------------------------------------
# the spawn and the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return jax.jit(ref_api(ref_get_config(arch, smoke=True), plan=None).init_params)(
        jax.random.PRNGKey(0))


def _emit_plans(arch: str, prefix: str) -> dict:
    """The smoke config's K1 serving pair (2 slots) and train plan."""
    with contextlib.redirect_stdout(io.StringIO()):
        assert dse_cli.main(["--arch", arch, "--smoke", "--top-k", "2", "--tokens", "16",
                             "--serve-slots", "2", "--plan-backend", "streaming_tt",
                             "--emit-plan-pair", prefix, "--out", os.devnull]) == 0
        assert dse_cli.main(["--arch", arch, "--smoke", "--mode", "train", "--top-k", "2",
                             "--tokens", "32", "--plan-backend", "streaming_tt",
                             "--emit-plan", f"{prefix}.train.json",
                             "--out", os.devnull]) == 0
    return {k: f"{prefix}.{k}.json" for k in ("prefill", "decode", "train")}


@pytest.fixture(scope="module")
def plans(tmp_path_factory) -> dict:
    out = tmp_path_factory.mktemp("plans")
    return {arch: _emit_plans(arch, str(out / arch)) for arch in SP_ARCHS}


@pytest.fixture(scope="module")
def four(plans, tmp_path_factory) -> list[dict]:
    weights = tmp_path_factory.mktemp("weights")
    paths = {}
    for arch in SP_ARCHS:
        paths[arch] = str(weights / f"{arch}.pt")
        torch.save(params_from_jax(jax.tree.map(np.asarray, _ref_params(arch))),
                   paths[arch])
    return spawn("seq_parallel", 4, {"params": paths, "plans": plans},
                 tmp_path_factory.mktemp("four"), timeout=SPAWN_TIMEOUT_S)


def _ref_batch(arch: str, labels: bool) -> dict:
    batch = sp_batch(get_config(arch, smoke=True))
    if not labels:
        batch.pop("labels")
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_forward(arch: str) -> np.ndarray:
    rcfg = ref_get_config(arch, smoke=True)
    rm = ref_api(rcfg, plan=None)
    extra = rcfg.n_frontend_tokens if rcfg.family == "vlm" else 0
    logits, _ = jax.jit(lambda p, b: rm.prefill_full(p, b, SP_BATCH[1] + extra))(
        _ref_params(arch), _ref_batch(arch, False))
    return np.asarray(logits)


@functools.lru_cache(maxsize=None)
def _ref_train(arch: str):
    rm = ref_api(ref_get_config(arch, smoke=True), plan=None)
    loss, grads = jax.jit(jax.value_and_grad(rm.train_loss))(
        _ref_params(arch), _ref_batch(arch, True))
    return float(loss), {k: v.numpy() for k, v in _flat(params_from_jax(
        jax.tree.map(np.asarray, grads))).items()}


@functools.lru_cache(maxsize=None)
def _ref_serve(arch: str):
    """The reference's greedy first tokens of both lane prompts, their
    last-token prefill logits and one decode step's logits, each prompt
    prefilled alone at batch 1 as the serve engine prefills it (the MoE's
    router groups are the batch's tokens) and the caches stacked along
    the lanes."""
    rcfg = ref_get_config(arch, smoke=True)
    rm = ref_api(rcfg, plan=None)

    @jax.jit
    def run(params, prompts):
        lanes = [rm.prefill_full(params, {"tokens": prompts[i:i + 1]}, LANE_MAX_SEQ)
                 for i in range(prompts.shape[0])]
        rows = jnp.concatenate([logits[:, -1] for logits, _ in lanes])
        caches = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1),
                              *(c for _, c in lanes))
        first = jnp.argmax(rows, axis=-1)
        step, _ = rm.decode_step(params, first[:, None].astype(jnp.int32), caches,
                                 jnp.full((2,), LANE_PROMPT_LEN, jnp.int32))
        return first, rows, step

    first, rows, step = run(_ref_params(arch), jnp.asarray(lane_prompts(rcfg.vocab)))
    return [int(t) for t in first], np.asarray(rows), np.asarray(step)


# ---------------------------------------------------------------------------
# forward, step 0 and serving against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SP_ARCHS)
def test_sequence_split_forward_matches_the_reference(four, arch):
    """Every rank's gathered prefill logits (every text position) against
    the reference's; each planned record ran on the rank's rows, with the
    mesh named: a quarter of the positions (the experts at their capacity
    slots of the rank's groups)."""
    want = _ref_forward(arch)
    cfg = get_config(arch, smoke=True)
    prefix = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    rows = SP_BATCH[0] * (SP_BATCH[1] + prefix) // TP
    for rank in four:
        got = rank["seq_parallel"]["cases"][arch]
        _close(got["forward"], want)
        assert got["records"] and {m for _, m, _ in got["records"]} == {f"model={TP}"}
        assert {shape[0] for name, _, shape in got["records"]
                if not name.startswith("moe.e")} == {rows}


@pytest.mark.parametrize("arch", SP_ARCHS)
def test_sequence_split_step0_matches_the_reference(four, arch):
    loss, want = _ref_train(arch)
    norm = math.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want.values()))
    for rank in four:
        got = rank["seq_parallel"]["cases"][arch]
        assert got["loss"] == pytest.approx(loss, rel=1e-4)
        assert sorted(got["grads"]) == sorted(want)
        got_norm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                                 for g in got["grads"].values()))
        assert got_norm == pytest.approx(norm, rel=1e-4)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[name], **TOL, err_msg=name)
    # the gradients summed over the sequence's axis: one tree on every rank
    for rank in four[1:]:
        for name, g in rank["seq_parallel"]["cases"][arch]["grads"].items():
            assert torch.equal(g, four[0]["seq_parallel"]["cases"][arch]["grads"][name])


def test_a_remat_step_recomputes_the_gathers_and_changes_no_bit(four, plans):
    """chatglm3-smoke's step 0 under ``remat="full"`` on the ranks: every
    block's recompute gathers K and V again (counted forward, as the
    formula says), and the loss and every gradient leaf equal the
    remat-free step's bit for bit."""
    cfg = get_config("chatglm3-6b", smoke=True).with_(remat="full")
    want = step_collectives(cfg, load_plan(plans["chatglm3-6b"]["train"]), None,
                            "train", *SP_BATCH, False, mesh=MESH)
    assert want["fwd"]["all_gather"] == 2 * cfg.n_layers
    for rank in four:
        case = rank["seq_parallel"]["cases"]["chatglm3-6b"]
        assert case["remat"]["collectives"] == want
        assert case["remat"]["loss"] == case["loss"]
        for name, g in case["remat"]["grads"].items():
            assert torch.equal(g, case["grads"][name]), name


@pytest.mark.parametrize("arch", SP_ARCHS)
def test_decode_over_a_sequence_split_cache_matches_one_device(four, arch):
    """Two lanes over a KV cache whose positions split over ``model``: each
    rank holds a quarter of every layer's positions, and the tokens and
    logits are the reference's on one device."""
    first, rows, step = _ref_serve(arch)
    cfg = get_config(arch, smoke=True)
    block = (2, LANE_MAX_SEQ // TP, cfg.n_kv_heads, cfg.hd)
    for rank in four:
        got = rank["seq_parallel"]["cases"][arch]
        assert got["cache_shapes"] == [block] * (2 * cfg.n_layers)
        assert got["first"] == first
        _close(got["prefill"], rows)
        _close(got["decode"], step)


@pytest.mark.parametrize("arch", SP_ARCHS)
def test_sequence_split_collectives_equal_the_formula(four, arch, plans):
    cfg = get_config(arch, smoke=True)
    pre, dec, train = (load_plan(plans[arch][k]) for k in ("prefill", "decode", "train"))
    b, s = SP_BATCH
    prefix = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    cell = ShapeConfig("t", *SP_DECODE_CELL, "decode")
    want = {
        "prefill_collectives": step_collectives(cfg, pre, None, "prefill", b, s, False,
                                                frames=prefix, mesh=MESH),
        "train_collectives": step_collectives(cfg, train, None, "train", b, s, False,
                                              frames=prefix, mesh=MESH),
        "decode_collectives": step_collectives(
            cfg, None if cfg.family == "moe" else dec, None, "decode", 2, LANE_MAX_SEQ,
            False, mesh=MESH, cell=cell)}
    for rank in four:
        got = rank["seq_parallel"]["cases"][arch]
        for key, value in want.items():
            assert got[key] == value, key
    # a K/V gather a layer, forward; its reduce-scatter backward
    tr = want["train_collectives"]
    assert tr["fwd"]["all_gather"] >= cfg.n_layers
    assert tr["bwd"]["all_reduce"] >= cfg.n_layers
    assert tr["fwd"]["all_reduce"] == tr["bwd"]["grad_all_reduce"] == 1


# ---------------------------------------------------------------------------
# the policy, the layout and the dry run, without ranks
# ---------------------------------------------------------------------------

def test_chatglm3_policy_on_four_model_ranks():
    """Full-width chatglm3-6b (kv 2) on ``data=1 x model=4``: SP for
    training and prefill at any length; for its 28-layer 16 x 32 768 decode
    (2*16*32768*2*128*2 B x 28 = 14.0 GiB > 12) but not for 8 layers."""
    cfg = get_config("chatglm3-6b")
    mesh = _mesh()
    for shape in (ShapeConfig("t", 512, 4, "train"), ShapeConfig("t", 32, 1, "prefill"),
                  SHAPES["train_4k"], SHAPES["prefill_32k"]):
        assert make_rules(cfg, shape, mesh).seq_axis == "model"
    serve = ShapeConfig("t", 32_768, 16, "decode")
    assert _decode_cache_gib(cfg, serve, 1) == 14.0
    assert make_rules(cfg, serve, mesh).seq_axis == "model"
    assert _decode_cache_gib(cfg.with_(n_layers=8), serve, 1) == 4.0
    assert make_rules(cfg.with_(n_layers=8), serve, mesh).seq_axis is None
    rules = make_rules(cfg, serve, mesh)
    with use_rules(rules):
        assert splits_sequence("dense", 4, 512) and splits_sequence("vlm", 1, 32)
        assert not splits_sequence("dense", 4, 514)        # 514 % 4
        assert splits_sequence("hybrid", 4, 512)           # as the reference
        assert splits_sequence("encdec", 4, 512)
        assert not splits_sequence("rwkv", 4, 512)         # attention-free


@pytest.mark.parametrize("arch", BATCH_ARCHS)
def test_policy_and_cache_specs_on_four_model_ranks_match_the_reference(arch, monkeypatch):
    """On ``data=1 x model=4`` (no batch axis over 1): ``make_rules``' SP
    decision and every entry of ``batch_shardings`` and ``cache_shardings``
    of every applicable shape equal the reference's (its ``NamedSharding``
    reduced to its spec), the SP caches' ``seq`` entries included."""
    import types

    from repro.launch import mesh as ref_mesh

    monkeypatch.setattr(ref_mesh, "NamedSharding", lambda mesh, spec: spec)
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    mesh = _mesh()
    fake = types.SimpleNamespace(shape=dict(mesh.shape))
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        rules = make_rules(cfg, shape, mesh)
        rrules = ref_mesh.make_rules(rcfg, shape, fake)
        assert (rules.batch_axes, rules.seq_axis) == (rrules.batch_axes, rrules.seq_axis)
        got, want = dict(input_specs(cfg, shape)), dict(_ref_specs(arch, name))
        caches, ref_caches = got.pop("caches", None), want.pop("caches", None)
        g_in, w_in = batch_shardings(got, rules), ref_mesh.batch_shardings(want, rrules)
        assert {k: tuple(v) for k, v in w_in.items()} == g_in
        if caches is not None:
            ref_named = _cache_names(ref_mesh.cache_shardings(rcfg, ref_caches, rrules))
            for leaf, spec in _port_named(cache_shardings(cfg, caches, rules), caches):
                assert spec == ref_named[leaf][1:], (name, leaf)


def test_applied_cache_shardings_keep_the_seq_entry():
    """A KV cache of the SP policy: ``cache_shardings`` gives its positions
    the model axis, and the port applies it (a quarter of the positions a
    rank: ``init_caches`` under the same rules makes exactly that block);
    so does the hybrid's shared-attention cache (2 kv heads: the heads do
    not divide the axis), beside its SSM states' block of the heads."""
    cfg = get_config("chatglm3-6b", smoke=True)
    shape = ShapeConfig("t", *SP_DECODE_CELL, "decode")
    whole = api(cfg, device="meta").init_caches(16, 64)
    for r in range(TP):
        rules = kv_layout(make_rules(cfg, shape, _mesh({"data": 0, "model": r})),
                          cfg.family, cfg.n_kv_heads, 64)
        assert rules.seq_axis == "model" and rules.cache_seq_split
        specs = cache_shardings(cfg, whole, rules)
        assert applied_cache_shardings(cfg, whole, rules) == specs
        assert {spec for layer in specs for spec in layer} == {(None, "model", None, None)}
        blocks = LayoutBlocks(specs, rules).block(whole)
        with use_rules(rules):
            made = api(cfg, device="meta").init_caches(16, 64)
        assert [t.shape for t in leaves(made)] == [t.shape for t in leaves(blocks)]
        assert sum(t.numel() for t in leaves(blocks)) * TP == \
            sum(t.numel() for t in leaves(whole))
    hybrid = get_config("zamba2-1.2b", smoke=True).with_(n_kv_heads=2)
    rules = kv_layout(make_rules(hybrid, shape, _mesh()), hybrid.family,
                      hybrid.n_kv_heads, 64)
    caches = api(hybrid, device="meta").init_caches(16, 64)
    assert cache_shardings(hybrid, caches["attn"], rules)[0].k == (None, "model", None, None)
    assert {spec for layer in applied_cache_shardings(hybrid, caches["attn"], rules)
            for spec in layer} == {(None, "model", None, None)}
    with use_rules(rules):
        made = api(hybrid, device="meta").init_caches(16, 64)
    blocks = LayoutBlocks(applied_cache_shardings(hybrid, caches, rules), rules).block(caches)
    assert [t.shape for t in leaves(made)] == [t.shape for t in leaves(blocks)]


def test_layout_lines_name_the_sequence_split():
    cfg = get_config("chatglm3-6b")
    mesh = _mesh()
    rules = batch_layout(make_rules(cfg, ShapeConfig("t", 512, 4, "train"), mesh), 4)
    assert describe_layout(rules, 4, "sequences", cfg, 512) == (
        "batch whole: 4 sequences on every rank (data=1); sequence 128 of 512 a "
        "rank, heads whole over model=4, d_ff whole, vocab whole")
    serve = make_rules(cfg, ShapeConfig("t", 32_768, 16, "decode"), mesh)
    assert describe_layout(batch_layout(serve, 16), 16, "lanes", cfg,
                           max_seq=32_768) == (
        "batch whole: 16 lanes on every rank (data=1); heads whole over model=4, "
        "KV cache positions 8192 of 32768 a rank, d_ff 3424 of 13696 a rank, "
        "vocab 16256 of 65024 a rank")


def test_dryrun_dense_train_cell_traces_a_quarter_of_the_flops():
    """Dense chatglm3-smoke's train step on the shape-only ``model=4`` mesh
    (SP on) against ``model=1``: a rank traces exactly a quarter of the
    FLOPs, because no FLOP is repeated whole on every rank (the tokens'
    block is embedded alone, a lookup; the heads, d_ff and the vocab are
    whole on the rank's positions, and a rank's queries score every key
    once: the K/V gather moves bytes, not FLOPs).  Its peak falls, and it
    records the K/V gathers (one a layer, the remat-free forward) at their
    bytes."""
    cfg = get_config("chatglm3-6b", tt=False, smoke=True)
    shape = ShapeConfig("t", 64, 4, "train")
    out = {}
    for tp in (1, TP):
        mesh = Mesh({"data": 1, "model": tp}, {"data": 0, "model": 0}, {})
        rules = batch_layout(make_rules(cfg, shape, mesh), shape.global_batch)
        assert (rules.seq_axis == "model") == (tp > 1)
        with use_rules(rules):
            out[tp] = dryrun.trace_step(cfg, shape, mesh)
    assert out[1]["flops"] == TP * out[TP]["flops"]
    assert out[TP]["memory"]["peak_bytes"] < out[1]["memory"]["peak_bytes"]
    kv = 4 * 64 * 2 * cfg.n_kv_heads * cfg.hd * 4            # B S (K,V) Hkv Dh fp32
    assert out[TP]["collectives"]["all-gather"] == cfg.n_layers * kv
    assert out[1]["collectives"]["all-gather"] == 0


def test_dryrun_sp_decode_cell_traces_a_quarter_of_the_cache():
    """The decode step on ``model=4`` under the SP cell's rules: a rank's
    argument bytes hold a quarter of the KV cache's (every other argument
    whole), and the step sends one all-gather of the softmax statistics a
    layer and the vocab's."""
    cfg = get_config("chatglm3-6b", smoke=True)
    shape = ShapeConfig("t", 64, 16, "decode")
    cache = 2 * 16 * decode_cache_len(cfg, shape) * cfg.n_kv_heads * cfg.hd * 4 \
        * cfg.n_layers
    out = {}
    for tp in (1, TP):
        mesh = Mesh({"data": 1, "model": tp}, {"data": 0, "model": 0}, {})
        rules = make_rules(cfg, ShapeConfig("t", *SP_DECODE_CELL, "decode"), mesh)
        rules = kv_layout(batch_layout(rules, 16), cfg.family, cfg.n_kv_heads,
                          decode_cache_len(cfg, shape))
        assert rules.cache_seq_split == (tp > 1)
        with use_rules(rules):
            out[tp] = dryrun.trace_step(cfg, shape, mesh)
    a1, a4 = (out[t]["memory"]["argument_bytes"] for t in (1, TP))
    assert a1 - a4 == cache - cache // TP
    assert out[TP]["collectives"]["all-gather"] > 0
