"""The model axis of the SSM and WKV heads, their decode states and the
encoder-decoder's own sites in the port, on the CPU.

On a ``data=2 x model=2`` mesh of 4 ``gloo`` ranks (one spawn of
``tests/_torch_shard_ranks.py``'s ``model_axis_states`` body, with its own
time limit) each rank of a model group holds and computes only its block
of zamba2's SSM heads and SSD state, rwkv6's WKV heads and WKV state, and
seamless's cross-attention kv heads, cross K/V cache and vocab
(``repro_torch.sharding.state_heads``, ``head_layout``), and the values
stay the reference's on one device (its plain path on its seed-0 weights,
carried over by ``params_from_jax``).  Each smoke config runs under its
K1 plans (the port's DSE, every layer forced to streaming_tt) with
``tt_model_reduce`` and under no plan without it:

* two lanes served (zamba2 and rwkv6 through a 2-lane ``ServeEngine``,
  seamless through the step builders, a lane a data rank) give the
  reference's greedy first tokens, and their prefill and decode logits
  are within 1e-4 x max |logit|;
* train step 0 on the split batch gives the loss and grad norm within rel
  1e-4 and every gradient leaf within 1e-4 (rtol and atol) of
  ``jax.grad``; every rank holds the same gradients;
* each rank's cache leaves have exactly the block shapes of
  ``applied_cache_shardings``: the heads of the SSM, WKV and cross K/V
  leaves halved, the conv history and token shifts whole;
* a decode step's and a train step's collectives equal
  ``chip_smoke.py``'s ``step_collectives``.

Without ranks: a rank's SSM and WKV head blocks and its contiguous block
of cross-attention heads (2 kv heads) equal the matching slices of the
whole layer's; the dry run's SSD and WKV scan FLOPs a rank halve on
``model=2``; the experts' parameter specs are the reference's.
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
from repro.launch.mesh import _param_pspec as ref_param_pspec
from repro.models import api as ref_api

from _torch_shard_ranks import (FAMILY_FRAMES, LANE_MAX_SEQ, LANE_PROMPT_LEN,
                                STATE_ARCHS, STATE_CASES, lane_frames, lane_prompts,
                                spawn, state_batch)
from test_torch_model_axis import TOL, _close, _flat, step_collectives
from repro_torch import dse_cli
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (LayoutBlocks, Mesh, _map_named,
                                     applied_cache_shardings, batch_layout,
                                     cache_shardings, describe_model_split, make_rules,
                                     param_shardings)
from repro_torch.models import api, encdec
from repro_torch.models.blocks import ssm_spec
from repro_torch.models.config import ShapeConfig
from repro_torch.nn import rwkv, ssm
from repro_torch.plan import load_plan
from repro_torch.sharding import use_rules
from repro_torch.tree import leaves

#: time limit of the spawn, seconds (its body takes ~20 s on one core a rank)
SPAWN_TIMEOUT_S = 150
CASES = [f"{arch}:{plans}:{reduce}" for arch, plans, reduce in STATE_CASES]
TP = 2


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
    return {arch: _emit_plans(arch, str(out / arch)) for arch in STATE_ARCHS}


@pytest.fixture(scope="module")
def four(plans, tmp_path_factory) -> list[dict]:
    weights = tmp_path_factory.mktemp("weights")
    paths = {}
    for arch in STATE_ARCHS:
        paths[arch] = str(weights / f"{arch}.pt")
        torch.save(params_from_jax(jax.tree.map(np.asarray, _ref_params(arch))),
                   paths[arch])
    return spawn("model_axis_states", 4, {"params": paths, "plans": plans},
                 tmp_path_factory.mktemp("four"), timeout=SPAWN_TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def _ref_serve(arch: str):
    """The reference's greedy first tokens of both lanes, their last-token
    prefill logits and one decode step's logits."""
    rcfg = ref_get_config(arch, smoke=True)
    rm = ref_api(rcfg, plan=None)
    prompts = jnp.asarray(lane_prompts(rcfg.vocab))

    @jax.jit
    def run(params, prompts):
        if rcfg.family == "encdec":
            batch = {"tokens": prompts, "frontend": jnp.asarray(lane_frames(rcfg))}
            rows, caches = rm.prefill(params, batch, LANE_MAX_SEQ)
            pos = jnp.asarray(LANE_PROMPT_LEN, jnp.int32)
        else:
            logits, caches = rm.prefill_full(params, {"tokens": prompts}, LANE_MAX_SEQ)
            rows = logits[:, -1]
            pos = jnp.full((2,), LANE_PROMPT_LEN, jnp.int32)
        first = jnp.argmax(rows, axis=-1)
        step, _ = rm.decode_step(params, first[:, None].astype(jnp.int32), caches, pos)
        return first, rows, step

    first, rows, step = run(_ref_params(arch), prompts)
    return [int(t) for t in first], np.asarray(rows), np.asarray(step)


@functools.lru_cache(maxsize=None)
def _ref_train(arch: str):
    rcfg = ref_get_config(arch, smoke=True)
    batch = {k: jnp.asarray(v.astype(np.float32 if k == "frontend" else np.int32))
             for k, v in state_batch(rcfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(ref_api(rcfg, plan=None).train_loss))(
        _ref_params(arch), batch)
    return float(loss), {k: v.numpy() for k, v in _flat(params_from_jax(
        jax.tree.map(np.asarray, grads))).items()}


# ---------------------------------------------------------------------------
# serving, training, caches and collectives on the ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_states_serve_like_the_reference(four, case):
    first, rows, step = _ref_serve(case.split(":")[0])
    for rank in four:
        got = rank["model_axis_states"]["cases"][case]
        assert got["first"] == first
        _close(got["prefill"], rows)
        _close(got["decode"], step)


@pytest.mark.parametrize("case", CASES)
def test_states_train_like_the_reference(four, case):
    loss, want = _ref_train(case.split(":")[0])
    norm = math.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want.values()))
    for rank in four:
        got = rank["model_axis_states"]["cases"][case]
        assert got["loss"] == pytest.approx(loss, rel=1e-4)
        assert sorted(got["grads"]) == sorted(want)
        got_norm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                                 for g in got["grads"].values()))
        assert got_norm == pytest.approx(norm, rel=1e-4)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[name], **TOL, err_msg=name)
    for rank in four[1:]:
        for name, g in rank["model_axis_states"]["cases"][case]["grads"].items():
            assert torch.equal(g, four[0]["model_axis_states"]["cases"][case]["grads"][name])


def _mesh(coords: dict) -> Mesh:
    return Mesh({"data": 2, "model": TP}, coords, {})


def _decode_rules(cfg, coords):
    return batch_layout(make_rules(cfg, ShapeConfig("t", LANE_MAX_SEQ, 2, "decode"),
                                   _mesh(coords)), 2)


def _whole_caches(cfg, batch: int = 2, max_seq: int = LANE_MAX_SEQ,
                  frames: int = FAMILY_FRAMES):
    if cfg.family == "encdec":
        return encdec.init_caches(cfg, batch, max_seq, frames, device="meta")
    return api(cfg, device="meta").init_caches(batch, max_seq)


@pytest.mark.parametrize("case", CASES)
def test_state_cache_leaves_are_the_blocks_of_applied_cache_shardings(four, case):
    """Each rank's cache leaves: its lane, and half the heads of every SSM,
    WKV, KV and cross K/V leaf; the conv history and token shifts whole."""
    cfg = get_config(case.split(":")[0], smoke=True)
    whole = _whole_caches(cfg)
    for rank in four:
        rules = _decode_rules(cfg, rank["model_axis_states"]["coords"])
        specs = applied_cache_shardings(cfg, whole, rules)
        want = [tuple(t.shape) for t in leaves(LayoutBlocks(specs, rules).block(whole))]
        assert rank["model_axis_states"]["cases"][case]["cache_shapes"] == want
        for w, got in zip(leaves(whole), want):
            # the lanes halve; so do the heads of every 4-d leaf (K/V, cross
            # K/V, SSM and WKV states), not the conv history or the shifts
            assert got[0] * 2 == w.shape[0]
            assert math.prod(got) * (4 if w.dim() == 4 else 2) == w.numel()


@pytest.mark.parametrize("case", CASES)
def test_state_step_collectives_equal_the_formula(four, plans, case):
    arch, kind, reduce = case.split(":")
    cfg = get_config(arch, smoke=True)
    dec, train = ((load_plan(plans[arch][k]) for k in ("decode", "train"))
                  if kind == "k1" else (None, None))
    for rank in four:
        got = rank["model_axis_states"]["cases"][case]
        assert got["decode_collectives"] == step_collectives(
            cfg, dec, None, "decode", 2, LANE_MAX_SEQ, reduce == "True")
        assert got["train_collectives"] == step_collectives(
            cfg, train, None, "train", 2, 16, reduce == "True", frames=FAMILY_FRAMES)


def test_the_state_formulas_at_smoke_width():
    """Without the reduce: zamba2's decode step gathers each SSM layer's
    gated output and each shared attention's output, the vocab and the
    lanes; rwkv6's gathers each layer's ``wo`` input, the vocab and the
    lanes; seamless's (the step builders: no lanes) each layer's self- and
    cross-attention outputs, its d_ff block and the vocab."""
    z, r, s = (get_config(a, smoke=True) for a in STATE_ARCHS)
    assert step_collectives(z, None, None, "decode", 2, LANE_MAX_SEQ, False) == {
        "all_gather": z.n_layers + z.n_layers // z.attn_every + 2, "all_reduce": 0,
        "grad_all_reduce": 0}
    assert step_collectives(r, None, None, "decode", 2, LANE_MAX_SEQ, False) == {
        "all_gather": r.n_layers + 2, "all_reduce": 0, "grad_all_reduce": 0}
    assert step_collectives(s, None, None, "decode", 2, LANE_MAX_SEQ, False) == {
        "all_gather": 3 * s.n_layers + 1, "all_reduce": 0, "grad_all_reduce": 0}


# ---------------------------------------------------------------------------
# the layout's decisions and a rank's blocks, without ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_applied_cache_shardings_split_state_and_cross_heads(arch):
    """Full width on ``data=2 x model=2``: the SSM, WKV and cross K/V
    leaves' heads take ``model`` as the reference's ``_cache_pspec`` does;
    the conv history and token shifts, which the reference splits too,
    stay whole."""
    cfg = get_config(arch)
    whole = _whole_caches(cfg, 4, 64, 32)
    rules = make_rules(cfg, ShapeConfig("t", 64, 4, "decode"), _mesh({"data": 0, "model": 0}))
    by_name = {}
    _map_named(lambda name, t: by_name.setdefault(name, t), whole)
    got = applied_cache_shardings(cfg, by_name, rules)
    want = cache_shardings(cfg, by_name, rules)
    for name in ("ssm", "wkv", "cross_k", "cross_v", "k", "v"):
        if name in got:
            assert got[name] == want[name] and "model" in got[name], name
    for name in ("conv", "shift_tm", "shift_cm"):
        if name in got:
            assert "model" in want[name], name
            assert got[name] == tuple(None if e == "model" else e for e in want[name])


def _split(index: int, tp: int):
    """A rank's ``model_axis_split`` without a group: the forward of a block
    needs none."""
    return (None, index, tp)


@pytest.mark.parametrize("tp", (2, 4))
def test_a_rank_scans_its_ssm_heads_as_the_whole_layer_does(tp):
    """For every rank of a model axis of ``tp``, from a conv history and an
    SSD state: the rank's block (``_head_block``) through the conv, the
    scan and the gate gives exactly its heads' slice of the whole layer's
    gated output and final state."""
    spec = ssm.SSMSpec("s", d_model=32, d_state=8, head_dim=8, chunk=4)
    params = ssm.ssm_init(spec, torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(7)
    params["dt_bias"] = torch.from_numpy(rng.standard_normal(spec.n_heads).astype(np.float32))
    params["D"] = torch.from_numpy(rng.standard_normal(spec.n_heads).astype(np.float32))
    zxbcdt = torch.from_numpy(rng.standard_normal((2, 8, spec.d_in_proj)).astype(np.float32))
    hist = torch.from_numpy(rng.standard_normal(
        (2, spec.d_conv - 1, spec.conv_channels)).astype(np.float32))
    init = torch.from_numpy(rng.standard_normal(
        (2, spec.n_heads, spec.d_state, spec.head_dim)).astype(np.float32))
    with torch.no_grad():
        y, final = ssm._scan_heads(spec, *ssm._head_block(spec, params, None, zxbcdt, hist),
                                   init)
        h, cols = spec.n_heads // tp, spec.d_inner // tp
        for index in range(tp):
            yl, fl = ssm._scan_heads(
                spec, *ssm._head_block(spec, params, _split(index, tp), zxbcdt, hist),
                init[:, index * h:(index + 1) * h])
            torch.testing.assert_close(yl, y[..., index * cols:(index + 1) * cols],
                                       rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(fl, final[:, index * h:(index + 1) * h],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tp", (2, 4))
def test_a_rank_scans_its_wkv_heads_as_the_whole_layer_does(tp):
    """For every rank of a model axis of ``tp``, from a WKV state: the
    rank's channel block (``_head_block``) through the scan, the group
    norm and the gate gives exactly its heads' slice of the whole layer's
    output and final state."""
    spec = rwkv.RWKVSpec("r", d_model=32, head_dim=8, lora_r=4, chunk=4)
    params = rwkv.rwkv_init(spec, torch.Generator().manual_seed(5), device="cpu")
    rng = np.random.default_rng(9)
    r, k, v, g, dl = (torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32))
                      for _ in range(5))
    init = torch.from_numpy(rng.standard_normal((2, spec.n_heads, 8, 8)).astype(np.float32))
    with torch.no_grad():
        y, final = rwkv._wkv_heads(spec, *rwkv._head_block(spec, params, None,
                                                           r, k, v, g, dl), init)
        h, cols = spec.n_heads // tp, spec.d_model // tp
        for index in range(tp):
            yl, fl = rwkv._wkv_heads(spec, *rwkv._head_block(
                spec, params, _split(index, tp), r, k, v, g, dl),
                init[:, index * h:(index + 1) * h])
            torch.testing.assert_close(yl, y[..., index * cols:(index + 1) * cols],
                                       rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(fl, final[:, index * h:(index + 1) * h],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("heads,kv,tp", [(4, 2, 2), (8, 2, 2), (4, 4, 4)])
def test_a_rank_attends_its_cross_heads_as_the_whole_layer_does(heads, kv, tp):
    """Memory heads repeat consecutively, so a rank's contiguous block of
    the kv heads serves the contiguous block of the query heads: through
    ``_attend_memory`` they give exactly that block of the whole output."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((2, 3, heads, 8)).astype(np.float32))
    mk, mv = (torch.from_numpy(rng.standard_normal((2, 10, kv, 8)).astype(np.float32))
              for _ in range(2))
    whole = encdec._attend_memory(q, mk, mv)
    h, c = heads // tp, kv // tp
    for index in range(tp):
        got = encdec._attend_memory(q[:, :, index * h:(index + 1) * h],
                                    mk[:, :, index * c:(index + 1) * c],
                                    mv[:, :, index * c:(index + 1) * c])
        torch.testing.assert_close(got, whole[:, :, index * h:(index + 1) * h],
                                   rtol=1e-6, atol=1e-6)


def test_layout_lines_name_the_state_and_cross_splits():
    full = {a: get_config(a) for a in STATE_ARCHS}
    rules = {a: make_rules(c, ShapeConfig("t", 512, 4, "decode"),
                           _mesh({"data": 0, "model": 0})) for a, c in full.items()}
    assert describe_model_split(full["zamba2-1.2b"], rules["zamba2-1.2b"]) == (
        "ssm heads over model=2: 32 of 64 a rank, heads kv_major over model=2: 16 of "
        "32 kv heads a rank, vocab 16000 of 32000 a rank")
    assert describe_model_split(full["rwkv6-7b"], rules["rwkv6-7b"]) == (
        "wkv heads over model=2: 32 of 64 a rank, vocab 32768 of 65536 a rank")
    assert describe_model_split(full["seamless-m4t-medium"],
                                rules["seamless-m4t-medium"]) == (
        "heads kv_major over model=2: 8 of 16 kv heads a rank, cross kv heads 8 of 16 "
        "a rank, d_ff 2048 of 4096 a rank, vocab 128103 of 256206 a rank")


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _no_ssd(x, da, bmat, cmat, chunk, init_state=None):
    """The SSD scan's shapes and graph with no matmul: FLOP-free."""
    keep = (da.sum() + bmat.sum() + cmat.sum()) * 0
    b, _, h, p = x.shape
    state = x.new_zeros((b, h, bmat.shape[-1], p), dtype=torch.float32) + keep
    return x + keep.to(x.dtype), state


def _no_wkv(r, k, v, logw, bonus, chunk, init_state=None):
    """The WKV scan's shapes and graph with no matmul: FLOP-free."""
    keep = (k.sum() + v.sum() + logw.sum() + bonus.sum()) * 0
    b, _, h, n = r.shape
    state = r.new_zeros((b, h, n, n), dtype=torch.float32) + keep
    return r + keep.to(r.dtype), state


@pytest.mark.parametrize("arch", ("zamba2-1.2b", "rwkv6-7b"))
def test_dryrun_scan_flops_halve_on_the_model_axis(monkeypatch, arch):
    """The hybrid and rwkv smoke train cells on the shape-only test meshes
    of 2 (``data=2``) and 4 (``data=2 x model=2``) ranks: a rank's scan
    FLOPs (the step's FLOPs less those of the same step with a FLOP-free
    scan) at ``model=2`` are exactly half those at ``model=1``, less the
    SSD's C.B scores, which do not depend on the heads (one group of B and
    C): every rank computes them whole, 2 B S l N a layer forward and twice
    that backward (chunk ``l``)."""
    cfg = get_config(arch, smoke=True)
    shape = ShapeConfig("t", 32, 4, "train")
    name, stub = (("_ssd_chunked", _no_ssd) if arch == "zamba2-1.2b"
                  else ("_wkv_chunked", _no_wkv))
    module = ssm if arch == "zamba2-1.2b" else rwkv
    scan = {}
    for n in (2, 4):
        monkeypatch.setenv("REPRO_DRYRUN_DEVICES", str(n))
        mesh = dryrun.shape_mesh(test_mesh=True)
        flops = []
        for fn in (getattr(module, name), stub):
            with monkeypatch.context() as m:
                m.setattr(module, name, fn)
                with use_rules(batch_layout(make_rules(cfg, shape, mesh), 4)):
                    flops.append(dryrun.trace_step(cfg, shape, mesh)["flops"])
        scan[n] = flops[0] - flops[1]
    scores = 0
    if arch == "zamba2-1.2b":
        rows, chunk = 2, min(ssm_spec(cfg).chunk, shape.seq_len)
        scores = 3 * 2 * rows * shape.seq_len * chunk * cfg.ssm_state * cfg.n_layers
    assert scan[2] > 0 and (scan[4] - scores) * 2 == scan[2] - scores


# ---------------------------------------------------------------------------
# the experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", ((16, 16), (2, 2)))
def test_expert_param_specs_are_the_references(mesh_shape):
    """qwen2-moe-a2.7b at full width, on ``meta``: the port's
    ``param_shardings`` spec of every layer's stacked expert leaves (``eu``,
    ``ed``, ``eg``: each TT core with the expert axis first) is the
    reference's ``_param_pspec`` of that leaf.  That is the experts' only
    model layout: they compute whole along ``model``, as the reference's
    ``expert_in`` constraint ``("batch", None, None, None)`` has them."""
    axis_sizes = dict(zip(("data", "model"), mesh_shape))
    cfg = get_config("qwen2-moe-a2.7b")
    params = api(cfg, device="meta").init_params(0)
    specs = param_shardings(params, Mesh(axis_sizes, {"data": 0, "model": 0}, {}))
    n = 0
    for block, spec in zip(params["blocks"], specs["blocks"]):
        for nm in ("eu", "ed", "eg"):
            for core, t in block["moe"][nm].items():
                assert t.shape[0] == cfg.moe_experts
                assert spec["moe"][nm][core] == tuple(
                    ref_param_pspec(tuple(t.shape), axis_sizes)), (nm, core)
                n += any(e == "model" for e in spec["moe"][nm][core])
    assert n > 0
