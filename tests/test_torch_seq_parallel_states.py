"""The SP sequence split of the hybrid and the encoder-decoder in the port,
on the CPU.

On a ``data=1 x model=4`` mesh of 4 ``gloo`` ranks (one spawn of
``tests/_torch_shard_ranks.py``'s ``seq_parallel_states`` body, with its
own time limit), under the reference tests' SP rules (``seq_axis="model"``:
``_torch_shard_ranks.sps_rules``), each rank holds its block of the
positions of zamba2-smoke (the hybrid) and of the frames and tokens of
seamless-smoke (the encoder-decoder): the Mamba2 scan hands its conv inputs
and its SSD state from rank to rank, attention gathers K and V, the
decoder's cross K/V gather the ranks' frames, and the values stay the
reference's on one device (its plain path on its seed-0 weights, carried
over by ``params_from_jax``), each config under its smoke K1 plans:

* the prefill logits of every position within 1e-4 x max |logit|, and
  each planned record at the rank's rows (``model=4``);
* train step 0 gives the loss and grad norm within rel 1e-4 and every
  gradient leaf within 1e-4 (rtol and atol) of the reference's unsharded
  ``jax.grad``, the same on every rank; under ``remat="full"`` the same
  bit for bit, the recompute gathering again;
* two lanes served (zamba2 through a ``ServeEngine``: a prompt of 8, 2
  positions a rank, fewer than ``d_conv - 1``; seamless through the step
  builders): the reference's greedy first tokens, its prefill and decode
  logits within 1e-4 x max |logit|, every cache leaf the decode layout's
  block (the SP prefill writes the rank's kv heads and SSM heads); and
  seamless with 2 kv heads, whose decode caches hold the rank's block of
  the positions and of the frames;
* the prefill's, step 0's and the decode step's collectives equal
  ``chip_smoke.py``'s ``step_collectives``.

Without ranks: the blockwise SSD scan and conv halo against the whole
scan (fp32, 1e-5: blocks shorter than ``d_conv - 1``, and the global
chunk length past 8 192 positions); ``make_rules`` of both smoke configs
on a shape-only ``model=8`` mesh against the reference's; the cache
shardings the port applies; the dry run's hybrid and encoder-decoder
smoke train cells at a rank's block.
"""

from __future__ import annotations

import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models import encdec as ref_encdec

from _torch_shard_ranks import (LANE_MAX_SEQ, LANE_PROMPT_LEN, SP_BATCH, SPS_ARCHS,
                                SPS_FRAMES, SPS_KV2, SPS_MIXED, lane_frames,
                                lane_prompts, sps_batch, spawn)
from test_torch_model_axis import TOL, _close, _flat, step_collectives
from test_torch_seq_parallel import _emit_plans
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (LayoutBlocks, Mesh, applied_cache_shardings,
                                     batch_layout, describe_layout, make_rules)
from repro_torch.models import api, encdec
from repro_torch.models.blocks import ssm_spec
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.nn import ssm
from repro_torch.plan import load_plan
from repro_torch.sharding import kv_layout, splits_sequence, use_rules
from repro_torch.tree import leaves

#: time limit of the spawn, seconds (its body takes ~10 s on one core a rank)
SPAWN_TIMEOUT_S = 150
TP = 4
MESH = (1, TP)
#: the formula's policy cell: a train shape of 2**18 positions, where
#: ``make_rules`` turns SP on whatever the kv heads (the body's rules)
SP_CELL = ShapeConfig("t", 1 << 18, SP_BATCH[0], "train")
#: the served cases: each smoke config, and seamless with 2 kv heads
SERVED = SPS_ARCHS + ("kv2",)


def _mesh(tp: int = TP, coords=None) -> Mesh:
    return Mesh({"data": 1, "model": tp}, coords or {"data": 0, "model": 0}, {})


# ---------------------------------------------------------------------------
# the spawn and the reference
# ---------------------------------------------------------------------------

def _arch(case: str) -> str:
    return "seamless-m4t-medium" if case == "kv2" else case


@functools.lru_cache(maxsize=None)
def _ref_cfg(case: str):
    rcfg = ref_get_config(_arch(case), smoke=True)
    return rcfg.with_(**SPS_KV2) if case == "kv2" else rcfg


@functools.lru_cache(maxsize=None)
def _ref_params(case: str):
    return jax.jit(ref_api(_ref_cfg(case), plan=None).init_params)(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def plans(tmp_path_factory) -> dict:
    out = tmp_path_factory.mktemp("plans")
    return {arch: _emit_plans(arch, str(out / arch)) for arch in SPS_ARCHS}


@pytest.fixture(scope="module")
def four(plans, tmp_path_factory) -> list[dict]:
    weights = tmp_path_factory.mktemp("weights")
    paths = {}
    for case in SERVED:
        paths[case] = str(weights / f"{case}.pt")
        torch.save(params_from_jax(jax.tree.map(np.asarray, _ref_params(case))),
                   paths[case])
    ranks = spawn("seq_parallel_states", 4, {"params": paths, "plans": plans},
                  tmp_path_factory.mktemp("four"), timeout=SPAWN_TIMEOUT_S)
    return [rank["seq_parallel_states"] for rank in ranks]


def _ref_batch(case: str, labels: bool, *shape) -> dict:
    batch = sps_batch(_ref_cfg(case), *shape)
    if not labels:
        batch.pop("labels")
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_forward(case: str) -> np.ndarray:
    """The reference's logits of every position of :func:`sps_batch`."""
    rcfg = _ref_cfg(case)
    if rcfg.family == "encdec":
        def run(params, batch):
            memory = ref_encdec.encode(rcfg, params, batch["frontend"])
            mem_kv = ref_encdec._stacked_memory_kv(rcfg, params, memory)
            return ref_encdec._decoder(rcfg, params, batch["tokens"], mem_kv, None,
                                       None)[0]
    else:
        def run(params, batch):
            return ref_api(rcfg, plan=None).prefill_full(params, batch, SP_BATCH[1])[0]
    return np.asarray(jax.jit(run)(_ref_params(case), _ref_batch(case, False)))


@functools.lru_cache(maxsize=None)
def _ref_train(case: str, *shape):
    loss, grads = jax.jit(jax.value_and_grad(ref_api(_ref_cfg(case), plan=None).train_loss))(
        _ref_params(case), _ref_batch(case, True, *shape))
    return float(loss), {k: v.numpy() for k, v in _flat(params_from_jax(
        jax.tree.map(np.asarray, grads))).items()}


@functools.lru_cache(maxsize=None)
def _ref_serve(case: str):
    """The reference's greedy first tokens of both lanes, their last-token
    prefill logits and one decode step's logits."""
    rcfg = _ref_cfg(case)
    rm = ref_api(rcfg, plan=None)

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

    first, rows, step = run(_ref_params(case), jnp.asarray(lane_prompts(rcfg.vocab)))
    return [int(t) for t in first], np.asarray(rows), np.asarray(step)


# ---------------------------------------------------------------------------
# forward, step 0, serving and collectives on the ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SPS_ARCHS)
def test_sequence_split_forward_matches_the_reference(four, arch):
    """Every rank's gathered prefill logits (every position) against the
    reference's; each planned record ran on the rank's rows with the mesh
    named: a quarter of the positions (and of the frames)."""
    want = _ref_forward(arch)
    rows = SP_BATCH[0] * SP_BATCH[1] // TP
    assert SPS_FRAMES == SP_BATCH[1]
    for rank in four:
        got = rank["cases"][arch]
        _close(got["forward"], want)
        assert got["records"] and {m for _, m, _ in got["records"]} == {f"model={TP}"}
        assert {shape[0] for _, _, shape in got["records"]} == {rows}


@pytest.mark.parametrize("arch", SPS_ARCHS)
def test_sequence_split_step0_matches_the_reference(four, arch):
    loss, want = _ref_train(arch)
    norm = math.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want.values()))
    for rank in four:
        got = rank["cases"][arch]["step0"]
        assert got["loss"] == pytest.approx(loss, rel=1e-4)
        assert sorted(got["grads"]) == sorted(want)
        got_norm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                                 for g in got["grads"].values()))
        assert got_norm == pytest.approx(norm, rel=1e-4)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[name], **TOL, err_msg=name)
    # the gradients summed over the sequence's axis: one tree on every rank
    for rank in four[1:]:
        for name, g in rank["cases"][arch]["step0"]["grads"].items():
            assert torch.equal(g, four[0]["cases"][arch]["step0"]["grads"][name])


@pytest.mark.parametrize("arch", SPS_ARCHS)
def test_a_remat_step_recomputes_the_hand_offs_and_changes_no_bit(four, arch, plans):
    """Step 0 under ``remat="full"``: the recompute sends the gathers again
    (zamba2's Mamba layers inside a group twice more: the group's and
    their own checkpoint), and the loss and every leaf equal the
    remat-free step's bit for bit."""
    cfg = get_config(arch, smoke=True).with_(remat="full")
    want = step_collectives(cfg, load_plan(plans[arch]["train"]), None, "train",
                            *SP_BATCH, False, frames=SPS_FRAMES, mesh=MESH, cell=SP_CELL)
    plain = step_collectives(cfg.with_(remat="none"), load_plan(plans[arch]["train"]),
                             None, "train", *SP_BATCH, False, frames=SPS_FRAMES,
                             mesh=MESH, cell=SP_CELL)
    assert want["fwd"]["all_gather"] > plain["fwd"]["all_gather"]
    assert want["bwd"] == plain["bwd"]
    for rank in four:
        case = rank["cases"][arch]
        assert case["remat"]["collectives"] == want
        assert case["remat"]["loss"] == case["step0"]["loss"]
        for name, g in case["remat"]["grads"].items():
            assert torch.equal(g, case["step0"]["grads"][name]), name


@pytest.mark.parametrize("key", sorted(SPS_MIXED))
def test_a_step_whose_frames_or_tokens_alone_split_matches_the_reference(four, key):
    """seamless-smoke where only the frames (16 frames, 6 tokens) or only
    the tokens (10 frames, 16 tokens) divide ``model=4``: the part whose
    sequence stays whole runs whole on every rank, and step 0's loss and
    every leaf and the prefill's last logits are the reference's."""
    frames, seq = SPS_MIXED[key]
    arch = "seamless-m4t-medium"
    loss, want = _ref_train(arch, frames, seq)
    rcfg = _ref_cfg(arch)
    rows, _ = jax.jit(lambda p, b: ref_api(rcfg, plan=None).prefill(p, b, seq))(
        _ref_params(arch), _ref_batch(arch, False, frames, seq))
    for rank in four:
        got = rank["cases"][f"mixed-{key}"]
        _close(got["prefill"], np.asarray(rows))
        assert got["loss"] == pytest.approx(loss, rel=1e-4)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[name], **TOL, err_msg=name)


@pytest.mark.parametrize("case", SERVED)
def test_served_lanes_match_the_reference(four, case):
    first, rows, step = _ref_serve(case)
    for rank in four:
        got = rank["cases"][case]["serve"]
        assert got["first"] == first
        _close(got["prefill"], rows)
        _close(got["decode"], step)


@pytest.mark.parametrize("case", SERVED)
def test_served_caches_are_the_decode_layouts_blocks(four, case):
    """Each rank's cache leaves after the SP prefill have exactly the block
    shapes of ``applied_cache_shardings`` under the decode's rules: the
    kv heads and SSM heads a quarter (4 kv heads, 8 SSM heads); with 2 kv
    heads the self K/V's positions and the cross K/V's frames."""
    cfg = get_config(_arch(case), smoke=True)
    if case == "kv2":
        cfg = cfg.with_(**SPS_KV2)
    with use_rules(None):
        whole = (encdec.init_caches(cfg, 2, LANE_MAX_SEQ, lane_frames(cfg).shape[1],
                                    device="meta") if cfg.family == "encdec"
                 else api(cfg, device="meta").init_caches(2, LANE_MAX_SEQ))
    shapes = [tuple(t.shape) for t in leaves(whole)]
    for r, rank in enumerate(four):
        rules = kv_layout(make_rules(cfg, SP_CELL, _mesh(coords={"data": 0, "model": r})),
                          cfg.family, cfg.n_kv_heads, LANE_MAX_SEQ)
        specs = applied_cache_shardings(cfg, whole, rules)
        want = [tuple(t.shape) for t in leaves(LayoutBlocks(specs, rules).block(whole))]
        assert rank["cases"][case]["serve"]["cache_shapes"] == want
    # every leaf a quarter but the hybrid's conv histories (held whole)
    conv = (ssm_spec(cfg).d_conv - 1, ssm_spec(cfg).conv_channels)
    for got, full in zip(want, shapes):
        held = full[1:] == conv
        assert math.prod(got) * (1 if held else TP) == math.prod(full), (got, full)


@pytest.mark.parametrize("case", SERVED)
def test_sequence_split_collectives_equal_the_formula(four, case, plans):
    cfg = get_config(_arch(case), smoke=True)
    if case == "kv2":
        cfg = cfg.with_(**SPS_KV2)
        pre = dec = train = None
    else:
        pre, dec, train = (load_plan(plans[case][k]) for k in ("prefill", "decode", "train"))
    frames = lane_frames(cfg).shape[1]
    served = 2 if cfg.family == "encdec" else 1        # the engine prefills at batch 1
    want = {"prefill": step_collectives(cfg, pre, None, "prefill", served, LANE_PROMPT_LEN,
                                        False, frames=frames, mesh=MESH, cell=SP_CELL),
            "decode": step_collectives(cfg, dec, None, "decode", 2, LANE_MAX_SEQ, False,
                                       mesh=MESH, cell=SP_CELL)}
    if case != "kv2":
        want["forward"] = step_collectives(cfg, pre, None, "prefill", *SP_BATCH, False,
                                           frames=SPS_FRAMES, mesh=MESH, cell=SP_CELL)
        want["step0"] = step_collectives(cfg, train, None, "train", *SP_BATCH, False,
                                         frames=SPS_FRAMES, mesh=MESH, cell=SP_CELL)
    for rank in four:
        got = rank["cases"][case]
        seen = {"prefill": got["serve"]["prefill_collectives"],
                "decode": got["serve"]["decode_collectives"]}
        if case != "kv2":
            seen.update(forward=got["prefill_collectives"]["fwd"],
                        step0=got["step0"]["collectives"])
        assert seen == want
    if case == "zamba2-1.2b":
        # two hand-offs a Mamba layer and a K/V gather a shared attention,
        # forward; a reduce-scatter each backward
        tr = want["step0"]
        n_attn = cfg.n_layers // cfg.attn_every
        assert tr["fwd"]["all_gather"] == 2 * cfg.n_layers + n_attn
        assert tr["bwd"]["all_reduce"] == 2 * cfg.n_layers + n_attn


# ---------------------------------------------------------------------------
# the scan's hand-off, the policy, the layout and the dry run, without ranks
# ---------------------------------------------------------------------------

def _blockwise_scan(x, da, bmat, cmat, init, chunk: int, tp: int):
    """:func:`ssm._ssd_chunked` of ``tp`` blocks in one process, with the
    hand-off of ``nn/ssm.py``'s SP path: each block scanned from zero at the
    whole sequence's chunk length, the states folded in block order, the
    entering state's term added.  Returns the whole ``y`` and end state."""
    s = x.shape[1]
    m = s // tp
    ys, ends, totals = [], [], []
    for r in range(tp):
        sl = slice(r * m, (r + 1) * m)
        y, end = ssm._ssd_chunked(x[:, sl], da[:, sl], bmat[:, sl], cmat[:, sl], chunk,
                                  seq_len=s)
        ys.append(y)
        ends.append(end)
        totals.append(da[:, sl].sum(dim=1))
    ends, totals = torch.stack(ends), torch.stack(totals)
    out = []
    for r in range(tp):
        start, final = ssm.fold_states(ends, totals, init, r)
        sl = slice(r * m, (r + 1) * m)
        out.append(ys[r] + ssm.init_term(cmat[:, sl], da[:, sl], start, x.dtype))
    return torch.cat(out, dim=1), final


@pytest.mark.parametrize("s,tp,chunk", [(64, 4, 8), (8, 4, 8), (12, 4, 128),
                                        (16_384, 4, 128)])
def test_blockwise_scan_and_conv_halo_equal_the_whole_scan(s, tp, chunk):
    """zamba2-smoke's SSD and depthwise conv shapes (8 heads of 16, state 8,
    ``d_conv`` 4) in fp32 on ``tp`` blocks of ``s / tp`` positions: blocks of
    16 in chunks of 8, of 2 and 3 (shorter than ``d_conv - 1``: the halo
    spans several blocks) and of 4 096 of a 16 384-position sequence (the
    whole sequence's chunk length 64, not the block's 128), from a nonzero
    entering state and conv history, against the whole scan and conv:
    every output and the end state within 1e-5 of their scale."""
    spec = ssm_spec(get_config("zamba2-1.2b", smoke=True))
    gen = torch.Generator().manual_seed(59)
    b, h, p, n, k = 1, spec.n_heads, spec.head_dim, spec.d_state, spec.d_conv
    x = torch.randn(b, s, h, p, generator=gen)
    da = -torch.rand(b, s, h, generator=gen) * (2.0 * tp / s)   # a block's decay ~e^-1
    bmat, cmat = torch.randn(b, s, n, generator=gen), torch.randn(b, s, n, generator=gen)
    init = torch.randn(b, h, n, p, generator=gen)
    want, want_end = ssm._ssd_chunked(x, da, bmat, cmat, chunk, init)
    got, end = _blockwise_scan(x, da, bmat, cmat, init, chunk, tp)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert (end - want_end).abs().max() <= 1e-5 * want_end.abs().max()
    m = s // tp
    assert ssm.chunk_len(m, chunk, s) == ssm.chunk_len(s, chunk) or m % ssm.chunk_len(s, chunk)
    if s > 8192:
        assert ssm.chunk_len(m, chunk, s) == 64 != ssm.chunk_len(m, chunk)

    c = spec.conv_channels
    u = torch.randn(b, s, c, generator=gen)
    w, bias = torch.randn(k, c, generator=gen), torch.randn(c, generator=gen)
    hist = torch.randn(b, k - 1, c, generator=gen)
    whole = ssm._causal_conv(u, w, bias, hist)
    t = min(k - 1, m)
    tails = torch.stack([u[:, (r + 1) * m - t:(r + 1) * m] for r in range(tp)])
    blocks = torch.cat([ssm._causal_conv(u[:, r * m:(r + 1) * m], w, bias,
                                         ssm.conv_halo(tails, r, hist, k))
                        for r in range(tp)], dim=1)
    assert (blocks - whole).abs().max() <= 1e-5 * whole.abs().max()
    assert torch.equal(ssm.conv_halo(tails, tp, hist, k),
                       torch.cat([hist, u], dim=1)[:, -(k - 1):])


@pytest.mark.parametrize("arch", SPS_ARCHS)
def test_policy_on_a_shape_only_model8_mesh_matches_the_reference(arch):
    """zamba2-smoke's and seamless-smoke's 4 kv heads do not divide
    ``model=8``: ``make_rules`` turns SP on for every train and prefill
    shape and not for decode, as the reference's does, and a step's
    sequence (and the frames) then split."""
    from repro.launch import mesh as ref_mesh

    cfg, rcfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
    mesh = Mesh({"data": 1, "model": 8}, {"data": 0, "model": 0}, {})
    fake = types.SimpleNamespace(shape=dict(mesh.shape))
    for shape in SHAPES.values():
        rules = make_rules(cfg, shape, mesh)
        assert rules.seq_axis == ref_mesh.make_rules(rcfg, shape, fake).seq_axis
        assert (rules.seq_axis == "model") == (shape.step != "decode")
    with use_rules(make_rules(cfg, SHAPES["train_4k"], mesh)):
        assert splits_sequence(cfg.family, 2, 4096)
        assert not splits_sequence(cfg.family, 2, 4100)
    with use_rules(make_rules(get_config("rwkv6-7b", smoke=True), SHAPES["train_4k"], mesh)):
        assert not splits_sequence("rwkv", 2, 4096)


def test_layout_lines_name_the_sequence_split():
    mesh = _mesh()
    z = get_config("zamba2-1.2b")
    rules = batch_layout(make_rules(z, ShapeConfig("t", 1 << 18, 4, "train"), mesh), 4)
    assert describe_layout(rules, 4, "sequences", z, 512) == (
        "batch whole: 4 sequences on every rank (data=1); sequence 128 of 512 a "
        "rank, ssm heads whole over model=4, heads whole over model=4, vocab whole")
    s2 = get_config("seamless-m4t-medium", smoke=True).with_(**SPS_KV2)
    rules = kv_layout(make_rules(s2, SP_CELL, mesh), s2.family, s2.n_kv_heads, 16)
    assert "KV cache positions 4 of 16 a rank, cross K/V frames 1/4 a rank" in \
        describe_layout(batch_layout(rules, 2), 2, "lanes", s2, max_seq=16)


@pytest.mark.parametrize("arch", SPS_ARCHS)
def test_dryrun_train_cell_traces_a_ranks_block(arch):
    """The smoke train step on the shape-only ``model=4`` mesh under the SP
    policy against ``model=1``: a rank traces at most 0.3 of one device's
    FLOPs (its quarter, plus the hand-offs' fold and the entering state's
    term, and the MLP-free hybrid's and the encoder-decoder's whole
    gathers cost no FLOP), a lower peak, and all-gathers exactly the
    bytes of the hand-offs and the K/V gathers of its block."""
    cfg = get_config(arch, tt=False, smoke=True)
    shape = ShapeConfig("t", 64, 4, "train")
    out = {}
    for tp in (1, TP):
        mesh = _mesh(tp)
        rules = batch_layout(make_rules(cfg, SP_CELL, mesh), shape.global_batch)
        assert rules.seq_axis == "model"
        with use_rules(rules):
            out[tp] = dryrun.trace_step(cfg, shape, mesh)
    assert out[TP]["flops"] <= 0.3 * out[1]["flops"]
    assert out[TP]["memory"]["peak_bytes"] < out[1]["memory"]["peak_bytes"]
    b, f4 = 4, 4
    kv = b * 64 * 2 * cfg.n_kv_heads * cfg.hd * f4          # B S (K,V) Hkv Dh fp32
    if cfg.family == "hybrid":
        sp = ssm_spec(cfg)
        tails = TP * b * (sp.d_conv - 1) * sp.conv_channels * f4
        states = TP * b * (sp.n_heads * sp.d_state * sp.head_dim + sp.n_heads) * f4
        want = cfg.n_layers * (tails + states) + cfg.n_layers // cfg.attn_every * kv
    else:                       # 64 frames: the encoder's, self and memory K/V
        want = (cfg.encoder_layers + 2 * cfg.n_layers) * kv
    assert out[TP]["collectives"]["all-gather"] == want
    assert out[1]["collectives"]["all-gather"] == 0


def test_a_ranks_query_chunk_under_sp_is_the_reference_layouts(monkeypatch):
    """Under SP a rank scores every head of its queries, so its query chunk
    is ``q_chunk / tp``: its scores stay the reference layout's (``q_chunk``
    queries of ``H / tp`` heads a device).  chatglm3-smoke with ``q_chunk``
    64 on the shape-only ``model=4`` mesh, a prefill of 256 positions (64
    a rank): every attention call of a rank chunks its 64 queries by 16,
    where one device chunks 256 by 64; the FLOPs a rank stay a quarter and
    the peak falls below the unchunked block's."""
    from repro_torch.nn import attention

    cfg = get_config("chatglm3-6b", tt=False, smoke=True).with_(q_chunk=64)
    shape = ShapeConfig("t", 256, 2, "prefill")
    seen, real = [], attention._chunked_attention

    def spy(q, k, v, causal, q_chunk, *rest):
        seen.append((q.shape[1], q_chunk))
        return real(q, k, v, causal, q_chunk, *rest)

    monkeypatch.setattr(attention, "_chunked_attention", spy)
    out = {}
    for tp in (1, TP):
        seen.clear()
        rules = batch_layout(make_rules(cfg, shape, _mesh(tp)), shape.global_batch)
        with use_rules(rules):
            out[tp] = dryrun.trace_step(cfg, shape, _mesh(tp))
        assert set(seen) == {(256 // tp, 64 // tp)}
    assert out[1]["flops"] == TP * out[TP]["flops"]
    whole = cfg.with_(q_chunk=4096)
    rules = batch_layout(make_rules(whole, shape, _mesh()), shape.global_batch)
    with use_rules(rules):
        one_chunk = dryrun.trace_step(whole, shape, _mesh())
    assert out[TP]["memory"]["peak_bytes"] < one_chunk["memory"]["peak_bytes"]
