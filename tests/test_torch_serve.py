"""The slice as a whole: tt-lm-smoke through the port against the reference.

Weights come from the JAX package's ``init_params`` and cross over as
numpy arrays (``repro_torch.convert.params_from_jax``).  The JAX side runs
its Pallas kernels in interpret mode; the port runs the kernels' plain
PyTorch versions on the CPU.

Tolerance 1e-4 for logits: both sides accumulate in fp32 but in another
order, and the error grows through the layers and the KV cache (the
reference's own tolerance for TT contractions, ``tests/test_kernels.py:89``).
Token ids and continuous == oneshot are compared exactly.

The smoke ``tt_gemm`` plan fuses path steps [2, 4) of every layer into one
segment; both packages serve it as emitted, the port through its
fused-segment kernel's wrapper (``kernels/fused_path.py``).
"""

from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.nn import attention as ref_attention
from repro.nn import install_plan as ref_install_plan
from repro.nn import embedding as ref_embedding
from repro.nn import norms as ref_norms
from repro.nn import rope as ref_rope
from repro.plan import load_plan as ref_load_plan
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import ServePolicy as RefServePolicy
from repro.serve import synthetic_trace as ref_synthetic_trace
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as port_serve
from repro_torch.models import api
from repro_torch.models import lm as port_lm
from repro_torch.nn import attention, embedding, install_plan, norms, rope
from repro_torch.plan import execution_log, load_plan, reset_execution_log
from repro_torch.serve import Request, Scheduler, ServeEngine, ServePolicy, synthetic_trace

torch.set_num_threads(2)

PLANS = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"
SMOKE_PLANS = ("tt-lm-smoke.json", "tt-lm-smoke.tt_gemm.json")
N_SLOTS, MAX_SEQ, BUCKET = 2, 16, 4
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _clear_installed_plans():
    """Plans install globally in both packages; leave none behind for the
    test modules that run next in this process."""
    yield
    ref_install_plan(None)
    install_plan(None)


class _Pair:
    """Reference and port of tt-lm-smoke under one plan, same weights."""

    def __init__(self, plan_name: str):
        self.cfg = get_config("tt-lm-100m", smoke=True)
        self.rcfg = ref_get_config("tt-lm-100m", smoke=True)
        self.rplan = ref_load_plan(str(PLANS / plan_name))
        self.plan = load_plan(str(PLANS / plan_name))
        self.rm = ref_api(self.rcfg, plan=self.rplan)
        self.rparams = self.rm.init_params(jax.random.PRNGKey(0))
        self.m = api(self.cfg, plan=self.plan, device="cpu")
        self.params = params_from_jax(jax.tree.map(np.asarray, self.rparams))
        self._cache: dict = {}

    def ref_trace_tokens(self, requests):
        if "trace" not in self._cache:
            eng = RefServeEngine(self.rcfg, self.rparams, n_slots=N_SLOTS,
                                 max_seq=MAX_SEQ, prompt_bucket=BUCKET,
                                 prefill_plan=self.rplan, decode_plan=self.rplan,
                                 arch="tt-lm-100m")
            res = RefScheduler(eng, RefServePolicy("continuous")).run(requests)
            self._cache["trace"] = res.tokens_by_rid()
        return self._cache["trace"]

    def engine(self) -> ServeEngine:
        return ServeEngine(self.cfg, self.params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                           prompt_bucket=BUCKET, prefill_plan=self.plan,
                           decode_plan=self.plan, arch="tt-lm-100m")


_PAIRS: dict[str, _Pair] = {}


@pytest.fixture(params=SMOKE_PLANS)
def pair(request) -> _Pair:
    if request.param not in _PAIRS:
        _PAIRS[request.param] = _Pair(request.param)
    return _PAIRS[request.param]


def _prompt(b: int, s: int, vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def test_prefill_full_and_three_decode_steps_match_reference(pair):
    toks = _prompt(2, 8, pair.cfg.vocab)
    rlogits, rcaches = jax.jit(
        lambda p, t: pair.rm.prefill_full(p, {"tokens": t}, MAX_SEQ))(
            pair.rparams, jnp.asarray(toks))
    reset_execution_log()
    logits, caches = pair.m.prefill_full(
        pair.params, {"tokens": torch.from_numpy(toks).long()}, MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    backends = {r["backend"] for r in execution_log()}
    assert backends == {lp.backend for lp in pair.plan.layers}
    fused = {tuple(r["segment"]) for r in execution_log() if "segment" in r}
    assert fused == {tuple(s) for lp in pair.plan.layers for s in lp.segments or ()}

    rdecode = jax.jit(pair.rm.decode_step)
    tok = np.argmax(np.asarray(rlogits)[:, -1], axis=-1).astype(np.int32)[:, None]
    for step in range(3):
        pos = np.array([8 + step, 5 + step], np.int32)  # per-lane positions
        rl, rcaches = rdecode(pair.rparams, jnp.asarray(tok), rcaches,
                              jnp.asarray(pos))
        pl, caches = pair.m.decode_step(pair.params, torch.from_numpy(tok).long(),
                                        caches, torch.from_numpy(pos).long())
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
        tok = np.argmax(np.asarray(rl), axis=-1).astype(np.int32)[:, None]


def test_greedy_trace_tokens_match_reference(pair):
    requests = synthetic_trace(2, pair.cfg.vocab, prompt_len=5, gen=4, seed=0)
    rrequests = ref_synthetic_trace(2, pair.cfg.vocab, prompt_len=5, gen=4, seed=0)
    assert [r.prompt for r in requests] == [r.prompt for r in rrequests]
    got = Scheduler(pair.engine(), ServePolicy("continuous")).run(requests)
    assert got.tokens_by_rid() == pair.ref_trace_tokens(rrequests)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_continuous_equals_oneshot_bit_for_bit(pair, temperature):
    rng = np.random.default_rng(7)
    requests = [Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
                    0, pair.cfg.vocab, size=1 + i % 5)),
                        max_new_tokens=1 + (3 * i) % 4, arrival=float(i % 3))
                for i in range(5)]
    eng = pair.engine()
    runs = [Scheduler(eng, ServePolicy(schedule), temperature=temperature,
                      seed=3).run(requests)
            for schedule in ("continuous", "oneshot")]
    assert runs[0].tokens_by_rid() == runs[1].tokens_by_rid()
    assert len(runs[0].completions) == len(requests)


def test_unplanned_forward_matches_reference():
    cfg, rcfg = get_config("tt-lm-100m", smoke=True), ref_get_config("tt-lm-100m", smoke=True)
    rm = ref_api(rcfg, plan=None)
    rparams = rm.init_params(jax.random.PRNGKey(1))
    m = api(cfg, plan=None, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, rparams))
    toks = _prompt(1, 6, cfg.vocab, seed=2)
    rlogits, _ = rm.prefill_full(rparams, {"tokens": jnp.asarray(toks)}, 8)
    logits, _ = m.prefill_full(params, {"tokens": torch.from_numpy(toks).long()}, 8)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)


def test_params_from_jax_matches_port_init_shapes():
    cfg = get_config("tt-lm-100m", smoke=True)
    rparams = ref_api(ref_get_config("tt-lm-100m", smoke=True), plan=None).init_params(
        jax.random.PRNGKey(0))
    converted = params_from_jax(jax.tree.map(np.asarray, rparams))
    own = api(cfg, plan=None, device="cpu").init_params(0)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)

    assert shapes(converted) == shapes(own)
    assert len(own["blocks"]) == cfg.n_layers


def test_rmsnorm_and_rope_match_reference():
    x = np.random.default_rng(0).normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    scale = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        norms.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)).numpy(),
        np.asarray(ref_norms.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    for frac in (1.0, 0.5):
        np.testing.assert_allclose(
            rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                            rotary_fraction=frac).numpy(),
            np.asarray(ref_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                           rotary_fraction=frac)),
            rtol=1e-5, atol=1e-5)


def test_tt_embedding_and_tied_head_match_reference():
    cfg = get_config("tt-lm-100m", smoke=True)
    spec = port_lm.embed_spec(cfg)
    rspec = ref_embedding.EmbeddingSpec("embed", cfg.vocab, cfg.d_model,
                                        ref_get_config("tt-lm-100m", smoke=True).tt)
    rparams = ref_embedding.embedding_init(jax.random.PRNGKey(3), rspec)
    params = {k: torch.from_numpy(np.array(v)) for k, v in rparams.items()}
    ids = _prompt(2, 7, cfg.vocab, seed=4)
    np.testing.assert_allclose(
        embedding.embedding_apply(spec, params, torch.from_numpy(ids)).numpy(),
        np.asarray(ref_embedding.embedding_apply(rspec, rparams, jnp.asarray(ids))),
        rtol=1e-5, atol=1e-6)
    h = np.random.default_rng(5).normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        embedding.head_apply(spec, params, torch.from_numpy(h)).numpy(),
        np.asarray(ref_embedding.head_apply(rspec, rparams, jnp.asarray(h))),
        rtol=1e-4, atol=1e-6)


def test_attention_per_lane_decode_matches_reference():
    """Decode with a (B,) cache position: the in-place cache write and the
    per-lane valid horizon give the reference's output and cache."""
    cfg = get_config("tt-lm-100m", smoke=True)
    rcfg = ref_get_config("tt-lm-100m", smoke=True)
    from repro.models.blocks import attn_spec as ref_attn_spec
    from repro_torch.models.blocks import attn_spec

    rspec, spec = ref_attn_spec(rcfg), attn_spec(cfg)
    ref_install_plan(None)
    install_plan(None)
    rparams = ref_attention.attention_init(jax.random.PRNGKey(6), rspec)
    params = params_from_jax({"blocks": jax.tree.map(
        lambda a: np.asarray(a)[None], rparams)})["blocks"][0]
    rng = np.random.default_rng(7)
    k = rng.normal(size=(3, 10, spec.n_kv_heads, spec.head_dim)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([4, 0, 9], np.int32)
    ry, rcache = ref_attention.attention_apply(
        rspec, rparams, jnp.asarray(x), None,
        ref_attention.KVCache(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(pos))
    cache = attention.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    y, cache = attention.attention_apply(spec, params, torch.from_numpy(x), None,
                                         cache, torch.from_numpy(pos).long())
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(rcache.k), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(rcache.v), rtol=1e-5, atol=1e-6)


def test_serve_cli_runs_on_cpu_under_strict_plan(capsys):
    out = port_serve.run([
        "--smoke", "--device", "cpu", "--plan", str(PLANS / "tt-lm-smoke.json"),
        "--strict-plan", "--schedule", "continuous", "--batch", "2",
        "--n-requests", "3", "--prompt-len", "5", "--gen", "3"])
    assert out.code == 0
    assert len(out.result.completions) == 3
    assert "prefill backends {'streaming_tt'" in capsys.readouterr().out


def test_serve_cli_refuses_missing_card_and_swapped_pair(capsys):
    if not torch.cuda.is_available():
        assert port_serve.main(["--smoke"]) == 2
    code = port_serve.main([
        "--device", "cpu",
        "--plan-prefill", str(PLANS / "tt-lm-100m.pair.decode.json"),
        "--plan-decode", str(PLANS / "tt-lm-100m.pair.prefill.json")])
    assert code == 2
    assert "swapped" in capsys.readouterr().err
