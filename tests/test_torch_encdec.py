"""The encoder-decoder family (seamless-m4t-medium) served through the port
against the reference, on the CPU.

The smoke model (``seamless-smoke``: 2 encoder and 2 decoder layers, d 64,
4 heads) with the reference's ``init_params(PRNGKey(0))`` weights
(``repro_torch.convert.params_from_jax``); frames and tokens from a numpy
seed.  Each case runs under no plan and under the smoke plan pair that the
port's DSE emits with every layer forced to one kernel backend
(``--plan-backend streaming_tt`` / ``tt_gemm``), so that the plain
versions of K1 and of K2-K5 run; the reference runs the same plan files in
Pallas interpret mode.

Tolerances are the reference's: fp32 1e-5 unplanned, 1e-4 under a plan
(both sides sum in fp32, in another order, through the kernels' plain
versions; ``tests/test_kernels.py:34,89``).  Within the port, the decode
step against the full decoder at the same position is held at 1e-5.
"""

from __future__ import annotations

import contextlib
import io
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.steps import make_decode_step as ref_make_decode_step
from repro.launch.steps import make_prefill_step as ref_make_prefill_step
from repro.models import SHAPES as REF_SHAPES
from repro.models import api as ref_api
from repro.models import encdec as ref_encdec
from repro.models import input_specs as ref_input_specs
from repro.nn import install_plan as ref_install_plan
from repro.nn import plan_context as ref_plan_context
from repro.plan import execution_log as ref_execution_log
from repro.plan import load_plan as ref_load_plan
from repro.plan import reset_execution_log as ref_reset_execution_log
from repro_torch import dse_cli
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import ENC_LEN_CAP, SHAPES, api, encdec, input_specs
from repro_torch.nn import install_plan, plan_context
from repro_torch.plan import execution_log, load_plan, reset_execution_log
from repro_torch.tree import leaves, map_tree
from test_torch_plan import one_blas_thread  # noqa: F401

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
BACKENDS = (None, "streaming_tt", "tt_gemm")
B, PROMPT, FRAMES, MAX_SEQ = 2, 10, 12, 16


def tol(backend) -> dict:
    t = 1e-5 if backend is None else 1e-4
    return dict(rtol=t, atol=t)


@pytest.fixture(autouse=True, scope="module")
def _clear_installed_plans():
    yield
    ref_install_plan(None)
    install_plan(None)


class Model:
    """The smoke model in both packages (the same weights), its plan pair
    per forced backend (``(None, None)`` for no plan), and the inputs."""

    def __init__(self, plan_dir: str):
        self.cfg = get_config(ARCH, smoke=True)
        self.rcfg = ref_get_config(ARCH, smoke=True)
        self.rm = ref_api(self.rcfg, plan=None)
        self.rparams = jax.jit(self.rm.init_params)(jax.random.PRNGKey(0))
        self.m = api(self.cfg, plan=None, device="cpu")
        self.params = params_from_jax(jax.tree.map(np.asarray, self.rparams))
        self.plans = {None: (None, None)}
        self.rplans = {None: (None, None)}
        for backend in BACKENDS[1:]:
            prefix = os.path.join(plan_dir, backend)
            with contextlib.redirect_stdout(io.StringIO()):
                assert dse_cli.main(
                    ["--arch", ARCH, "--smoke", "--top-k", "2", "--tokens", "16",
                     "--serve-slots", "2", "--plan-backend", backend,
                     "--emit-plan-pair", prefix, "--out", os.devnull]) == 0
            files = [f"{prefix}.{p}.json" for p in ("prefill", "decode")]
            self.plans[backend] = tuple(load_plan(f) for f in files)
            self.rplans[backend] = tuple(ref_load_plan(f) for f in files)
        rng = np.random.default_rng(0)
        self.tokens = rng.integers(0, self.cfg.vocab, (B, PROMPT + 4)).astype(np.int32)
        self.frames = {n: rng.normal(size=(B, n, self.cfg.d_model)).astype(np.float32)
                       for n in (FRAMES, 32)}

    def batch(self, n_tokens: int = PROMPT, frames: int = FRAMES):
        """(numpy batch, torch batch) of the first ``n_tokens`` tokens."""
        nb = {"tokens": self.tokens[:, :n_tokens], "frontend": self.frames[frames]}
        return nb, {"tokens": torch.from_numpy(nb["tokens"]).long(),
                    "frontend": torch.from_numpy(nb["frontend"])}


@pytest.fixture(scope="module")
def model(tmp_path_factory) -> Model:
    return Model(str(tmp_path_factory.mktemp("plans")))


def _close(got, want, backend, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=err_msg, **tol(backend))


def _used_backends() -> set:
    return {r["backend"] for r in execution_log()}


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames", [FRAMES, 32])
@pytest.mark.parametrize("backend", BACKENDS)
def test_encoder_matches_reference(model, backend, frames):
    """``encode``: non-causal self-attention over 12 frames (one ragged
    chunk) and 32 (two ``q_chunk=16`` chunks: the chunk loop runs) with
    positions ``arange(S_enc)``, then the MLP, per layer."""
    pre, rpre = model.plans[backend][0], model.rplans[backend][0]
    x = model.frames[frames]
    with ref_plan_context(rpre):
        want = jax.jit(lambda p, f: ref_encdec.encode(model.rcfg, p, f))(
            model.rparams, jnp.asarray(x))
    reset_execution_log()
    with plan_context(pre):
        got = encdec.encode(model.cfg, model.params, torch.from_numpy(x))
    _close(got, want, backend)
    assert _used_backends() == (set() if backend is None else {backend})


@pytest.mark.parametrize("n_kv_heads", [4, 2])
@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_attention_matches_reference(model, backend, n_kv_heads):
    """``_cross_attention`` of decoder layer 0 on given memory K/V; with 2
    kv heads for 4 query heads each memory head serves two consecutive
    query heads (``h // n_rep``), unlike self-attention's interleaving."""
    cfg, rcfg = model.cfg.with_(n_kv_heads=n_kv_heads), model.rcfg.with_(
        n_kv_heads=n_kv_heads)
    # the query and output projections do not depend on the kv heads
    rp = jax.tree.map(lambda a: a[0], model.rparams["dec_blocks"])["xattn"]
    p = model.params["dec_blocks"][0]["xattn"]
    rng = np.random.default_rng(n_kv_heads)
    x = rng.normal(size=(B, 5, cfg.d_model)).astype(np.float32)
    mk, mv = (rng.normal(size=(B, FRAMES, n_kv_heads, cfg.hd)).astype(np.float32)
              for _ in range(2))
    pre, rpre = model.plans[backend][0], model.rplans[backend][0]
    with ref_plan_context(rpre):
        want = jax.jit(lambda p_, *a: ref_encdec._cross_attention(rcfg, p_, *a))(
            rp, jnp.asarray(x), jnp.asarray(mk), jnp.asarray(mv))
    with plan_context(pre):
        got = encdec._cross_attention(cfg, p, *map(torch.from_numpy, (x, mk, mv)))
    _close(got, want, backend)
    if n_kv_heads < cfg.n_heads:
        # the other grouping (query head h on kv head h % n_kv) is far off
        n_rep = cfg.n_heads // n_kv_heads
        order = [h % n_kv_heads for h in range(cfg.n_heads)]
        rk = torch.from_numpy(mk)[:, :, order]
        rv = torch.from_numpy(mv)[:, :, order]
        cfg_full = cfg.with_(n_kv_heads=cfg.n_heads)
        with plan_context(pre):
            other = encdec._cross_attention(cfg_full, p, torch.from_numpy(x), rk, rv)
        assert n_rep > 1 and np.abs(other.detach().numpy() - np.asarray(want)).max() > 1e-2


def _ref_prefill_and_decode(model, backend, steps: int):
    pre, dec = model.rplans[backend]
    nb, _ = model.batch()
    with ref_plan_context(pre):
        logits, caches = jax.jit(lambda p, b: model.rm.prefill(p, b, MAX_SEQ))(
            model.rparams, jax.tree.map(jnp.asarray, nb))
    outs = [(logits, caches)]
    with ref_plan_context(dec):
        step = jax.jit(model.rm.decode_step)
        for i in range(steps):
            tok = jnp.asarray(model.tokens[:, PROMPT + i:PROMPT + i + 1])
            logits, caches = step(model.rparams, tok, caches,
                                  jnp.asarray(PROMPT + i, jnp.int32))
            outs.append((logits, caches))
    return outs


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_and_decode_steps_match_reference(model, backend):
    """``prefill`` (last-token logits; self K/V of every decoder layer, cross
    K/V cast to the config's dtype) then 4 ``decode_step``s at scalar
    positions 10-13 under the decode plan: logits and caches."""
    want = _ref_prefill_and_decode(model, backend, 4)
    pre, dec = model.plans[backend]
    _, tb = model.batch()
    reset_execution_log()
    with plan_context(pre):
        logits, caches = model.m.prefill(model.params, tb, MAX_SEQ)
    # the self K/V are updated in place: keep each step's copy
    got = [(logits, map_tree(torch.clone, caches))]
    for i in range(4):
        tok = torch.from_numpy(model.tokens[:, PROMPT + i:PROMPT + i + 1]).long()
        with plan_context(dec):
            logits, caches = model.m.decode_step(model.params, tok, caches,
                                                 torch.tensor(PROMPT + i))
        got.append((logits, map_tree(torch.clone, caches)))
    for step, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        assert gl.shape == (B, model.cfg.vocab)
        _close(gl, wl, backend, f"step {step}")
        for layer in range(model.cfg.n_layers):
            for a, b in ((gc.self_kv[layer].k, wc.self_kv.k[layer]),
                         (gc.self_kv[layer].v, wc.self_kv.v[layer]),
                         (gc.cross_k[layer], wc.cross_k[layer]),
                         (gc.cross_v[layer], wc.cross_v[layer])):
                assert a.dtype == torch.float32 and a.shape == b.shape
                _close(a, b, backend, f"step {step} layer {layer}")
    assert _used_backends() == (set() if backend is None else {backend})


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_equals_the_full_decoder(model, backend):
    """``prefill(tokens[:8])`` then ``decode_step(tokens[8])`` at position 8
    equals the full decoder over ``tokens[:9]`` at its last position, in
    the port (1e-5); and the reference's decode step (plan tolerance)."""
    pre, dec = model.plans[backend]
    _, tb = model.batch(8)
    tok = torch.from_numpy(model.tokens[:, 8:9]).long()
    with plan_context(pre):
        _, caches = model.m.prefill(model.params, tb, MAX_SEQ)
    with plan_context(dec):
        step, _ = model.m.decode_step(model.params, tok, caches, torch.tensor(8))
        memory = encdec.encode(model.cfg, model.params, tb["frontend"])
        mem_kv = encdec._stacked_memory_kv(model.cfg, model.params, memory)
        full, _ = encdec._decoder(model.cfg, model.params,
                                  torch.from_numpy(model.tokens[:, :9]).long(),
                                  mem_kv, None, None)
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(), rtol=1e-5, atol=1e-5)
    rpre, rdec = model.rplans[backend]
    nb, _ = model.batch(8)
    with ref_plan_context(rpre):
        _, rc = jax.jit(lambda p, b: model.rm.prefill(p, b, MAX_SEQ))(
            model.rparams, jax.tree.map(jnp.asarray, nb))
    with ref_plan_context(rdec):
        want, _ = jax.jit(model.rm.decode_step)(model.rparams, jnp.asarray(tok.numpy(),
                                                                           jnp.int32),
                                                rc, jnp.asarray(8, jnp.int32))
    _close(step, want, backend)


# ---------------------------------------------------------------------------
# plan names: what runs planned, what runs on the plain contraction
# ---------------------------------------------------------------------------

def _asked_names(monkeypatch, linear_module) -> list:
    """Record every projection name the model looks up in the installed
    plan (``nn.linear.planned_layer``, at trace time in the reference)."""
    asked, real = [], linear_module.planned_layer

    def recording(name):
        asked.append(name)
        return real(name)

    monkeypatch.setattr(linear_module, "planned_layer", recording)
    return asked


@pytest.mark.parametrize("backend", BACKENDS[1:])
def test_execution_log_names_match_reference(model, backend, monkeypatch):
    """Under the smoke prefill plan, the projection names that ran planned
    (``execution_log``) and those that ran unplanned (looked up, absent
    from the plan) equal the reference's: the plan names the decoder's
    self-attention and MLP ``attn.*`` / ``mlp.*`` and the model asks for
    ``dec_attn.*`` / ``dec_mlp.*`` (``src/repro/dse_cli.py:119-122``,
    ``src/repro/models/encdec.py:161,170``), so those run unplanned in
    both, and the plan's ``attn.*`` and ``mlp.*`` entries never run."""
    import repro.nn.linear as ref_linear
    import repro_torch.nn.linear as port_linear

    pre, rpre = model.plans[backend][0], model.rplans[backend][0]
    nb, tb = model.batch()
    ref_asked = _asked_names(monkeypatch, ref_linear)
    ref_reset_execution_log()
    with ref_plan_context(rpre):
        jax.jit(lambda p, b: model.rm.prefill(p, b, MAX_SEQ))(
            model.rparams, jax.tree.map(jnp.asarray, nb))
    ref_planned = {r["name"] for r in ref_execution_log()}
    asked = _asked_names(monkeypatch, port_linear)
    reset_execution_log()
    with plan_context(pre):
        model.m.prefill(model.params, tb, MAX_SEQ)
    planned = {r["name"] for r in execution_log()}
    assert planned == ref_planned
    assert set(asked) - planned == set(ref_asked) - ref_planned
    assert planned == {f"{a}.{w}" for a in ("enc_attn", "xattn")
                       for w in ("wq", "wk", "wv", "wo")} | {"enc_mlp.wu", "enc_mlp.wd"}
    assert set(asked) - planned == {f"dec_attn.{w}" for w in ("wq", "wk", "wv", "wo")} \
        | {"dec_mlp.wu", "dec_mlp.wd"}
    assert {lp.name for lp in pre.layers} - set(asked) == {
        f"attn.{w}" for w in ("wq", "wk", "wv", "wo")} | {"mlp.wu", "mlp.wd", "head"}
    assert _used_backends() == {backend}


# ---------------------------------------------------------------------------
# the API: input specs, step builders, the example
# ---------------------------------------------------------------------------

def _spec_shapes(tree):
    """{path: (shape, dtype name)} of a spec tree (dicts, sequences, the
    port's per-layer lists stacked as the reference's leading axis)."""
    if hasattr(tree, "_fields"):
        return _spec_shapes(dict(zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k in tree for p, v in _spec_shapes(tree[k]).items()}
    if isinstance(tree, (list, tuple)) and tree and isinstance(tree[0], torch.Tensor):
        shape, dt = tuple(tree[0].shape), str(tree[0].dtype).split(".")[-1]
        return {"": ((len(tree),) + shape, dt)}
    if isinstance(tree, (list, tuple)):
        if tree and hasattr(tree[0], "_fields"):
            # per-layer named tuples -> one named tuple of stacked fields
            fields = type(tree[0])._fields
            return _spec_shapes({f: [getattr(t, f) for t in tree] for f in fields})
        return {f"[{i}]{p}": v for i, t in enumerate(tree)
                for p, v in _spec_shapes(t).items()}
    if isinstance(tree, torch.Tensor):
        return {"": (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    return {"": (tuple(tree.shape), str(tree.dtype))}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", [ARCH, "tt-lm-100m", "internvl2-2b", "zamba2-1.2b",
                                  "rwkv6-7b"])
def test_input_specs_match_reference(arch, shape):
    """``input_specs`` of the full-width config at each step's cell: meta
    tensors of the reference's ShapeDtypeStructs' shapes and dtypes (the
    port's per-layer cache lists against the reference's stacked leading
    axis); an encoder-decoder's frames capped at ``ENC_LEN_CAP``."""
    got = input_specs(get_config(arch), SHAPES[shape])
    want = ref_input_specs(ref_get_config(arch), REF_SHAPES[shape])
    assert all(t.device.type == "meta" for t in leaves(got))
    assert _spec_shapes(got) == _spec_shapes(want)
    if arch == ARCH and shape != "decode_32k":
        assert got["frontend"].shape[1] == min(ENC_LEN_CAP, SHAPES[shape].seq_len)


@pytest.mark.parametrize("arch", [ARCH, "tt-lm-100m"])
def test_prefill_and_decode_step_builders_match_reference(arch):
    """``make_prefill_step(cfg, max_seq)`` and ``make_decode_step(cfg)`` of
    the smoke model against the reference's: logits at 1e-5 through a
    prefill and 3 greedy decode steps at scalar positions, no autograd
    graph built."""
    cfg, rcfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
    rparams = jax.jit(ref_api(rcfg, plan=None).init_params)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, rparams))
    for p in leaves(params):
        p.requires_grad_(True)
    install_plan(None)
    rng = np.random.default_rng(3)
    nb = {"tokens": rng.integers(0, cfg.vocab, (B, 6)).astype(np.int32)}
    if cfg.family == "encdec":
        nb["frontend"] = rng.normal(size=(B, 8, cfg.d_model)).astype(np.float32)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    tb["tokens"] = tb["tokens"].long()
    rl, rc = jax.jit(ref_make_prefill_step(rcfg, max_seq=12))(
        rparams, jax.tree.map(jnp.asarray, nb))
    logits, caches = make_prefill_step(cfg, max_seq=12)(params, tb)
    assert not logits.requires_grad
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl), rtol=1e-5, atol=1e-5)
    rdecode, decode = jax.jit(ref_make_decode_step(rcfg)), make_decode_step(cfg)
    tok = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]
    for i in range(3):
        rl, rc = rdecode(rparams, jnp.asarray(tok), rc, jnp.asarray(6 + i, jnp.int32))
        logits, caches = decode(params, torch.from_numpy(tok).long(), caches,
                                torch.tensor(6 + i))
        assert not logits.requires_grad
        np.testing.assert_allclose(logits.numpy(), np.asarray(rl), rtol=1e-5, atol=1e-5)
        tok = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]


def test_serve_decode_example_runs_on_the_cpu():
    """``examples/serve_decode_torch.py --arch seamless-m4t-medium --smoke
    --device cpu``: exit 0 with the reference example's report lines."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_decode_torch.py"), "--arch",
         ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--gen", "4"], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("prefill 2x8: ") and lines[1].startswith("decode 3 steps")
    assert lines[2].startswith("sample: [")


def test_api_builds_and_has_no_full_logits_prefill():
    m = api(get_config(ARCH, smoke=True), device="cpu")
    assert m.prefill_full is None
    caches = m.init_caches(2, 16)
    assert len(caches.self_kv) == len(caches.cross_k) == 2
    assert caches.cross_k[0].shape == (2, 16, 4, 16)
    caches = api(get_config(ARCH), device="meta").init_caches(1, 8192)
    assert caches.cross_k[0].shape == (1, ENC_LEN_CAP, 16, 64)
