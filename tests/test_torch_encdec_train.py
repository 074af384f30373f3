"""Training the encoder-decoder family (seamless-m4t-medium) through the
port against the reference, on the CPU.

The smoke model with the reference's ``init_params(PRNGKey(0))`` weights
(``repro_torch.convert.params_from_jax``); frames, tokens and labels from a
numpy seed (batch 2, 16 tokens, 12 frames).  The port runs under no plan
and under the smoke train plan that its DSE emits with every layer forced
to one kernel backend (``--smoke --mode train --top-k 2 --tokens 32
--plan-backend streaming_tt`` / ``tt_gemm``), so that its backward runs
through the plain versions of K1 (forward and dx) and of K2-K5; the
reference runs its plain path under ``jax.value_and_grad`` (a plan changes
only the order of fp32 sums), as the other families' training files do.

Tolerance 1e-4 (rtol and atol) for losses and every gradient leaf, the
reference's gradcheck tolerance; the port's remat modes are held bit-equal
to ``"none"``.
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
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import api as ref_api
from repro.models.lm import count_params as ref_count_params
from repro.nn import install_plan as ref_install_plan
from repro.optim import adamw_init as ref_adamw_init
from repro_torch import dse_cli
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as port_train
from repro_torch.launch.steps import make_eval_loss, make_train_step
from repro_torch.models import api
from repro_torch.models.lm import count_params
from repro_torch.nn import install_plan
from repro_torch.optim import adamw_init
from repro_torch.plan import execution_log, load_plan, reset_execution_log
from repro_torch.tree import leaves
from test_torch_plan import one_blas_thread  # noqa: F401

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
BACKENDS = ("streaming_tt", "tt_gemm")
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, SEQ, FRAMES = 2, 16, 12


class Model:
    """The smoke model in both packages, its train plan per forced backend,
    and the reference's loss and gradients, computed once per setting."""

    def __init__(self, plan_dir: str):
        self.cfg = get_config(ARCH, smoke=True)
        self.rcfg = ref_get_config(ARCH, smoke=True)
        self.rparams = jax.jit(ref_api(self.rcfg, plan=None).init_params)(
            jax.random.PRNGKey(0))
        self.plan_files = {}
        for backend in BACKENDS:
            path = os.path.join(plan_dir, f"{backend}.train.json")
            with contextlib.redirect_stdout(io.StringIO()):
                assert dse_cli.main(
                    ["--arch", ARCH, "--smoke", "--mode", "train", "--top-k", "2",
                     "--tokens", "32", "--plan-backend", backend, "--emit-plan",
                     path, "--out", os.devnull]) == 0
            self.plan_files[backend] = path
        self._refs: dict = {}

    def params(self) -> dict:
        p = params_from_jax(jax.tree.map(np.asarray, self.rparams))
        for leaf in leaves(p):
            leaf.requires_grad_(True)
        return p

    def batch(self, seed: int = 0) -> dict:
        rng = np.random.default_rng(seed)
        out = {k: rng.integers(0, self.cfg.vocab, (BATCH, SEQ)).astype(np.int32)
               for k in ("tokens", "labels")}
        out["frontend"] = rng.normal(size=(BATCH, FRAMES, self.cfg.d_model)).astype(
            np.float32)
        return out

    def plan(self, backend):
        return None if backend is None else load_plan(self.plan_files[backend])

    def reference(self, loss_chunk: int):
        if loss_chunk not in self._refs:
            ref_install_plan(None)
            rm = ref_api(self.rcfg.with_(loss_chunk=loss_chunk), plan=None)
            loss, grads = jax.jit(jax.value_and_grad(rm.train_loss))(
                self.rparams, jax.tree.map(jnp.asarray, self.batch()))
            self._refs[loss_chunk] = float(loss), params_from_jax(
                jax.tree.map(np.asarray, grads))
        return self._refs[loss_chunk]


@pytest.fixture(scope="module")
def model(tmp_path_factory) -> Model:
    yield Model(str(tmp_path_factory.mktemp("plans")))
    ref_install_plan(None)
    install_plan(None)


def torch_batch(batch: dict) -> dict:
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("tokens", "labels"):
        out[k] = out[k].long()
    return out


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in flat(t, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def loss_and_grads(model: Model, cfg, plan, batch=None):
    install_plan(None)
    m = api(cfg, plan=plan, device="cpu")
    params = model.params()
    loss = m.train_loss(params, torch_batch(batch or model.batch()))
    loss.backward()
    return loss.detach(), {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                           for k, p in flat(params).items()}


@pytest.mark.parametrize("loss_chunk", [0, 8])
@pytest.mark.parametrize("backend", (None,) + BACKENDS)
def test_train_loss_and_gradients_match_reference(model, backend, loss_chunk):
    """The loss and every gradient leaf (both layer stacks, the tied TT
    embedding, the cross-attention and its norm) at 1e-4 under no plan and
    under the train plan forced to K1 / K2-K5; ``loss_chunk`` 0 and 8 (two
    interleaved chunks of the vocab-254 logits).  The planned forward and
    backward records name only the encoder's and the cross-attention's
    projections (the decoder's self-attention and MLP run unplanned, as in
    the reference)."""
    rloss, rgrads = model.reference(loss_chunk)
    want = flat(rgrads)
    reset_execution_log()
    loss, got = loss_and_grads(model, model.cfg.with_(loss_chunk=loss_chunk),
                               model.plan(backend))
    assert loss.item() == pytest.approx(rloss, rel=1e-4)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), **TOL,
                                   err_msg=key)
    log = execution_log()
    if backend is None:
        assert not log
        return
    assert {r["backend"] for r in log if r["phase"] == "fwd"} == {backend}
    assert {r["backend"] for r in log if r["phase"] == "bwd"} >= {"tt_gemm"}
    assert {r["name"].split(".")[0] for r in log} == {"enc_attn", "enc_mlp", "xattn"}


@pytest.mark.parametrize("backend", [None, "streaming_tt"])
def test_remat_modes_are_bit_equal_to_none(model, backend):
    """``remat="full"`` and ``"dots"`` change no bit of the loss or of any
    gradient.  Under ``"full"`` every encoder layer (the first too, whose
    input needs no gradient) and the in-body ``xattn.wq`` / ``xattn.wo``
    forward again; the cross K/V, projected outside the decoder's remat,
    do not: 6 + 2 more planned forward records per layer pair."""
    plan = model.plan(backend)
    runs, fwd = {}, {}
    for mode in ("none", "full", "dots"):
        reset_execution_log()
        runs[mode] = loss_and_grads(model, model.cfg.with_(remat=mode), plan)
        fwd[mode] = [r["name"] for r in execution_log() if r["phase"] == "fwd"]
    loss, grads = runs["none"]
    for mode in ("full", "dots"):
        assert torch.equal(runs[mode][0], loss), mode
        for key, g in grads.items():
            assert torch.equal(runs[mode][1][key], g), (mode, key)
    if backend is not None:
        cfg = model.cfg
        assert len(fwd["none"]) == 6 * cfg.encoder_layers + 4 * cfg.n_layers
        assert len(fwd["full"]) == len(fwd["none"]) + 6 * cfg.encoder_layers \
            + 2 * cfg.n_layers
        assert fwd["full"].count("xattn.wk") == fwd["none"].count("xattn.wk")


def test_two_adamw_steps_match_reference(model):
    """Two steps of ``make_train_step`` (clip, AdamW) under the streaming
    train plan: the loss curve and the gradient norms at 1e-4; the eval
    loss of the updated weights too."""
    rstep = jax.jit(ref_make_train_step(model.rcfg))
    ref_install_plan(None)
    rparams, ropt = model.rparams, ref_adamw_init(model.rparams)
    install_plan(None)
    api(model.cfg, plan=model.plan("streaming_tt"), device="cpu")
    step = make_train_step(model.cfg)
    params = model.params()
    opt = adamw_init(params)
    try:
        for i in range(2):
            batch = model.batch(seed=10 + i)
            rparams, ropt, rmetrics = rstep(rparams, ropt,
                                            jax.tree.map(jnp.asarray, batch))
            params, opt, metrics = step(params, opt, torch_batch(batch))
            for k in ("loss", "grad_norm"):
                assert metrics[k].item() == pytest.approx(float(rmetrics[k]),
                                                          rel=1e-4), (i, k)
        batch = model.batch(seed=20)
        want = ref_api(model.rcfg).train_loss(rparams, jax.tree.map(jnp.asarray, batch))
        got = make_eval_loss(model.cfg)(params, torch_batch(batch))
        assert got.item() == pytest.approx(float(want), rel=1e-4)
    finally:
        install_plan(None)


def test_count_params_matches_reference(model):
    assert count_params(model.params()) == ref_count_params(model.rparams) > 0


def test_train_cli_refuses_encdec_where_the_reference_raises(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch seamless-m4t-medium``
    exits 2 naming the missing encoder frames: its data pipeline yields
    tokens and labels only.  The reference's train CLI feeds the same pipeline
    and fails at its first step with ``KeyError: 'frontend'``."""
    out = port_train.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                          "1", "--ckpt-dir", str(tmp_path / "port")])
    assert out.code == 2 and not out.losses
    err = capsys.readouterr().err
    assert "encoder frames" in err and "batch['frontend']" in err
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", "--arch", ARCH, "--smoke",
         "--steps", "1", "--batch", "2", "--seq", "16", "--ckpt-dir",
         str(tmp_path / "ref")], env=env, capture_output=True, text=True,
        timeout=300)
    assert ref.returncode != 0
    assert "KeyError: 'frontend'" in ref.stderr
