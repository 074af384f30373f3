"""The training loop of the port against the JAX package: train step, AdamW,
schedules, the data pipeline, checkpoints and the ``launch.train`` driver.

Tolerances: the 2-step loss curve at rel 1e-4 (the gradients agree at
1e-4, ``tests/test_torch_train.py``); one AdamW update at 1e-6 (elementwise
fp32 arithmetic in another library); data batches and checkpoint leaves
exactly.
"""

from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.data import make_pipeline as ref_make_pipeline
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import api as ref_api
from repro.nn import install_plan as ref_install_plan
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import linear_warmup_cosine as ref_warmup_cosine
from repro.plan import load_plan as ref_load_plan
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import make_pipeline
from repro_torch.launch import train as port_train
from repro_torch.launch.steps import make_eval_loss, make_train_step
from repro_torch.models import api
from repro_torch.nn import install_plan
from repro_torch.optim import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    linear_warmup_cosine,
)
from repro_torch.plan import load_plan
from repro_torch.runtime import FaultTolerantLoop
from repro_torch.tree import leaves

torch.set_num_threads(2)

PLANS = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"
SMOKE_TRAIN = "tt-lm-smoke.train.tt_gemm.json"


@pytest.fixture(autouse=True, scope="module")
def _clear_installed_plans():
    yield
    ref_install_plan(None)
    install_plan(None)


def _trainable(params):
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def test_two_step_loss_curve_matches_reference():
    """Two steps of ``make_train_step`` under the smoke tt_gemm train plan
    (fused segments forward, tt_gemm backward), batches from the shared
    data pipeline."""
    rcfg, cfg = ref_get_config("tt-lm-100m", smoke=True), get_config("tt-lm-100m", smoke=True)
    rm = ref_api(rcfg, plan=ref_load_plan(str(PLANS / SMOKE_TRAIN)))
    rparams = rm.init_params(jax.random.PRNGKey(0))
    params = _trainable(params_from_jax(jax.tree.map(np.asarray, rparams)))
    pipe = make_pipeline(cfg.vocab, 16, 2)
    rstep = jax.jit(ref_make_train_step(rcfg))
    ropt = ref_adamw_init(rparams)
    install_plan(load_plan(str(PLANS / SMOKE_TRAIN)))
    step = make_train_step(cfg)
    opt = adamw_init(params)
    for s in range(2):
        batch = pipe.batch(s)
        rparams, ropt, rmetrics = rstep(rparams, ropt,
                                        {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, metrics = step(params, opt, {k: torch.from_numpy(v).long()
                                                  for k, v in batch.items()})
        assert float(metrics["loss"]) == pytest.approx(float(rmetrics["loss"]), rel=1e-4)
        assert float(metrics["grad_norm"]) == pytest.approx(
            float(rmetrics["grad_norm"]), rel=1e-4)
    assert int(opt.step) == int(ropt.step) == 2
    # the eval loss of the updated weights agrees too
    ev = float(make_eval_loss(cfg)(params, {k: torch.from_numpy(v).long()
                                            for k, v in pipe.batch(2).items()}))
    rev = float(rm.train_loss(rparams, {k: jnp.asarray(v)
                                        for k, v in pipe.batch(2).items()}))
    assert ev == pytest.approx(rev, rel=1e-4)


def _random_tree(rng):
    return {"blocks": {"w": rng.normal(size=(3, 4, 5)).astype(np.float32)},
            "embed": {"core0": rng.normal(size=(7,)).astype(np.float32)},
            "ln_f": {"scale": (1 + rng.normal(size=(6,))).astype(np.float32)}}


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(0)
    params, grads = _random_tree(rng), _random_tree(rng)
    rparams = jax.tree.map(jnp.asarray, params)
    rgrads, rnorm = ref_clip(jax.tree.map(jnp.asarray, grads), 1.0)
    lr = ref_warmup_cosine(3e-4, 2, 10)
    rstate = ref_adamw_init(rparams)
    tparams = jax.tree.map(torch.from_numpy, params)
    tgrads, tnorm = clip_by_global_norm(jax.tree.map(torch.from_numpy, grads), 1.0)
    tstate = adamw_init(tparams)
    assert float(tnorm) == pytest.approx(float(rnorm), rel=1e-6)
    for _ in range(3):   # warmup, then cosine
        rparams, rstate = ref_adamw_update(rgrads, rstate, rparams, lr)
        tparams, tstate = adamw_update(tgrads, tstate, tparams,
                                       linear_warmup_cosine(3e-4, 2, 10))
    for got, want in zip(leaves(tparams) + leaves(tstate.m) + leaves(tstate.v),
                         jax.tree.leaves(rparams) + jax.tree.leaves(rstate.m)
                         + jax.tree.leaves(rstate.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for s in (0, 1, 2, 5, 10, 20):
        assert float(linear_warmup_cosine(3e-4, 2, 10)(torch.tensor(s))) == \
            pytest.approx(float(lr(jnp.asarray(s))), rel=1e-6)


@pytest.mark.parametrize("seed", [0, 5])
def test_data_pipeline_batches_are_the_reference(seed):
    mine, theirs = make_pipeline(512, 16, 4, seed), ref_make_pipeline(512, 16, 4, seed)
    for step in (0, 3):
        for rank, world in ((0, 1), (1, 2)):
            a, b = mine.batch(step, rank, world), theirs.batch(step, rank, world)
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype


def _ref_state(step: int):
    cfg = ref_get_config("tt-lm-100m", smoke=True)
    rparams = ref_api(cfg, plan=None).init_params(jax.random.PRNGKey(1))
    ropt = ref_adamw_init(rparams)._replace(step=jnp.asarray(step, jnp.int32))
    ropt = ropt._replace(m=jax.tree.map(lambda p: p * 0.5, rparams))
    return {"params": rparams, "opt": ropt}


def _port_template():
    params = api(get_config("tt-lm-100m", smoke=True), plan=None,
                 device="cpu").init_params(0)
    return {"params": params, "opt": adamw_init(params)}


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    ref_state = _ref_state(7)
    RefCheckpointManager(str(tmp_path / "ref")).save(7, ref_state)
    step, state = CheckpointManager(str(tmp_path / "ref")).restore(_port_template())
    assert step == 7 and isinstance(state["opt"], AdamWState)
    assert int(state["opt"].step) == 7 and state["opt"].step.dtype == torch.int32
    want = params_from_jax(jax.tree.map(np.asarray, ref_state["params"]))
    for got, ref in zip(leaves(state["params"]), leaves(want)):
        assert torch.equal(got, ref)
    for got, ref in zip(leaves(state["opt"].m), leaves(
            params_from_jax(jax.tree.map(np.asarray, ref_state["opt"].m)))):
        assert torch.equal(got, ref)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    ref_state = _ref_state(3)
    mgr = CheckpointManager(str(tmp_path / "port"), keep=2)
    RefCheckpointManager(str(tmp_path / "ref")).save(3, ref_state)
    _, port_state = CheckpointManager(str(tmp_path / "ref")).restore(_port_template())
    for s in (1, 2, 3):
        mgr.save_async(s, port_state)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]          # retention keeps the newest two
    step, back = RefCheckpointManager(str(tmp_path / "port")).restore(ref_state)
    assert step == 3
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        assert np.array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


TRAIN_ARGS = ["--smoke", "--device", "cpu", "--plan", str(PLANS / SMOKE_TRAIN),
              "--batch", "2", "--seq", "16", "--log-every", "1"]


def test_train_cli_resume_continues_the_same_loss(tmp_path, capsys):
    straight = port_train.run(TRAIN_ARGS + ["--steps", "3", "--ckpt-dir",
                                            str(tmp_path / "a")])
    assert straight.code == 0 and len(straight.losses) == 3
    first = port_train.run(TRAIN_ARGS + ["--steps", "2", "--ckpt-every", "1",
                                         "--ckpt-dir", str(tmp_path / "b")])
    assert first.losses == straight.losses[:2]
    resumed = port_train.run(TRAIN_ARGS + ["--steps", "3", "--resume",
                                           "--ckpt-dir", str(tmp_path / "b")])
    assert resumed.done == 3 and resumed.losses == straight.losses[2:]
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert "planned execution under grad: fwd backends ['tt_gemm'], " \
        "bwd backends ['tt_gemm']" in out
    assert "fused segments under grad:" in out
    assert all(np.isfinite(straight.losses)) and straight.fused_runs > 0


def test_train_cli_refuses_missing_card_and_mismatched_plan(tmp_path, capsys):
    if not torch.cuda.is_available():
        assert port_train.main(["--smoke", "--steps", "1"]) == 2
    code = port_train.main(["--smoke", "--device", "cpu", "--steps", "1",
                            "--ckpt-dir", str(tmp_path), "--plan",
                            str(PLANS / "tt-lm-100m.train.json")])
    assert code == 2
    assert "plan/model mismatch" in capsys.readouterr().err


def _poison_loop(tmp_path, fail):
    """A loop (checkpoint every 2 steps, 2 retries a step) whose step 3
    fails while ``fail(n)`` holds for its n-th call; the step-2 checkpoint
    has landed before step 3 runs, so each failure restores it and
    replays step 2.  Returns the loop, the steps called and ``run``'s
    outcome."""
    mgr = CheckpointManager(str(tmp_path))
    calls, tries = [], []

    def step_fn(state, step):
        calls.append(step)
        if len(calls) > 50:
            pytest.fail(f"replayed forever: {calls[:12]} ...")
        if step == 3:
            mgr.wait()
            tries.append(step)
            if fail(len(tries)):
                raise RuntimeError("step 3 fails")
        return {"x": state["x"] + 1}

    loop = FaultTolerantLoop(step_fn, mgr, checkpoint_every=2, max_retries_per_step=2)
    try:
        out = loop.run({"x": torch.zeros(())}, 0, 6)
    except RuntimeError as e:
        out = e
    return loop, calls, out


def test_a_step_that_always_fails_after_a_checkpoint_aborts(tmp_path):
    """The poison-batch guard counts the retries of the failing step across
    the replay of the step before it: three failures of step 3, then the
    error.  (The reference's loop resets the count on the replayed step 2
    and replays forever once the checkpoint has landed; its own test of a
    poison step passes only while that checkpoint is still being written.)"""
    loop, calls, out = _poison_loop(tmp_path, lambda n: True)
    assert isinstance(out, RuntimeError)
    assert calls == [0, 1, 2, 3, 2, 3, 2, 3]
    assert loop.recoveries == 3


def test_a_step_that_fails_twice_recovers_from_its_checkpoint(tmp_path):
    """Two failures of step 3 stay within the two retries: restored from
    step 2 and replayed each time, the loop finishes all six steps with
    every step's update applied once."""
    loop, calls, out = _poison_loop(tmp_path, lambda n: n <= 2)
    state, done = out
    assert done == 6 and int(state["x"]) == 6
    assert calls == [0, 1, 2, 3, 2, 3, 2, 3, 4, 5]
    assert loop.recoveries == 2

