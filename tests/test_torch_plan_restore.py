"""The launchers leave the process's installed plan as they found it.

``launch.serve.run`` and ``launch.train.run`` install the plan they are
given into ``nn/linear.py``'s ``_PLAN`` (and a v4 plan's factorizations
into ``_FACTORIZATION``) and restore what was installed before on every
path out, an error exit included.  Before, a serve run left its plan in
the process, so a later shapes-only dry run in the same process (the
order ``tests/test_torch_shard_exec.py`` then
``tests/test_torch_dryrun_counts.py``) called K1 on ``meta`` tensors.
"""

from __future__ import annotations

import contextlib
import io
import pathlib

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, serve, train
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ShapeConfig
from repro_torch.nn import install_plan, linear
from repro_torch.plan import execution_log, load_plan, reset_execution_log
from repro_torch.sharding import use_rules

PLANS = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"
SERVE = ["--smoke", "--device", "cpu", "--batch", "2", "--n-requests", "2",
         "--prompt-len", "5", "--gen", "2", "--strict-plan"]


def _installed() -> tuple[dict, dict]:
    return dict(linear._PLAN), dict(linear._FACTORIZATION)


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kw)


@pytest.mark.parametrize("before", [None, "tt-lm-smoke.train.json"])
@pytest.mark.parametrize("plan", ["tt-lm-smoke.json", "tt-lm-smoke.rank.json"])
def test_serve_run_restores_the_installed_plan(plan, before):
    """A plain plan and a v4 plan (searched factorizations) served on the
    smoke config: ``_PLAN`` and ``_FACTORIZATION`` are what they were, an
    empty installation or another plan's."""
    install_plan(None if before is None else load_plan(str(PLANS / before)))
    try:
        want = _installed()
        run = _quiet(serve.run, SERVE + ["--plan", str(PLANS / plan)])
        assert run.code == 0
        assert _installed() == want
        if plan.endswith(".rank.json"):      # it did install factorizations
            assert load_plan(str(PLANS / plan)).layers[0].factorization is not None
    finally:
        install_plan(None)


def test_serve_and_train_restore_the_plan_on_an_error_exit(tmp_path):
    """A plan for another config is refused (exit 2) after it was loaded,
    and a train run's plan/model mismatch too: nothing stays installed."""
    install_plan(None)
    assert _quiet(serve.run, ["--smoke", "--device", "cpu", "--arch", "glm4-9b",
                              "--plan", str(PLANS / "tt-lm-smoke.json"),
                              "--batch", "2", "--n-requests", "1"]).code == 2
    assert _installed() == ({}, {})
    assert _quiet(train.run, ["--smoke", "--device", "cpu", "--arch", "glm4-9b",
                              "--plan", str(PLANS / "tt-lm-smoke.train.json"),
                              "--steps", "1"]).code == 2
    assert _installed() == ({}, {})


def test_train_run_restores_the_installed_plan(tmp_path):
    install_plan(None)
    run = _quiet(train.run, ["--smoke", "--device", "cpu", "--plan",
                             str(PLANS / "tt-lm-smoke.train.json"), "--steps", "1",
                             "--batch", "2", "--seq", "16", "--ckpt-dir",
                             str(tmp_path / "ck")])
    assert run.code == 0 and run.fwd_backends
    assert _installed() == ({}, {})


def test_a_dry_run_after_a_served_plan_runs_no_planned_projection():
    """The order that failed: a serve run under the smoke K1 plan, then the
    dry run's shapes-only train step of a dense smoke cell in the same
    process, which must run unplanned (no kernel is called on ``meta``)."""
    install_plan(None)
    assert _quiet(serve.run, SERVE + ["--plan", str(PLANS / "tt-lm-smoke.json")]).code == 0
    cfg = get_config("glm4-9b", smoke=True)
    mesh = Mesh({"data": 1, "model": 1}, {"data": 0, "model": 0}, {})
    reset_execution_log()
    with use_rules(None):
        out = dryrun.trace_step(cfg, ShapeConfig("t", 32, 2, "train"), mesh)
    assert out["flops"] > 0
    assert not execution_log()
