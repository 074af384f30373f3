"""tt-lm-smoke under its rank-searched plan: the port against the reference.

``tt-lm-smoke.rank.json`` (schema v4) sets every layer to a searched d = 1
factorization: each TT projection is X (T, d_in) . G (d_in, r) . G (r,
d_out), a two-core network whose path has no token-free step.  The plan
installs before ``init_params`` in both packages (the factorizations set
the parameter shapes), and the weights cross over through NumPy
(``repro_torch.convert.params_from_jax``).

Tolerances are the reference's: 1e-4 for logits, rtol 1e-5 for the
activation RMS that the rank search's calibration weights come from.
The plan's layers run on ``jnp`` (the plain executor), but its tied head
is planned on ``streaming_tt``; ``plan_backend="streaming_tt"`` forces
every layer onto K1 (its plain version here, the reference's Pallas
kernel in interpret mode) through the new ``api(..., plan_backend=)``.
"""

from __future__ import annotations

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.nn import capture_activation_rms as ref_capture
from repro.nn import install_plan as ref_install_plan
from repro.plan import load_plan as ref_load_plan
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import api
from repro_torch.nn import capture_activation_rms, install_plan
from repro_torch.plan import execution_log, load_plan, reset_execution_log
from repro_torch.rank import activation_calibration
from repro_torch.serve import Request, Scheduler, ServeEngine, ServePolicy

torch.set_num_threads(2)

PLANS = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"
RANK_PLAN = str(PLANS / "tt-lm-smoke.rank.json")
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 16


@pytest.fixture(autouse=True, scope="module")
def _clear_installed_plans():
    yield
    ref_install_plan(None)
    install_plan(None)


def _models(backend=None, eager=False):
    """(reference api, its params, port api, the same params) under the
    smoke rank plan, ``backend`` forced on every layer.  ``eager`` turns
    off the reference's layer scan and remat, as its calibration forward
    does (a traced layer hides its activations from the capture hook)."""
    rcfg, cfg = ref_get_config("tt-lm-100m", smoke=True), get_config("tt-lm-100m",
                                                                       smoke=True)
    if eager:
        rcfg = dataclasses.replace(rcfg, scan_layers=False, remat="none")
        cfg = dataclasses.replace(cfg, scan_layers=False, remat="none")
    rm = ref_api(rcfg, plan=ref_load_plan(RANK_PLAN), plan_backend=backend)
    rparams = rm.init_params(jax.random.PRNGKey(0))
    m = api(cfg, plan=RANK_PLAN, plan_backend=backend, device="cpu")
    return rm, rparams, m, params_from_jax(jax.tree.map(np.asarray, rparams))


def _tokens(b=2, s=8, vocab=512, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def test_rank_plan_parameters_take_the_searched_shapes():
    _, rparams, m, params = _models()
    wq = params["blocks"][0]["attn"]["wq"]
    assert sorted(tuple(v.shape) for v in wq.values()) == [(2, 128), (256, 2)]
    own = m.init_params(0)["blocks"][0]["attn"]["wq"]
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in wq.items()}


@pytest.mark.parametrize("backend", [None, "streaming_tt", "tt_gemm"])
def test_prefill_last_token_logits_match_reference(backend):
    rm, rparams, m, params = _models(backend)
    toks = _tokens()
    rlogits, _ = rm.prefill(rparams, {"tokens": jnp.asarray(toks)}, MAX_SEQ)
    reset_execution_log()
    logits, caches = m.prefill(params, {"tokens": torch.from_numpy(toks).long()},
                               MAX_SEQ)
    assert logits.shape == (2, 512) and len(caches) == 2
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    full, _ = m.prefill_full(params, {"tokens": torch.from_numpy(toks).long()},
                             MAX_SEQ)
    assert torch.equal(full[:, -1], logits)
    # the plan's layers run on jnp (the plain executor); the tied head's
    # streaming_tt entry never executes; a forced backend takes every layer
    backends = {r["backend"] for r in execution_log()}
    assert backends == {backend or "jnp"}


def test_activation_rms_capture_matches_reference():
    rm, rparams, m, params = _models(eager=True)
    toks = _tokens(seed=1)
    with ref_capture() as want:
        rm.prefill(rparams, {"tokens": jnp.asarray(toks)}, MAX_SEQ)
    with capture_activation_rms() as got:
        m.prefill(params, {"tokens": torch.from_numpy(toks).long()}, MAX_SEQ)
    assert sorted(got) == sorted(want) and got
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-5)
    # no capture open: nothing is recorded
    with capture_activation_rms() as empty:
        pass
    assert empty == {}


def test_activation_calibration_on_the_cpu():
    cfg = get_config("tt-lm-100m", smoke=True)
    install_plan(load_plan(RANK_PLAN))
    try:
        a = activation_calibration(cfg, device="cpu")
        b = activation_calibration(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
        c = activation_calibration(cfg, device="cpu", seed=1)
    finally:
        install_plan(None)
    assert a == b and a != c
    assert set(a) == {"attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wg",
                      "mlp.wu", "mlp.wd"}
    assert all(v > 0 and np.isfinite(v) for v in a.values())


def test_api_plan_backend_checks_match_reference():
    cfg, rcfg = get_config("tt-lm-100m", smoke=True), ref_get_config("tt-lm-100m",
                                                                       smoke=True)
    for kw in (dict(plan=RANK_PLAN, plan_backend="nope"),
               dict(plan_backend="tt_gemm"), dict(plan=None, plan_backend="jnp")):
        with pytest.raises(ValueError) as mine:
            api(cfg, device="cpu", **kw)
        rkw = dict(kw)
        if isinstance(rkw.get("plan"), str):
            rkw["plan"] = ref_load_plan(rkw["plan"])
        with pytest.raises(ValueError) as theirs:
            ref_api(rcfg, **rkw)
        assert str(mine.value) == str(theirs.value)
    install_plan(None)
    ref_install_plan(None)


@pytest.mark.parametrize("backend", [None, "streaming_tt"])
def test_rank_plan_serves_continuous_equal_to_oneshot(backend):
    _, _, _, params = _models(backend)
    plan = load_plan(RANK_PLAN)
    eng = ServeEngine(get_config("tt-lm-100m", smoke=True), params, n_slots=2,
                      max_seq=MAX_SEQ, prompt_bucket=4, prefill_plan=plan,
                      decode_plan=plan, arch="tt-lm-100m", plan_backend=backend)
    rng = np.random.default_rng(7)
    requests = [Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
                    0, 512, size=1 + i % 5)),
                        max_new_tokens=1 + (3 * i) % 4, arrival=float(i % 3))
                for i in range(5)]
    runs = [Scheduler(eng, ServePolicy(schedule), seed=3).run(requests)
            for schedule in ("continuous", "oneshot")]
    assert runs[0].tokens_by_rid() == runs[1].tokens_by_rid()
    assert len(runs[0].completions) == len(requests)
