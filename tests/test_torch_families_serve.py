"""The MoE, hybrid (Mamba2), RWKV6 and VLM families as a whole: the
smoke models through the port against the reference, on the CPU.

Each family's smoke config is planned by the port's DSE with every layer
forced to one kernel backend (``--plan-backend streaming_tt`` and
``--plan-backend tt_gemm``, a prefill/decode pair), so that the plain
versions of K1 and of K2-K5 run; the reference runs the same plan files
in Pallas interpret mode.  Weights come from the reference's
``init_params`` (``repro_torch.convert.params_from_jax``); prompts are
made from a seed with numpy.

Tolerance 1e-4 for logits, as for the dense slice: both sides accumulate
in fp32 in another order, and the error grows through the layers and the
caches.  Token ids are compared exactly: the port's continuous batching
against its one-shot serving and against the reference's tokens.
"""

from __future__ import annotations

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.nn import install_plan as ref_install_plan
from repro.nn import plan_context as ref_plan_context
from repro.plan import load_plan as ref_load_plan
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import ServePolicy as RefServePolicy
from repro_torch import dse_cli
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as port_serve
from repro_torch.models import api
from repro_torch.nn import install_plan, plan_context
from repro_torch.plan import execution_log, load_plan, reset_execution_log
from repro_torch.serve import Scheduler, ServeEngine, ServePolicy, synthetic_trace
from test_torch_plan import one_blas_thread  # noqa: F401

torch.set_num_threads(2)

ARCHS = ("qwen2-moe-a2.7b", "zamba2-1.2b", "rwkv6-7b", "internvl2-2b")
BACKENDS = ("streaming_tt", "tt_gemm")
N_SLOTS, MAX_SEQ, BUCKET = 2, 24, 4
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _clear_installed_plans():
    yield
    ref_install_plan(None)
    install_plan(None)


class _Family:
    """Reference and port of one smoke model, the same weights, and its
    plan pair per forced backend."""

    def __init__(self, arch: str, plan_dir: str):
        self.arch = arch
        self.cfg = get_config(arch, smoke=True)
        self.rcfg = ref_get_config(arch, smoke=True)
        self.rm = ref_api(self.rcfg, plan=None)
        self.rparams = jax.jit(self.rm.init_params)(jax.random.PRNGKey(0))
        self.m = api(self.cfg, plan=None, device="cpu")
        self.params = params_from_jax(jax.tree.map(np.asarray, self.rparams))
        self.plans, self.rplans = {}, {}
        for backend in BACKENDS:
            prefix = os.path.join(plan_dir, f"{arch}.{backend}")
            with contextlib.redirect_stdout(io.StringIO()):
                assert dse_cli.main(
                    ["--arch", arch, "--smoke", "--top-k", "2", "--tokens", "16",
                     "--serve-slots", str(N_SLOTS), "--plan-backend", backend,
                     "--emit-plan-pair", prefix, "--out", os.devnull]) == 0
            files = [f"{prefix}.{p}.json" for p in ("prefill", "decode")]
            self.plans[backend] = [load_plan(f) for f in files]
            self.rplans[backend] = [ref_load_plan(f) for f in files]
        self._tokens: dict = {}

    def batch(self, b: int, s: int, seed: int = 0) -> dict:
        rng = np.random.default_rng(seed)
        out = {"tokens": rng.integers(0, self.cfg.vocab, (b, s)).astype(np.int32)}
        if self.cfg.family == "vlm":
            out["frontend"] = rng.normal(
                size=(b, self.cfg.n_frontend_tokens, self.cfg.d_model)).astype(np.float32)
        return out

    def engine(self, backend: str) -> ServeEngine:
        pre, dec = self.plans[backend]
        return ServeEngine(self.cfg, self.params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                           prompt_bucket=BUCKET, prefill_plan=pre, decode_plan=dec,
                           arch=self.arch)

    def ref_tokens(self, backend: str, requests, schedule: str = "continuous"):
        if (backend, schedule) not in self._tokens:
            pre, dec = self.rplans[backend]
            eng = RefServeEngine(self.rcfg, self.rparams, n_slots=N_SLOTS,
                                 max_seq=MAX_SEQ, prompt_bucket=BUCKET,
                                 prefill_plan=pre, decode_plan=dec, arch=self.arch)
            self._tokens[backend, schedule] = RefScheduler(
                eng, RefServePolicy(schedule)).run(requests).tokens_by_rid()
        return self._tokens[backend, schedule]


_FAMILIES: dict[str, _Family] = {}


@pytest.fixture(params=ARCHS)
def family(request, tmp_path_factory) -> _Family:
    if request.param not in _FAMILIES:
        _FAMILIES[request.param] = _Family(
            request.param, str(tmp_path_factory.mktemp("plans")))
    return _FAMILIES[request.param]


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_full_and_decode_steps_match_reference(family, backend):
    """Full prefill logits (a VLM with its frontend prefix), then two decode
    steps with per-lane positions, under the plan pair: logits at 1e-4,
    every projection on the forced backend."""
    pre, dec = family.plans[backend]
    rpre, rdec = family.rplans[backend]
    batch = family.batch(2, 10)
    with ref_plan_context(rpre):
        rlogits, rcaches = jax.jit(
            lambda p, b: family.rm.prefill_full(p, b, MAX_SEQ))(
                family.rparams, jax.tree.map(jnp.asarray, batch))
    reset_execution_log()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    with plan_context(pre):
        logits, caches = family.m.prefill_full(family.params, tb, MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    assert {r["backend"] for r in execution_log()} == {backend}

    with ref_plan_context(rdec):
        rdecode = jax.jit(family.rm.decode_step)
    tok = np.argmax(np.asarray(rlogits)[:, -1], axis=-1).astype(np.int32)[:, None]
    offset = family.cfg.n_frontend_tokens if family.cfg.family == "vlm" else 0
    for step in range(2):
        pos = np.array([10 + offset + step, 6 + step], np.int32)  # per-lane
        with ref_plan_context(rdec):
            rl, rcaches = rdecode(family.rparams, jnp.asarray(tok), rcaches,
                                  jnp.asarray(pos))
        with plan_context(dec):
            pl, caches = family.m.decode_step(
                family.params, torch.from_numpy(tok).long(), caches,
                torch.from_numpy(pos).long())
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
        tok = np.argmax(np.asarray(rl), axis=-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("backend", BACKENDS)
def test_served_tokens_match_reference_and_oneshot(family, backend):
    """Three requests through the continuous-batching scheduler (2 decode
    lanes) give the reference's tokens, and one-shot serving the same.  The
    reference's own MoE keeps that contract too (its decode group of 2
    tokens never fills an expert's 4 slots), so the port is held to it."""
    requests = synthetic_trace(3, family.cfg.vocab, prompt_len=5, gen=4, seed=1)
    got = Scheduler(family.engine(backend), ServePolicy("continuous")).run(requests)
    one = Scheduler(family.engine(backend), ServePolicy("oneshot")).run(requests)
    assert got.tokens_by_rid() == one.tokens_by_rid()
    assert got.tokens_by_rid() == family.ref_tokens(backend, requests)
    if family.cfg.family == "moe":
        assert family.ref_tokens(backend, requests, "oneshot") == got.tokens_by_rid()
    if family.cfg.supports_long_context:
        assert family.engine(backend).prompt_bucket == 1


def test_serve_cli_runs_each_family_under_a_strict_plan(family, tmp_path, capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu`` with the
    streaming pair and ``--strict-plan``: exit 0, every projection on K1's
    plain version."""
    pre, dec = (str(tmp_path / f"{p}.json") for p in ("prefill", "decode"))
    for plan, path in zip(family.plans["streaming_tt"], (pre, dec)):
        with open(path, "w") as f:
            f.write(plan.dumps())
    assert port_serve.main(
        ["--arch", family.arch, "--smoke", "--device", "cpu", "--plan-prefill", pre,
         "--plan-decode", dec, "--strict-plan", "--schedule", "continuous",
         "--batch", "2", "--n-requests", "3", "--prompt-len", "5", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "planned executions" in out and "DEMOTED" not in out
