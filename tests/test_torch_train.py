"""Gradients through the port against ``jax.grad`` of the JAX package.

The JAX side runs its Pallas kernels in interpret mode; the port runs the
kernels' plain PyTorch versions on the CPU, under the executor's autograd
Functions.  Inputs come from ``np.random.default_rng``; model weights
cross over through ``convert.params_from_jax``.

Tolerance 1e-4 (rtol and atol) for outputs and gradients, the reference's
own gradcheck tolerance (``tests/test_backward.py:40``): both sides sum in
fp32, in another order.  The execution logs are compared as sets of
``(name, phase, backend, wrt, segment)``: the port logs per call, JAX per
trace.
"""

from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.backward import backward_networks as ref_backward_networks
from repro.core.paths import find_topk_paths as ref_find_topk_paths
from repro.core.tensor_network import tt_linear_network as ref_tt_linear_network
from repro.dse_cli import model_dse_layers as ref_model_dse_layers
from repro.kernels import ops as ref_ops
from repro.models import api as ref_api
from repro.nn import install_plan as ref_install_plan
from repro.plan import execution_log as ref_execution_log
from repro.plan import load_plan as ref_load_plan
from repro.plan import reset_execution_log as ref_reset_execution_log
from repro.plan.executor import planned_tt_linear as ref_planned_tt_linear
from repro_torch.configs import get_config
from repro_torch import dse_cli
from repro_torch.convert import params_from_jax
from repro_torch.core import find_topk_paths, tt_linear_network
from repro_torch.core.backward import backward_networks
from repro_torch.dse_cli import model_dse_layers
from repro_torch.kernels import launches, ops
from repro_torch.models import api
from repro_torch.nn import install_plan
from repro_torch.plan import execution_log, load_plan, reset_execution_log
from repro_torch.plan.executor import planned_tt_linear

torch.set_num_threads(2)

PLANS = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"
TRAIN_PLANS = ("tt-lm-smoke.train.json", "tt-lm-smoke.train.tt_gemm.json")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _clear_installed_plans():
    """Plans install globally in both packages; leave none behind."""
    yield
    ref_install_plan(None)
    install_plan(None)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _log_set(log) -> set:
    return {(r["name"], r["phase"], r["backend"], r.get("wrt"),
             tuple(r["segment"]) if "segment" in r else None) for r in log}


def _nodes(tn):
    return [(n.name, n.edges, n.dims, n.kind) for n in tn.nodes]


# ---------------------------------------------------------------------------
# gradient networks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_backward_networks_match_reference(smoke):
    mine = model_dse_layers(get_config("tt-lm-100m", smoke=smoke), tokens=37)
    theirs = ref_model_dse_layers(ref_get_config("tt-lm-100m", smoke=smoke), tokens=37)
    for (name, tn), (_, rtn) in zip(mine, theirs):
        got = [(wrt, _nodes(net)) for wrt, net in backward_networks(tn)]
        want = [(wrt, _nodes(net)) for wrt, net in ref_backward_networks(rtn)]
        assert got == want, name


# ---------------------------------------------------------------------------
# the differentiable kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataflow", ["OS", "WS", "IS"])
def test_tt_gemm_vjp_matches_reference(dataflow):
    a, b, w = _np((16, 24), 2), _np((24, 20), 3), _np((16, 20), 4)
    blocks = dict(block_m=8, block_k=8, block_n=8)

    def f(a, b):
        y = ref_ops.gemm(a, b, dataflow=dataflow, interpret=True,
                         differentiable=True, **blocks)
        return jnp.vdot(y, jnp.asarray(w))

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    y = ops.gemm(ta, tb, dataflow=dataflow, differentiable=True, **blocks)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[1]), **TOL)


def test_streaming_tt_vjp_matches_reference():
    """The reference's case (``tests/test_backward.py:236``): a block
    network of 8 tokens, 20 tokens streamed (a ragged last block)."""
    tn = tt_linear_network(8, (4, 4), (4, 4), (3, 3, 3))
    rtn = ref_tt_linear_network(8, (4, 4), (4, 4), (3, 3, 3))
    path, rpath = find_topk_paths(tn, k=1)[0], ref_find_topk_paths(rtn, k=1)[0]
    assert path.steps == rpath.steps
    cores = [_np(n.dims, 10 + k) for k, n in enumerate(tn.nodes) if n.name != "X"]
    x, w = _np((20, 16), 5), _np((20, 16), 6)

    def f(x, cores):
        y = ref_ops.tt_linear(x, cores, rtn, rpath, block_tokens=8,
                              interpret=True, differentiable=True)
        return jnp.vdot(y, jnp.asarray(w))

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                       tuple(jnp.asarray(c) for c in cores))
    tx = torch.from_numpy(x).requires_grad_(True)
    tcores = [torch.from_numpy(c).requires_grad_(True) for c in cores]
    y = ops.tt_linear(tx, tcores, tn, path, block_tokens=8, differentiable=True)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[0]), **TOL)
    for got, ref in zip(tcores, want[1]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# one planned projection, forward and backward, per backend
# ---------------------------------------------------------------------------

LAYER_CASES = [
    ("tt-lm-smoke.train.tt_gemm.json", "jnp"),
    ("tt-lm-smoke.train.json", None),           # streaming_tt, dx on K1
    ("tt-lm-smoke.train.tt_gemm.json", None),   # tt_gemm with fused segments
]


@pytest.mark.parametrize("tokens", [20, 37])
@pytest.mark.parametrize("plan_file,force", LAYER_CASES)
def test_planned_tt_linear_grads_match_reference(plan_file, force, tokens):
    lp = load_plan(str(PLANS / plan_file)).layer("mlp.wg")
    rlp = ref_load_plan(str(PLANS / plan_file)).layer("mlp.wg")
    if force is not None:
        lp, rlp = lp.with_backend(force), rlp.with_backend(force)
    spec = {s.name: s for s, _, _ in dse_cli._block_specs(
        get_config("tt-lm-100m", smoke=True))}["mlp.wg"]
    geometry = (spec.in_modes, spec.out_modes, spec.tt_ranks)
    x = _np((tokens, spec.d_in), 7)
    cores = [_np(n.dims, 20 + k, 0.5)
             for k, n in enumerate(spec.network(tokens).nodes) if n.kind != "input"]
    w = _np((tokens, spec.d_out), 8)

    def f(x, cores):
        y = ref_planned_tt_linear(rlp, x, cores, *geometry)
        return jnp.vdot(y, jnp.asarray(w)), y

    ref_reset_execution_log()
    (_, ry), rgrads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), [jnp.asarray(c) for c in cores])
    reset_execution_log()
    tx = torch.from_numpy(x).requires_grad_(True)
    tcores = [torch.from_numpy(c).requires_grad_(True) for c in cores]
    y = planned_tt_linear(lp, tx, tcores, *geometry)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rgrads[0]), **TOL)
    for got, ref in zip(tcores, rgrads[1]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), **TOL)
    assert _log_set(execution_log()) == _log_set(ref_execution_log())
    phases = {r["phase"] for r in execution_log()}
    assert phases == ({"fwd"} if force == "jnp" else {"fwd", "bwd"})


# ---------------------------------------------------------------------------
# the slice as a whole: tt-lm-smoke loss and every parameter gradient
# ---------------------------------------------------------------------------

class _Model:
    """tt-lm-smoke in both packages under one train plan, same weights."""

    def __init__(self, plan_name: str):
        self.cfg = get_config("tt-lm-100m", smoke=True)
        rcfg = ref_get_config("tt-lm-100m", smoke=True)
        self.rm = ref_api(rcfg, plan=ref_load_plan(str(PLANS / plan_name)))
        self.rparams = self.rm.init_params(jax.random.PRNGKey(0))
        rng = np.random.default_rng(3)
        self.batch = {k: rng.integers(0, self.cfg.vocab, size=(2, 16)).astype(np.int32)
                      for k in ("tokens", "labels")}
        ref_reset_execution_log()
        loss, grads = jax.jit(jax.value_and_grad(self.rm.train_loss))(
            self.rparams, {k: jnp.asarray(v) for k, v in self.batch.items()})
        self.ref_loss = float(loss)
        self.ref_grads = params_from_jax(jax.tree.map(np.asarray, grads))
        self.ref_log = _log_set(ref_execution_log())
        self.m = api(self.cfg, plan=load_plan(str(PLANS / plan_name)), device="cpu")


_MODELS: dict[str, _Model] = {}


@pytest.fixture(params=TRAIN_PLANS)
def model(request) -> _Model:
    if request.param not in _MODELS:
        _MODELS[request.param] = _Model(request.param)
    install_plan(load_plan(str(PLANS / request.param)))
    return _MODELS[request.param]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def test_smoke_train_loss_and_gradients_match_reference(model):
    params = params_from_jax(jax.tree.map(np.asarray, model.rparams))
    for p in _flat(params).values():
        p.requires_grad_(True)
    reset_execution_log()
    launches.reset()
    loss = model.m.train_loss(params, {k: torch.from_numpy(v).long()
                                       for k, v in model.batch.items()})
    loss.backward()
    assert loss.item() == pytest.approx(model.ref_loss, rel=1e-4)
    want = _flat(model.ref_grads)
    got = _flat(params)
    assert sorted(got) == sorted(want)
    for key, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[key].numpy(), **TOL,
                                   err_msg=key)
    log = execution_log()
    assert _log_set(log) == model.ref_log
    assert {r["backend"] for r in log if r["phase"] == "bwd"} >= {"tt_gemm"}
    assert sum(launches.COUNTS.values()) == 0  # the CPU runs the plain versions
