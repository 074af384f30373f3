"""The experts' batched launch (the reference's ``jax.vmap`` of the planned
projection over the stacked expert axis) against the reference and
against the port's per-expert calls, on the CPU.

* The batched plain versions of K1 and K3, the batched GEMM contraction
  and the batched planned projection (forward and every gradient) equal
  the per-expert unbatched calls bit for bit: the CPU runs each expert's
  plain version, and the card's batched launches are held to the same
  bits by ``tests/test_torch_cuda.py``.
* ``moe_apply`` of smoke qwen2-moe-a2.7b's layer 0 under its smoke train
  plan forced to ``streaming_tt`` (K1, K3) and to ``tt_gemm`` (K2-K4):
  the output, the aux loss, dx and every parameter's gradient against
  the reference's ``moe_apply`` under the same plan, its Pallas kernels
  in interpret mode as its own tests run them.  Tolerances: the output
  at 1e-4 under K1 and 1e-5 under ``tt_gemm`` (the reference's
  ``tests/test_kernels.py``), every gradient at 1e-4 (its gradcheck
  tolerance, ``tests/test_backward.py:40``).
* The port's ``moe.*`` execution-log records (name, backend, tokens,
  phase, wrt) of that forward and backward equal the reference's: one
  per projection at ``G * cap`` tokens and one per backward op, as its
  trace under ``vmap`` writes them.

Weights come from the reference's ``init_params``; inputs are made from a
seed with numpy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models import blocks as ref_blocks
from repro.nn import install_plan as ref_install_plan
from repro.nn import moe as ref_moe
from repro.plan import execution_log as ref_execution_log
from repro.plan import load_plan as ref_load_plan
from repro.plan import reset_execution_log as ref_reset_execution_log
from repro_torch import dse_cli
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import execute_path, find_topk_paths
from repro_torch.kernels import launches, ops, streaming_tt, tt_gemm
from repro_torch.models import blocks
from repro_torch.nn import install_plan, moe
from repro_torch.plan import (execution_log, load_plan, planned_tt_linear,
                              planned_tt_linear_batched, reset_execution_log)
from _torch_shard_ranks import MOE_ROUTES, named_leaves, spawn
from test_torch_plan import one_blas_thread  # noqa: F401

torch.set_num_threads(2)

ARCH = "qwen2-moe-a2.7b"
BACKENDS = ("streaming_tt", "tt_gemm")
#: the output's tolerance on each backend; every gradient at GRAD_TOL
FWD_TOL = {"streaming_tt": 1e-4, "tt_gemm": 1e-5}
GRAD_TOL = 1e-4
#: (batch, seq, router_group, capacity_factor): one routing group, and
#: two groups whose capacity drops (token, choice) pairs
CASES = {"one group": (2, 8, 512, 1.25), "dropped pairs": (2, 8, 8, 0.3)}


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The smoke config's layer-0 MoE weights in both packages and its
    smoke train plan forced to each kernel backend (the port's DSE)."""
    d = tmp_path_factory.mktemp("plans")
    plans = {}
    for backend in BACKENDS:
        path = str(d / f"{backend}.json")
        with contextlib.redirect_stdout(io.StringIO()):
            assert dse_cli.main(
                ["--arch", ARCH, "--smoke", "--mode", "train", "--top-k", "2",
                 "--tokens", "32", "--plan-backend", backend, "--emit-plan", path,
                 "--out", os.devnull]) == 0
        plans[backend] = path
    rcfg = ref_get_config(ARCH, smoke=True)
    rparams = jax.jit(ref_api(rcfg, plan=None).init_params)(jax.random.PRNGKey(0))
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"])["moe"]
    p = params_from_jax(jax.tree.map(np.asarray, rparams))["blocks"][0]["moe"]
    return get_config(ARCH, smoke=True), rcfg, rp, p, plans


def _specs(cfg, rcfg, case):
    _, _, group, cf = CASES[case]
    return (dataclasses.replace(blocks.moe_spec(cfg), router_group=group,
                                capacity_factor=cf),
            dataclasses.replace(ref_blocks.moe_spec(rcfg), router_group=group,
                                capacity_factor=cf))


def _stacked_inputs(spec, experts, tokens, seed):
    """x (E, tokens, d_in) and stacked cores of ``spec``'s network."""
    tn = spec.network(tokens)
    x = torch.from_numpy(_np((experts, tokens, spec.d_in), seed))
    cores = [torch.from_numpy(_np((experts,) + n.dims, seed + 1 + k, 0.3))
             for k, n in enumerate(tn.nodes) if n.kind != "input"]
    return tn, x, cores


def test_batched_plain_k1_and_k3_equal_the_per_expert_plain_versions(smoke):
    """K1 along every top-2 path of the experts' up and down projections,
    and K3 at a weight-gradient shape: the batched plain versions are the
    per-expert plain versions, stacked, bit for bit; a CPU call counts no
    launch."""
    cfg = smoke[0]
    spec = blocks.moe_spec(cfg)
    launches.reset()
    for ls in (spec.expert_up, spec.expert_down):
        tn, x, cores = _stacked_inputs(ls, 6, 7, 10)
        for path in find_topk_paths(tn, k=2):
            got = streaming_tt.streaming_tt_linear_batched(x, cores, tn, path)
            assert got.shape == (6, 7, ls.d_out)
            for e in range(6):
                want = streaming_tt.streaming_tt_linear_plain(
                    x[e], [c[e] for c in cores], tn, path)
                assert torch.equal(got[e], want)
    a = torch.from_numpy(_np((6, 21, 48), 20))
    b = torch.from_numpy(_np((6, 48, 12), 21))
    for dataflow in ("WS", "OS", "IS"):
        got = tt_gemm.tt_gemm_batched(a, b, dataflow=dataflow, block_m=16,
                                      block_k=16, block_n=8)
        for e in range(6):
            assert torch.equal(got[e], tt_gemm.tt_gemm_plain(
                a[e], b[e], dataflow=dataflow, block_m=16, block_k=16, block_n=8))
    assert sum(launches.COUNTS.values()) == 0


@pytest.mark.parametrize("dataflow", ["WS", "OS", None])
def test_batched_gemm_contraction_and_backward_equal_per_expert(smoke, dataflow):
    """``execute_path`` with the GEMM contraction (``dataflow`` None: the
    plain one, a ``torch.bmm`` a step) on operands behind the experts' axis
    and ``ops.tt_linear_backward`` on stacked operands (dx streamed through
    batched K1, every core gradient one batched network) equal the
    per-expert unbatched calls bit for bit."""
    spec = blocks.moe_spec(smoke[0]).expert_up
    tn, x, cores = _stacked_inputs(spec, 5, 9, 30)
    path = find_topk_paths(tn, k=1)[0]
    names = [n.name for n in tn.nodes if n.kind != "input"]
    out_edges = ("b",) + tuple(f"i{t + 1}" for t in range(len(spec.out_modes)))
    contract = (ops.gemm_contract(dataflow=dataflow, block_m=16, block_k=8,
                                  block_n=8) if dataflow else None)
    xs = x.reshape((5, 9) + spec.in_modes)
    got = execute_path(tn, path, {"X": xs, **dict(zip(names, cores))},
                       out_edges=out_edges, contract_fn=contract)
    for e in range(5):
        want = execute_path(tn, path, {"X": xs[e], **{n: c[e] for n, c in
                                                      zip(names, cores)}},
                            out_edges=out_edges, contract_fn=contract)
        assert torch.equal(got[e], want)
    dy = torch.from_numpy(_np((5, 9, spec.d_out), 40))

    routes = {wrt: ops.GradRoute(None, "streaming_tt", block_tokens=8)
              if wrt == "dx" else
              ops.GradRoute(None, "tt_gemm" if dataflow else "jnp", contract)
              for wrt in ["dx"] + names}

    dx, dcores = ops.tt_linear_backward(tn, x, dy, cores, routes)
    for e in range(5):
        wdx, wcores = ops.tt_linear_backward(tn, x[e], dy[e], [c[e] for c in cores],
                                             routes)
        assert torch.equal(dx[e], wdx)
        for g, w in zip(dcores, wcores):
            assert torch.equal(g[e], w)


@pytest.mark.parametrize("backend", BACKENDS)
def test_planned_batched_projection_equals_per_expert_calls(smoke, backend):
    """``planned_tt_linear_batched`` of the plan's ``moe.ed``: the output
    and the gradients of x and of every stacked core equal E unbatched
    ``planned_tt_linear`` calls bit for bit; the batched call writes the
    records of one unbatched call (one forward, one a fused segment, one
    a backward op), the E calls E times as many."""
    cfg, _, _, _, plans = smoke
    lp = next(layer for layer in load_plan(plans[backend]).layers
              if layer.name == "moe.ed")
    spec = blocks.moe_spec(cfg).expert_down
    geometry = (spec.in_modes, spec.out_modes, spec.tt_ranks)
    _, x, cores = _stacked_inputs(spec, 4, 11, 50)
    w = torch.from_numpy(_np((4, 11, spec.d_out), 60))
    leaves = [x.clone().requires_grad_(True)] + [
        c.clone().requires_grad_(True) for c in cores]
    reset_execution_log()
    y = planned_tt_linear_batched(lp, leaves[0], leaves[1:], *geometry)
    (y * w).sum().backward()
    records = execution_log()
    segments = sum("segment" in r for r in records)
    assert len(records) == 1 + segments + 1 + len(cores)
    reset_execution_log()
    for e in range(4):
        one = [x[e].clone().requires_grad_(True)] + [
            c[e].clone().requires_grad_(True) for c in cores]
        ye = planned_tt_linear(lp, one[0], one[1:], *geometry)
        (ye * w[e]).sum().backward()
        assert torch.equal(y[e], ye)
        for batched, single in zip(leaves, one):
            assert torch.equal(batched.grad[e], single.grad)
    assert len(execution_log()) == 4 * len(records)


def _slots(spec, case) -> int:
    """An expert's rows: ``G * cap`` (``nn/moe.py``'s capacity rule)."""
    b, s, _, _ = CASES[case]
    g = min(spec.router_group, b * s)
    cap = max(4, min(int(np.ceil(spec.top_k * g * spec.capacity_factor
                                 / spec.n_experts)), g))
    return (b * s // g) * cap


def _ref_records(log):
    return sorted((r["name"], r["backend"], r["tokens"], r["phase"], r.get("wrt"))
                  for r in log if r["name"].startswith("moe."))


def _reference(smoke, backend, case):
    """The reference's ``moe_apply`` under ``backend``'s plan on the
    case's inputs: y, aux, the gradients of ``sum(y w) + aux`` by
    parameter path (``/eu/core0``) and of x, and its ``moe.*`` records."""
    cfg, rcfg, rp, _, plans = smoke
    _, rspec = _specs(cfg, rcfg, case)
    b, s, _, _ = CASES[case]
    x = _np((b, s, cfg.d_model), 70)
    w = _np((b, s, cfg.d_model), 71)

    def ref_loss(params, x_):
        y, aux = ref_moe.moe_apply(rspec, params, x_)
        return jnp.sum(y * w) + aux, (y, aux)

    ref_install_plan(ref_load_plan(plans[backend]))
    ref_reset_execution_log()
    try:
        (_, (ry, raux)), (rgp, rgx) = jax.jit(jax.value_and_grad(
            ref_loss, argnums=(0, 1), has_aux=True))(rp, jnp.asarray(x))
        rlog = _ref_records(ref_execution_log())
    finally:
        ref_install_plan(None)
    grads = {"".join(f"/{k.key}" if hasattr(k, "key") else f"[{k.idx}]"
                     for k in path): np.asarray(g)
             for path, g in jax.tree_util.tree_flatten_with_path(rgp)[0]}
    return np.asarray(ry), float(raux), grads, np.asarray(rgx), rlog


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_planned_moe_apply_matches_reference(smoke, backend, case):
    """``moe_apply`` under the smoke train plan forced to ``backend``: y,
    aux, dx and every gradient leaf (router, the experts' stacked cores,
    the shared FFN) against the reference under the same plan, and the
    ``moe.*`` execution-log records equal to the reference's."""
    cfg, rcfg, rp, p, plans = smoke
    spec, _ = _specs(cfg, rcfg, case)
    b, s, _, _ = CASES[case]
    x = _np((b, s, cfg.d_model), 70)
    w = _np((b, s, cfg.d_model), 71)
    ry, raux, rgrads, rgx, rlog = _reference(smoke, backend, case)

    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), p)
    tx = torch.from_numpy(x).requires_grad_(True)
    install_plan(load_plan(plans[backend]))
    reset_execution_log()
    try:
        y, aux = moe.moe_apply(spec, params, tx)
        (torch.sum(y * torch.from_numpy(w)) + aux).backward()
        log = _ref_records(execution_log())
    finally:
        install_plan(None)

    tol = FWD_TOL[backend]
    np.testing.assert_allclose(y.detach().numpy(), ry, rtol=tol, atol=tol)
    np.testing.assert_allclose(aux.item(), raux, rtol=tol, atol=tol)
    np.testing.assert_allclose(tx.grad.numpy(), rgx, rtol=GRAD_TOL, atol=GRAD_TOL)
    got = named_leaves(jax.tree.map(lambda t: t.grad, params))
    assert got.keys() == rgrads.keys() and len(got) > 10
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), rgrads[path], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=path)
    experts = [r for r in log if r[0].startswith("moe.e")]
    assert experts and {r[2] for r in experts} == {_slots(spec, case)}
    assert {r[0] for r in experts} == {"moe.eu", "moe.eg", "moe.ed"}
    assert log == rlog


@pytest.fixture(scope="module")
def sharded(smoke, tmp_path_factory):
    """Every rank's results of ``_torch_shard_ranks.body_moe_batched``: the
    smoke MoE layer under the K1 plan on each route of ``MOE_ROUTES`` and
    each case of :data:`CASES`, on 2 ``gloo`` ranks."""
    d = tmp_path_factory.mktemp("moe_batched")
    torch.save(smoke[3], d / "params.pt")
    ranks = spawn("moe_batched", 2, {
        "arch": ARCH, "params": str(d / "params.pt"),
        "plan": smoke[4]["streaming_tt"],
        "cases": {case: list(CASES[case]) for case in CASES}}, d / "out")
    return [r["moe_batched"] for r in ranks]


#: the collectives one expert projection sends on a route that shards it:
#: {direction: {kind: count}}; the data-split routes add none of their own
PER_PROJECTION = {
    "rows": {"fwd": {"all_gather": 1}, "bwd": {"all_gather": 1, "all_reduce": 1}},
    "reduce": {"fwd": {"all_reduce": 1}, "bwd": {"all_gather": 2, "all_reduce": 1}},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("route", sorted(MOE_ROUTES))
def test_sharded_batched_experts_match_reference(smoke, sharded, route, case):
    """The experts' batched projections on the sharded routes (rows split
    over ``data``, ``batch_split``, the model reduction, ``seq_split``), 2
    ranks: on every rank y and aux at the K1 tolerance, dx and every
    gradient leaf (the stacked expert cores summed once each) at the
    gradient tolerance, against the reference's ``moe_apply`` on the whole
    batch; one forward record per expert projection, and on a sharded
    route one set of its collectives per projection (not one per expert):
    the collectives less the shared FFN's are those of the three expert
    projections, or on a data-split route the routing's one each way."""
    ry, raux, rgrads, rgx, _ = _reference(smoke, "streaming_tt", case)
    tol = FWD_TOL["streaming_tt"]
    for rank in sharded:
        got = rank[(route, case)]
        np.testing.assert_allclose(got["y"].numpy(), ry, rtol=tol, atol=tol)
        np.testing.assert_allclose(got["aux"], raux, rtol=tol, atol=tol)
        np.testing.assert_allclose(got["dx"].numpy(), rgx, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        assert got["grads"].keys() == rgrads.keys()
        for path, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), rgrads[path], rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=path)
        experts = [r for r in got["records"] if r[0] in ("moe.eu", "moe.eg", "moe.ed")
                   and r[1] == "fwd"]
        assert sorted(r[0] for r in experts) == ["moe.ed", "moe.eg", "moe.eu"]
        own = {way: {k: got[way][k] - got["shared"][way][k] for k in got[way]}
               for way in ("fwd", "bwd")}
        if route in PER_PROJECTION:
            # the rows route splits an expert's rows only where 2 divides
            # them (one group: 7 slots, so the experts run whole)
            n = sum(bool(r[4]) for r in experts)
            spec = _specs(smoke[0], smoke[1], case)[0]
            assert n == (3 if route == "reduce" or _slots(spec, case) % 2 == 0 else 0)
            assert own == {way: {k: n * PER_PROJECTION[route][way].get(k, 0)
                                 for k in own[way]} for way in own}
        else:
            assert all(r[4] for r in experts)
            assert sum(own["fwd"].values()) == sum(own["bwd"].values()) == 1
