"""The reference's data-parallel layout in the port, on the CPU.

Where the batch axes divide a step's global batch, each rank holds and
computes only its block of the batch (``launch/mesh.py::batch_layout``,
``batch_shardings``, ``cache_shardings``, ``LayoutBlocks``):

* the three specs against the reference's ``PartitionSpec`` entries for
  the inputs and caches of every arch and shape, on the test meshes of 2,
  4 and 8 ranks;
* on 2 ``gloo`` ranks (``tests/_torch_shard_ranks.py``, 60 s limit), each
  holding its block: a MoE layer (qwen2-moe's kind) whose router groups sit
  inside a rank, straddle the ranks, or straddle them with a padded group,
  against the reference's ``moe_apply`` on the whole batch (output, aux
  loss, dx and every parameter's gradient, the router's included); and
  rwkv6-smoke's train step (loss and every gradient leaf) and its
  per-row recurrent states and logits over a prefill and a decode step,
  against the reference's single device on the same weights;
* the dry run at a rank's block: a dense smoke cell's train FLOPs on
  ``data=2`` are exactly half the one-rank trace's, its peak falls, and
  the gradient sum is counted at the gradients' bytes.

Tolerance 1e-4 (rtol and atol), the reference's gradcheck tolerance: the
ranks sum their blocks' gradients in another order.
"""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path
from repro.configs import all_arch_ids
from repro.configs import get_config as ref_get_config
from repro.launch import mesh as ref_mesh
from repro.models import api as ref_api
from repro.models import input_specs as ref_input_specs
from repro.nn.moe import MoESpec as RefMoESpec
from repro.nn.moe import moe_apply as ref_moe_apply

from _torch_shard_ranks import (MOE_GROUPS, RWKV_BATCH, moe_inputs, moe_spec,
                                named_leaves, rwkv_tokens, spawn)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (Mesh, batch_layout, batch_shardings,
                                     cache_shardings, make_rules, replicated,
                                     small_mesh_shape)
from repro_torch.models import SHAPES, input_specs, shape_applicable
from repro_torch.models.config import ShapeConfig
from repro_torch.nn.moe import moe_init
from repro_torch.sharding import use_rules

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("tt-lm-100m",) + tuple(all_arch_ids())


# ---------------------------------------------------------------------------
# the specs against the reference
# ---------------------------------------------------------------------------

def _meshes(n: int):
    shape, axes = small_mesh_shape(n)
    sizes = dict(zip(axes, shape))
    return (Mesh(sizes, {a: 0 for a in axes}, {}),
            types.SimpleNamespace(shape=sizes))


@functools.lru_cache(maxsize=None)
def _ref_specs(arch: str, shape_name: str):
    return ref_input_specs(ref_get_config(arch), SHAPES[shape_name])


def _cache_names(tree) -> dict:
    """``{leaf name: spec}`` of the reference's stacked cache specs (the
    name ``_cache_pspec`` reads off the path)."""
    out = {}
    for path, spec in tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        key = "/".join(str(p) for p in path)
        out[key.rsplit("/", 1)[-1].rsplit(".", 1)[-1]] = tuple(spec)
    return out


def _port_named(specs, tree, name="") -> list:
    """``(leaf name, spec)`` of the port's spec tree (per-layer leaves)."""
    if isinstance(tree, torch.Tensor):
        return [(name, specs)]
    if isinstance(tree, dict):
        return [x for k in tree for x in _port_named(specs[k], tree[k], k)]
    if hasattr(tree, "_fields"):
        return [x for f, s, t in zip(tree._fields, specs, tree)
                for x in _port_named(s, t, f)]
    return [x for s, t in zip(specs, tree) for x in _port_named(s, t, name)]


@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_the_reference(arch, n, monkeypatch):
    """Every entry of ``batch_shardings``, ``cache_shardings`` and
    ``replicated`` equals the reference's, for every input and cache leaf
    of every applicable shape (the reference's ``NamedSharding`` reduced to
    its spec: its functions run unchanged, without a device mesh)."""
    monkeypatch.setattr(ref_mesh, "NamedSharding", lambda mesh, spec: spec)
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    mesh, ref_fake = _meshes(n)
    checked = 0
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        rules = make_rules(cfg, shape, mesh)
        rrules = ref_mesh.make_rules(rcfg, shape, ref_fake)
        assert (rules.batch_axes, rules.seq_axis) == (rrules.batch_axes, rrules.seq_axis)
        got, want = dict(input_specs(cfg, shape)), dict(_ref_specs(arch, name))
        caches, ref_caches = got.pop("caches", None), want.pop("caches", None)
        g_in, w_in = batch_shardings(got, rules), ref_mesh.batch_shardings(want, rrules)
        assert set(g_in) == set(w_in)
        for k in g_in:
            assert g_in[k] == tuple(w_in[k]), (name, k)
        assert set(replicated(got, mesh).values()) == {()}
        assert {tuple(p) for p in jax.tree.leaves(
            ref_mesh.replicated(want, None),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))} == {()}
        if caches is not None:
            ref_named = _cache_names(ref_mesh.cache_shardings(rcfg, ref_caches, rrules))
            port_named = _port_named(cache_shardings(cfg, caches, rules), caches)
            assert {k for k, _ in port_named} == set(ref_named)
            for leaf, spec in port_named:
                # the reference's leaf is stacked on a leading layer axis
                assert spec == ref_named[leaf][1:], (name, leaf)
        checked += 1
    assert checked >= 2


def test_batch_layout_splits_only_what_divides():
    mesh, _ = _meshes(4)                # data=2 x model=2
    cfg = get_config("tt-lm-100m", smoke=True)
    rules = make_rules(cfg, ShapeConfig("t", 16, 4, "train"), mesh)
    assert batch_layout(rules, 4).batch_split and batch_layout(rules, 4).split_dp == 2
    assert not batch_layout(rules, 3).batch_split
    assert batch_layout(rules, 3).split_dp == 1
    # the batch axes leave a split step's token axes
    assert rules.token_shard_axes(8) == ("data",)
    assert batch_layout(rules, 4).token_shard_axes(8) == ()


# ---------------------------------------------------------------------------
# the MoE layer and rwkv6-smoke on 2 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory) -> dict:
    d = tmp_path_factory.mktemp("weights")
    moe = moe_init(moe_spec(4), torch.Generator().manual_seed(0), device="cpu")
    torch.save(moe, d / "moe.pt")
    rm = ref_api(ref_get_config("rwkv6-7b", smoke=True))
    rwkv = params_from_jax(jax.tree.map(
        np.asarray, rm.init_params(jax.random.PRNGKey(0))))
    torch.save(rwkv, d / "rwkv.pt")
    return {"moe": moe, "moe_params": str(d / "moe.pt"),
            "rwkv_params": str(d / "rwkv.pt")}


@pytest.fixture(scope="module")
def two(weights, tmp_path_factory) -> list[dict]:
    return spawn("moe,rwkv", 2, {"moe_params": weights["moe_params"],
                                 "rwkv_params": weights["rwkv_params"]},
                 tmp_path_factory.mktemp("two"))


def _jnp(tree):
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy())


def _ref_moe(params, router_group: int):
    spec = RefMoESpec(name="moe", d_model=16, d_ff=8, n_experts=4, top_k=2,
                      n_shared=1, shared_d_ff=16, router_group=router_group)
    x, w = moe_inputs()

    def f(p, x):
        y, aux = ref_moe_apply(spec, p, x)
        return jnp.vdot(y, jnp.asarray(w)) + aux, (y, aux)

    (loss, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(_jnp(params), jnp.asarray(x))
    grads = named_leaves(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), gp))
    return float(loss), np.asarray(y), float(aux), np.asarray(gx), grads


@pytest.mark.parametrize("case", sorted(MOE_GROUPS))
def test_moe_aux_loss_and_router_gradient_match_the_reference(two, weights, case):
    """Each rank routes its block: the output, the load-balance aux loss
    (a product of global means), dx and every gradient, the router's
    included, equal the reference's on the whole batch; a group inside a
    rank sums the statistics (one forward all-reduce), a straddling group
    gathers the batch (one all-gather)."""
    loss, y, aux, dx, grads = _ref_moe(weights["moe"], MOE_GROUPS[case])
    for rank in two:
        got = rank["moe"][case]
        assert got["aux"] == pytest.approx(aux, rel=1e-4)
        assert got["loss"] == pytest.approx(loss, rel=1e-4)
        np.testing.assert_allclose(got["y"].numpy(), y, **TOL)
        np.testing.assert_allclose(got["dx"].numpy(), dx, **TOL)
        assert sorted(got["grads"]) == sorted(grads)
        assert "/router" in grads
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), grads[name].numpy(), **TOL,
                                       err_msg=name)
        inside = case == "inside"
        assert got["collectives"]["all_gather"] == (0 if inside else 1)
        # the statistics' sum, forward and backward; the gathered batch's
        # gradient sum in the backward
        assert got["collectives"]["all_reduce"] == (2 if inside else 1)


@functools.lru_cache(maxsize=None)
def _ref_rwkv():
    rcfg = ref_get_config("rwkv6-7b", smoke=True)
    rm = ref_api(rcfg)
    params = rm.init_params(jax.random.PRNGKey(0))
    data = rwkv_tokens(rcfg.vocab)
    batch = {k: jnp.asarray(data[k].astype(np.int32)) for k in ("tokens", "labels")}
    loss, grads = jax.jit(jax.value_and_grad(rm.train_loss))(params, batch)
    s = RWKV_BATCH[1]

    @jax.jit
    def serve(params, tokens, nxt):
        logits, caches = rm.prefill_full(params, {"tokens": tokens}, s + 1)
        step, caches = rm.decode_step(params, nxt, caches, jnp.asarray(s, jnp.int32))
        return logits, step, caches

    logits, step, caches = serve(params, batch["tokens"],
                                 jnp.asarray(data["next"][:, :1].astype(np.int32)))
    named = named_leaves(params_from_jax(jax.tree.map(np.asarray, grads)))
    return (float(loss), named, np.concatenate([np.asarray(logits[:, -1]),
                                                np.asarray(step)], axis=1),
            [np.asarray(t) for t in jax.tree.leaves(caches)])


def test_rwkv_rows_train_and_decode_as_one_device(two):
    """rwkv6-smoke on 2 ranks, one sequence each: the loss and every
    gradient leaf, the prefill's last and the decode step's logits, and
    every layer's recurrent states (time-mix and channel-mix shifts, WKV)
    gathered back, against the reference's single device."""
    loss, grads, logits, states = _ref_rwkv()
    for rank in two:
        got = rank["rwkv"]
        assert got["batch_split"]
        assert got["loss"] == pytest.approx(loss, rel=1e-4)
        assert sorted(got["grads"]) == sorted(grads)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), grads[name].numpy(), **TOL,
                                       err_msg=name)
        np.testing.assert_allclose(got["logits"].numpy(), logits, **TOL)
        # each rank held one row of every state
        assert set(got["state_rows"]) == {1}
        # the reference stacks each field on a leading layer axis; the
        # port keeps per-layer (shift_tm, shift_cm, wkv)
        n_layers = states[0].shape[0]
        assert len(got["states"]) == 3 * n_layers
        for i, t in enumerate(got["states"]):
            np.testing.assert_allclose(t.numpy(), states[i % 3][i // 3], **TOL)


# ---------------------------------------------------------------------------
# the dry run at a rank's block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", (4, 3))
def test_dryrun_traces_a_rank_at_its_block(batch, monkeypatch):
    """Dense tt-lm-smoke's train step on the shape-only ``data=2`` test
    mesh: a batch of 4 splits, and the rank's FLOPs are exactly half the
    one-rank trace's, its peak lower, and its gradient sum one all-reduce
    of every gradient's bytes plus the loss's 4; a batch of 3 does not
    divide, stays replicated, and traces as one rank does."""
    cfg = get_config("tt-lm-100m", tt=False, smoke=True)
    shape = ShapeConfig("t", 32, batch, "train")
    out = {}
    for n in (1, 2):
        monkeypatch.setenv("REPRO_DRYRUN_DEVICES", str(n))
        mesh = dryrun.shape_mesh(test_mesh=True)
        rules = batch_layout(make_rules(cfg, shape, mesh), batch)
        with use_rules(rules):
            out[n] = dryrun.trace_step(cfg, shape, mesh)
    one, two = out[1], out[2]
    if batch == 4:
        assert one["flops"] == 2 * two["flops"]
        assert two["memory"]["peak_bytes"] < one["memory"]["peak_bytes"]
        grad_bytes = sum(int(np.prod(s)) * 4 for s in _param_shapes(cfg))
        assert two["collectives"]["all-reduce"] == grad_bytes + 4
    else:
        assert one["flops"] == two["flops"]
        assert two["collectives"]["all-reduce"] == 0
    assert one["collectives"]["total"] == 0


def _param_shapes(cfg):
    from repro_torch.models import api
    from repro_torch.tree import leaves

    return [tuple(p.shape) for p in leaves(api(cfg, device="meta").init_params(0))]
