"""Training across ranks, on the CPU: the port's sharded backward against
the reference's unsharded ``jax.grad``.

``repro_torch.plan.sharded`` under autograd on a ``gloo`` process group:
2 ranks (``data=2``) and 4 ranks (``data=2 x model=2`` with
``tt_model_reduce``: row-parallel too), each rank a process of its own
(``tests/_torch_shard_ranks.py``, 60 s limit a spawn):

* one planned projection (tt-lm-smoke's mlp.wg) on the plain versions of
  K1 (dx on K1), K2-K4 (OS, WS, IS) and K5 (fused segments).  On a
  replicated batch every rank computes the same loss and must end with
  the whole gradient: at 8 tokens (token-parallel) and 7 (they do not
  divide over ``data=2``: every rank runs the kernel whole; on 4 ranks the
  columns still split), and a mixed pair (mlp.wg split, then mlp.wd on 7
  of its rows).  On local rows (``batch_split``) each rank holds 4 of the
  8 rows and its own loss, and the sum of the ranks' gradients over
  ``data`` must be the whole batch's, each core's counted once.  y, dx and
  every core gradient against the reference's ``jax.grad`` through its
  ``planned_tt_linear`` (Pallas interpret mode), one device;
* tt-lm-smoke's loss and every gradient leaf under both smoke train plans,
  through the train step's ``loss_and_grads``: a batch of 2 that splits
  (each rank one sequence, the gradients summed over ``data``) and one of
  3 that does not (replicated; its 15 tokens decline too), against the
  reference's single-device ``jax.value_and_grad`` of ``train_loss`` (its
  plain path) on the same weights (``params_from_jax``); a
  ``remat="full"`` step whose backward runs on another thread (the
  recompute must find the layout);
* three AdamW steps with the state split by ``param_shardings`` against
  the unsplit steps, bit for bit; ``_param_pspec`` against the
  reference's at every leaf of every arch.

Tolerance 1e-4 (rtol and atol), the reference's gradcheck tolerance: the
ranks sum the blocks' gradients in another order, and the CPU plain K1 is
not row-independent (ROADMAP.md, port conventions).
``tests/test_torch_shard_train_cli.py`` runs the train driver on ranks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro import plan as ref_plan
from repro.configs import all_arch_ids
from repro.configs import get_config as ref_get_config
from repro.launch.mesh import _param_pspec as ref_param_pspec
from repro.models import api as ref_api
from repro.plan.executor import planned_tt_linear as ref_planned_tt_linear

from _torch_shard_ranks import (MIXED_LAYER, MODEL_BATCHES, TRAIN_LAYER,
                                TRAIN_PLANS, TRAIN_ROUTES, TRAIN_TOKENS,
                                _geometry, _model_batch, adamw_tree, spawn,
                                train_layer_inputs, train_layer_plan)
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import (ParamShards, _param_pspec,
                                     param_shardings, small_mesh_shape)

TOL = dict(rtol=1e-4, atol=1e-4)
WORLDS = ("two", "four")
LAYER_KEYS = [f"{r[0]}:{t}" for r in TRAIN_ROUTES for t in TRAIN_TOKENS]
SPLIT_KEYS = [f"{r[0]}:split" for r in TRAIN_ROUTES]
NONE = {"all_gather": 0, "all_reduce": 0, "grad_all_reduce": 0}
#: tt-lm-smoke's layers
N_LAYERS = 2


@pytest.fixture(scope="module")
def weights(tmp_path_factory) -> str:
    """tt-lm-smoke's reference weights (``PRNGKey(0)``) in the port's layout."""
    rm = ref_api(ref_get_config("tt-lm-100m", smoke=True))
    params = params_from_jax(jax.tree.map(
        np.asarray, rm.init_params(jax.random.PRNGKey(0))))
    path = tmp_path_factory.mktemp("weights") / "params.pt"
    torch.save(params, path)
    return str(path)


BODIES = "train_layers,train_model,train_adamw"


@pytest.fixture(scope="module")
def two(weights, tmp_path_factory) -> list[dict]:
    return spawn(BODIES, 2, {"reduce": False, "params": weights},
                 tmp_path_factory.mktemp("two"))


@pytest.fixture(scope="module")
def four(weights, tmp_path_factory) -> list[dict]:
    return spawn(BODIES, 4, {"reduce": True, "params": weights},
                 tmp_path_factory.mktemp("four"))


# ---------------------------------------------------------------------------
# one planned projection
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_layer(key: str):
    """The reference's loss and gradients (x, then the cores) of
    ``sum(y * w)`` through its ``planned_tt_linear``, one device."""
    label, tokens = key.split(":")
    route = next(r for r in TRAIN_ROUTES if r[0] == label)
    rlp = train_layer_plan(ref_plan, route)
    x, cores, w = train_layer_inputs(TRAIN_LAYER, int(tokens), seed=int(tokens))

    def f(x, *cores):
        y = ref_planned_tt_linear(rlp, x, list(cores), *_geometry(TRAIN_LAYER))
        return jnp.vdot(y, jnp.asarray(w))

    loss, grads = jax.value_and_grad(f, argnums=tuple(range(1 + len(cores))))(
        jnp.asarray(x), *(jnp.asarray(c) for c in cores))
    return float(loss), [np.asarray(g) for g in grads]


def _ref_mixed():
    route = TRAIN_ROUTES[0]
    first = train_layer_plan(ref_plan, route, TRAIN_LAYER)
    second = train_layer_plan(ref_plan, route, MIXED_LAYER)
    x, c1, _ = train_layer_inputs(TRAIN_LAYER, 8, seed=21)
    _, c2, w = train_layer_inputs(MIXED_LAYER, 7, seed=22)
    n1 = len(c1)

    def f(x, *cs):
        h = ref_planned_tt_linear(first, x, list(cs[:n1]), *_geometry(TRAIN_LAYER))
        y = ref_planned_tt_linear(second, h[:7], list(cs[n1:]),
                                  *_geometry(MIXED_LAYER))
        return jnp.vdot(y, jnp.asarray(w))

    args = [x, *c1, *c2]
    loss, grads = jax.value_and_grad(f, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    return float(loss), [np.asarray(g) for g in grads]


def _assert_grads(got: dict, want, scaled: bool = False) -> None:
    """Loss and gradients at :data:`TOL`; ``scaled``: each gradient within
    1e-4 of its own max |value| (two layers deep, elements that cancel to
    a small value carry the rounding of their large terms)."""
    loss, grads = want
    assert float(got["loss"]) == pytest.approx(loss, rel=1e-4)
    assert len(got["grads"]) == len(grads)
    for k, (g, w) in enumerate(zip(got["grads"], grads)):
        tol = dict(rtol=0, atol=1e-4 * np.abs(w).max()) if scaled else TOL
        np.testing.assert_allclose(g.numpy(), w, **tol, err_msg=f"input {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", LAYER_KEYS)
def test_layer_gradients_match_the_reference(world, key, request):
    want = _ref_layer(key)
    for rank in request.getfixturevalue(world):
        _assert_grads(rank["train_layers"][key], want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", SPLIT_KEYS)
def test_local_rows_sum_each_core_gradient_once(world, key, request):
    """Each rank holds 4 of the 8 rows and its own loss; with no collective
    over ``data`` in the route, the ranks' core gradients summed over
    ``data`` (the train step's gradient sum) and their dx blocks gathered
    equal the reference's whole-batch gradients.  A route that also summed
    the core gradients over ``data`` would give twice them."""
    want = _ref_layer(key.split(":")[0] + ":8")
    for rank in request.getfixturevalue(world):
        _assert_grads(rank["train_layers"][key], want)


@pytest.mark.parametrize("world", WORLDS)
def test_a_split_and_a_declined_projection_train_together(world, request):
    """mlp.wg splits its 8 tokens; mlp.wd, on 7 of its output rows, runs
    whole on every rank of 2 (7 do not divide) and splits its columns on 4:
    dx flows through both, each core gets its whole gradient."""
    want = _ref_mixed()
    for rank in request.getfixturevalue(world):
        got = rank["train_layers"]["mixed"]
        _assert_grads(got, want, scaled=True)
        meshes = {(r["name"], r["phase"], r["mesh"]) for r in got["records"]}
        second = "" if world == "two" else "reduce(model=2)"
        first = "data=2" if world == "two" else "data=2+reduce(model=2)"
        assert meshes == {(n, p, m) for n, m in ((TRAIN_LAYER, first),
                                                 (MIXED_LAYER, second))
                          for p in ("fwd", "bwd")}


#: (world, tokens) -> (mesh, per-shard d_in, forward, backward collectives)
LAYER_PLACEMENT = {
    ("two", 8): ("data=2", 128, {**NONE, "all_gather": 1},
                 {**NONE, "all_gather": 1, "all_reduce": 1}),
    ("two", 7): ("", None, NONE, NONE),
    # dx gathered over rows and columns, j1's slice summed over the token
    # axis and gathered over the model axis, the other cores summed once
    ("four", 8): ("data=2+reduce(model=2)", 64, {**NONE, "all_gather": 1, "all_reduce": 1},
                  {**NONE, "all_gather": 3, "all_reduce": 2}),
    ("four", 7): ("reduce(model=2)", 64, {**NONE, "all_reduce": 1},
                  {**NONE, "all_gather": 2, "all_reduce": 1}),
    # local rows: no collective over data; under the reduce, the model
    # axis's alone (dx and j1's slice gathered, the other cores summed)
    ("two", "split"): ("data=2", 128, NONE, NONE),
    ("four", "split"): ("data=2+reduce(model=2)", 64, {**NONE, "all_reduce": 1},
                        {**NONE, "all_gather": 2, "all_reduce": 1}),
}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", LAYER_KEYS + SPLIT_KEYS)
def test_gradient_records_carry_the_mesh_and_per_shard_shape(world, key, request):
    tokens = key.split(":")[1]
    tokens = tokens if tokens == "split" else int(tokens)
    mesh, d_in, fwd, bwd = LAYER_PLACEMENT[(world, tokens)]
    rows = 4 if tokens == "split" else tokens // 2 if tokens % 2 == 0 else tokens
    for rank in request.getfixturevalue(world):
        got = rank["train_layers"][key]
        recs = got["records"]
        assert {r["phase"] for r in recs} == {"fwd", "bwd"}
        for r in recs:
            assert r["mesh"] == mesh, r
            assert r["shard_shape"] == ([rows, d_in] if mesh else None), r
            assert r["tokens"] == rows, r
        assert got["bwd_collectives"] == bwd
        assert {k: got["collectives"][k] - bwd[k] for k in bwd} == fwd


# ---------------------------------------------------------------------------
# the slice as a whole: tt-lm-smoke
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}[{i}]").items()}
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _ref_model(key: str):
    """The reference's single-device loss and gradients (its plain path)."""
    rcfg = ref_get_config("tt-lm-100m", smoke=True)
    rm = ref_api(rcfg)
    batch = {k: jnp.asarray(v.astype(np.int32))
             for k, v in _model_batch(rcfg, key).items()}
    loss, grads = jax.jit(jax.value_and_grad(rm.train_loss))(
        rm.init_params(jax.random.PRNGKey(0)), batch)
    return float(loss), _flat(params_from_jax(jax.tree.map(np.asarray, grads)))


def _assert_model(got: dict, key: str) -> None:
    loss, want = _ref_model(key)
    assert got["loss"] == pytest.approx(loss, rel=1e-4)
    assert sorted(got["grads"]) == sorted(want)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", sorted(MODEL_BATCHES))
@pytest.mark.parametrize("plan_file", TRAIN_PLANS)
def test_smoke_loss_and_every_gradient_match_the_reference(world, key, plan_file,
                                                           request):
    ranks = request.getfixturevalue(world)
    for rank in ranks:
        got = rank["train_model"][f"{plan_file}:{key}"]
        _assert_model(got, key)
        planned = [r for r in got["records"] if r["backend"] != "jnp"]
        assert {r["phase"] for r in planned} == {"fwd", "bwd"}
        meshes = {r["mesh"] for r in planned}
        if key == "split":
            # one of the 2 sequences a rank, its 16 rows local
            assert got["rows"] == 1
            assert meshes == {"data=2" if world == "two" else "data=2+reduce(model=2)"}
            assert all(r["shard_shape"][0] == 16 for r in planned)
            assert got["collectives"]["grad_all_reduce"] == 1
            assert got["bwd_collectives"]["grad_all_reduce"] == 1
            # on 4 ranks the forward gathers each layer's attention output
            # (its kv-head blocks) and the loss's per-token terms (the vocab
            # blocks) over the model axis
            assert got["collectives"]["all_gather"] - got["bwd_collectives"][
                "all_gather"] == (0 if world == "two" else N_LAYERS + 1)
            if world == "two":
                # the reported loss's sum, and no collective of a projection
                assert got["collectives"] == {**NONE, "all_reduce": 1,
                                              "grad_all_reduce": 1}
        elif world == "two":
            # 3 sequences do not divide: replicated, and 15 tokens do not
            # divide either: every rank runs the kernels whole
            assert got["rows"] == 3
            assert meshes == {""} and got["collectives"] == NONE
        else:
            assert meshes == {"reduce(model=2)"}
    # every rank ends with the same gradients
    for rank in ranks[1:]:
        for name, g in rank["train_model"][f"{plan_file}:{key}"]["grads"].items():
            assert torch.equal(g, ranks[0]["train_model"][f"{plan_file}:{key}"]["grads"][name])


@pytest.mark.parametrize("world", WORLDS)
def test_a_remat_backward_on_another_thread_still_splits(world, request):
    """``remat="full"`` recomputes each block in the backward; run on a
    thread of its own (as the card's autograd engine runs it), the
    recompute must find the forward's sharding rules: the same gradients
    as without remat, and every planned record, recompute included, at
    the per-shard shape."""
    mesh = "data=2" if world == "two" else "data=2+reduce(model=2)"
    for rank in request.getfixturevalue(world):
        got = rank["train_model"]["remat"]
        plain = rank["train_model"][f"{TRAIN_PLANS[0]}:split"]
        assert got["loss"] == plain["loss"]
        for name, g in got["grads"].items():
            assert torch.equal(g, plain["grads"][name]), name
        planned = [r for r in got["records"] if r["backend"] != "jnp"]
        n_fwd = sum(r["phase"] == "fwd" for r in planned)
        # every block's forward ran twice: once, then in the recompute
        assert n_fwd == 2 * sum(r["phase"] == "fwd" for r in plain["records"]
                                if r["backend"] != "jnp")
        assert all(r["mesh"] == mesh and r["shard_shape"][0] == 16 for r in planned)


# ---------------------------------------------------------------------------
# AdamW state split by param_shardings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_split_adamw_steps_are_bit_identical_to_unsplit(world, request):
    ranks = request.getfixturevalue(world)
    for rank in ranks:
        got = rank["train_adamw"]
        assert all(got["params_equal"]) and all(got["moments_equal"])
        n_split = 0
        for spec, m, p in zip(got["specs"], got["moment_shapes"], got["param_shapes"]):
            if spec:
                n_split += 1
                # each rank holds only its block of a split leaf's moments
                assert m == tuple(n // (2 if e else 1) for n, e in zip(p, spec))
            else:
                assert m == p
        assert n_split == 4 and len(got["specs"]) == 7
    assert ranks[0]["train_adamw"]["specs"] == [
        _param_pspec(s, dict(zip(*reversed(small_mesh_shape(len(ranks))))))
        for s in ranks[0]["train_adamw"]["param_shapes"]]


def test_param_shardings_of_one_rank_split_nothing():
    """One rank: every spec is all ``None`` or ``()``, so the AdamW state
    stays whole (the driver then builds no :class:`ParamShards`)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import leaves

    mesh = make_test_mesh()
    tree = adamw_tree(0)
    specs = param_shardings(tree, mesh)
    assert specs["embed"] == (None, None) and specs["norm"] == ()
    assert specs["blocks"][1] == {"w": (None, None), "b": ()}
    shards = ParamShards(tree, mesh)
    assert not any(shards.split(i) for i in range(len(leaves(tree))))


# ---------------------------------------------------------------------------
# _param_pspec against the reference at every leaf of every arch
# ---------------------------------------------------------------------------

ARCHS = ("tt-lm-100m",) + tuple(all_arch_ids())


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str) -> tuple:
    """Every parameter leaf's shape of ``arch``, tensorized and dense, from
    ``jax.eval_shape`` (nothing is allocated)."""
    shapes = []
    for tt in (True, False):
        tree = jax.eval_shape(ref_api(ref_get_config(arch, tt=tt)).init_params,
                              jax.random.PRNGKey(0))
        shapes += [tuple(leaf.shape) for leaf in jax.tree.leaves(tree)]
    return tuple(shapes)


@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_matches_the_reference(arch, n):
    shape, axes = small_mesh_shape(n)
    axis_sizes = dict(zip(axes, shape))
    split = 0
    for s in _ref_shapes(arch):
        want = ref_param_pspec(s, axis_sizes)
        got = _param_pspec(s, axis_sizes)
        assert got == tuple(want), (arch, s)
        split += any(e is not None for e in got)
    assert split > 0
