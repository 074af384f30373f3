"""The port's sharded planned execution across ranks, on the CPU.

``repro_torch.plan.sharded`` and the serve engine on a ``gloo`` process
group: 2 ranks (``data=2``) and 4 ranks (``data=2 x model=2`` with
``tt_model_reduce``: row-parallel too), each rank a process of its own
(``tests/_torch_shard_ranks.py``, 60 s limit a spawn).  The oracle is the
port's own single-device route: the reference's own sharded harnesses
(forced 8-device host meshes) fail in their set-up, ROADMAP.md Queue A
item 11.  The ranks' prefill logits are also held against the reference's
unsharded ``prefill_full`` on the same weights (``params_from_jax``):

* ``sharded_tt_linear`` with the plain versions of K1 and K2-K4 (OS, WS,
  IS) equals ``planned_tt_linear`` bit for bit under token-DP: the CPU
  plain versions' rows do not depend on the token count at these shapes
  (one BLAS thread on both sides); under model-reduce within 1e-5 of the
  output's max (the all-reduce changes the order of sums);
* smoke tt-lm-100m served continuous on 2 ranks under ``--shards 2``
  plans equals the single-device oneshot per request, token for token,
  and its prefill logits agree at the streaming tolerance (1e-4 x max
  |logit|: the CPU plain version of K1 is not row-independent at every
  network, see :func:`test_two_ranks_prefill_logits_match_single_device`);
  every rank's records sit at per-shard shapes; the 2- and 4-rank
  prefill logits agree with the reference's at the same tolerance;
* tokens that do not divide over the mesh run the planned kernel on the
  whole block on every rank (a record without a mesh), so ``--strict-plan``
  passes and the tokens equal the single-device run's;
* the decode lanes split over ``data``: a 2-lane engine's rank holds and
  decodes one lane, and one decode step's gathered logits equal the
  reference's decode of both prompts at 1e-4 x max |logit|, with the
  logits' gather as its only collective on 2 ranks;
* under autograd the sharded route's gradients equal the single-device
  route's (``tests/test_torch_shard_train.py`` trains across ranks).
"""

from __future__ import annotations

import contextlib
import functools
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
from repro.models import api as ref_api
from repro.nn import install_plan as ref_install_plan
from repro.plan import load_plan as ref_load_plan

from _torch_shard_ranks import (GEOMETRIES, LANE_MAX_SEQ, LANE_PROMPT_LEN, ROUTES,
                                SRC, TOKENS, autograd_weights, lane_prompts,
                                layer_plan, linear_inputs, spawn)
from repro_torch import dse_cli
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.nn import plan_context
from repro_torch.plan import load_plan, planned_tt_linear

SMOKE_PAIR = ["--arch", "tt-lm-100m", "--smoke", "--top-k", "2", "--tokens",
              "64", "--serve-slots", "2", "--plan-backend", "streaming_tt",
              "--shards", "2"]
SERVE = ["--smoke", "--device", "cpu", "--batch", "2", "--n-requests", "3",
         "--prompt-len", "5", "--gen", "4", "--strict-plan"]


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory) -> list[str]:
    out = tmp_path_factory.mktemp("plans") / "s2"
    with contextlib.redirect_stdout(io.StringIO()):
        assert dse_cli.main(SMOKE_PAIR + ["--emit-plan-pair", str(out),
                                          "--out", os.devnull]) == 0
    return ["--plan-prefill", f"{out}.prefill.json",
            "--plan-decode", f"{out}.decode.json"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory) -> str:
    """tt-lm-smoke's reference weights (``PRNGKey(0)``) in the port's
    layout, saved for the ranks' logits."""
    rm = ref_api(ref_get_config("tt-lm-100m", smoke=True))
    params = params_from_jax(jax.tree.map(
        np.asarray, rm.init_params(jax.random.PRNGKey(0))))
    path = tmp_path_factory.mktemp("weights") / "params.pt"
    torch.save(params, path)
    return str(path)


def _spec(pair, weights, reduce: bool) -> dict:
    runs = {"continuous": pair + SERVE + ["--schedule", "continuous"],
            "tt_gemm": pair + SERVE + ["--schedule", "continuous",
                                       "--plan-backend", "tt_gemm"]}
    if not reduce:
        runs["decline"] = pair + SERVE + ["--prompt-bucket", "1"]
    return {"reduce": reduce, "runs": runs, "prefill_plan": pair[1],
            "decode_plan": pair[3], "params": weights}


@pytest.fixture(scope="module")
def two(pair, weights, tmp_path_factory) -> list[dict]:
    return spawn("linear,serve,lanes", 2, _spec(pair, weights, False),
                 tmp_path_factory.mktemp("two"))


@pytest.fixture(scope="module")
def four(pair, weights, tmp_path_factory) -> list[dict]:
    return spawn("linear,serve,lanes", 4, _spec(pair, weights, True),
                 tmp_path_factory.mktemp("four"))


def _single(key: str) -> torch.Tensor:
    g, backend, dataflow = key.split(":")
    geometry = GEOMETRIES[int(g)]
    x, cores = linear_inputs(geometry, seed=int(g))
    with one_thread():
        return planned_tt_linear(layer_plan(backend, dataflow, geometry), x,
                                 cores, *geometry)


KEYS = [f"{g}:{b}:{d}" for g in range(len(GEOMETRIES)) for b, d in ROUTES]


def test_meshes_place_every_rank(two, four):
    assert [r["linear"]["mesh"] for r in two] == [{"data": 2, "model": 1}] * 2
    assert [r["linear"]["mesh"] for r in four] == [{"data": 2, "model": 2}] * 4
    assert [tuple(r["linear"]["coords"].values()) for r in four] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("key", KEYS)
def test_token_parallel_equals_single_device_bit_for_bit(two, key):
    want = _single(key)
    for rank in two:
        assert torch.equal(rank["linear"]["y"][key], want), key


@pytest.mark.parametrize("key", KEYS)
def test_token_parallel_records_per_shard_shapes(two, key):
    d_in = int(np.prod(GEOMETRIES[int(key[0])][0]))
    for rank in two:
        recs = rank["linear"]["records"][key]
        assert recs and all(r["mesh"] == "data=2" for r in recs), recs
        assert all(r["shard_shape"] == [TOKENS // 2, d_in]
                   and r["tokens"] == TOKENS // 2 for r in recs), recs
        assert rank["linear"]["collectives"][key] == {
            "all_gather": 1, "all_reduce": 0, "grad_all_reduce": 0}


@pytest.mark.parametrize("key", KEYS)
def test_model_reduce_within_1e5_of_single_device(four, key):
    want = _single(key)
    d_in = int(np.prod(GEOMETRIES[int(key[0])][0]))
    for rank in four:
        got = rank["linear"]["y"][key]
        assert got.shape == want.shape
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), key
        recs = rank["linear"]["records"][key]
        assert recs and all(r["mesh"] == "data=2+reduce(model=2)"
                            and r["shard_shape"] == [TOKENS // 2, d_in // 2]
                            for r in recs), recs
        assert rank["linear"]["collectives"][key] == {
            "all_gather": 1, "all_reduce": 1, "grad_all_reduce": 0}
    # the two model ranks of a data group hold the same sum
    assert torch.equal(four[0]["linear"]["y"][key], four[1]["linear"]["y"][key])


def test_sharded_route_refuses_autograd(two):
    """Once the refusal of autograd (the sharded backward was not ported);
    now the parity that replaced it: every rank's dx and core gradients of
    ``sum(y * w)`` through the sharded K1 route equal the single-device
    route's at the gradient tolerance, 1e-4 (the CPU plain K1 is not
    row-independent).  ``tests/test_torch_shard_train.py`` holds the
    sharded backward to the reference."""
    x, cores = linear_inputs(GEOMETRIES[0])
    x.requires_grad_(True)
    for c in cores:
        c.requires_grad_(True)
    with one_thread():
        y = planned_tt_linear(layer_plan("streaming_tt", "OS", GEOMETRIES[0]),
                              x, cores, *GEOMETRIES[0])
        (y * autograd_weights(y.shape)).sum().backward()
    want = [x.grad] + [c.grad for c in cores]
    for rank in two:
        got = rank["linear"]["autograd"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_ranks_check_that_they_generated_the_same_tokens(two):
    """``launch.serve``'s agreement check: a digest of every rank's tokens,
    all-gathered; one rank with other tokens fails it on every rank."""
    for rank in two:
        assert rank["linear"]["agree"] == {"same": True, "differ": False}


def _oneshot(pair, extra=()) -> serve.ServeRun:
    with one_thread(), contextlib.redirect_stdout(io.StringIO()):
        return serve.run(pair + SERVE + ["--schedule", "oneshot", *extra])


@pytest.mark.parametrize("run,extra", [("continuous", ()),
                                       ("tt_gemm", ("--plan-backend", "tt_gemm"))])
def test_two_ranks_serve_equals_single_device_oneshot(two, pair, run, extra):
    solo = _oneshot(pair, extra)
    assert solo.code == 0
    want = solo.result.tokens_by_rid()
    assert len(want) == 3
    for rank in two:
        got = rank["serve"][run]
        assert got["code"] == 0, got["stdout"]
        assert got["tokens"] == want


@pytest.mark.parametrize("run,backends", [
    ("continuous", {"streaming_tt"}), ("tt_gemm", {"tt_gemm"})])
def test_two_ranks_serve_records_per_shard_shapes(two, run, backends):
    for i, rank in enumerate(two):
        recs = rank["serve"][run]["records"]
        assert {r["stream"] for r in recs} == {"prefill", "decode"}
        assert {r["backend"] for r in recs} == backends
        for r in recs:
            assert r["mesh"] == "data=2", r
            assert r["shard_shape"][0] == r["tokens"], r
        # prefill 8 bucketed tokens, decode 2 slots, split in two
        assert {r["tokens"] for r in recs} == {4, 1}
        out = rank["serve"][run]["stdout"]
        if i == 0:
            assert "sharded execution: mesh data=2" in out
            assert "backend gloo, on the CPU" in out
        else:
            assert out == ""  # rank 0 prints the report


def _prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(3).integers(0, vocab, size=(2, 8))


def _single_logits(pair, weights) -> torch.Tensor:
    cfg = get_config("tt-lm-100m", smoke=True)
    m = api(cfg, device="cpu")
    params = torch.load(weights, weights_only=False)
    with one_thread(), plan_context(load_plan(pair[1])), torch.no_grad():
        want, _ = m.prefill_full(
            params, {"tokens": torch.from_numpy(_prompts(cfg.vocab))}, 16)
    return want


@pytest.fixture(scope="module")
def ref_logits(pair) -> torch.Tensor:
    """The reference's unsharded prefill logits under the same plan (its
    Pallas kernels in interpret mode), on the reference's own weights."""
    rcfg = ref_get_config("tt-lm-100m", smoke=True)
    try:
        rm = ref_api(rcfg, plan=ref_load_plan(pair[1]))
        logits, _ = jax.jit(lambda p, t: rm.prefill_full(p, {"tokens": t}, 16))(
            rm.init_params(jax.random.PRNGKey(0)),
            jnp.asarray(_prompts(rcfg.vocab)))
    finally:
        ref_install_plan(None)  # plans install globally in the reference
    return torch.from_numpy(np.array(logits))


def test_two_ranks_prefill_logits_match_single_device(two, pair, weights):
    """At the streaming tolerance, 1e-4 x max |logit|, not bit for bit: the
    CPU plain version of K1 (``execute_path`` over all rows at once) is not
    row-independent here.  Its GEMMs for attn.wo and mlp.wd (input modes
    (16, 16)) round some rows differently at 16 tokens than at 8 (max
    1.4e-6 apart); the CUDA kernels are held bit for bit on the card."""
    want = _single_logits(pair, weights)
    for rank in two:
        got = rank["serve"]["logits"]
        assert got.shape == want.shape
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("world", ["two", "four"])
def test_sharded_prefill_logits_match_the_reference(world, ref_logits, request):
    """The ranks' prefill logits against the reference's unsharded ones on
    the same weights, at the streaming tolerance: the end-to-end tie of the
    sharded model path, the model-reduce slicing of core j1 included, to
    the JAX package."""
    for rank in request.getfixturevalue(world):
        got = rank["serve"]["logits"]
        assert got.shape == ref_logits.shape
        assert (got - ref_logits).abs().max() <= 1e-4 * ref_logits.abs().max()


def test_tokens_that_do_not_divide_run_the_kernel_unsharded(two, pair):
    """5-token prefills do not divide over 2 ranks: every rank runs the
    planned kernel on the whole block, so nothing is demoted and
    ``--strict-plan`` passes; the 2-slot decode steps still shard."""
    solo = _oneshot(pair, ("--prompt-bucket", "1"))
    assert solo.code == 0
    for rank in two:
        got = rank["serve"]["decline"]
        assert got["code"] == 0, got["stdout"]
        assert got["tokens"] == solo.result.tokens_by_rid()
        recs = got["records"]
        assert {r["backend"] for r in recs} == {"streaming_tt"}
        whole = [r for r in recs if r["mesh"] == ""]
        assert whole and all(r["stream"] == "prefill" and r["tokens"] == 5
                             and r["shard_shape"] is None for r in whole)
        assert {r["mesh"] for r in recs} == {"", "data=2"}


def test_four_ranks_reduce_serves_close_to_single_device(four, pair, weights):
    want = _single_logits(pair, weights)
    for rank in four:
        got = rank["serve"]["logits"]
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
        for run in ("continuous", "tt_gemm"):
            res = rank["serve"][run]
            assert res["code"] == 0, res["stdout"]
            assert all(len(t) == 4 for t in res["tokens"].values())
            meshes = {r["mesh"] for r in res["records"]}
            assert meshes <= {"data=2", "data=2+reduce(model=2)"}
            assert "data=2+reduce(model=2)" in meshes
    assert all(r["serve"]["continuous"]["tokens"]
               == four[0]["serve"]["continuous"]["tokens"] for r in four)


@functools.lru_cache(maxsize=None)
def _ref_decode() -> tuple[list, np.ndarray]:
    """The reference's greedy first tokens of both lane prompts and its
    logits of one decode step on them (its plain path, one device)."""
    rm = ref_api(ref_get_config("tt-lm-100m", smoke=True))
    params = rm.init_params(jax.random.PRNGKey(0))
    prompts = jnp.asarray(lane_prompts(rm_vocab()))

    @jax.jit
    def run(params, prompts):
        logits, caches = rm.prefill_full(params, {"tokens": prompts}, LANE_MAX_SEQ)
        first = jnp.argmax(logits[:, -1], axis=-1)
        step, _ = rm.decode_step(params, first[:, None].astype(jnp.int32), caches,
                                 jnp.full((2,), LANE_PROMPT_LEN, jnp.int32))
        return first, step

    first, step = run(params, prompts)
    return [int(t) for t in first], np.asarray(step)


def rm_vocab() -> int:
    return ref_get_config("tt-lm-100m", smoke=True).vocab


@pytest.mark.parametrize("world", ["two", "four"])
def test_decode_lanes_split_over_data(world, request):
    """A 2-lane engine: each rank of a ``data`` group holds and decodes one
    lane (its cache rows), and the step's logits of both lanes, gathered
    over ``data``, match the reference's decode at 1e-4 x max |logit|;
    the greedy first tokens of both prefills are the reference's.  On 2
    ranks the logits' all-gather is the step's only collective."""
    first, want = _ref_decode()
    ranks = request.getfixturevalue(world)
    for rank in ranks:
        got = rank["lanes"]
        assert got["first"] == first
        assert got["cache_rows"] == 1
        lo = rank["linear"]["coords"]["data"]
        assert tuple(got["lanes"]) == (lo, lo + 1)
        assert got["logits"].shape == want.shape
        assert np.abs(got["logits"].numpy() - want).max() <= 1e-4 * np.abs(want).max()
        if world == "two":
            assert got["collectives"] == {"all_gather": 1, "all_reduce": 0,
                                          "grad_all_reduce": 0}
    # every rank holds the same gathered logits
    for rank in ranks[1:]:
        assert torch.equal(rank["lanes"]["logits"], ranks[0]["lanes"]["logits"])


def test_torchrun_serves_on_two_ranks(pair):
    """``launch.serve`` under torchrun joins the ranks itself (env://)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(SRC),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *pair,
         *SERVE, "--schedule", "continuous"],
        capture_output=True, text=True, timeout=60, env=env,
        cwd=pathlib.Path(__file__).parent)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("sharded execution: mesh data=2") == 1
    assert "(2 ranks, backend gloo, on the CPU)" in proc.stdout
