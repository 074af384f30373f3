"""The port's cost model and DSE against the JAX package's, exactly.

``repro_torch`` carries NumPy copies of ``core/simulator.py``,
``core/cost_table.py``, ``core/dse.py``, ``core/tt.py``, ``hw/space.py``,
the DSE half of ``core/backward.py`` and the compiler half of
``core/fusion.py``.  The same inputs go through both packages and the
results compare with ``==``: latencies, cost tables, argmins, Pareto fronts
and architecture spaces are framework-neutral arithmetic, so any reordered
reduction or dtype promotion shows here.  Wall-clock fields
(``build_seconds``) are dropped before comparing.  TT-SVD compares at 1e-6
(LAPACK runs under both).  Cases follow ``tests/test_{simulator,
cost_table,dse,hw,tt,backward,paths,tensor_network}.py`` on ``fpga_vu9p``
and ``tpu_v5e``.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.core import fusion as ref_fusion
from repro.core.dse import build_cost_table as ref_build_cost_table
from repro.core.cost_table import fused_cost_tables as ref_fused_cost_tables
from repro.hw import ArchSpace as RefArchSpace
from repro.hw import arch_coordinates as ref_arch_coordinates
from repro.hw import get_target as ref_get_target
from repro.models.vision import model_layers as ref_model_layers
from repro_torch.core import fusion
from repro_torch.core.cost_table import fused_cost_tables
from repro_torch.core.dse import build_cost_table
from repro_torch.hw import ArchSpace, arch_coordinates, get_target
from repro_torch.models.vision import model_layers

HW_NAMES = ("fpga_vu9p", "tpu_v5e")
#: (batch, in_modes, out_modes, ranks) of ``tests/test_cost_table.py`` and
#: ``tests/test_dse.py``
SIZES = [
    (4, (4, 4), (4, 4), (4, 4, 4)),
    (64, (2, 8), (8, 2), (4, 4, 4)),
    (1024, (12, 8, 8), (12, 8, 8), (16, 16, 16, 16, 16)),
]
SMALL = SIZES[:2]
#: wall-clock fields, dropped before comparing
WALL = ("build_seconds",)


def canon(x):
    """A framework-neutral value: dataclasses as field dicts (wall-clock
    fields dropped), enums as their values, tensor networks as their nodes,
    arrays as (dtype, shape, bytes)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: canon(getattr(x, f.name))
                                   for f in dataclasses.fields(x)
                                   if f.name not in WALL})
    if isinstance(x, enum.Enum):
        return ("enum", x.value)
    if isinstance(x, (P.TensorNetwork, R.TensorNetwork)):
        return ("TensorNetwork", canon(x.nodes))
    if isinstance(x, dict):
        return {canon(k): canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(canon(v) for v in x)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    return x


def _paths(sizes, k=4):
    """(port layer paths, reference layer paths), equal by construction
    of ``find_topk_paths`` (checked)."""
    mine = [P.find_topk_paths(P.tt_linear_network(*s), k=k) for s in sizes]
    theirs = [R.find_topk_paths(R.tt_linear_network(*s), k=k) for s in sizes]
    assert canon(mine) == canon(theirs)
    return mine, theirs


def _nets(sizes):
    return ([P.tt_linear_network(*s) for s in sizes],
            [R.tt_linear_network(*s) for s in sizes])


# ---------------------------------------------------------------------------
# tensor networks and paths
# ---------------------------------------------------------------------------

def test_tensor_network_builders_and_paths_match_reference():
    pairs = [
        (P.dense_linear_network(8, 12, 20), R.dense_linear_network(8, 12, 20)),
        (P.tt_conv_network(49, (4, 4), (8, 8), 9, (4, 4, 4, 4)),
         R.tt_conv_network(49, (4, 4), (8, 8), 9, (4, 4, 4, 4))),
    ] + list(zip(*_nets(SIZES)))
    for mine, theirs in pairs:
        assert canon(mine.nodes) == canon(theirs.nodes)
        assert mine.output_dims() == theirs.output_dims()
        for fn in ("greedy_path", "reconstruction_path"):
            assert canon(getattr(P, fn)(mine)) == canon(getattr(R, fn)(theirs))
        steps = P.find_topk_paths(mine, k=1)[0].steps
        assert mine.total_macs(steps) == theirs.total_macs(steps)


# ---------------------------------------------------------------------------
# the systolic simulator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("hw_name", HW_NAMES)
def test_simulate_every_strategy_matches_reference(hw_name, size):
    """``simulate`` / ``layer_latency`` / ``gemm_latency`` over every
    partitioning of ``STRATEGY_SPACE``, every dataflow and every GEMM."""
    hw, rhw = get_target(hw_name), ref_get_target(hw_name)
    (mine,), (theirs,) = _paths([size])
    assert canon(P.STRATEGY_SPACE) == canon(R.STRATEGY_SPACE)
    parts = sorted({c for cs in P.STRATEGY_SPACE.values() for c in cs})
    for p, rp in zip(mine, theirs):
        for c in parts:
            for d, rd in zip(P.ALL_DATAFLOWS, R.ALL_DATAFLOWS):
                assert canon(P.simulate(p, c, d, hw)) == canon(R.simulate(rp, c, rd, rhw))
                assert canon(P.layer_latency(p, d, c, hw)) == \
                    canon(R.layer_latency(rp, rd, c, rhw))
        for g, rg in zip(p.gemms, rp.gemms):
            for d, rd in zip(P.ALL_DATAFLOWS, R.ALL_DATAFLOWS):
                assert canon(P.gemm_latency(g, d, hw)) == canon(R.gemm_latency(rg, rd, rhw))
                assert canon(P.gemm_latency(g, d, hw, rows=16, cols=8)) == \
                    canon(R.gemm_latency(rg, rd, rhw, rows=16, cols=8))


# ---------------------------------------------------------------------------
# cost tables: scalar and vectorized, inference, train and fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["scalar", "vectorized"])
@pytest.mark.parametrize("hw_name", HW_NAMES)
def test_cost_table_engines_match_reference(hw_name, engine):
    hw, rhw = get_target(hw_name), ref_get_target(hw_name)
    mine, theirs = _paths(SIZES)
    mine.append(mine[0])      # a repeated layer takes the dedup path
    theirs.append(theirs[0])
    got = build_cost_table(mine, hw, P.ALL_PARTITIONINGS, engine=engine)
    want = ref_build_cost_table(theirs, rhw, R.ALL_PARTITIONINGS, engine=engine)
    assert canon(got) == canon(want)
    if engine == "vectorized":
        t, rt = P.build_cost_tables(mine, hw), R.build_cost_tables(theirs, rhw)
        assert canon(t) == canon(rt)
        assert canon(t.edp(hw)) == canon(rt.edp(rhw))
        assert got == build_cost_table(mine, hw, P.ALL_PARTITIONINGS,
                                       engine="scalar")


@pytest.mark.parametrize("hw_name", HW_NAMES)
def test_train_cost_tables_match_reference(hw_name):
    hw, rhw = get_target(hw_name), ref_get_target(hw_name)
    nets, rnets = _nets(SMALL)
    mine, theirs = _paths(SMALL, k=3)
    lbs = P.memoised_layer_backwards(nets, k=3)
    rlbs = R.memoised_layer_backwards(rnets, k=3)
    assert canon(lbs) == canon(rlbs)
    t = P.build_train_cost_tables(mine, lbs, hw)
    rt = R.build_train_cost_tables(theirs, rlbs, rhw)
    assert canon(t) == canon(rt)
    assert canon(t.train_seconds()) == canon(rt.train_seconds())
    w = P.TrainCostWeights(fwd=1.0, bwd=2.0, update=0.5)
    rw = R.TrainCostWeights(fwd=1.0, bwd=2.0, update=0.5)
    assert canon(P.build_train_cost_tables(mine, lbs, hw, weights=w)
                 .train_seconds()) == \
        canon(R.build_train_cost_tables(theirs, rlbs, rhw, weights=rw)
              .train_seconds())


@pytest.mark.parametrize("budget", [8 * 2**20, 4096])
@pytest.mark.parametrize("hw_name", HW_NAMES)
def test_fused_cost_tables_match_reference(hw_name, budget):
    hw, rhw = get_target(hw_name), ref_get_target(hw_name)
    nets, rnets = _nets(SIZES)
    mine, theirs = _paths(SIZES)
    got = fused_cost_tables(mine, nets, hw, block_tokens=64, budget_bytes=budget,
                            base=P.build_cost_tables(mine, hw))
    want = ref_fused_cost_tables(theirs, rnets, rhw, block_tokens=64,
                                 budget_bytes=budget,
                                 base=R.build_cost_tables(theirs, rhw))
    assert canon(got) == canon(want)


# ---------------------------------------------------------------------------
# Algorithm 1: global search, brute force, calibration, Pareto fronts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["latency", "edp", "train-latency"])
@pytest.mark.parametrize("hw_name", HW_NAMES)
def test_global_search_matches_reference(hw_name, objective):
    hw, rhw = get_target(hw_name), ref_get_target(hw_name)
    mine, theirs = _paths(SMALL, k=3)
    if objective == "train-latency":
        nets, rnets = _nets(SMALL)
        got = P.global_search(mine, hw, objective=objective,
                              layer_backwards=P.memoised_layer_backwards(nets, k=3))
        want = R.global_search(theirs, rhw, objective=objective,
                               layer_backwards=R.memoised_layer_backwards(rnets, k=3))
    elif objective == "edp":
        got = P.global_search(mine, hw, table=P.build_cost_tables(mine, hw).edp(hw))
        want = R.global_search(theirs, rhw,
                               table=R.build_cost_tables(theirs, rhw).edp(rhw))
    else:
        got, want = P.global_search(mine, hw), R.global_search(theirs, rhw)
        assert P.brute_force_search(mine, hw) == R.brute_force_search(theirs, rhw)
        assert got.total_latency_s == pytest.approx(P.brute_force_search(mine, hw),
                                                    abs=1e-12)
        for engine in ("scalar", "vectorized"):
            assert canon(P.global_search(mine, hw, engine=engine)) == \
                canon(R.global_search(theirs, rhw, engine=engine))
    assert canon(got) == canon(want)


@pytest.mark.parametrize("hw_name", HW_NAMES)
def test_explore_model_and_calibration_match_reference(hw_name):
    hw, rhw = get_target(hw_name), ref_get_target(hw_name)
    nets, rnets = _nets(SMALL)
    for objective in ("latency", "train-latency"):
        assert canon(P.explore_model(nets, hw, top_k=2, objective=objective)) == \
            canon(R.explore_model(rnets, rhw, top_k=2, objective=objective))
    mine, theirs = _paths(SMALL, k=3)
    cal = {"OS": 1.5, "WS": 0.75, "IS": 2.0}
    table = P.build_cost_tables(mine, hw).seconds
    rtable = R.build_cost_tables(theirs, rhw).seconds
    got = P.apply_calibration(table, {P.Dataflow(k): v for k, v in cal.items()})
    want = R.apply_calibration(rtable, {R.Dataflow(k): v for k, v in cal.items()})
    assert canon(got) == canon(want)
    assert canon(P.global_search(mine, hw, calibration={
        P.Dataflow(k): v for k, v in cal.items()})) == canon(R.global_search(
            theirs, rhw, calibration={R.Dataflow(k): v for k, v in cal.items()}))


def test_throughput_phase_tables_match_reference():
    from repro.core.dse import combine_phase_tables as ref_combine
    from repro.core.dse import replay_paths as ref_replay
    from repro_torch.core.dse import combine_phase_tables, replay_paths

    hw, rhw = get_target("fpga_vu9p"), ref_get_target("fpga_vu9p")
    mine, theirs = _paths(SMALL, k=3)
    dec = [P.tt_linear_network(2, *s[1:]) for s in SMALL]
    rdec = [R.tt_linear_network(2, *s[1:]) for s in SMALL]
    dp, rdp = replay_paths(mine, dec), ref_replay(theirs, rdec)
    assert canon(dp) == canon(rdp)
    got = combine_phase_tables(P.build_cost_tables(mine, hw).seconds,
                               P.build_cost_tables(dp, hw).seconds, w_decode=16.0)
    want = ref_combine(R.build_cost_tables(theirs, rhw).seconds,
                       R.build_cost_tables(rdp, rhw).seconds, w_decode=16.0)
    assert canon(got) == canon(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_front_matches_reference(seed):
    rng = np.random.default_rng(seed)
    pts = [tuple(map(float, p)) for p in rng.integers(0, 20, size=(40, 2))]
    assert P.pareto_front(pts) == R.pareto_front(pts)
    pts = [(1.0, 5.0), (2.0, 1.0), (3.0, 4.0), (0.5, 6.0), (2.5, 0.5)]
    assert P.pareto_front(pts) == R.pareto_front(pts)


# ---------------------------------------------------------------------------
# the hardware axis: ArchSpace and the co-search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [None, 2048, 8192])
@pytest.mark.parametrize("hw_name", HW_NAMES)
def test_arch_space_matches_reference(hw_name, budget):
    hw, rhw = get_target(hw_name), ref_get_target(hw_name)
    space = ArchSpace(base=hw, mac_budget=budget)
    rspace = RefArchSpace(base=rhw, mac_budget=budget)
    cands, rcands = space.candidates(), rspace.candidates()
    assert canon(cands) == canon(rcands)
    assert arch_coordinates(cands) == ref_arch_coordinates(rcands)
    for c, rc in zip(cands, rcands):
        assert space.describe(c) == rspace.describe(rc)
        assert space.feasibility(c) == rspace.feasibility(rc)
    odd = dataclasses.replace(hw, name="odd", pe_rows=3, pe_cols=4096)
    rodd = dataclasses.replace(rhw, name="odd", pe_rows=3, pe_cols=4096)
    assert space.feasibility(odd) == rspace.feasibility(rodd)


@pytest.mark.parametrize("objective", ["latency", "train-latency"])
@pytest.mark.parametrize("hw_name", HW_NAMES)
def test_hw_space_search_matches_reference(hw_name, objective):
    hw, rhw = get_target(hw_name), ref_get_target(hw_name)
    cands = ArchSpace(base=hw).candidates()[:12]
    rcands = RefArchSpace(base=rhw).candidates()[:12]
    mine, theirs = _paths(SMALL, k=3)
    if objective == "train-latency":
        nets, rnets = _nets(SMALL)
        lbs = P.memoised_layer_backwards(nets, k=3)
        rlbs = R.memoised_layer_backwards(rnets, k=3)
        got = P.global_search(mine, objective=objective, layer_backwards=lbs,
                              hw_space=cands)
        want = R.global_search(theirs, objective=objective, layer_backwards=rlbs,
                               hw_space=rcands)
        assert canon(P.build_train_cost_tables_hw(mine, lbs, cands[:3])) == \
            canon(R.build_train_cost_tables_hw(theirs, rlbs, rcands[:3]))
    else:
        got = P.global_search(mine, hw_space=cands)
        want = R.global_search(theirs, hw_space=rcands)
        assert canon(P.build_cost_tables_hw(mine, cands)) == \
            canon(R.build_cost_tables_hw(theirs, rcands))
    assert canon(got) == canon(want)


# ---------------------------------------------------------------------------
# training DSE, fusion segmentation, TT-SVD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw_name", HW_NAMES)
def test_layer_backward_and_update_seconds_match_reference(hw_name):
    hw, rhw = get_target(hw_name), ref_get_target(hw_name)
    for tn, rtn in zip(*_nets(SIZES)):
        lb, rlb = P.layer_backward(tn, k=3), R.layer_backward(rtn, k=3)
        assert canon(lb) == canon(rlb)
        assert P.update_seconds(lb.n_params, hw) == R.update_seconds(rlb.n_params, rhw)
        assert P.update_seconds(lb.n_params, hw, 4.0) == \
            R.update_seconds(rlb.n_params, rhw, 4.0)


@pytest.mark.parametrize("block_tokens", [8, 64, 256])
@pytest.mark.parametrize("budget", [8 * 2**20, 65536, 4096])
def test_segment_path_matches_reference(block_tokens, budget):
    for tn, rtn in zip(*_nets(SIZES)):
        for p in P.find_topk_paths(tn, k=4):
            for input_bytes in (4, 2):
                assert fusion.segment_path(
                    tn, p.steps, block_tokens=block_tokens, budget_bytes=budget,
                    input_bytes=input_bytes) == ref_fusion.segment_path(
                    rtn, p.steps, block_tokens=block_tokens, budget_bytes=budget,
                    input_bytes=input_bytes)


@pytest.mark.parametrize("rel_eps", [0.0, 0.1])
@pytest.mark.parametrize("max_rank", [2, 8, 64])
def test_tt_svd_matches_reference(max_rank, rel_eps):
    rng = np.random.default_rng(max_rank)
    w = rng.normal(size=(64, 48))
    mine = P.tt_svd(w, (4, 4, 4), (4, 12), max_rank, rel_eps)
    theirs = R.tt_svd(w, (4, 4, 4), (4, 12), max_rank, rel_eps)
    assert mine.ranks == theirs.ranks
    for a, b in zip(mine.cores, theirs.cores):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert P.reconstruction_error(mine, w) == pytest.approx(
        R.reconstruction_error(theirs, w), rel=1e-6, abs=1e-9)
    assert mine.compression_ratio == theirs.compression_ratio
    got = P.tt_rand(np.random.default_rng(3), (4, 8), (8, 4), max_rank)
    want = R.tt_rand(np.random.default_rng(3), (4, 8), (8, 4), max_rank)
    assert canon(got) == canon(want)


@pytest.mark.parametrize("arch", ["resnet18/cifar10", "resnet18/tiny_imagenet",
                                  "vit_ti4/cifar10"])
def test_vision_model_layers_match_reference(arch):
    model, dataset = arch.split("/")
    for batch in (1, 4):
        assert canon(model_layers(model, dataset, batch=batch)) == \
            canon(ref_model_layers(model, dataset, batch=batch))
