"""The guided joint search (``repro_torch.search``) against ``repro.search``.

The port's ``search/`` is a copy of the reference's NumPy code, so parity
is exact: the same genomes for the same seed, the same ``DSEResult`` for
the same layers, budget and seed.  The differential-oracle cases of
``tests/test_search_oracle.py`` are replayed against the port's own
functions (the port's exhaustive ``global_search`` is the oracle there).
"""

from __future__ import annotations

import random

import pytest

from repro.core import find_topk_paths as ref_find_topk_paths
from repro.core import memoised_layer_backwards as ref_layer_backwards
from repro.core import tt_linear_network as ref_tt_linear_network
from repro.core.cost_table import table_cells as ref_table_cells
from repro.hw import ArchSpace as RefArchSpace
from repro.hw import FPGA_VU9P as REF_FPGA
from repro.search import JointSpace as RefJointSpace
from repro.search import guided_search as ref_guided_search
from repro_torch.core import (
    find_topk_paths,
    global_search,
    memoised_layer_backwards,
    tt_linear_network,
)
from repro_torch.core.cost_table import table_cells
from repro_torch.core.simulator import ALL_DATAFLOWS
from repro_torch.hw import FPGA_VU9P, ArchSpace
from repro_torch.search import (
    ARCH_NEIGHBORS,
    DEFAULT_BUDGET_FRACTION,
    POPULATION,
    BudgetExhausted,
    JointSpace,
    guided_search,
)
from repro import search as ref_search

#: the small layer stacks of ``tests/test_search_oracle.py``:
#: (tokens, in_modes, out_modes, ranks, top-K) per layer
NETS = {
    "a": [(64, (2, 8), (8, 2), (4, 4, 4), 3), (4, (4, 4), (4, 4), (4, 4, 4), 2)],
    "b": [(16, (4, 4), (4, 4), (6, 6, 6), 2)],
    "c": [(32, (8, 4), (4, 8), (4, 4, 4), 2), (8, (2, 4), (4, 2), (2, 2, 2), 3),
          (64, (4, 8), (8, 4), (4, 4, 4), 2)],
}


def _layers(name: str, port: bool = True):
    net, paths = ((tt_linear_network, find_topk_paths) if port
                  else (ref_tt_linear_network, ref_find_topk_paths))
    return [paths(net(t, i, o, r), k=k) for t, i, o, r, k in NETS[name]]


def _nets(name: str, port: bool = True):
    net = tt_linear_network if port else ref_tt_linear_network
    return [net(t, i, o, r) for t, i, o, r, _ in NETS[name]]


_LAYERS = {n: _layers(n) for n in NETS}
_REF_LAYERS = {n: _layers(n, port=False) for n in NETS}
_CANDS = ArchSpace(base=FPGA_VU9P).candidates()
_REF_CANDS = RefArchSpace(base=REF_FPGA).candidates()


def _pick(start: int, n: int, cands):
    """``tests/test_search_oracle.py::_space``: ``n`` candidates of the VU9P
    space, the base first."""
    picked = [cands[0]]
    step = max(1, (len(cands) - 1) // max(1, n))
    i = 1 + (start % step)
    while len(picked) < n and i < len(cands):
        picked.append(cands[i])
        i += step
    return tuple(picked)


def _space(start: int, n: int):
    return _pick(start, n, _CANDS)


def _ref_space(start: int, n: int):
    return _pick(start, n, _REF_CANDS)


def _flat(res) -> tuple:
    """A ``DSEResult`` as plain values, comparable across the packages."""
    return (
        res.strategy, res.total_latency_s, res.objective, res.search,
        res.evals, res.found_at_eval,
        res.hw.name if res.hw is not None else None,
        tuple((c.layer, c.path_index, c.path.steps, c.partitioning,
               c.dataflow.value, c.latency_s) for c in res.choices),
        tuple((h.hw.name, h.strategy, h.total_latency_s) for h in res.hw_candidates),
        sorted((k[0], k[1], k[2], k[3].value, v) for k, v in res.cost_table.items()),
    )


def _gene(g) -> tuple:
    return (g.arch, g.strategy, tuple((p, c, d.value) for p, c, d in g.genes))


def _assert_same_result(g, e):
    assert g.total_latency_s == e.total_latency_s
    assert g.hw is e.hw
    assert g.strategy == e.strategy
    assert g.choices == e.choices
    assert g.objective == e.objective


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def test_constants_match_reference():
    assert (ARCH_NEIGHBORS, DEFAULT_BUDGET_FRACTION, POPULATION) == (
        ref_search.ARCH_NEIGHBORS, ref_search.DEFAULT_BUDGET_FRACTION,
        ref_search.POPULATION)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("net", sorted(NETS))
def test_genome_stream_matches_reference(net, seed):
    """Same seed: the same random genomes, crossovers and mutations, and
    the same architecture neighbourhoods."""
    space = JointSpace(_LAYERS[net], _space(seed, 9))
    ref = RefJointSpace(_REF_LAYERS[net], _ref_space(seed, 9))
    assert space.arch_neighbors == ref.arch_neighbors
    assert space.strategies == ref.strategies
    rng, rrng = random.Random(seed), random.Random(seed)
    mine = [space.random_genome(rng) for _ in range(6)]
    theirs = [ref.random_genome(rrng) for _ in range(6)]
    for _ in range(12):
        i, j = rng.randrange(len(mine)), rng.randrange(len(mine))
        assert (i, j) == (rrng.randrange(len(theirs)), rrng.randrange(len(theirs)))
        mine.append(space.mutate(space.crossover(mine[i], mine[j], rng), rng))
        theirs.append(ref.mutate(ref.crossover(theirs[i], theirs[j], rrng), rrng))
    assert [_gene(g) for g in mine] == [_gene(g) for g in theirs]


@pytest.mark.parametrize("budget_tables", [None, 1, 2, 5])
@pytest.mark.parametrize("seed,n_arch", [(0, 1), (1, 6), (7, 12)])
@pytest.mark.parametrize("net", sorted(NETS))
def test_guided_search_matches_reference(net, seed, n_arch, budget_tables):
    space, rspace = _space(seed, n_arch), _ref_space(seed, n_arch)
    budget = (None if budget_tables is None
              else budget_tables * table_cells(_LAYERS[net]))
    hw_space = space if n_arch > 1 else None
    rhw_space = rspace if n_arch > 1 else None
    mine = guided_search(_LAYERS[net], space[0], hw_space=hw_space,
                         budget=budget, seed=seed)
    theirs = ref_guided_search(_REF_LAYERS[net], rspace[0], hw_space=rhw_space,
                               budget=budget, seed=seed)
    assert _flat(mine) == _flat(theirs)


def test_guided_train_latency_matches_reference():
    space, rspace = _space(3, 6), _ref_space(3, 6)
    mine = guided_search(_LAYERS["a"], space[0], hw_space=space,
                         objective="train-latency", seed=7,
                         layer_backwards=memoised_layer_backwards(_nets("a"), k=3))
    theirs = ref_guided_search(
        _REF_LAYERS["a"], rspace[0], hw_space=rspace, objective="train-latency",
        seed=7, layer_backwards=ref_layer_backwards(_nets("a", port=False), k=3))
    assert _flat(mine) == _flat(theirs)


def test_guided_calibration_matches_reference():
    cal = {"IS": 3.0, "OS": 0.5, "WS": 1.5}
    mine = guided_search(_LAYERS["a"], FPGA_VU9P, hw_space=_space(0, 6),
                         calibration=cal, seed=1)
    theirs = ref_guided_search(_REF_LAYERS["a"], REF_FPGA,
                               hw_space=_ref_space(0, 6), calibration=cal, seed=1)
    assert _flat(mine) == _flat(theirs)
    assert table_cells(_LAYERS["c"]) == ref_table_cells(_REF_LAYERS["c"])


# ---------------------------------------------------------------------------
# the oracle cases of tests/test_search_oracle.py, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net,start,n_arch,seed", [
    ("a", 0, 1, 0), ("a", 5, 8, 17), ("b", 13, 16, 4242), ("b", 40, 3, 9),
    ("c", 2, 12, 777), ("c", 31, 5, 10_000),
])
def test_guided_generous_budget_matches_exhaustive(net, start, n_arch, seed):
    layer_paths = _LAYERS[net]
    space = _space(start, n_arch)
    exhaustive = global_search(layer_paths, space[0], hw_space=space)
    guided = guided_search(layer_paths, space[0], hw_space=space,
                           budget=exhaustive.evals, seed=seed)
    _assert_same_result(guided, exhaustive)
    assert guided.search == "guided" and exhaustive.search == "exhaustive"
    assert guided.evals == exhaustive.evals
    assert len(guided.hw_candidates) == len(space)
    assert guided.found_at_eval <= guided.evals


def test_guided_fixed_target_is_algorithm_one():
    exhaustive = global_search(_LAYERS["a"], FPGA_VU9P)
    guided = guided_search(_LAYERS["a"], FPGA_VU9P)
    _assert_same_result(guided, exhaustive)
    assert guided.hw_candidates == ()
    assert guided.evals == exhaustive.evals == len(exhaustive.cost_table)


def test_guided_train_latency_parity_with_exhaustive():
    backwards = memoised_layer_backwards(_nets("a"), k=3)
    space = _space(3, 6)
    exhaustive = global_search(_LAYERS["a"], space[0], hw_space=space,
                               objective="train-latency", layer_backwards=backwards)
    guided = guided_search(_LAYERS["a"], space[0], hw_space=space,
                           objective="train-latency", layer_backwards=backwards,
                           budget=exhaustive.evals, seed=7)
    _assert_same_result(guided, exhaustive)


@pytest.mark.parametrize("seed,n_arch", [(0, 2), (99, 7), (5000, 12)])
def test_guided_same_seed_bit_identical(seed, n_arch):
    space = _space(seed, n_arch)
    runs = [guided_search(_LAYERS["b"], space[0], hw_space=space, seed=seed)
            for _ in range(2)]
    assert runs[0] == runs[1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_guided_different_seeds_reach_oracle_with_full_budget(seed):
    space = _space(0, 8)
    exhaustive = global_search(_LAYERS["b"], space[0], hw_space=space)
    guided = guided_search(_LAYERS["b"], space[0], hw_space=space,
                           budget=exhaustive.evals, seed=seed)
    _assert_same_result(guided, exhaustive)


@pytest.mark.parametrize("seed", [0, 123, 999])
def test_guided_budget_monotone(seed):
    space = _space(2, 10)
    n_cells = table_cells(_LAYERS["b"])
    costs = []
    for mult in (1, 2, 3, 5, 10):
        res = guided_search(_LAYERS["b"], space[0], hw_space=space,
                            budget=mult * n_cells, seed=seed)
        assert res.evals <= mult * n_cells
        costs.append(res.total_latency_s)
    assert costs == sorted(costs, reverse=True)


def test_guided_budget_below_one_table_and_objectives_rejected():
    with pytest.raises(ValueError, match="cannot refine even one"):
        guided_search(_LAYERS["b"], FPGA_VU9P,
                      budget=table_cells(_LAYERS["b"]) - 1)
    with pytest.raises(ValueError, match="exhaustive path"):
        guided_search(_LAYERS["b"], FPGA_VU9P, objective="edp")
    with pytest.raises(ValueError, match="layer_backwards"):
        guided_search(_LAYERS["b"], FPGA_VU9P, objective="train-latency")


def test_guided_minimal_budget_equals_fixed_target():
    space = _space(1, 8)
    fixed = global_search(_LAYERS["a"], space[0])
    res = guided_search(_LAYERS["a"], space[0], hw_space=space,
                        budget=table_cells(_LAYERS["a"]), seed=0)
    assert res.total_latency_s == fixed.total_latency_s
    assert res.hw is space[0]


def test_guided_calibration_parity_with_exhaustive():
    space = _space(0, 6)
    cal = {"IS": 3.0, "OS": 0.5, "WS": 1.5}
    exhaustive = global_search(_LAYERS["a"], space[0], hw_space=space,
                               calibration=cal)
    guided = guided_search(_LAYERS["a"], space[0], hw_space=space,
                           calibration=cal, budget=exhaustive.evals, seed=1)
    _assert_same_result(guided, exhaustive)


@pytest.mark.parametrize("seed", [0, 17, 4096])
def test_genome_operators_always_produce_valid_table_coords(seed):
    space_hw = _space(seed, 9)
    js = JointSpace(_LAYERS["c"], space_hw)
    rng = random.Random(seed)
    genomes = [js.random_genome(rng) for _ in range(6)]
    for _ in range(10):
        a, b = rng.sample(genomes, 2)
        genomes.append(js.mutate(js.crossover(a, b, rng), rng))
    for g in genomes:
        assert 0 <= g.arch < len(space_hw)
        assert g.strategy in js.strategy_space
        for (l, p, c, d) in g.keys():
            assert 0 <= p < len(_LAYERS["c"][l])
            assert c in js.strategy_space[g.strategy]
            assert d in js.dataflows and d in ALL_DATAFLOWS


def test_budget_exhausted_is_internal_control_flow():
    assert issubclass(BudgetExhausted, Exception)
    res = guided_search(_LAYERS["b"], _CANDS[0], hw_space=_space(0, 12),
                        budget=table_cells(_LAYERS["b"]), seed=0)
    assert res.search == "guided"
