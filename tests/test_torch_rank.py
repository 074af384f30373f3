"""The rank search (``repro_torch.rank``) against ``repro.rank``.

The port's ``rank/`` is a copy of the reference's NumPy code (the
calibration forward aside, ``tests/test_torch_rank_model.py``), so parity
is exact: the same candidate spaces for every architecture, the same
TT-SVD proxies, the same frontier and chosen candidate for a rank search
on the smoke config over a narrowed ladder (two ranks, two mode counts),
and the same ``--rank-search budget`` report (minus its wall-clock keys)
and smoke plan bytes.  The cases of ``tests/test_rank.py`` are replayed
against the port's own functions.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import dse_cli as ref_dse_cli
from repro import rank as ref_rank
from repro.configs import get_config as ref_get_config
from repro.hw import ArchSpace as RefArchSpace
from repro.hw import get_target as ref_get_target
from repro_torch import dse_cli
from repro_torch import rank as port_rank
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.hw import ArchSpace, get_target
from repro_torch.nn import installed_factorizations, plan_context
from repro_torch.plan import load_plan
from repro_torch.rank import (
    FamilyFactorization,
    RankCandidate,
    RankSpace,
    candidate_proxy,
    clip_ranks,
    rank_search,
    reconstruction_proxy,
    reference_weight,
    vision_rank_space,
)
from repro_torch.rank.proxy import frontier_points
from test_torch_dse_cli import _main, _strip
from test_torch_plan import EMIT, PLANS, one_blas_thread  # noqa: F401

torch.set_num_threads(2)

WALL = ("eval_seconds", "rank_search_s")
ALL = ("tt-lm-100m",) + ARCH_IDS


def _strip_rank(report):
    """A report without its wall-clock keys, the rank search's included."""
    if isinstance(report, dict):
        return {k: _strip_rank(v) for k, v in _strip(report).items()
                if k not in WALL}
    if isinstance(report, list):
        return [_strip_rank(v) for v in report]
    return report


def _space_rows(space) -> tuple:
    return (space.param_budget_ratio, space.base_d, space.base_rank,
            space.ladder, space.mode_counts,
            [(c.name, c.d, c.rank, c.n_params, c.dense_params, c.compression,
              [dataclasses.astuple(f) for f in c.families])
             for c in space.candidates()])


def _small(pkg, cfg):
    """``tests/test_rank.py::_small_space``: two ranks, two mode counts."""
    return pkg.RankSpace.from_config(cfg, ladder=(0.5, 1.0), mode_counts=(1, 2))


def _result_rows(res) -> tuple:
    def ev(e):
        r = e.res
        return (e.candidate.name, e.total_latency_s, e.accuracy_proxy,
                sorted(e.family_proxies.items()), r.strategy, r.total_latency_s,
                r.search, r.evals, r.found_at_eval,
                r.hw.name if r.hw is not None else None,
                [(c.layer, c.path_index, c.partitioning, c.dataflow.value,
                  c.latency_s) for c in r.choices],
                [(n, [(x.name, x.edges, x.dims) for x in tn.nodes])
                 for n, tn in e.named])
    return (res.arch, res.tokens, res.frontier, res.chosen, res.frozen,
            res.accuracy_budget, res.param_budget_ratio, res.dominates_frozen,
            res.improvement_pct, [ev(e) for e in res.evals])


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def test_constants_match_reference():
    names = ("DEFAULT_PARAM_BUDGET_RATIO", "MODES_PER_SIDE", "RANK_LADDER_FACTORS",
             "NOISE_FLOOR", "REFERENCE_COMPONENTS", "SPECTRUM_DECAY", "PROXY_EPS",
             "RANK_SEARCH_MODES")
    assert [getattr(port_rank, n) for n in names] == \
        [getattr(ref_rank, n) for n in names]
    assert port_rank.__all__ == ref_rank.__all__


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ALL)
def test_rank_space_matches_reference(arch, smoke):
    assert _space_rows(RankSpace.from_config(get_config(arch, smoke=smoke))) == \
        _space_rows(ref_rank.RankSpace.from_config(ref_get_config(arch, smoke=smoke)))


@pytest.mark.parametrize("arch", dse_cli.VISION_ARCHS)
def test_vision_rank_space_matches_reference(arch):
    assert _space_rows(vision_rank_space(arch)) == \
        _space_rows(ref_rank.vision_rank_space(arch))


def test_full_width_rank_space_is_the_one_the_card_serves():
    """tt-lm-100m: 15 candidates, 1-4 modes a side, ranks 4-24 (a rank of
    32 leaves the 2x parameter budget at every mode count)."""
    cands = RankSpace.from_config(get_config("tt-lm-100m")).candidates()
    assert len(cands) == 15
    assert {c.d for c in cands} == {1, 2, 3, 4}
    assert min(c.rank for c in cands) == 4 and max(c.rank for c in cands) == 24


@pytest.mark.parametrize("arch", ["tt-lm-100m", "glm4-9b", "qwen2-moe-a2.7b"])
def test_proxies_match_reference(arch):
    """Reference weights bit for bit, every family's TT-SVD proxy and the
    candidate proxy (with and without activation weights) equal."""
    cfg, rcfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
    mine, theirs = _small(port_rank, cfg), _small(ref_rank, rcfg)
    for c, rc in zip(mine.candidates(), theirs.candidates()):
        for f, rf in zip(c.families, rc.families):
            assert np.array_equal(reference_weight(f.name, f.d_out, f.d_in),
                                  ref_rank.reference_weight(rf.name, rf.d_out, rf.d_in))
            assert port_rank.family_proxy(f) == ref_rank.family_proxy(rf)
        weights = {f.name: 1.0 + i for i, f in enumerate(c.families)}
        assert candidate_proxy(c) == ref_rank.candidate_proxy(rc)
        assert candidate_proxy(c, weights) == ref_rank.candidate_proxy(rc, weights)
    assert reconstruction_proxy("attn.wq", 64, 64, (8, 8), (8, 8), 3) == \
        ref_rank.reconstruction_proxy("attn.wq", 64, 64, (8, 8), (8, 8), 3)


@pytest.mark.parametrize("points", [
    [(1.0, 0.5), (2.0, 0.25), (1.5, 0.6), (3.0, 0.25), (1.0, 0.5)],
    [(0.1, 0.1)],
    [(2.0, 1.0), (1.0, 2.0), (1.0, 2.0), (0.5, 3.0), (3.0, 0.5)],
])
def test_frontier_points_match_reference(points):
    from repro.rank.proxy import frontier_points as ref_frontier_points

    assert frontier_points(points) == ref_frontier_points(points)


@pytest.mark.parametrize("case", [
    dict(),
    dict(search="guided"),
    dict(search="guided", search_seed=3),
    dict(accuracy_budget=0.9),
    dict(param_budget_ratio=1.0),
    dict(hw_space=True),
])
def test_rank_search_matches_reference(case):
    """The smoke config over the narrowed ladder: every candidate's
    networks, DSE result and proxies, the frontier and the chosen one."""
    case = dict(case)
    cfg, rcfg = get_config("tt-lm-100m", smoke=True), ref_get_config("tt-lm-100m",
                                                                     smoke=True)
    kw, rkw = dict(case), dict(case)
    if case.pop("hw_space", False):
        kw["hw_space"] = ArchSpace(base=get_target("fpga_vu9p")).candidates()[:4]
        rkw["hw_space"] = RefArchSpace(
            base=ref_get_target("fpga_vu9p")).candidates()[:4]
    space = dict(ladder=(0.5, 1.0), mode_counts=(1, 2))
    if "param_budget_ratio" in case:
        space["param_budget_ratio"] = case["param_budget_ratio"]
    mine = rank_search("tt-lm-100m", get_target("fpga_vu9p"), top_k=2, tokens=32,
                       smoke=True, space=RankSpace.from_config(cfg, **space), **kw)
    theirs = ref_rank.rank_search(
        "tt-lm-100m", ref_get_target("fpga_vu9p"), top_k=2, tokens=32, smoke=True,
        space=ref_rank.RankSpace.from_config(rcfg, **space), **rkw)
    assert _result_rows(mine) == _result_rows(theirs)


def test_rank_search_vision_matches_reference():
    space = dict(base_rank=8, ladder=(0.5, 1.0))
    mine = rank_search("vit_ti4/cifar10", get_target("fpga_vu9p"), top_k=2,
                       space=vision_rank_space("vit_ti4/cifar10", **space))
    theirs = ref_rank.rank_search(
        "vit_ti4/cifar10", ref_get_target("fpga_vu9p"), top_k=2,
        space=ref_rank.vision_rank_space("vit_ti4/cifar10", **space))
    assert _result_rows(mine) == _result_rows(theirs)


# ---------------------------------------------------------------------------
# the CLI: --rank-search budget
# ---------------------------------------------------------------------------

SMOKE = ["--arch", "tt-lm-100m", "--smoke", "--top-k", "2", "--tokens", "64"]


@pytest.mark.parametrize("extra", [
    ["--rank-search", "budget"],
    ["--rank-search", "budget", "--search", "guided", "--accuracy-budget", "0.5"],
])
def test_rank_search_report_matches_reference(extra):
    rc, out, err = _main(dse_cli.main, SMOKE + extra)
    rrc, rout, rerr = _main(ref_dse_cli.main, SMOKE + extra)
    assert rc == rrc == 0, err + rerr
    mine, theirs = json.loads(out), json.loads(rout)
    assert mine["rank_search"]["plan_embeddable"] is True
    assert _strip_rank(mine) == _strip_rank(theirs)


def test_smoke_rank_plan_emits_byte_identical_to_committed_and_reference(tmp_path):
    argv = EMIT["tt-lm-smoke.rank.json"]
    for main, name in ((dse_cli.main, "mine"), (ref_dse_cli.main, "theirs")):
        rc, _, err = _main(main, argv + ["--emit-plan", str(tmp_path / name),
                                         "--out", "-"])
        assert rc == 0, err
    text = (tmp_path / "mine").read_text()
    assert text == (tmp_path / "theirs").read_text()
    assert text == (PLANS / "tt-lm-smoke.rank.json").read_text()
    plan = load_plan(str(tmp_path / "mine"))
    assert plan.version == 4
    facts = [lp.factorization for lp in plan.layers]
    assert all(f is not None and f.out_modes and len(f.ranks) == 1 for f in facts)


# ---------------------------------------------------------------------------
# the cases of tests/test_rank.py, on the port
# ---------------------------------------------------------------------------

def test_clip_ranks_full_rank_bound():
    assert clip_ranks((4, 6, 6, 3), 1000) == (4, 18, 3)
    assert clip_ranks((4, 6, 6, 3), 8) == (4, 8, 3)
    assert clip_ranks((24,), 5) == ()
    assert clip_ranks((24, 18), 5) == (5,)


def test_family_factorization_validates():
    with pytest.raises(ValueError, match="do not factor"):
        FamilyFactorization("f", 24, 18, (4, 7), (6, 3), (4, 8, 3))
    with pytest.raises(ValueError, match="interior ranks"):
        FamilyFactorization("f", 24, 18, (4, 6), (6, 3), (4,))
    f = FamilyFactorization("f", 24, 18, (4, 6), (6, 3), (4, 8, 3))
    assert f.triple == ((4, 6), (6, 3), (4, 8, 3))
    assert f.dense_params == 24 * 18
    assert f.n_params == 16 + 192 + 144 + 9


def test_rank_space_frozen_first_dedup_budget():
    space = RankSpace([("proj", 64, 64, 2, 1.0)], base_d=2, base_rank=8)
    cands = space.candidates()
    assert cands[0].name == "frozen" and (cands[0].d, cands[0].rank) == (2, 8)
    names = [c.name for c in cands]
    assert len(names) == len(set(names)) and "d2_r8" not in names
    assert all(c.n_params <= space.param_budget_ratio * cands[0].n_params
               for c in cands)
    keys = [c._key() for c in cands]
    assert len(keys) == len(set(keys))


def test_rank_space_tight_budget_keeps_frozen():
    space = RankSpace([("proj", 64, 64, 1, 1.0)], base_d=2, base_rank=4,
                      param_budget_ratio=1.0)
    cands = space.candidates()
    assert cands[0].name == "frozen"
    assert all(c.n_params <= cands[0].n_params for c in cands)


def test_rank_space_from_config_and_dense_config():
    cfg = get_config("tt-lm-100m", tt=True, smoke=True)
    space = RankSpace.from_config(cfg)
    assert (space.base_d, space.base_rank) == (cfg.tt.d, cfg.tt.rank)
    assert space.frozen.compression > 1.0
    assert {f.name for f in space.frozen.families} >= {"attn.wq", "attn.wk"}
    with pytest.raises(ValueError, match="no tensorized"):
        RankSpace.from_config(get_config("tt-lm-100m", tt=False, smoke=True))


def test_d1_candidate_is_plain_low_rank():
    space = RankSpace([("proj", 24, 18, 1, 1.0)], base_d=2, base_rank=4,
                      mode_counts=(1,), ladder=(1.0,))
    f = next(c for c in space.candidates() if c.d == 1).families[0]
    assert (f.out_modes, f.in_modes, f.ranks) == ((24,), (18,), (4,))
    assert f.n_params == 1 * 24 * 4 + 4 * 18 * 1


def test_reference_weight_and_proxy_properties():
    w1 = reference_weight("attn.wq", 64, 48)
    assert w1 is reference_weight("attn.wq", 64, 48)
    assert w1.shape == (64, 48) and w1.dtype == np.float32 and not w1.flags.writeable
    assert not np.allclose(w1, reference_weight("mlp.w1", 64, 48))
    errs = [reconstruction_proxy("attn.wq", 64, 64, (8, 8), (8, 8), r)
            for r in (1, 2, 4, 8, 16)]
    assert all(e >= 0 for e in errs)
    assert all(errs[i] >= errs[i + 1] - 1e-12 for i in range(len(errs) - 1))
    good = FamilyFactorization("a", 64, 64, (64,), (64,), (64,))
    bad = FamilyFactorization("b", 64, 64, (64,), (64,), (1,))
    cand = RankCandidate("x", 1, 1, (good, bad))
    assert candidate_proxy(cand, weights={"b": 0.01}) < candidate_proxy(cand) \
        < candidate_proxy(cand, weights={"b": 100.0})


def test_rank_search_frontier_chosen_and_budgets():
    cfg = get_config("tt-lm-100m", tt=True, smoke=True)
    res = rank_search("tt-lm-100m", get_target("fpga_vu9p"), top_k=2, tokens=32,
                      smoke=True, space=_small(port_rank, cfg))
    assert res.evals[res.frozen].candidate.name == "frozen" and res.frontier
    cap = res.frozen_eval.accuracy_proxy + 1e-9
    assert res.chosen_eval.accuracy_proxy <= cap
    assert res.chosen_eval.total_latency_s == min(
        e.total_latency_s for e in res.evals if e.accuracy_proxy <= cap)
    with pytest.raises(ValueError, match="infeasible"):
        rank_search("tt-lm-100m", get_target("fpga_vu9p"), top_k=2, tokens=32,
                    smoke=True, space=_small(port_rank, cfg), accuracy_budget=1e-9)
    with pytest.raises(ValueError, match="positive"):
        rank_search("tt-lm-100m", get_target("fpga_vu9p"), accuracy_budget=-1.0)


def test_rank_search_frozen_matches_plain_dse():
    cfg = get_config("tt-lm-100m", tt=True, smoke=True)
    space = RankSpace.from_config(cfg, ladder=(1.0,), mode_counts=(cfg.tt.d,))
    res = rank_search("tt-lm-100m", get_target("fpga_vu9p"), top_k=2, tokens=32,
                      smoke=True, space=space)
    report = dse_cli.run_dse("tt-lm-100m", "fpga_vu9p", top_k=2, tokens=32,
                             smoke=True)
    assert res.frozen_eval.total_latency_s == report["total_latency_s"]


@pytest.fixture(scope="module")
def smoke_rank_run():
    """``run_dse_plan`` of the smoke config under the rank search, once."""
    return dse_cli.run_dse_plan("tt-lm-100m", "fpga_vu9p", top_k=2, tokens=32,
                                smoke=True, rank_search="budget")


def test_run_dse_rank_search_report(smoke_rank_run):
    report, _ = smoke_rank_run
    rs = report["rank_search"]
    assert rs["mode"] == "budget" and rs["n_candidates"] >= 2
    assert rs["chosen"]["name"] in {c["name"] for c in rs["candidates"]}
    assert rs["plan_embeddable"] is True and rs["chosen"]["families"]
    for fam in rs["chosen"]["families"]:
        assert set(fam) >= {"name", "out_modes", "in_modes", "ranks",
                            "accuracy_proxy"}
    assert report["total_latency_s"] == rs["chosen"]["total_latency_s"]


def test_emit_plan_v4_roundtrip_and_plan_context(smoke_rank_run, tmp_path):
    path = tmp_path / "p.json"
    path.write_text(smoke_rank_run[1].dumps())
    plan = load_plan(str(path))
    assert plan.version == 4
    facts = {lp.name: lp.factorization for lp in plan.layers}
    assert any(f is not None for f in facts.values())
    for f in facts.values():
        if f is not None:
            assert len(f.ranks) == len(f.out_modes) + len(f.in_modes) - 1
    assert json.dumps(plan.to_json(), indent=2, sort_keys=True) + "\n" == \
        path.read_text()
    before = installed_factorizations()
    with plan_context(plan):
        assert installed_factorizations() == {
            n: f.triple for n, f in facts.items() if f is not None}
    assert installed_factorizations() == before


def test_rank_search_flag_validation():
    for kwargs in (dict(mode="train"), dict(objective="edp"),
                   dict(engine="scalar")):
        with pytest.raises(ValueError, match="rank"):
            dse_cli.run_dse("tt-lm-100m", "fpga_vu9p", top_k=2, tokens=32,
                            smoke=True, rank_search="budget", **kwargs)
    with pytest.raises(ValueError, match="accuracy_budget"):
        dse_cli.run_dse("tt-lm-100m", "fpga_vu9p", top_k=2, tokens=32,
                        smoke=True, accuracy_budget=0.5)
    with pytest.raises(SystemExit):
        dse_cli.main(["--arch", "tt-lm-100m", "--smoke", "--accuracy-budget", "0.5"])
    with pytest.raises(SystemExit):
        dse_cli.main(["--arch", "tt-lm-100m", "--smoke", "--rank-search", "budget",
                      "--emit-plan-pair", "unused"])


def test_vision_rank_space_properties():
    cands = vision_rank_space("vit_ti4/cifar10", base_rank=8).candidates()
    assert cands[0].name == "frozen"
    assert all(c.d == 2 or c.name == "frozen" for c in cands)
    assert len({c.rank for c in cands}) > 1
