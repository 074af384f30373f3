"""Plans, plan guards and framework-neutral copies: port against reference.

Everything here is exact: the committed plans are byte-for-byte what the
JAX package's DSE emits, the port's schema round-trips them byte for byte,
and the copied path search, layer enumeration and plan guards give the
reference's answers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import dse_cli as ref_dse_cli
from repro.configs import get_config as ref_get_config
from repro.core import find_topk_paths as ref_find_topk_paths
from repro.hw import HW_TARGETS as REF_HW_TARGETS
from repro.plan import load_plan as ref_load_plan
from repro.plan.compiler import check_plan_for_config as ref_check_plan
from repro.plan.schema import ExecutionPlan as RefExecutionPlan
from repro.plan.schema import migrate_plan_json as ref_migrate
from repro_torch import dse_cli
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import find_topk_paths
from repro_torch.hw import HW_TARGETS
from repro_torch.nn import linear as port_linear
from repro_torch.plan import ExecutionPlan, load_plan, migrate_plan_json
from repro_torch.plan import executor
from repro_torch.plan.compiler import check_plan_for_config

torch.set_num_threads(2)

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # pragma: no cover
    threadpool_limits = None


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One BLAS thread while this module's tests run: the rank search's
    TT-SVDs (``numpy.linalg``) on every thread of every xdist worker at
    once slow each other down by 50x."""
    if threadpool_limits is None:
        yield
        return
    with threadpool_limits(limits=1):
        yield


ROOT = pathlib.Path(__file__).resolve().parents[1]
PLANS = ROOT / "src" / "repro_torch" / "plans"

#: committed plan -> the DSE arguments that emit it
EMIT = {
    "tt-lm-100m.json": ["--arch", "tt-lm-100m"],
    "tt-lm-100m.pair.prefill.json": ["--arch", "tt-lm-100m", "--serve-slots", "4"],
    "tt-lm-100m.pair.decode.json": ["--arch", "tt-lm-100m", "--serve-slots", "4"],
    "tt-lm-100m.shards2.pair.prefill.json": ["--arch", "tt-lm-100m", "--serve-slots",
                                             "4", "--shards", "2"],
    "tt-lm-100m.shards2.pair.decode.json": ["--arch", "tt-lm-100m", "--serve-slots",
                                            "4", "--shards", "2"],
    "tt-lm-smoke.json": ["--arch", "tt-lm-100m", "--smoke"],
    "tt-lm-smoke.tt_gemm.json": ["--arch", "tt-lm-100m", "--smoke",
                                 "--plan-backend", "tt_gemm"],
    "tt-lm-100m.train.json": ["--arch", "tt-lm-100m", "--mode", "train",
                              "--tokens", "2048"],
    "tt-lm-100m.train.tt_gemm.json": ["--arch", "tt-lm-100m", "--mode", "train",
                                      "--tokens", "2048", "--plan-backend",
                                      "tt_gemm"],
    "tt-lm-100m.shards2.train.json": ["--arch", "tt-lm-100m", "--mode", "train",
                                      "--tokens", "2048", "--shards", "2"],
    "tt-lm-100m.shards2.train.tt_gemm.json": ["--arch", "tt-lm-100m", "--mode",
                                              "train", "--tokens", "2048",
                                              "--shards", "2", "--plan-backend",
                                              "tt_gemm"],
    "tt-lm-smoke.train.json": ["--arch", "tt-lm-100m", "--smoke", "--mode",
                               "train", "--top-k", "2", "--tokens", "32"],
    "tt-lm-smoke.train.tt_gemm.json": ["--arch", "tt-lm-100m", "--smoke",
                                       "--mode", "train", "--top-k", "2",
                                       "--tokens", "32", "--plan-backend",
                                       "tt_gemm"],
    "tt-lm-100m.rank.json": ["--arch", "tt-lm-100m", "--rank-search", "budget",
                             "--search", "guided"],
    "tt-lm-smoke.rank.json": ["--arch", "tt-lm-100m", "--smoke", "--top-k", "2",
                              "--tokens", "64", "--rank-search", "budget",
                              "--search", "guided"],
    "qwen2-moe-a2.7b.pair.prefill.json": ["--arch", "qwen2-moe-a2.7b",
                                          "--serve-slots", "4"],
    "qwen2-moe-a2.7b.pair.decode.json": ["--arch", "qwen2-moe-a2.7b",
                                         "--serve-slots", "4"],
    "zamba2-1.2b.pair.prefill.json": ["--arch", "zamba2-1.2b", "--serve-slots", "4"],
    "zamba2-1.2b.pair.decode.json": ["--arch", "zamba2-1.2b", "--serve-slots", "4"],
    "rwkv6-7b.pair.prefill.json": ["--arch", "rwkv6-7b", "--serve-slots", "4"],
    "rwkv6-7b.pair.decode.json": ["--arch", "rwkv6-7b", "--serve-slots", "4"],
    "qwen2-moe-a2.7b.train.json": ["--arch", "qwen2-moe-a2.7b", "--mode", "train",
                                   "--tokens", "2048"],
    "zamba2-1.2b.train.json": ["--arch", "zamba2-1.2b", "--mode", "train",
                               "--tokens", "2048"],
    "zamba2-1.2b.train.tt_gemm.json": ["--arch", "zamba2-1.2b", "--mode", "train",
                                       "--tokens", "2048", "--plan-backend",
                                       "tt_gemm"],
    "rwkv6-7b.train.json": ["--arch", "rwkv6-7b", "--mode", "train",
                            "--tokens", "2048"],
    "seamless-m4t-medium.pair.prefill.json": ["--arch", "seamless-m4t-medium",
                                              "--serve-slots", "4"],
    "seamless-m4t-medium.pair.decode.json": ["--arch", "seamless-m4t-medium",
                                             "--serve-slots", "4"],
    "seamless-m4t-medium.train.json": ["--arch", "seamless-m4t-medium", "--mode",
                                       "train", "--tokens", "2048"],
    "chatglm3-6b.pair.prefill.json": ["--arch", "chatglm3-6b", "--serve-slots", "16"],
    "chatglm3-6b.pair.decode.json": ["--arch", "chatglm3-6b", "--serve-slots", "16"],
    "chatglm3-6b.train.json": ["--arch", "chatglm3-6b", "--mode", "train",
                               "--tokens", "2048"],
}
PLAN_FILES = sorted(EMIT)
#: plans whose emission takes minutes on a CPU (the full-width rank search
#: evaluates 15 decompositions): ``chip_smoke.py`` re-emits them with the
#: port's DSE and holds the bytes; the tests here hold the chosen
#: candidate's leg (:func:`test_rank_plan_is_the_chosen_candidates_compile`)
EMIT_ON_CARD_ONLY = ("tt-lm-100m.rank.json",)
EMITTED_HERE = [n for n in PLAN_FILES if n not in EMIT_ON_CARD_ONLY]


def test_committed_plans_are_the_listed_ones():
    assert sorted(p.name for p in PLANS.glob("*.json")) == PLAN_FILES


@pytest.mark.parametrize("name", PLAN_FILES)
def test_committed_plan_roundtrips_byte_identical(name):
    text = (PLANS / name).read_text()
    assert load_plan(str(PLANS / name)).dumps() == text
    assert ExecutionPlan.loads(text).dumps() == ref_load_plan(str(PLANS / name)).dumps()


@pytest.mark.parametrize("name", EMITTED_HERE)
def test_committed_plan_equals_fresh_reference_emission(name, tmp_path):
    out = tmp_path / "plan"
    if ".pair." in name:
        argv = EMIT[name] + ["--emit-plan-pair", str(out)]
        emitted = tmp_path / ("plan." + name.split(".pair.")[1])
    else:
        argv = EMIT[name] + ["--emit-plan", str(out)]
        emitted = out
    with contextlib.redirect_stdout(io.StringIO()):
        assert ref_dse_cli.main(argv + ["--out", os.devnull]) == 0
    assert emitted.read_text() == (PLANS / name).read_text()


@pytest.mark.parametrize("version", [1, 2, 3])
def test_migration_matches_reference(version):
    d = json.loads((PLANS / "tt-lm-100m.json").read_text())
    d["version"] = version
    if version < 3:
        d["hardware"] = None
    if version < 2:
        for layer in d["layers"]:
            layer.pop("backward")
    mine = ExecutionPlan.from_json(d).dumps()
    theirs = RefExecutionPlan.from_json(d).dumps()
    assert mine == theirs
    assert migrate_plan_json(d) == ref_migrate(d)


def test_hw_targets_match_reference():
    assert {k: v.to_json() for k, v in HW_TARGETS.items()} == \
        {k: v.to_json() for k, v in REF_HW_TARGETS.items()}


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    mine = dataclasses.asdict(get_config("tt-lm-100m", smoke=smoke))
    theirs = dataclasses.asdict(ref_get_config("tt-lm-100m", smoke=smoke))
    assert mine == theirs


def test_unported_arch_points_to_roadmap():
    """Every architecture's config is ported (the DSE plans them all), and
    so is the model code of every family: ``api()`` builds for every arch,
    the encoder-decoder included (no family raises any more)."""
    from repro_torch.models import api

    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            ref_get_config(arch, smoke=True))
        m = api(cfg, device="cpu")
        assert (m.prefill_full is None) == (cfg.family == "encdec")


@pytest.mark.parametrize("smoke", [False, True])
def test_model_layers_and_paths_match_reference(smoke):
    mine = dse_cli.model_dse_layers(get_config("tt-lm-100m", smoke=smoke), tokens=64)
    theirs = ref_dse_cli.model_dse_layers(ref_get_config("tt-lm-100m", smoke=smoke),
                                          tokens=64)
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    seen = set()
    for (name, tn), (_, rtn) in zip(mine, theirs):
        assert [(n.name, n.edges, n.dims, n.kind) for n in tn.nodes] == \
            [(n.name, n.edges, n.dims, n.kind) for n in rtn.nodes]
        family = name.split("[")[0]
        if family in seen:
            continue
        seen.add(family)
        got = [(p.steps, p.macs, tuple(g.as_tuple() for g in p.gemms))
               for p in find_topk_paths(tn, k=4)]
        want = [(p.steps, p.macs, tuple(g.as_tuple() for g in p.gemms))
                for p in ref_find_topk_paths(rtn, k=4)]
        assert got == want


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", PLAN_FILES)
def test_plan_guard_matches_reference(name, smoke):
    """check_plan_for_config gives the reference's problems for every
    committed plan against both configs of its arch, under each serving
    phase."""
    plan, rplan = load_plan(str(PLANS / name)), ref_load_plan(str(PLANS / name))
    arch = plan.arch
    cfg, rcfg = get_config(arch, smoke=smoke), ref_get_config(arch, smoke=smoke)
    for phase in (None, "prefill", "decode"):
        mine = check_plan_for_config(plan, arch, cfg, phase=phase)
        theirs = ref_check_plan(rplan, arch, rcfg, phase=phase)
        assert mine == theirs
        if ("smoke" in name) == smoke and phase is None:
            assert mine == []
    assert check_plan_for_config(plan, "glm4-9b", cfg) == \
        ref_check_plan(rplan, "glm4-9b", rcfg)


def test_fused_segments_run_bit_identical_to_per_step():
    """The smoke tt_gemm plan fuses steps [2, 4) of every layer: the
    segmented layer runs its chain through the fused-segment kernel's
    wrapper (the plain version here) and matches the per-step route bit
    for bit, with one record per segment."""
    plan = load_plan(str(PLANS / "tt-lm-smoke.tt_gemm.json"))
    lp = plan.layer("attn.wq")
    assert lp.segments is not None and any(e - s >= 2 for s, e in lp.segments)
    cfg = get_config("tt-lm-100m", smoke=True)
    spec = dict((s.name, s) for s, _, _ in dse_cli._block_specs(cfg))["attn.wq"]
    rng = np.random.default_rng(0)
    cores = [torch.from_numpy(rng.normal(size=n.dims).astype(np.float32))
             for n in spec.network(2).nodes if n.kind != "input"]
    x = torch.from_numpy(rng.normal(size=(5, spec.d_in)).astype(np.float32))
    geometry = (spec.in_modes, spec.out_modes, spec.tt_ranks)
    executor.reset_execution_log()
    fused = executor.planned_tt_linear(lp, x, cores, *geometry)
    recs = [r for r in executor.execution_log() if "segment" in r]
    assert [tuple(r["segment"]) for r in recs] == list(lp.segments)
    per_step = executor.planned_tt_linear(
        dataclasses.replace(lp, segments=None), x, cores, *geometry)
    assert torch.equal(fused, per_step)


def test_execution_log_is_a_bounded_ring():
    plan = load_plan(str(PLANS / "tt-lm-smoke.json"))
    executor.reset_execution_log()
    with executor.execution_stream("decode"):
        for t in range(executor._EXEC_LOG_MAX + 5):
            executor.record_execution(plan.layers[0], t)
    log = executor.execution_log()
    assert len(log) == executor._EXEC_LOG_MAX
    assert executor.execution_log_dropped() == 5
    assert log[0]["tokens"] == 5 and log[-1]["stream"] == "decode"
    executor.reset_execution_log()
    assert executor.execution_log() == () and executor.execution_log_dropped() == 0


def test_plan_context_restores_installed_plan():
    plan = load_plan(str(PLANS / "tt-lm-smoke.json"))
    port_linear.install_plan(None)
    with port_linear.plan_context(plan, force_backend="tt_gemm"):
        assert port_linear.planned_layer("attn.wq").backend == "tt_gemm"
        with port_linear.plan_context(None):
            assert port_linear.planned_layer("attn.wq") is None
        assert port_linear.planned_layer("mlp.wd").backend == "tt_gemm"
    assert port_linear.planned_layer("attn.wq") is None


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) > 20


def _chosen_candidate_compile(port: bool, plan_path: str) -> str:
    """Re-derive ``plan_path``'s rank plan from its chosen candidate alone:
    the candidate (by its d and rank) out of the full rank space, its
    families' accuracy proxies, its layers' guided DSE leg on the fixed
    target, and the compile, as ``dse_cli._run_rank_dse`` and
    ``run_dse_plan`` do it for the winner.  Returns the plan's bytes."""
    if port:
        from repro_torch import dse_cli as cli
        from repro_torch.configs import get_config as get_cfg
        from repro_torch.core import ALL_PARTITIONINGS, build_cost_tables
        from repro_torch.hw import get_target
        from repro_torch.plan import Factorization, compile_plan, load_plan as load
        from repro_torch.rank import RankSpace, family_proxy
        from repro_torch.search import guided_search
    else:
        from repro import dse_cli as cli
        from repro.configs import get_config as get_cfg
        from repro.core import ALL_PARTITIONINGS, build_cost_tables
        from repro.hw import get_target
        from repro.plan import Factorization, compile_plan, load_plan as load
        from repro.rank import RankSpace, family_proxy
        from repro.search import guided_search
    want = load(plan_path)
    fact = next(lp.factorization for lp in want.layers if lp.factorization)
    cfg, hw = get_cfg(want.arch), get_target(want.hw)
    cand = next(c for c in RankSpace.from_config(cfg).candidates()
                if c.d == len(fact.out_modes) and c.rank == max(fact.ranks))
    named = cli.model_dse_layers(cfg, want.tokens,
                                 factorizations=cand.factorization_map())
    paths = cli.model_layer_paths(named, 4)
    res = guided_search(paths, hw, objective="latency", seed=0)
    table = build_cost_tables(paths, hw, ALL_PARTITIONINGS).seconds
    total = 0.0
    for c in res.choices:
        total += table[(c.layer, c.path_index, c.partitioning, c.dataflow)]
    facts = {f.name: Factorization(f.out_modes, f.in_modes, f.ranks,
                                   float(family_proxy(f)))
             for f in cand.families}
    return compile_plan(named, res, hw, arch=want.arch, objective="latency",
                        tokens=want.tokens, total_latency_s=total,
                        factorizations=facts).dumps()


@pytest.mark.parametrize("package", ["repro_torch", "repro"])
def test_rank_plan_is_the_chosen_candidates_compile(package):
    """``tt-lm-100m.rank.json`` (emitted on the card's host by the port and
    byte-checked there; minutes on a CPU) is, byte for byte, the compile
    of its chosen candidate's guided DSE leg, in either package."""
    path = str(PLANS / "tt-lm-100m.rank.json")
    assert _chosen_candidate_compile(package == "repro_torch", path) == \
        (PLANS / "tt-lm-100m.rank.json").read_text()
