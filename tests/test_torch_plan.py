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
from repro_torch.configs import NOT_PORTED, get_config
from repro_torch.core import find_topk_paths
from repro_torch.hw import HW_TARGETS
from repro_torch.nn import linear as port_linear
from repro_torch.plan import ExecutionPlan, load_plan, migrate_plan_json
from repro_torch.plan import executor
from repro_torch.plan.compiler import check_plan_for_config

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLANS = ROOT / "src" / "repro_torch" / "plans"

#: committed plan -> the DSE arguments that emit it
EMIT = {
    "tt-lm-100m.json": ["--arch", "tt-lm-100m"],
    "tt-lm-100m.pair.prefill.json": ["--arch", "tt-lm-100m", "--serve-slots", "4"],
    "tt-lm-100m.pair.decode.json": ["--arch", "tt-lm-100m", "--serve-slots", "4"],
    "tt-lm-smoke.json": ["--arch", "tt-lm-100m", "--smoke"],
    "tt-lm-smoke.tt_gemm.json": ["--arch", "tt-lm-100m", "--smoke",
                                 "--plan-backend", "tt_gemm"],
}
PLAN_FILES = sorted(EMIT)


def test_committed_plans_are_the_listed_ones():
    assert sorted(p.name for p in PLANS.glob("*.json")) == PLAN_FILES


@pytest.mark.parametrize("name", PLAN_FILES)
def test_committed_plan_roundtrips_byte_identical(name):
    text = (PLANS / name).read_text()
    assert load_plan(str(PLANS / name)).dumps() == text
    assert ExecutionPlan.loads(text).dumps() == ref_load_plan(str(PLANS / name)).dumps()


@pytest.mark.parametrize("name", PLAN_FILES)
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
    for arch in NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)


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
    committed plan against both configs, under each serving phase."""
    cfg, rcfg = (get_config("tt-lm-100m", smoke=smoke),
                 ref_get_config("tt-lm-100m", smoke=smoke))
    plan, rplan = load_plan(str(PLANS / name)), ref_load_plan(str(PLANS / name))
    for phase in (None, "prefill", "decode"):
        mine = check_plan_for_config(plan, "tt-lm-100m", cfg, phase=phase)
        theirs = ref_check_plan(rplan, "tt-lm-100m", rcfg, phase=phase)
        assert mine == theirs
        if ("smoke" in name) == smoke and phase is None:
            assert mine == []
    assert check_plan_for_config(plan, "glm4-9b", cfg) == \
        ref_check_plan(rplan, "glm4-9b", rcfg)


def test_fused_segments_refuse_to_run():
    """The smoke tt_gemm plan fuses steps [2, 4) of every layer; the fused
    kernel is not ported, so the executor raises instead of running the
    steps one by one."""
    plan = load_plan(str(PLANS / "tt-lm-smoke.tt_gemm.json"))
    lp = plan.layer("attn.wq")
    assert lp.segments is not None and any(e - s >= 2 for s, e in lp.segments)
    cfg = get_config("tt-lm-100m", smoke=True)
    spec = dict((s.name, s) for s, _, _ in dse_cli._block_specs(cfg))["attn.wq"]
    cores = [torch.ones(n.dims) for n in spec.network(2).nodes if n.kind != "input"]
    with pytest.raises(NotImplementedError, match="fused_path"):
        executor.planned_tt_linear(lp, torch.ones(2, spec.d_in), cores,
                                   spec.in_modes, spec.out_modes, spec.tt_ranks)


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
