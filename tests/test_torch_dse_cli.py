"""``python -m repro_torch.dse`` against ``python -m repro.dse``.

The port's CLI (``repro_torch/dse_cli.py``) keeps the reference's parser,
defaults, report keys and exit codes.  Reports compare equal once their
wall-clock keys are dropped; emitted plans hold no wall times and compare
byte for byte, with the committed files (which ``tests/test_torch_plan.py``
holds equal to fresh reference emissions) and with the reference's own
emission.  ``--tune cache|measure`` runs (measurements stubbed in both
packages, ``--device cpu``; ``tests/test_torch_tune.py`` holds the tuner
itself); ``--shards N`` reports and plans (per-rank problems) equal the
reference's, and ``--rank-search`` with ``--shards`` is refused as there.  The plan-install API of ``nn/linear.py`` follows
``tests/test_plan.py:266-283`` and ``tests/test_nn.py:66-77``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import dse_cli as ref_dse_cli
from repro.core import FPGA_VU9P as REF_FPGA
from repro.core import find_topk_paths as ref_find_topk_paths
from repro.core import global_search as ref_global_search
from repro.nn import linear as ref_linear
from repro.plan import ExecutionPlan as RefExecutionPlan
from repro.plan import compile_plan as ref_compile_plan
from repro_torch import dse_cli
from repro_torch.core import FPGA_VU9P, find_topk_paths, global_search
from repro_torch.nn import linear as port_linear
from repro_torch.plan import (ExecutionPlan, compile_plan, execution_log,
                              reset_execution_log)
from test_torch_plan import EMIT, EMITTED_HERE, PLANS, ROOT, one_blas_thread  # noqa: F401

torch.set_num_threads(2)

#: report keys that hold wall-clock seconds
WALL_KEYS = ("timings", "build_s", "measure_s", "path_search_s")

SMOKE = ["--arch", "tt-lm-100m", "--smoke", "--top-k", "2", "--tokens", "64"]
REPORT_ARGV = {
    "infer": SMOKE,
    "train": SMOKE + ["--mode", "train"],
    "both": SMOKE + ["--mode", "both"],
    "fused-cost": SMOKE + ["--fused-cost"],
    "fused-cost-edp": SMOKE + ["--fused-cost", "--objective", "edp"],
    "hw-search": SMOKE + ["--hw-search", "budget"],
    "hw-search-train": SMOKE + ["--hw-search", "budget", "--mode", "train"],
    "edp": SMOKE + ["--objective", "edp"],
    "throughput": SMOKE + ["--objective", "throughput", "--serve-gen", "32"],
    "scalar": SMOKE + ["--engine", "scalar"],
    "tpu": SMOKE + ["--hw", "tpu_v5e"],
    "guided": SMOKE + ["--search", "guided"],
    "guided-seed-budget": SMOKE + ["--search", "guided", "--search-seed", "5",
                                   "--search-budget", "4000"],
    "guided-train": SMOKE + ["--search", "guided", "--mode", "train"],
    "guided-both": SMOKE + ["--search", "guided", "--mode", "both"],
    "guided-hw-search": SMOKE + ["--search", "guided", "--hw-search", "budget"],
    "guided-hw-search-train": SMOKE + ["--search", "guided", "--hw-search",
                                       "budget", "--mode", "train"],
    **{f"{arch} {hw}": ["--arch", arch, "--hw", hw, "--top-k", "2"]
       for arch in dse_cli.VISION_ARCHS for hw in ("fpga_vu9p", "tpu_v5e")},
}


def _strip(report):
    if isinstance(report, dict):
        return {k: _strip(v) for k, v in report.items() if k not in WALL_KEYS}
    if isinstance(report, list):
        return [_strip(v) for v in report]
    return report


def _main(main, argv):
    """(exit code, stdout, stderr) of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:   # argparse errors
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


# ---------------------------------------------------------------------------
# reports and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(REPORT_ARGV))
def test_report_matches_reference(case):
    argv = REPORT_ARGV[case]
    rc, out, err = _main(dse_cli.main, argv)
    rrc, rout, rerr = _main(ref_dse_cli.main, argv)
    assert rc == rrc == 0, err + rerr
    assert _strip(json.loads(out)) == _strip(json.loads(rout))


@pytest.mark.parametrize("name", EMITTED_HERE)
def test_emitted_plan_equals_committed_file(name, tmp_path):
    out = tmp_path / "plan"
    if ".pair." in name:
        argv = EMIT[name] + ["--emit-plan-pair", str(out)]
        emitted = tmp_path / ("plan." + name.split(".pair.")[1])
    else:
        argv = EMIT[name] + ["--emit-plan", str(out)]
        emitted = out
    rc, _, err = _main(dse_cli.main, argv + ["--out", os.devnull])
    assert rc == 0, err
    assert emitted.read_text() == (PLANS / name).read_text()


@pytest.mark.parametrize("extra", [
    ["--fused-cost"],
    ["--hw-search", "budget"],
    ["--mode", "both", "--plan-backend", "tt_gemm"],
    ["--phase", "decode", "--plan-backend", "streaming_tt"],
    ["--objective", "throughput", "--hw", "tpu_v5e"],
    ["--search", "guided", "--hw-search", "budget"],
    ["--search", "guided", "--mode", "train", "--plan-backend", "tt_gemm"],
])
def test_emitted_plan_equals_reference_emission(extra, tmp_path):
    argv = SMOKE + extra
    for main, name in ((dse_cli.main, "mine"), (ref_dse_cli.main, "theirs")):
        rc, _, err = _main(main, argv + ["--emit-plan", str(tmp_path / name),
                                         "--out", os.devnull])
        assert rc == 0, err
    assert (tmp_path / "mine").read_text() == (tmp_path / "theirs").read_text()


def test_chip_smoke_emits_the_committed_plans_with_these_arguments():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.EMIT == EMIT


@pytest.mark.parametrize("argv", [
    ["--list-archs"],
    ["--list-hw"],
    [],
    ["--arch", "nope"],
    SMOKE + ["--objective", "edp", "--engine", "scalar"],
    SMOKE + ["--mode", "train", "--objective", "edp"],
    SMOKE + ["--mode", "train", "--engine", "scalar"],
    SMOKE + ["--fused-cost", "--mode", "train"],
    SMOKE + ["--plan-backend", "tt_gemm"],
    SMOKE + ["--hw-budget", "64"],
    ["--arch", "resnet18/cifar10", "--objective", "throughput"],
    SMOKE + ["--search-budget", "100"],
    SMOKE + ["--search", "guided", "--objective", "edp"],
    SMOKE + ["--search", "guided", "--engine", "scalar"],
    SMOKE + ["--search", "guided", "--search-budget", "10"],
    SMOKE + ["--search", "guided", "--fused-cost"],
    SMOKE + ["--accuracy-budget", "0.5"],
    SMOKE + ["--rank-search", "budget", "--emit-plan-pair", os.devnull],
    SMOKE + ["--rank-search", "budget", "--mode", "train"],
    SMOKE + ["--rank-search", "budget", "--mode", "both"],
    SMOKE + ["--rank-search", "budget", "--objective", "edp"],
    SMOKE + ["--rank-search", "budget", "--engine", "scalar"],
    SMOKE + ["--rank-search", "budget", "--fused-cost"],
    SMOKE + ["--rank-search", "budget", "--accuracy-budget", "-1"],
    SMOKE + ["--rank-search", "budget", "--shards", "4"],
    SMOKE + ["--shards", "0"],
])
def test_listings_and_errors_match_reference(argv):
    """Listings print what the reference prints; refused combinations exit
    2 with the reference's message (its last line: argparse wraps the usage
    lines above it by the program's name)."""
    rc, out, err = _main(dse_cli.main, argv)
    rrc, rout, rerr = _main(ref_dse_cli.main, argv)
    assert rc == rrc
    if rc == 0:
        assert out == rout
    else:
        last = err.strip().splitlines()[-1].replace("repro_torch", "repro")
        assert last == rerr.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", [
    ["--shards", "2"],
    ["--shards", "4"],
    ["--shards", "4", "--mode", "train"],
    ["--shards", "2", "--objective", "throughput", "--serve-gen", "32"],
])
def test_sharded_report_matches_reference(argv):
    """``--shards N`` searches the per-rank problems: the report (its
    ``sharding`` section included) equals the reference's."""
    rc, out, err = _main(dse_cli.main, SMOKE + argv)
    rrc, rout, rerr = _main(ref_dse_cli.main, SMOKE + argv)
    assert rc == rrc == 0, err + rerr
    report = json.loads(out)
    assert _strip(report) == _strip(json.loads(rout))
    n = int(argv[1])
    assert report["sharding"]["n_shards"] == n
    assert report["sharding"]["global_tokens"] == 64


@pytest.mark.parametrize("argv,outputs", [
    (["--emit-plan-pair", "{out}", "--shards", "1"], [".prefill.json", ".decode.json"]),
    (["--emit-plan-pair", "{out}", "--shards", "2", "--serve-slots", "4"],
     [".prefill.json", ".decode.json"]),
    (["--emit-plan", "{out}", "--shards", "4", "--plan-backend", "tt_gemm"], [""]),
])
def test_sharded_plans_match_reference_byte_for_byte(argv, outputs, tmp_path):
    for main, tag in ((dse_cli.main, "port"), (ref_dse_cli.main, "ref")):
        rc, _, err = _main(main, SMOKE + [a.format(out=tmp_path / tag) for a in argv]
                           + ["--out", os.devnull])
        assert rc == 0, err
    for suffix in outputs:
        got = (tmp_path / f"port{suffix}").read_text()
        assert got == (tmp_path / f"ref{suffix}").read_text()
        shards = int(argv[argv.index("--shards") + 1])
        sharding = json.loads(got)["sharding"]
        assert (sharding is None) == (shards == 1)


@pytest.mark.parametrize("tune", ["cache", "measure"])
def test_tune_options_run_and_match_reference(tune, tmp_path, monkeypatch):
    """``--tune cache|measure`` run in both packages over the same stubbed
    measurements (the port with ``--device cpu``): reports equal minus
    wall-clock keys and the cache path, plans and caches byte for byte."""
    import repro.tune.autotune as ref_autotune
    import repro.tune.measure as ref_measure
    from repro_torch.tune import autotune as port_autotune
    from repro_torch.tune import measure as port_measure

    def gemm(M, K, N, dataflow, blocks, **kw):
        return 1e-9 * M * K * N / (blocks[0] * blocks[1] * blocks[2]) ** 0.5

    def streaming(tn_block, steps, tokens, block_tokens, **kw):
        return 1e-6 * tokens / block_tokens

    for mod in (ref_measure, port_measure):
        monkeypatch.setattr(mod, "measure_gemm", gemm)
        monkeypatch.setattr(mod, "measure_streaming", streaming)
    for mod in (ref_autotune, port_autotune):
        monkeypatch.setattr(mod, "kernel_fingerprint", lambda paths=None: "f" * 12)
    outs = []
    for main, tag, extra in ((dse_cli.main, "mine", ["--device", "cpu"]),
                             (ref_dse_cli.main, "theirs", [])):
        rc, out, err = _main(main, SMOKE + [
            "--tune", tune, "--tune-cache", str(tmp_path / f"{tag}.cache"),
            "--emit-plan", str(tmp_path / f"{tag}.plan")] + extra)
        assert rc == 0, err
        report = json.loads(out)
        assert report["tune"]["mode"] == tune and report["tune"]["n_measured"] > 0
        report["tune"].pop("cache")
        outs.append(_strip(report))
    assert outs[0] == outs[1]
    for suffix in ("cache", "plan"):
        assert (tmp_path / f"mine.{suffix}").read_text() == \
            (tmp_path / f"theirs.{suffix}").read_text()


@pytest.mark.parametrize("kw", [dict(search="nope"), dict(rank_search="nope"),
                                dict(tune="nope"), dict(search_budget=8),
                                dict(tune="cache", mode="both"),
                                dict(tune="cache", objective="edp"),
                                dict(tune="cache", rank_search="budget"),
                                dict(accuracy_budget=0.1),
                                dict(rank_search="budget", mode="train"),
                                dict(rank_search="budget", mode="both"),
                                dict(rank_search="budget", objective="edp"),
                                dict(rank_search="budget", engine="scalar"),
                                dict(search="guided", objective="throughput")])
def test_run_dse_refuses_what_the_reference_refuses(kw):
    """Library callers: unknown modes raise ``KeyError`` and combinations
    the searches cannot honour ``ValueError``, with the reference's
    messages."""
    args = dict(arch="tt-lm-100m", smoke=True, top_k=2, tokens=64)
    with pytest.raises((KeyError, ValueError)) as mine:
        dse_cli.run_dse(**args, **kw)
    with pytest.raises((KeyError, ValueError)) as theirs:
        ref_dse_cli.run_dse(**args, **kw)
    assert type(mine.value) is type(theirs.value)
    assert str(mine.value) == str(theirs.value)


def test_python_m_repro_torch_dse_runs_without_jax(tmp_path):
    """``python -m repro_torch.dse`` in a fresh process, once as is and once
    with ``jax`` and ``repro`` made unimportable: the emitted plan is the
    committed one."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.dse"] + SMOKE,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["arch"] == "tt-lm-100m"
    plan = tmp_path / "plan.json"
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.argv = ['repro_torch.dse'] + {EMIT['tt-lm-smoke.json']!r} + "
        f"['--emit-plan', {str(plan)!r}, '--out', {os.devnull!r}]\n"
        "runpy.run_module('repro_torch.dse', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert plan.read_text() == (PLANS / "tt-lm-smoke.json").read_text()


# ---------------------------------------------------------------------------
# the compiler, directly
# ---------------------------------------------------------------------------

def _unit_problem(port: bool, tokens=32):
    """``tests/test_plan.py::_unit_problem`` in either package."""
    lin = port_linear if port else ref_linear
    tt = lin.TTConfig(enabled=True, d=2, rank=8, min_dim=64)
    spec = lin.LinearSpec("demo", 128, 256, tag="mlp", tt=tt)
    tn = spec.network(tokens)
    if port:
        res = global_search([find_topk_paths(tn, k=4)], FPGA_VU9P)
        plan = compile_plan([("demo", tn)], res, FPGA_VU9P, arch="unit",
                            tokens=tokens)
    else:
        res = ref_global_search([ref_find_topk_paths(tn, k=4)], REF_FPGA)
        plan = ref_compile_plan([("demo", tn)], res, REF_FPGA, arch="unit",
                                tokens=tokens)
    return spec, tn, res, plan


@pytest.mark.parametrize("tokens", [1, 32, 4096])
@pytest.mark.parametrize("backend", ["auto", "jnp", "tt_gemm", "streaming_tt"])
def test_compile_plan_matches_reference(backend, tokens):
    mine, theirs = (_unit_problem(port, tokens) for port in (True, False))
    kw = dict(arch="unit", tokens=tokens, backend=backend, phase="prefill")
    got = compile_plan([("demo", mine[1])], mine[2], FPGA_VU9P, **kw)
    want = ref_compile_plan([("demo", theirs[1])], theirs[2], REF_FPGA, **kw)
    assert got.dumps() == want.dumps()
    assert mine[3].dumps() == theirs[3].dumps()


# ---------------------------------------------------------------------------
# the plan-install API (tests/test_plan.py:266-283, tests/test_nn.py:66-77)
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_plans():
    port_linear.install_plan(None)
    ref_linear.install_plan(None)
    yield
    port_linear.install_plan(None)
    ref_linear.install_plan(None)


def _params(spec, ref_spec, seed):
    """The reference's ``linear_init`` drawn once, as numpy, for both."""
    ref = ref_linear.linear_init(jax.random.PRNGKey(seed), ref_spec)
    return ({k: torch.from_numpy(np.array(v)) for k, v in ref.items()}, ref)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_explicit_path_index_overrides_plan(clean_plans):
    spec, _, _, plan = _unit_problem(True)
    ref_spec = _unit_problem(False)[0]
    params, ref_params = _params(spec, ref_spec, 0)
    x = _x((32, spec.d_in), 3)
    port_linear.install_plan(plan.with_backend("streaming_tt"))
    reset_execution_log()
    y = port_linear.linear_apply(spec, params, torch.from_numpy(x), path_index=0)
    assert execution_log() == ()      # an explicit index bypasses the plan
    want = ref_linear.linear_apply(ref_spec, ref_params, x, path_index=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_legacy_dict_install(clean_plans):
    spec, ref_spec = _unit_problem(True)[0], _unit_problem(False)[0]
    port_linear.install_plan({"demo": 1})
    ref_linear.install_plan({"demo": 1})
    assert port_linear.planned_path_index("demo") == 1
    assert port_linear.planned_path_index("other") == 0
    lp = port_linear.planned_layer("demo")
    assert lp is not None and lp.backend == "jnp" and lp.path_steps == ()
    assert lp.to_json() == ref_linear.planned_layer("demo").to_json()
    params, ref_params = _params(spec, ref_spec, 0)
    x = torch.from_numpy(_x((16, spec.d_in), 4))
    y = port_linear.linear_apply(spec, params, x)
    assert torch.equal(y, port_linear.linear_apply(spec, params, x, path_index=1))
    want = ref_linear.linear_apply(ref_spec, ref_params, x.numpy())
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="legacy"):
        port_linear.install_plan({"demo": 1}, force_backend="tt_gemm")


def test_tt_linear_all_paths_equivalent(clean_plans):
    spec = port_linear.LinearSpec("l2", 16, 16, False, "mlp", port_linear.TTConfig(
        enabled=True, d=2, rank=64, min_dim=8))
    ref_spec = ref_linear.LinearSpec("l2", 16, 16, False, "mlp", ref_linear.TTConfig(
        enabled=True, d=2, rank=64, min_dim=8))
    params, ref_params = _params(spec, ref_spec, 0)
    x = _x((4, 16), 5)
    outs = [port_linear.linear_apply(spec, params, torch.from_numpy(x),
                                     path_index=i).numpy() for i in range(3)]
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o, outs[0], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o, np.asarray(ref_linear.linear_apply(
            ref_spec, ref_params, x, path_index=i)), rtol=1e-5, atol=1e-5)


def test_installed_factorizations_and_linear_flops(clean_plans):
    plan = json.loads((PLANS / "tt-lm-smoke.json").read_text())
    lp = plan["layers"][0]
    lp["factorization"] = {"out_modes": [4, 32], "in_modes": [8, 16],
                           "ranks": [8, 8, 8], "accuracy_proxy": 0.25}
    plan["version"] = 4
    text = json.dumps(plan)
    port_linear.install_plan(ExecutionPlan.loads(text))
    ref_linear.install_plan(RefExecutionPlan.loads(text))
    assert port_linear.installed_factorizations() == \
        ref_linear.installed_factorizations() == {
            lp["name"]: ((4, 32), (8, 16), (8, 8, 8))}
    for tt in (False, True):
        cfg = dict(enabled=tt, d=2, rank=16, min_dim=8)
        spec = port_linear.LinearSpec("f", 64, 96, False, "mlp",
                                      port_linear.TTConfig(**cfg))
        ref_spec = ref_linear.LinearSpec("f", 64, 96, False, "mlp",
                                         ref_linear.TTConfig(**cfg))
        for tokens in (1, 37):
            for idx in (0, 1, 9):
                assert port_linear.linear_flops(spec, tokens, idx) == \
                    ref_linear.linear_flops(ref_spec, tokens, idx)
