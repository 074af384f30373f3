"""The measurement harness of ``repro_torch.tune`` on the CPU, and every
kernel variant the full-width sweeps hold.

- One genuine ``measure_gemm`` / ``measure_streaming`` / ``measure_fused``
  / ``measure_per_step`` on ``device="cpu"`` (the kernels' plain versions,
  ``perf_counter``) at smoke size returns a finite positive number of
  seconds, and a tuner on the CPU writes ``device_kind "cpu"`` /
  ``interpret true`` entries.  Which variant is faster is not asserted.
- :func:`sweep_variants` records what the tune path asks to measure at
  full width (``python -m repro_torch.tune`` and six ``repro_torch.dse
  --tune`` settings, with recording stand-ins for the measure
  functions); every such variant must build its K1 program and grid, its
  K2-K4 grid and its K5 program, as on the card.
  ``tests/test_torch_cuda.py`` runs the same variants through the CUDA
  kernels.
- The cache fingerprint covers the CUDA sources, the shared header of
  K2-K5 and the build flags.

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import shutil

import pytest
import torch

from repro_torch import dse_cli
from repro_torch.core import find_topk_paths, tt_linear_network
from repro_torch.core.tensor_network import TensorNetwork
from repro_torch.kernels import _build, fused_path, ops, streaming_tt, tt_gemm
from repro_torch.plan.compiler import rebatch
from repro_torch.tune import (Autotuner, TuningCache, kernel_fingerprint,
                              kernel_source_paths)
from repro_torch.tune import autotune as tune_autotune
from repro_torch.tune import cli as tune_cli
from repro_torch.tune import measure as tune_measure

torch.set_num_threads(2)

#: ``python -m repro_torch.dse --arch tt-lm-100m`` settings of the tune path
DSE_SETTINGS = {
    "infer": [],
    "tt_gemm": ["--plan-backend", "tt_gemm"],
    "fused": ["--fused-cost", "--tokens", "2048"],
    "fused_tt_gemm": ["--fused-cost", "--tokens", "2048", "--plan-backend",
                      "tt_gemm"],
    "train": ["--mode", "train", "--tokens", "2048"],
    "throughput": ["--objective", "throughput"],
}


def _unit_network(tokens=32):
    tn = tt_linear_network(tokens, (8, 16), (16, 16), (1, 8, 1))
    return tn, find_topk_paths(tn, k=1)[0].steps


@contextlib.contextmanager
def recording(calls: dict):
    """Replace the four measure functions (and the kernel fingerprint) of
    the port with stand-ins that record each request and return a
    deterministic number of seconds."""
    def gemm(M, K, N, dataflow, blocks, **kw):
        calls["gemm"].add((M, K, N, dataflow, tuple(blocks)))
        return 1e-9 * M * K * N / math.prod(blocks) ** 0.25

    def streaming(tn_block, steps, tokens, block_tokens, **kw):
        key = (tuple((n.edges, n.dims) for n in tn_block.nodes),
               tuple(map(tuple, steps)), tokens, block_tokens)
        calls["streaming"][key] = (tn_block, steps)
        return 1e-6 * tokens / block_tokens ** 0.5

    def fused(tn, steps, segments, block_tokens, block_k=128, **kw):
        key = (tuple((n.edges, n.dims) for n in tn.nodes),
               tuple(map(tuple, steps)), tuple(map(tuple, segments)),
               block_tokens, block_k)
        calls["fused"][key] = (tn, steps, segments, block_tokens, block_k)
        return 1.0 / block_tokens

    def per_step(tn, steps, **kw):
        calls["per_step"][(tuple((n.edges, n.dims) for n in tn.nodes),
                           tuple(map(tuple, steps)))] = (tn, steps)
        return 1.0

    saved = (tune_measure.measure_gemm, tune_measure.measure_streaming,
             tune_measure.measure_fused, tune_measure.measure_per_step,
             tune_autotune.kernel_fingerprint)
    tune_measure.measure_gemm = gemm
    tune_measure.measure_streaming = streaming
    tune_measure.measure_fused = fused
    tune_measure.measure_per_step = per_step
    tune_autotune.kernel_fingerprint = lambda paths=None: "0" * 12
    try:
        yield calls
    finally:
        (tune_measure.measure_gemm, tune_measure.measure_streaming,
         tune_measure.measure_fused, tune_measure.measure_per_step,
         tune_autotune.kernel_fingerprint) = saved


@functools.lru_cache(maxsize=1)
def sweep_variants() -> dict:
    """What the full-width tune path asks to measure: ``gemm`` a set of
    (M, K, N, dataflow, blocks); ``streaming``, ``fused`` and ``per_step``
    maps of their distinct calls to the call's arguments."""
    import tempfile

    calls = {"gemm": set(), "streaming": {}, "fused": {}, "per_step": {}}
    with recording(calls), tempfile.TemporaryDirectory() as d:
        tune_cli.run_tune("tt-lm-100m", mode="measure", cache_path=f"{d}/t.json",
                          device="cpu")
        for name, extra in DSE_SETTINGS.items():
            with contextlib.redirect_stdout(io.StringIO()):
                rc = dse_cli.main(
                    ["--arch", "tt-lm-100m", "--tune", "measure", "--device",
                     "cpu", "--tune-cache", f"{d}/{name}.json", "--out",
                     "-", "--emit-plan", f"{d}/{name}.plan.json"] + extra)
            assert rc == 0
    return calls


def segment_entries(tn: TensorNetwork, steps, segments):
    """``(entries, steps)`` of each multi-step segment: the work list
    (edges, dims) at the segment's first step, as ``measure_fused`` and
    the planned executor hold it."""
    out = []
    net = tn
    for s, e in segments:
        if e - s >= 2:
            out.append((tuple((n.edges, n.dims) for n in net.nodes),
                        tuple(tuple(st) for st in steps[s:e])))
        for i, j in steps[s:e]:
            net, _ = net.contract_pair(i, j)
    return out


# ---------------------------------------------------------------------------
# the harness on the CPU
# ---------------------------------------------------------------------------

def test_measure_gemm_cpu_returns_seconds():
    for df in ("OS", "WS", "IS"):
        s = tune_measure.measure_gemm(32, 48, 16, df, (32, 32, 16),
                                      device="cpu", warmup=1, repeats=1)
        assert math.isfinite(s) and s > 0


def test_measure_streaming_cpu_returns_seconds():
    tn, steps = _unit_network(32)
    s = tune_measure.measure_streaming(rebatch(tn, 16), steps, 32, 16,
                                       device="cpu", warmup=1, repeats=1)
    assert math.isfinite(s) and s > 0


def test_measure_fused_and_per_step_cpu_return_seconds():
    from repro_torch.core import fusion

    tn, steps = _unit_network(64)
    segs = fusion.segment_path(tn, steps, block_tokens=64,
                               budget_bytes=8 * 2**20)
    assert fusion.has_fused(segs)
    s = tune_measure.measure_fused(tn, steps, segs, 64, device="cpu",
                                   warmup=1, repeats=1)
    p = tune_measure.measure_per_step(tn, steps, device="cpu", warmup=1,
                                      repeats=1)
    assert math.isfinite(s) and s > 0 and math.isfinite(p) and p > 0


def test_measure_refuses_an_interpret_flag_the_device_contradicts():
    with pytest.raises(RuntimeError, match="device decides"):
        tune_measure.measure_gemm(8, 8, 8, "OS", (8, 8, 8), device="cpu",
                                  interpret=False)
    assert tune_measure.device_kind("cpu") == "cpu"
    assert tune_measure.default_interpret("cpu") is True
    assert tune_measure.default_interpret("cuda") is False


def test_cpu_tuner_writes_cpu_interpret_entries():
    tn, steps = _unit_network(32)
    tuner = Autotuner(TuningCache(), "cache", device="cpu", warmup=1, repeats=1)
    assert (tuner.device_kind, tuner.interpret) == ("cpu", True)
    tuner.tune_gemm(32, 48, 16, "IS")
    assert tuner.tune_streaming(tn, steps, 32, include=[32]) is not None
    assert tuner.n_measured == sum(len(e.measured_s)
                                   for e in tuner.cache.entries.values())
    for e in tuner.cache.entries.values():
        assert e.device_kind == "cpu" and e.interpret is True
        assert all(math.isfinite(s) and s > 0 for s in e.measured_s.values())
        assert e.key.endswith(f":cpu:interp:s1:k{tuner.kernel_fp}")
    json.loads(tuner.cache.dumps())


def test_no_card_refuses_cuda_and_names_the_cpu_option(monkeypatch, capsys):
    """Without a card the tuner, ``python -m repro_torch.tune`` and
    ``repro_torch.dse --tune`` refuse ``cuda`` (exit 2) and name
    ``--device cpu``; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="--device cpu"):
        Autotuner(TuningCache(), "cache")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_measure.measure_gemm(8, 8, 8, "OS", (8, 8, 8))
    assert tune_cli.main(["--arch", "tt-lm-100m", "--smoke"]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert dse_cli.main(["--arch", "tt-lm-100m", "--smoke", "--tune",
                         "cache"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and "--device cpu" in err


def test_tune_cli_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.tune --device cpu`` at smoke size, two
    shapes: the report and the cache name the CPU; a second call over the
    warm cache measures nothing."""
    cache = tmp_path / "c.json"
    argv = ["--arch", "tt-lm-100m", "--smoke", "--top-k", "2", "--tokens",
            "32", "--max-shapes", "2", "--device", "cpu", "--warmup", "1",
            "--repeats", "1", "--cache", str(cache)]
    assert tune_cli.main(argv) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["device_kind"] == "cpu" and report["interpret"] is True
    assert report["n_measured"] > 0 and report["n_families"] == 2
    assert tune_cli.main(argv) == 0
    again = json.loads(capsys.readouterr().out)
    assert again["n_measured"] == 0 and again["n_cache_hits"] > 0
    assert TuningCache.load(str(cache)).dumps() == cache.read_text()


# ---------------------------------------------------------------------------
# the fingerprint
# ---------------------------------------------------------------------------

def test_kernel_fingerprint_covers_cuda_sources_headers_and_flags(tmp_path):
    """The fingerprint hashes the wrappers, every ``csrc/*.cu`` and
    ``*.cuh`` and ``_build.py``: a copy of that set hashes alike, and an
    edit of the copy of ``gemm_tile.cuh`` (the tile loop of K2-K5, in no
    ``.cu`` file) changes it."""
    paths = kernel_source_paths()
    names = {p.rsplit("/", 1)[1] for p in paths}
    assert {"gemm_tile.cuh", "tt_gemm.cu", "streaming_tt.cu", "fused_path.cu",
            "_build.py", "ops.py", "tt_gemm.py", "streaming_tt.py",
            "fused_path.py"} <= names
    assert {p.name for p in _build.CSRC.iterdir()} <= names
    root = _build.CSRC.parent
    copies = []
    for p in paths:
        rel = p[len(str(root)) + 1:]
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(p, dst)
        copies.append(str(dst))
    assert kernel_fingerprint(copies) == kernel_fingerprint() == \
        kernel_fingerprint(paths)
    header = tmp_path / "csrc" / "gemm_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert kernel_fingerprint(copies) != kernel_fingerprint()


# ---------------------------------------------------------------------------
# every variant of the full-width sweeps builds
# ---------------------------------------------------------------------------

def test_full_width_sweeps_hold_the_reference_counts():
    """The distinct variants the port sweeps at full width over
    ``python -m repro_torch.tune`` and the six DSE settings (K1 at 1024 and
    2048 tokens; ``tests/test_torch_tune.py`` holds each setting's
    measurements equal to the reference's, call for call)."""
    v = sweep_variants()
    assert len(v["gemm"]) == 195
    assert len(v["streaming"]) == 34
    assert len(v["fused"]) == 21
    assert len(v["per_step"]) == 4


@pytest.mark.parametrize("dataflow", ["OS", "WS", "IS"])
def test_every_swept_gemm_variant_builds_its_grid(dataflow):
    grids = {"OS": tt_gemm.os_grid, "WS": tt_gemm.ws_grid, "IS": tt_gemm.is_grid}
    n = 0
    for M, K, N, df, (bm, bk, bn) in sorted(sweep_variants()["gemm"]):
        if df != dataflow:
            continue
        g = grids[df](M, K, N, block_m=bm, block_k=bk, block_n=bn, n_sm=132)
        assert g.smem_bytes <= tt_gemm.SMEM_LIMIT_BYTES
        n += 1
    assert n > 0


def test_every_swept_streaming_variant_builds_its_program_and_grid():
    for (tn_block, steps) in sweep_variants()["streaming"].values():
        prog = streaming_tt.compile_program(tn_block, steps)
        for t in (1, 4, tn_block.nodes[0].dims[0], 2048):
            grid = streaming_tt.launch_grid(prog, t)
            assert grid.smem_bytes <= streaming_tt.SMEM_LIMIT_BYTES


def test_every_swept_fused_variant_builds_its_program():
    """K5's program (token block chosen as on the card, 132 SMs) for every
    multi-step segment of every fused variant, and the per-step route's
    K2 grids."""
    n = 0
    for tn, steps, segments, bt, block_k in sweep_variants()["fused"].values():
        for entries, seg in segment_entries(tn, steps, segments):
            prog = fused_path._compiled(entries, seg, block_k, bt, 132,
                                        fused_path.BATCH_EDGE)
            assert prog.smem_bytes <= fused_path.SMEM_LIMIT_BYTES
            n += 1
    assert n >= len(sweep_variants()["fused"])
    for tn, steps in sweep_variants()["per_step"].values():
        for g in tn.gemm_sequence(tuple(tuple(s) for s in steps)):
            tt_gemm.os_grid(g.M, g.K, g.N, block_m=ops.clamp_block(128, g.M),
                            block_k=ops.clamp_block(128, g.K),
                            block_n=ops.clamp_block(128, g.N), n_sm=132)
