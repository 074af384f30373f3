"""``repro_torch.tune`` against ``repro.tune``: caches, reports, plans.

Both packages get the same injected measurements (module-level stand-ins
for the four measure functions, a fixed kernel fingerprint, the CPU as
the device: ``device_kind "cpu"``, ``interpret true`` in both), so every
number either writes is a function of the requested variant only, and
the two must agree exactly:

- byte-identical ``TuningCache.dumps()`` and measured plans, for
  tt-lm-smoke and full-width tt-lm-100m, in each ``--tune`` setting of
  :data:`SETTINGS`, with equal measurement counts;
- equal ``run_tune`` and ``--tune`` DSE reports, minus wall-clock keys and
  the cache path;
- a ``--tune cache`` replay over a warm cache measures nothing and emits
  the same bytes; each package reads the cache the other wrote;
- the oracle cases of ``tests/test_tune.py``, ``tests/test_correction.py``
  and the fused sweep of ``tests/test_fused_exec.py`` hold for the port.
"""

from __future__ import annotations

import dataclasses
import json
import math

import pytest
import torch

import repro.tune as ref_tune
import repro.tune.autotune as ref_autotune
import repro.tune.measure as ref_measure
from repro import dse_cli as ref_dse_cli
from repro.tune import cli as ref_cli
from repro_torch import dse_cli
from repro_torch.core import (FPGA_VU9P, Dataflow, find_topk_paths,
                              global_search, tt_linear_network)
from repro_torch.core.cost_table import build_cost_table_vectorized
from repro_torch.core.dse import apply_calibration, combine_phase_tables
from repro_torch.core.simulator import ALL_DATAFLOWS, ALL_PARTITIONINGS
from repro_torch.nn import LinearSpec, TTConfig
from repro_torch.plan import ExecutionPlan, compile_plan, streaming_fits
from repro_torch.plan.compiler import rebatch
from repro_torch import tune
from repro_torch.tune import (KERNEL_MODULES, Autotuner, CostCorrection,
                              TuningCache, TuningEntry, analytic_gemm_seconds,
                              entry_fingerprint, entry_shards,
                              fit_cost_correction, gemm_variants,
                              gemm_work_items, heuristic_blocks,
                              measured_calibration, merge_caches,
                              shape_bucket, streaming_variants, variant_key)
from repro_torch.tune import autotune as port_autotune
from repro_torch.tune import cli as port_cli
from repro_torch.tune import measure as port_measure
from repro_torch.tune.variants import dominant_gemm
from test_torch_dse_cli import WALL_KEYS, _main

torch.set_num_threads(2)

FP = "0123456789ab"
SMOKE = ["--arch", "tt-lm-100m", "--smoke", "--top-k", "2"]
FULL = ["--arch", "tt-lm-100m"]
#: ``--tune`` settings held byte for byte, and each one's measurements at
#: full width: (gemm, streaming, fused, per_step)
SETTINGS = {
    "infer": ([], (30, 17, 0, 0)),
    "tt_gemm": (["--plan-backend", "tt_gemm"], (75, 0, 0, 0)),
    "fused": (["--fused-cost", "--tokens", "2048"], (30, 17, 21, 4)),
    "fused_tt_gemm": (["--fused-cost", "--tokens", "2048", "--plan-backend",
                       "tt_gemm"], (75, 0, 21, 4)),
    "train": (["--mode", "train", "--tokens", "2048"], (16, 17, 0, 0)),
    "throughput": (["--objective", "throughput"], (30, 17, 0, 0)),
}
DF_WEIGHT = {"IS": 1.0, "OS": 1.5, "WS": 2.5}


# measurements that depend on the shape, the dataflow and the tiling, so
# the calibration and every sweep's argmin are exercised
def fake_gemm(M, K, N, dataflow, blocks, **kw):
    return 1e-9 * M * K * N * DF_WEIGHT[dataflow] / math.prod(blocks) ** 0.25


def fake_streaming(tn_block, steps, tokens, block_tokens, **kw):
    return 1e-6 * tokens / block_tokens ** 0.5


def fake_fused(tn, steps, segments, block_tokens, **kw):
    return 1.0 / block_tokens


def fake_per_step(tn, steps, **kw):
    return 1.0


def _raise(*a, **kw):
    raise AssertionError("measurement requested on a warm cache")


class Measured:
    """Module-level stand-ins for both packages' measure functions."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.counts = {}
        for mod in (ref_autotune, port_autotune):
            monkeypatch.setattr(mod, "kernel_fingerprint", lambda paths=None: FP)
        self.use(fake_gemm, fake_streaming, fake_fused, fake_per_step)

    def use(self, *fns):
        self.counts = {"gemm": 0, "streaming": 0, "fused": 0, "per_step": 0}

        def counted(name, fn):
            def f(*a, **kw):
                self.counts[name] += 1
                return fn(*a, **kw)
            return f

        for mod in (ref_measure, port_measure):
            for name, fn in zip(self.counts, fns):
                self.mp.setattr(mod, f"measure_{name}", counted(name, fn))

    def fail(self):
        self.use(_raise, _raise, _raise, _raise)

    def take(self) -> tuple[int, ...]:
        out = tuple(self.counts.values())
        for k in self.counts:
            self.counts[k] = 0
        return out


@pytest.fixture
def measured(monkeypatch):
    return Measured(monkeypatch)


def _strip(report, drop=WALL_KEYS + ("cache", "tune_seconds")):
    if isinstance(report, dict):
        return {k: _strip(v, drop) for k, v in report.items() if k not in drop}
    if isinstance(report, list):
        return [_strip(v, drop) for v in report]
    return report


def _dse(main, argv, tmp_path, tag, device=True):
    cache = tmp_path / f"{tag}.cache.json"
    plan = tmp_path / f"{tag}.plan.json"
    extra = ["--device", "cpu"] if device else []
    rc, out, err = _main(main, argv + ["--tune-cache", str(cache), "--emit-plan",
                                       str(plan)] + extra)
    assert rc == 0, err
    return json.loads(out), plan.read_text(), cache.read_text()


# ---------------------------------------------------------------------------
# the DSE's --tune: reports, plans and caches equal the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_dse_tune_matches_reference_and_replays(setting, size, measured,
                                                tmp_path):
    extra, counts = SETTINGS[setting]
    argv = (SMOKE if size == "smoke" else FULL) + extra + ["--tune", "measure"]
    report, plan, cache = _dse(dse_cli.main, argv, tmp_path, "mine")
    mine = measured.take()
    ref_report, ref_plan, ref_cache = _dse(ref_dse_cli.main, argv, tmp_path,
                                           "theirs", device=False)
    assert measured.take() == mine
    if size == "full":
        assert mine == counts
    assert plan == ref_plan
    assert cache == ref_cache
    assert _strip(report) == _strip(ref_report)
    assert json.loads(plan)["tilings"] == "measured"
    t = report["tune"]
    assert (t["device_kind"], t["interpret"]) == ("cpu", True)
    assert t["n_measured"] == sum(mine)

    # a --tune cache replay over the warm cache: nothing measured, same bytes
    measured.fail()
    argv[argv.index("measure")] = "cache"
    again, plan2, cache2 = _dse(dse_cli.main, argv, tmp_path, "mine")
    assert plan2 == plan and cache2 == cache
    assert again["tune"]["n_measured"] == 0 and again["tune"]["n_cache_hits"] > 0
    # and the reference replays the port's cache file the same way
    _, ref_plan2, _ = _dse(ref_dse_cli.main, argv, tmp_path, "mine",
                           device=False)
    assert ref_plan2 == plan


def test_dse_tune_throughput_is_calibrated_like_the_reference(measured,
                                                             tmp_path):
    args = dict(arch="tt-lm-100m", smoke=True, top_k=2, tokens=32,
                objective="throughput", tune="cache")
    mine = dse_cli.run_dse(**args, tune_cache=str(tmp_path / "a.json"),
                           device="cpu")
    theirs = ref_dse_cli.run_dse(**args, tune_cache=str(tmp_path / "b.json"))
    assert mine["serving"]["calibrated"] is True
    assert _strip(mine) == _strip(theirs)
    untuned = dse_cli.run_dse(arch="tt-lm-100m", smoke=True, top_k=2,
                              tokens=32, objective="throughput")
    assert untuned["serving"]["calibrated"] is False


@pytest.mark.parametrize("kw", [
    dict(tune="cache", mode="both"),
    dict(tune="measure", objective="edp"),
    dict(tune="cache", rank_search="budget"),
    dict(tune="nope"),
])
def test_run_dse_plan_refuses_what_the_reference_refuses(kw):
    args = dict(arch="tt-lm-100m", smoke=True, top_k=2, tokens=32)
    with pytest.raises((KeyError, ValueError)) as mine:
        dse_cli.run_dse_plan(**args, **kw)
    with pytest.raises((KeyError, ValueError)) as theirs:
        ref_dse_cli.run_dse_plan(**args, **kw)
    assert type(mine.value) is type(theirs.value)
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# python -m repro_torch.tune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["smoke", "full"])
def test_run_tune_matches_reference(size, measured, tmp_path):
    kw = dict(smoke=True, top_k=2, tokens=32) if size == "smoke" else {}
    mine = port_cli.run_tune("tt-lm-100m", mode="measure", device="cpu",
                             cache_path=str(tmp_path / "mine.json"), **kw)
    n_mine = measured.take()
    theirs = ref_cli.run_tune("tt-lm-100m", mode="measure",
                              cache_path=str(tmp_path / "theirs.json"), **kw)
    assert measured.take() == n_mine
    if size == "full":
        assert n_mine == (30, 17, 0, 0) and mine["n_measured"] == 47
        assert mine["n_families"] == 6
    assert _strip(mine) == _strip(theirs)
    assert (tmp_path / "mine.json").read_text() == \
        (tmp_path / "theirs.json").read_text()
    # warm cache: the port measures nothing the second time
    measured.fail()
    again = port_cli.run_tune("tt-lm-100m", mode="cache", device="cpu",
                              cache_path=str(tmp_path / "mine.json"), **kw)
    assert again["n_measured"] == 0 and again["n_cache_hits"] > 0
    assert again["calibration"] == mine["calibration"]
    assert again["families"] == mine["families"]


def test_tune_cli_main_matches_reference_and_merge(measured, tmp_path):
    """``python -m repro_torch.tune`` (``--device cpu``) and ``... merge``
    print and write what the reference's CLI does."""
    argv = ["--arch", "tt-lm-100m", "--smoke", "--top-k", "2", "--tokens",
            "32", "--max-shapes", "2"]
    rc, out, err = _main(port_cli.main, argv + ["--device", "cpu", "--cache",
                                                str(tmp_path / "a.json")])
    rrc, rout, rerr = _main(ref_cli.main, argv + ["--cache",
                                                  str(tmp_path / "b.json")])
    assert rc == rrc == 0
    assert _strip(json.loads(out)) == _strip(json.loads(rout))
    assert err.split("->")[0] == rerr.split("->")[0]
    merged = []
    for main, tag in ((port_cli.main, "m1"), (ref_cli.main, "m2")):
        rc, _, err = _main(main, ["merge", str(tmp_path / "a.json"),
                                  str(tmp_path / "b.json"), "-o",
                                  str(tmp_path / tag), "--fingerprint", FP])
        assert rc == 0, err
        merged.append((tmp_path / tag).read_text())
    assert merged[0] == merged[1]
    assert merged[0] == (tmp_path / "a.json").read_text()
    rc, _, err = _main(port_cli.main, ["merge", str(tmp_path / "nope.json"),
                                       "-o", str(tmp_path / "m3")])
    assert rc == 2 and err.startswith("error: ")


def test_each_package_reads_the_cache_the_other_wrote(measured, tmp_path):
    tn, paths = _unit_problem()[1:3]
    caches = {}
    for pkg, mod in (("port", tune), ("ref", ref_tune)):
        t = mod.Autotuner(mod.TuningCache(), "cache", device_kind="cpu",
                          interpret=True, kernel_fp=FP)
        t.tune_gemm(96, 160, 512, "OS", include=[heuristic_blocks(96, 160, 512)])
        t.tune_streaming(tn, paths[0].steps, 32, include=[32])
        path = tmp_path / f"{pkg}.json"
        t.save(str(path))
        caches[pkg] = path.read_text()
    assert caches["port"] == caches["ref"]
    assert ref_tune.TuningCache.load(str(tmp_path / "port.json")).dumps() == \
        caches["port"]
    assert TuningCache.load(str(tmp_path / "ref.json")).dumps() == caches["ref"]
    assert tune.CACHE_FORMAT == ref_tune.CACHE_FORMAT
    assert tune.CACHE_VERSION == ref_tune.CACHE_VERSION
    assert tune.DEFAULT_CACHE_PATH == ref_tune.DEFAULT_CACHE_PATH


def test_measure_seeds_and_variants_match_reference():
    """The inputs each measurement synthesizes (same seeds, same NumPy
    draws) and the variant spaces are the reference's."""
    import numpy as np

    tn, paths = _unit_problem()[1:3]
    x, cores = port_measure.synthesize_tensors(tn)
    rx, rcores = ref_measure.synthesize_tensors(tn)
    assert np.array_equal(x.numpy(), np.asarray(rx))
    assert all(np.array_equal(c.numpy(), np.asarray(r))
               for c, r in zip(cores, rcores))
    net = port_measure.synthesize_network_tensors(tn)
    rnet = ref_measure.synthesize_network_tensors(tn)
    assert all(np.array_equal(net[k].numpy(), np.asarray(rnet[k])) for k in rnet)
    assert port_measure._seed_for(3, 4) == ref_measure._seed_for(3, 4)
    assert (port_measure.WARMUP, port_measure.REPEATS) == \
        (ref_measure.WARMUP, ref_measure.REPEATS)
    for shape in ((96, 160, 512), (1, 16, 2048), (2048, 768, 16)):
        assert gemm_variants(*shape) == ref_tune.gemm_variants(*shape)
    for tokens in (32, 512):
        assert streaming_variants(rebatch(tn, tokens), paths[0].steps, tokens,
                                  include=[256]) == \
            ref_tune.streaming_variants(rebatch(tn, tokens), paths[0].steps,
                                        tokens, include=[256])
    assert tune.GEMM_BLOCK_CAPS == ref_tune.GEMM_BLOCK_CAPS
    assert tune.STREAM_BLOCK_CAPS == ref_tune.STREAM_BLOCK_CAPS
    assert tune.network_signature(tn, paths[0].steps) == \
        ref_tune.network_signature(tn, paths[0].steps)


# ---------------------------------------------------------------------------
# the oracle cases of tests/test_tune.py, on the port
# ---------------------------------------------------------------------------

def _fake_gemm(M, K, N, dataflow, blocks, **kw):
    bm, bk, bn = blocks
    return 1.0 / (bm * bk * bn)


def _fake_streaming(tn_block, steps, tokens, block_tokens, **kw):
    return 1.0 / block_tokens


def _stub_tuner(cache=None, mode="cache", device_kind="cpu", **kw):
    return Autotuner(cache, mode, device_kind=device_kind, interpret=True,
                     measure_gemm_fn=_fake_gemm,
                     measure_streaming_fn=_fake_streaming, **kw)


def _warm(cache, **kw):
    return Autotuner(cache, "cache", device_kind="cpu", interpret=True,
                     measure_gemm_fn=_raise, measure_streaming_fn=_raise, **kw)


def _unit_problem(tokens=32, d_out=256):
    tt = TTConfig(enabled=True, d=2, rank=8, min_dim=64)
    spec = LinearSpec("demo", 128, d_out, tag="mlp", tt=tt)
    tn = spec.network(tokens)
    paths = find_topk_paths(tn, k=4)
    res = global_search([paths], FPGA_VU9P)
    return spec, tn, paths, res


def test_cache_roundtrip_bit_stable(tmp_path):
    tuner = _stub_tuner()
    tuner.tune_gemm(96, 160, 512, "OS", include=[heuristic_blocks(96, 160, 512)])
    _, tn, paths, _ = _unit_problem()
    tuner.tune_streaming(tn, paths[0].steps, 32, include=[32])
    assert len(tuner.cache) == 2
    text = tuner.cache.dumps()
    assert TuningCache.loads(text).dumps() == text
    path = tmp_path / "cache.json"
    tuner.cache.save(str(path))
    assert TuningCache.load(str(path)).dumps() == text
    TuningCache.load(str(path)).save(str(path))
    assert path.read_text() == text


def test_cache_is_device_keyed():
    cache = TuningCache()
    cpu = _stub_tuner(cache, device_kind="cpu")
    best = cpu.tune_gemm(64, 64, 64, "OS")
    card = _stub_tuner(cache, device_kind="NVIDIA_H100_80GB_HBM3")
    assert card.tune_gemm(64, 64, 64, "OS") == best
    assert card.n_cache_hits == 0 and card.n_measured == cpu.n_measured > 0
    assert any(":cpu:" in k for k in cache.entries)
    assert any(":NVIDIA_H100_80GB_HBM3:" in k for k in cache.entries)


def test_kernel_fingerprint_tracks_kernel_sources(tmp_path):
    assert tune.kernel_fingerprint() == tune.kernel_fingerprint()
    assert len(tune.kernel_fingerprint()) == 12
    assert KERNEL_MODULES == tuple(m.replace("repro.", "repro_torch.")
                                   for m in ref_tune.KERNEL_MODULES)
    a, b = tmp_path / "a.py", tmp_path / "b.py"
    a.write_text("def kernel(): return 1\n")
    b.write_text("def other(): return 2\n")
    fp = tune.kernel_fingerprint([str(a), str(b)])
    assert fp == ref_tune.kernel_fingerprint([str(a), str(b)])
    assert tune.kernel_fingerprint([str(b), str(a)]) == fp
    a.write_text("def kernel(): return 9\n")
    assert tune.kernel_fingerprint([str(a), str(b)]) != fp


def test_cache_is_kernel_fingerprint_keyed():
    cache = TuningCache()
    v1 = _stub_tuner(cache, kernel_fp="aaaa00000000")
    best = v1.tune_gemm(64, 64, 64, "OS")
    warm = _warm(cache, kernel_fp="aaaa00000000")
    assert warm.tune_gemm(64, 64, 64, "OS") == best
    assert warm.n_measured == 0 and warm.n_cache_hits > 0
    v2 = _stub_tuner(cache, kernel_fp="bbbb11111111")
    assert v2.tune_gemm(64, 64, 64, "OS") == best
    assert v2.n_cache_hits == 0 and v2.n_measured > 0


def test_cache_rejects_foreign_json():
    with pytest.raises(ValueError, match="not a tuning cache"):
        TuningCache.loads('{"format": "something.else", "version": 1}')
    with pytest.raises(ValueError, match="version"):
        TuningCache.loads('{"format": "repro.tuning_cache", "version": 99}')


def test_entry_key_parsing():
    for key in ("gemm:32:32:32:OS:cpu:i1:kdeadbeef", "gemm:32:32:32:OS:cpu:i1",
                "gemm:32:kXYZ"):
        assert entry_fingerprint(key) == ref_tune.entry_fingerprint(key)
    assert entry_fingerprint("gemm:32:32:32:OS:cpu:i1:kdeadbeef") == "deadbeef"
    for key, n in (("gemm:32x32x32:OS:cpu:interp:s4:kdeadbeef", 4),
                   ("gemm:32x32x32:OS:cpu:interp:s1:kdeadbeef", 1),
                   ("gemm:32x32x32:OS:cpu:interp:kdeadbeef", None)):
        assert entry_shards(key) == ref_tune.entry_shards(key) == n


def test_merge_caches_union_shards_and_stale():
    a = _stub_tuner(TuningCache())
    a.tune_gemm(96, 160, 512, "OS", include=[heuristic_blocks(96, 160, 512)])
    b = _stub_tuner(TuningCache())
    b.tune_gemm(96, 160, 512, "OS", include=[heuristic_blocks(96, 160, 512)])
    b.tune_gemm(64, 64, 64, "IS", include=[heuristic_blocks(64, 64, 64)])
    fp = entry_fingerprint(next(iter(a.cache.entries)))
    merged, dropped, dropped_shards = merge_caches([a.cache, b.cache],
                                                   fingerprint=fp)
    assert (len(merged), dropped, dropped_shards) == (2, 0, 0)
    key = next(k for k in merged.entries if k in a.cache.entries)
    assert merged.entries[key].measured_s == b.cache.entries[key].measured_s
    assert merge_caches([merged], fingerprint=fp)[0].dumps() == merged.dumps()
    assert len(merge_caches([a.cache], fingerprint="0" * 12)[0]) == 0
    c4 = Autotuner(TuningCache(), "cache", device_kind="cpu", interpret=True,
                   measure_gemm_fn=_fake_gemm, kernel_fp=a.kernel_fp, shards=4)
    c4.tune_gemm(64, 64, 64, "OS")
    m4, d, ds = merge_caches([a.cache, c4.cache], fingerprint=fp, shards=4)
    assert (len(m4), d, ds) == (1, 0, 1)
    assert all(":s4:" in k for k in m4.entries)
    assert a.cached_gemm_blocks(64, 64, 64, "OS") is None
    rm, rd, rds = ref_tune.merge_caches(
        [ref_tune.TuningCache.loads(a.cache.dumps()),
         ref_tune.TuningCache.loads(c4.cache.dumps())], fingerprint=fp, shards=4)
    assert rm.dumps() == m4.dumps() and (rd, rds) == (d, ds)


def test_cached_tiling_lookups_never_measure():
    t = _stub_tuner(TuningCache())
    t.tune_gemm(96, 160, 512, "OS", include=[heuristic_blocks(96, 160, 512)])
    _, tn, paths, _ = _unit_problem()
    t.tune_streaming(tn, paths[0].steps, 32, include=[32])
    warm = _warm(t.cache)
    assert warm.cached_gemm_blocks(96, 160, 512, "OS") is not None
    assert warm.cached_gemm_blocks(97, 160, 512, "OS") is None
    assert warm.cached_streaming_tokens(tn, paths[0].steps, 32) == 32
    assert warm.cached_streaming_tokens(rebatch(tn, 64), paths[0].steps,
                                        64) is None


def test_entry_argmin_is_deterministic_on_ties():
    tuner = _stub_tuner()
    entry = tuner.cache.ensure(tuner.gemm_key(64, 64, 64, "OS"), kind="gemm",
                               backend="tt_gemm", device_kind="cpu",
                               interpret=True, problem={})
    entry.measured_s[variant_key((64, 64, 64))] = 1.0
    entry.measured_s[variant_key((32, 64, 64))] = 1.0
    entry.measured_s[variant_key((64, 32, 64))] = 2.0
    assert entry.best_blocks == (32, 64, 64)


def test_variants_feasible_and_work_items():
    vs = gemm_variants(96, 160, 512, include=[heuristic_blocks(96, 160, 512)])
    assert heuristic_blocks(96, 160, 512) in vs and vs == sorted(set(vs))
    for bm, bk, bn in vs:
        for b, dim in ((bm, 96), (bk, 160), (bn, 512)):
            assert b >= 8 and (b & (b - 1)) == 0
            assert b <= max(8, 1 << (dim - 1).bit_length())
    _, tn, paths, _ = _unit_problem(tokens=512)
    all_bt = streaming_variants(tn, paths[0].steps, 512, include=[256])
    assert 256 in all_bt
    assert streaming_variants(tn, paths[0].steps, 512, include=[256],
                              budget_bytes=1) == []
    assert all(streaming_fits(tn, paths[0].steps, bt) for bt in all_bt)
    items = gemm_work_items([paths, paths, paths])
    assert len(items) == len(set(items)) and items == gemm_work_items([paths])
    assert gemm_work_items([paths], max_shapes=1) == items[:1]


def test_measured_plan_validates_and_replays_from_cache():
    _, tn, _, res = _unit_problem(tokens=32)
    cache = TuningCache()
    tuner = _stub_tuner(cache)
    kw = dict(arch="unit", tokens=32, tilings="measured")
    plan = compile_plan([("demo", tn)], res, FPGA_VU9P, tuner=tuner, **kw)
    assert plan.tilings == "measured" and tuner.n_measured > 0
    text = plan.dumps()
    assert plan.to_json()["version"] == 4
    assert ExecutionPlan.loads(text).dumps() == text
    replay = _warm(cache)
    assert compile_plan([("demo", tn)], res, FPGA_VU9P, tuner=replay,
                        **kw).dumps() == text
    assert replay.n_measured == 0 and replay.n_cache_hits > 0
    stale = _stub_tuner(cache, kernel_fp="deadbeef0000")
    assert compile_plan([("demo", tn)], res, FPGA_VU9P, tuner=stale,
                        **kw).dumps() == text
    assert stale.n_cache_hits == 0 and stale.n_measured > 0
    # the reference's compiler over the same measurements: the same plan
    from repro.core import FPGA_VU9P as REF_FPGA
    from repro.core import find_topk_paths as ref_paths
    from repro.core import global_search as ref_search
    from repro.plan import compile_plan as ref_compile

    rres = ref_search([ref_paths(tn, k=4)], REF_FPGA)
    rt = ref_tune.Autotuner(ref_tune.TuningCache(), "cache", device_kind="cpu",
                            interpret=True, measure_gemm_fn=_fake_gemm,
                            measure_streaming_fn=_fake_streaming)
    assert ref_compile([("demo", tn)], rres, REF_FPGA, tuner=rt,
                       **kw).dumps() == text


def test_measured_tilings_differ_from_heuristic_on_large_shapes():
    _, tn, _, res = _unit_problem(tokens=512)
    plan_h = compile_plan([("demo", tn)], res, FPGA_VU9P, arch="unit",
                          tokens=512)
    plan_m = compile_plan([("demo", tn)], res, FPGA_VU9P, arch="unit",
                          tokens=512, tilings="measured", tuner=_stub_tuner())
    (lp_h,), (lp_m,) = plan_h.layers, plan_m.layers
    assert lp_h.backend == lp_m.backend
    if lp_m.backend == "streaming_tt":
        assert lp_m.tiling.block_tokens > lp_h.tiling.block_tokens
    else:
        assert lp_m.tiling != lp_h.tiling


def test_calibration_changes_argmin_and_measured_scales():
    _, _, paths, base = _unit_problem()
    (choice,) = base.choices
    won = choice.dataflow
    res = global_search([paths], FPGA_VU9P, calibration={won.value: 1000.0})
    assert res.choices[0].dataflow != won
    uniform = global_search([paths], FPGA_VU9P,
                            calibration={d.value: 7.5 for d in Dataflow})
    assert uniform.choices[0].dataflow == won
    assert uniform.total_latency_s == pytest.approx(7.5 * base.total_latency_s)
    scales = measured_calibration([(128, 128, 256)], _stub_tuner(), FPGA_VU9P)
    assert set(scales) == {"IS", "OS", "WS"}
    assert all(s > 0 for s in scales.values()) and len(set(scales.values())) > 1
    from repro.core import FPGA_VU9P as REF_FPGA

    rt = ref_tune.Autotuner(None, "cache", device_kind="cpu", interpret=True,
                            measure_gemm_fn=_fake_gemm)
    assert scales == ref_tune.measured_calibration([(128, 128, 256)], rt,
                                                   REF_FPGA)


def test_run_dse_tune_cache_reports_and_replays(tmp_path, monkeypatch):
    monkeypatch.setattr(port_measure, "measure_gemm", _fake_gemm)
    monkeypatch.setattr(port_measure, "measure_streaming", _fake_streaming)
    cache = str(tmp_path / "cache.json")
    kw = dict(smoke=True, top_k=2, tokens=32, tune="cache", tune_cache=cache,
              device="cpu")
    report, plan = dse_cli.run_dse_plan("tt-lm-100m", **kw)
    t = report["tune"]
    assert t["mode"] == "cache" and t["cache"] == cache
    assert set(t["calibration"]) == {"IS", "OS", "WS"} and t["n_measured"] > 0
    assert plan.tilings == "measured"
    assert sum(lp.latency_s * lp.instances for lp in plan.layers) == \
        pytest.approx(plan.total_latency_s)
    monkeypatch.setattr(port_measure, "measure_gemm", _raise)
    monkeypatch.setattr(port_measure, "measure_streaming", _raise)
    report2, plan2 = dse_cli.run_dse_plan("tt-lm-100m", **kw)
    assert report2["tune"]["n_measured"] == 0
    assert plan2.dumps() == plan.dumps()


def test_run_dse_tune_train_and_hw_search(tmp_path, monkeypatch):
    monkeypatch.setattr(port_measure, "measure_gemm", _fake_gemm)
    monkeypatch.setattr(port_measure, "measure_streaming", _fake_streaming)
    kw = dict(smoke=True, top_k=2, tokens=32, tune="cache", device="cpu")
    report, plan = dse_cli.run_dse_plan(
        "tt-lm-100m", mode="train", tune_cache=str(tmp_path / "a.json"), **kw)
    t = report["tune"]
    assert t["calibration"] is None and t["n_calibration_shapes"] == 0
    assert "analytic" in t["note"] and t["n_measured"] > 0
    assert plan.tilings == "measured" and any(lp.backward for lp in plan.layers)
    report = dse_cli.run_dse("tt-lm-100m", hw_search="budget",
                             tune_cache=str(tmp_path / "b.json"), **kw)
    assert report["hw_search"]["n_candidates"] >= 64
    assert report["tune"]["correction"]["model"] == "shape-bucket-geomean"


def test_run_tune_pipeline_with_stub_tuner(tmp_path):
    cache_path = str(tmp_path / "cache.json")
    tuner = _stub_tuner(TuningCache(), cache_path=cache_path)
    report = port_cli.run_tune("tt-lm-100m", smoke=True, top_k=2, tokens=32,
                               max_shapes=2, tuner=tuner)
    assert report["n_shapes"] == report["n_families"] == 2
    assert report["n_measured"] == tuner.n_measured > 0
    for fam in report["families"]:
        if fam.get("speedup_vs_heuristic"):
            assert fam["speedup_vs_heuristic"] >= 1.0
    assert TuningCache.load(cache_path).dumps() == tuner.cache.dumps()


# ---------------------------------------------------------------------------
# the fused sweep of tests/test_fused_exec.py:410-450, on the port
# ---------------------------------------------------------------------------

def _fused_problem():
    from repro_torch.core import fusion

    tn = tt_linear_network(64, (8, 8), (8, 8), (4, 8, 4))
    steps = tuple(tuple(s) for s in find_topk_paths(tn, k=1)[0].steps)
    segs = fusion.segment_path(tn, steps, block_tokens=64,
                               budget_bytes=8 * 2**20)
    assert fusion.has_fused(segs)
    return tn, steps, segs


def test_tune_fused_sweep_and_cache_replay():
    tn, steps, segs = _fused_problem()
    calls = []

    def fused(tn_, steps_, segs_, bt, **kw):
        calls.append(("fused", bt))
        return 1.0 / bt

    def per_step(tn_, steps_, **kw):
        calls.append(("per_step", None))
        return 1.0

    def make(mod, cache):
        return mod.Autotuner(cache, "cache", device_kind="test", interpret=True,
                             kernel_fp="deadbeef", measure_fused_fn=fused,
                             measure_per_step_fn=per_step)

    tuner = make(tune, TuningCache())
    res = tuner.tune_fused(tn, steps, segs, 64, include=(64,))
    assert res == {"block_tokens": 64, "fused_s": 1.0 / 64, "per_step_s": 1.0}
    assert tuner.n_measured == len(calls) > 0
    n_calls = len(calls)
    tuner2 = make(tune, tuner.cache)
    assert tuner2.tune_fused(tn, steps, segs, 64, include=(64,)) == res
    assert tuner2.n_measured == 0 and len(calls) == n_calls
    ref = make(ref_tune, ref_tune.TuningCache())
    assert ref.tune_fused(tn, steps, segs, 64, include=(64,)) == res
    assert ref.cache.dumps() == tuner.cache.dumps()


def test_fused_token_variants_preserve_segmentation():
    from repro_torch.core import fusion

    tn, steps, segs = _fused_problem()
    variants = tune.fused_token_variants(tn, steps, segs, 64, include=(64,))
    assert variants == ref_tune.fused_token_variants(tn, steps, segs, 64,
                                                     include=(64,))
    assert variants
    for bt in variants:
        assert fusion.segment_path(tn, steps, block_tokens=bt,
                                   budget_bytes=8 * 2**20) == segs


# ---------------------------------------------------------------------------
# the oracle cases of tests/test_correction.py, on the port
# ---------------------------------------------------------------------------

def _gemm_entry(M, K, N, dataflow, scale, device_kind="cpu", interpret=True,
                at_heuristic=True):
    blocks = heuristic_blocks(M, K, N) if at_heuristic else (1, 1, 1)
    return TuningEntry(
        key=f"gemm:{M}x{K}x{N}:{dataflow}:{device_kind}:i:ktest",
        kind="gemm", backend="tt_gemm", device_kind=device_kind,
        interpret=interpret, problem={"M": M, "K": K, "N": N,
                                      "dataflow": dataflow},
        measured_s={variant_key(blocks):
                    analytic_gemm_seconds(M, K, N, dataflow, FPGA_VU9P) * scale})


def _cache(entries):
    return TuningCache({e.key: e for e in entries})


def _ref_fit(entries, **kw):
    from repro.hw import FPGA_VU9P as REF_FPGA

    return ref_tune.fit_cost_correction(
        ref_tune.TuningCache.loads(_cache(entries).dumps()), REF_FPGA, **kw)


def test_shape_bucket_quantizes_log2_volume():
    assert shape_bucket(2, 2, 1) == 1 and shape_bucket(4, 4, 4) == 3
    assert shape_bucket(4, 2, 2) == shape_bucket(8, 2, 2)
    assert shape_bucket(256, 64, 64) == shape_bucket(64, 64, 64) + 1
    with pytest.raises(ValueError, match="positive"):
        shape_bucket(0, 4, 4)


def test_fit_recovers_known_bucket_scales():
    small = [(16, 16, 16), (32, 16, 16)]
    large = [(256, 256, 256), (512, 256, 256)]
    truth = {(shape_bucket(*small[0]), "IS"): 3.0,
             (shape_bucket(*small[0]), "OS"): 1.5,
             (shape_bucket(*large[0]), "IS"): 0.25,
             (shape_bucket(*large[0]), "OS"): 8.0}
    entries = [_gemm_entry(M, K, N, d, truth[(shape_bucket(M, K, N), d)])
               for shapes in (small, large) for (M, K, N) in shapes
               for d in ("IS", "OS")]
    model = fit_cost_correction(_cache(entries), FPGA_VU9P)
    for (b, d), s in truth.items():
        assert model.bucket_scales[(b, d)] == pytest.approx(s, rel=1e-12)
        assert model.bucket_samples[(b, d)] == 2
    assert model.scale(16, 16, 16, "IS") == pytest.approx(3.0)
    assert model.n_ratios == 8
    assert model.describe() == _ref_fit(entries).describe()


def test_fit_fallback_chain_and_filters():
    entries = [_gemm_entry(16, 16, 16, "IS", 2.0),
               _gemm_entry(32, 16, 16, "IS", 2.0),
               _gemm_entry(512, 512, 512, "IS", 32.0)]
    model = fit_cost_correction(_cache(entries), FPGA_VU9P)
    geo = math.exp((2 * math.log(2.0) + math.log(32.0)) / 3)
    assert (shape_bucket(512, 512, 512), "IS") not in model.bucket_scales
    assert model.scale(512, 512, 512, "IS") == pytest.approx(geo, rel=1e-12)
    assert model.scale(512, 512, 512, "OS") == 1.0
    assert fit_cost_correction(_cache([]), FPGA_VU9P).scale(64, 64, 64,
                                                             "IS") == 1.0
    trusting = fit_cost_correction(_cache(entries[2:]), FPGA_VU9P, min_samples=1)
    assert trusting.bucket_scales[(shape_bucket(512, 512, 512), "IS")] == \
        pytest.approx(32.0)
    keep = _gemm_entry(16, 16, 16, "IS", 2.0)
    others = [_gemm_entry(32, 16, 16, "IS", 100.0, device_kind="tpu"),
              _gemm_entry(16, 32, 16, "IS", 100.0, interpret=False),
              _gemm_entry(64, 64, 64, "IS", 100.0, at_heuristic=False)]
    kw = dict(device_kind="cpu", interpret=True)
    filtered = fit_cost_correction(_cache([keep] + others), FPGA_VU9P, **kw)
    assert filtered.n_ratios == 1
    assert filtered.dataflow_scales["IS"] == pytest.approx(2.0)
    assert filtered.describe() == _ref_fit([keep] + others, **kw).describe()
    pinned = fit_cost_correction(_cache([keep, _gemm_entry(64, 64, 64, "IS",
                                                           100.0)]),
                                 FPGA_VU9P, shapes=[(16, 16, 16)])
    assert pinned.n_ratios == 1
    json.dumps(filtered.describe())


def test_apply_calibration_with_the_fitted_model():
    layer_paths = [
        find_topk_paths(tt_linear_network(64, (2, 8), (8, 2), (4, 4, 4)), k=3),
        find_topk_paths(tt_linear_network(4, (4, 4), (4, 4), (4, 4, 4)), k=2),
    ]
    table = build_cost_table_vectorized(layer_paths, FPGA_VU9P,
                                        ALL_PARTITIONINGS)
    model = CostCorrection(bucket_scales={}, dataflow_scales={"IS": 2.0},
                           bucket_samples={})
    scaled = apply_calibration(table, model, layer_paths=layer_paths)
    for (l, p, c, d), v in table.items():
        assert scaled[(l, p, c, d)] == pytest.approx(
            (2.0 if d.value == "IS" else 1.0) * v)
    buckets = {(shape_bucket(*dominant_gemm(path)), d.value): 5.0
               for paths in layer_paths for path in paths for d in ALL_DATAFLOWS}
    scaled = apply_calibration(
        table, CostCorrection(bucket_scales=buckets, dataflow_scales={},
                              bucket_samples={}), layer_paths=layer_paths)
    assert all(scaled[k] == pytest.approx(5.0 * v) for k, v in table.items())
    with pytest.raises(ValueError, match="layer_paths"):
        apply_calibration(table, model)
    with pytest.raises(ValueError, match="positive"):
        apply_calibration(table, dataclasses.replace(
            model, dataflow_scales={"IS": -1.0}), layer_paths=layer_paths)


def test_combine_phase_tables_calibrates_each_phase_at_own_shapes():
    from types import SimpleNamespace

    key = (0, 0, (1, 1), Dataflow.OS)

    def path_with_gemm(M, K, N):
        return SimpleNamespace(gemms=(SimpleNamespace(M=M, K=K, N=N,
                                                      macs=M * K * N),))

    class ShapeScale:
        def scale(self, M, K, N, dataflow):
            return 2.0 if M >= 1024 else 5.0

    out = combine_phase_tables(
        {key: 10.0}, {key: 1.0}, w_prefill=1.0, w_decode=3.0,
        calibration=ShapeScale(),
        prefill_paths=[[path_with_gemm(1024, 64, 64)]],
        decode_paths=[[path_with_gemm(8, 64, 64)]])
    assert out[key] == pytest.approx(2.0 * 10.0 + 3.0 * 5.0 * 1.0)
