"""The roofline (``repro_torch.launch.roofline``) against the reference's
``repro.launch.roofline``, on the CPU.

The analytic parameter counts and model FLOPs of every arch x shape equal
the reference's exactly.  ``analyze_cell`` and ``markdown_table`` on the
same result dicts, with the port's three peaks set to the reference's,
give the reference's rows and table text; with the port's own peaks (one
H100) every time is its count over that peak.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import roofline
from repro_torch.models import SHAPES

#: the reference's peaks (``src/repro/launch/roofline.py:34-36``)
REF_PEAKS = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9, "LINK_BW": 50e9}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_match_the_reference(arch):
    assert roofline.arch_param_counts(arch) == ref_roofline.arch_param_counts(arch)
    for shape in SHAPES:
        assert roofline.model_flops(arch, shape) == ref_roofline.model_flops(arch, shape)


def _results(seed: int) -> list[dict]:
    """One result dict per arch x shape in the dry run's layout, from
    seeded random figures, plus the cells ``analyze_cell`` passes over."""
    rng = np.random.default_rng(seed)
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            f, b, c = rng.uniform(1e9, 1e17, 3)
            out.append({
                "cell": f"{arch}_{shape}_pod_tt", "arch": arch, "shape": shape,
                "status": "ok", "n_devices": int(rng.choice([8, 256, 512])),
                "cost": {"flops_per_device": float(f), "bytes_per_device": float(b),
                         "collective_bytes_per_device":
                             float(c) if rng.random() < 0.7 else 0.0}})
    out.append({"cell": "x_long_500k_pod_tt", "arch": ARCH_IDS[1],
                "shape": "long_500k", "status": "skipped", "reason": "r"})
    out.append({"cell": "y", "arch": ARCH_IDS[0], "shape": "train_4k",
                "status": "ok", "n_devices": 8})          # --no-cost
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_and_table_match_the_reference_at_its_peaks(seed, monkeypatch):
    for name, value in REF_PEAKS.items():
        monkeypatch.setattr(roofline, name, value)
        assert getattr(ref_roofline, name) == value
    results = _results(seed)
    port = [roofline.analyze_cell(r) for r in results]
    ref = [ref_roofline.analyze_cell(r) for r in results]
    assert port == ref
    assert port[-2:] == [None, None]
    rows = [r for r in port if r]
    assert roofline.markdown_table(rows) == ref_roofline.markdown_table(rows)


def test_h100_peaks():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    for r in _results(3)[:-2]:
        row = roofline.analyze_cell(r)
        cost = r["cost"]
        assert row["compute_s"] == cost["flops_per_device"] / 989e12
        assert row["memory_s"] == cost["bytes_per_device"] / 3.35e12
        assert row["collective_s"] == cost["collective_bytes_per_device"] / 450e9
        assert row["compute_s"] * roofline.PEAK_FLOPS == \
            pytest.approx(cost["flops_per_device"], rel=1e-15)
        assert row["memory_s"] * roofline.HBM_BW == \
            pytest.approx(cost["bytes_per_device"], rel=1e-15)
        assert row["collective_s"] * roofline.LINK_BW == \
            pytest.approx(cost["collective_bytes_per_device"], rel=1e-15)
        assert row["roofline_s"] == max(row["compute_s"], row["memory_s"],
                                        row["collective_s"])


def test_cli_reads_the_dry_runs_files(tmp_path, capsys):
    results = _results(4)
    for r in results:
        with open(tmp_path / f"{r['cell']}.json", "w") as f:
            json.dump(r, f)
    out = tmp_path / "rows.json"
    roofline.main(["--results", str(tmp_path), "--pattern", "*_pod_tt.json",
                   "--json-out", str(out)])
    rows = [roofline.analyze_cell(r) for r in results if r["cell"].endswith("_pod_tt")]
    rows = [r for r in rows if r]
    assert capsys.readouterr().out.strip() == roofline.markdown_table(rows)
    with open(out) as f:
        assert sorted(json.load(f), key=lambda r: r["cell"]) == \
            sorted(rows, key=lambda r: r["cell"])
