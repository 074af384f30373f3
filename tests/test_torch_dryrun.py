"""The dry run (``repro_torch.launch.dryrun``) against the reference's
``repro.launch.dryrun``, on the CPU, at exact equality: the depth variants
of every arch x shape, the extrapolation (on the reference test's values
and on seeded random ones), the skipped cells, the names, shapes and
dtypes of the parameters at FULL width (``meta`` tensors against
``jax.eval_shape``; nothing is drawn), and the CLI's result file.

What the ``meta`` trace counts is held in ``test_torch_dryrun_depth.py``
and ``test_torch_dryrun_counts.py``.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (its 512 forced host
devices); the import below puts the variable back as it was.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import SHAPES as REF_SHAPES  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.models import shape_applicable as ref_shape_applicable  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import LAYER_STACKS  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import SHAPES, api, shape_applicable  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


# ---------------------------------------------------------------------------
# the reference's framework-neutral parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cost_variants_match_the_reference(arch, shape):
    port = dryrun._cost_variants(get_config(arch), SHAPES[shape])
    ref = ref_dryrun._cost_variants(ref_get_config(arch), REF_SHAPES[shape])
    assert [(label, w) for label, _, w in port] == [(label, w) for label, _, w in ref]
    for (_, pcfg, _), (_, rcfg, _) in zip(port, ref):
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)


def test_extrapolation_on_the_reference_tests_values():
    """``tests/test_dryrun.py::test_extrapolation_linear_families``."""
    cases = [("glm4-9b", {"l1": 10.0, "l2": 13.0}, 7 + 40 * 3),
             ("zamba2-1.2b", {"m1": 8.0, "m2": 9.0, "g1": 7 + 6 * 1 + 2},
              7 + 38 + 6 * 2),
             ("seamless-m4t-medium", {"e1d1": 6.0, "e2d1": 8.0, "e1d2": 9.0},
              1 + 12 * 2 + 12 * 3)]
    for arch, vals, want in cases:
        got = dryrun.extrapolate(get_config(arch), vals)
        assert got == ref_dryrun.extrapolate(ref_get_config(arch), vals)
        assert abs(got - want) < 1e-9


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_extrapolation_on_random_values(arch):
    rng = np.random.default_rng(sum(map(ord, arch)))
    labels = [label for label, _, _ in
              dryrun._cost_variants(get_config(arch), SHAPES["train_4k"])]
    for _ in range(20):
        vals = {label: float(v) for label, v in
                zip(labels, rng.uniform(0, 1e15, len(labels)))}
        assert dryrun.extrapolate(get_config(arch), vals) == \
            ref_dryrun.extrapolate(ref_get_config(arch), vals)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skipped_cells_match_the_reference(arch, tmp_path):
    for shape in SHAPES:
        ok = shape_applicable(get_config(arch), SHAPES[shape])
        assert ok == ref_shape_applicable(ref_get_config(arch), REF_SHAPES[shape])
        if ok[0]:
            continue
        port = dryrun.run_cell(arch, shape, out_dir=str(tmp_path / "port"))
        ref = ref_dryrun.run_cell(arch, shape, out_dir=str(tmp_path / "ref"))
        assert port == ref
        assert port["status"] == "skipped"
        with open(tmp_path / "port" / f"{port['cell']}.json") as f:
            assert json.load(f) == port


def _port_leaves(params: dict) -> dict:
    """name -> (shape, dtype) in the reference's layout: the layer lists
    stacked on a leading axis."""
    out = {}

    def walk(tree, name, stack=None):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{name}/{k}" if name else k, stack)
        else:
            shape = tuple(tree.shape) if stack is None else (stack,) + tuple(tree.shape)
            out[name] = (shape, str(tree.dtype).removeprefix("torch."))

    for k, v in params.items():
        if k in LAYER_STACKS:
            shapes = [_port_leaves(layer) for layer in v]
            assert all(s == shapes[0] for s in shapes)
            walk(v[0], k, len(v))
        else:
            walk(v, k)
    return out


def _ref_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) for p in path): (tuple(a.shape), str(a.dtype))
            for path, a in flat}


@pytest.mark.parametrize("arch", ARCH_IDS + ("tt-lm-100m",))
def test_full_width_meta_params_match_eval_shape(arch):
    params = api(get_config(arch), device="meta").init_params(0)
    assert all(p.device.type == "meta" for p in leaves(params))
    ref = jax.eval_shape(ref_api(ref_get_config(arch)).init_params,
                         jax.random.PRNGKey(0))
    assert _port_leaves(params) == _ref_leaves(ref)



def test_cli_writes_the_reference_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "8")
    dryrun.main(["--arch", "rwkv6-7b", "--shape", "decode_32k", "--smoke",
                 "--test-mesh", "--force", "--out-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip()
    assert "rwkv6-7b_decode_32k_testpod_tt" in line and " ok " in line
    with open(tmp_path / "rwkv6-7b_decode_32k_testpod_tt.json") as f:
        out = json.load(f)
    assert out["status"] == "ok"
    assert out["mesh"] == {"data": 4, "model": 2} and out["n_devices"] == 8
    # the reference's keys, with trace_s where it has compile_s
    assert set(out) == {"cell", "arch", "shape", "multi_pod", "tt", "step",
                        "mesh", "n_devices", "sp_enabled", "trace_s", "memory",
                        "scanned_cost", "scanned_collectives", "cost",
                        "status"}
    assert set(out["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "peak_bytes"}
    assert set(out["scanned_collectives"]) == set(ref_dryrun._COLLECTIVES) | {"total"}
    assert set(out["cost"]) == {"flops_per_device", "bytes_per_device",
                                "collective_bytes_per_device"}
    # the full-depth count, not a depth extrapolation
    assert out["cost"]["flops_per_device"] == out["scanned_cost"]["flops"] > 0
    assert out["cost"]["bytes_per_device"] == out["scanned_cost"]["bytes"] > 0
    assert out["cost"]["collective_bytes_per_device"] == \
        out["scanned_collectives"]["total"]
