"""The CUDA kernels of ``repro_torch`` against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The module
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)  TF32 is
off: the model is fp32 and the kernels use full fp32 FMAs.  Tolerances:
1e-5 for GEMMs and 1e-4 for TT contractions, as the CPU parity tests use;
kernel and plain version sum in another order.  Row independence and the
dataflows' agreement are exact.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dse_cli import model_dse_layers
from repro_torch.kernels import launches, ops, streaming_tt, tt_gemm
from repro_torch.plan.executor import as_candidate_path

DATAFLOWS = ("OS", "WS", "IS")
GEMM_SHAPES = [(32, 32, 32), (64, 96, 32), (128, 64, 96), (33, 47, 65), (1, 128, 128),
               (32000, 16, 37), (37, 768, 16)]
PLANS = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def streaming_cases():
    """(plan file, layer) for every distinct streaming_tt layer of the
    committed plans: each is a path geometry the CUDA kernel must run."""
    cases, seen = [], set()
    for f in sorted(PLANS.glob("*.json")):
        plan = json.loads(f.read_text())
        for lp in plan["layers"]:
            key = (plan["arch"], "smoke" in f.name, lp["name"],
                   json.dumps(lp["path_steps"]), lp["tiling"]["block_tokens"])
            if lp["backend"] == "streaming_tt" and key not in seen:
                seen.add(key)
                cases.append((f.name, lp["name"]))
    return cases


def plan_layer(plan_file: str, name: str):
    """(layer plan JSON, the model's network for that projection)."""
    smoke = "smoke" in plan_file
    lp = next(l for l in json.loads((PLANS / plan_file).read_text())["layers"]
              if l["name"] == name)
    families = dict(model_dse_layers(get_config("tt-lm-100m", smoke=smoke), tokens=8))
    tn = families.get(name) or families[f"{name}[0]"]
    return lp, tn


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_tt_gemm_cuda_matches_plain(cuda_device, dataflow):
    launches.reset()
    for m, k, n in GEMM_SHAPES:
        a = torch.from_numpy(_np((m, k), 40)).to(cuda_device)
        b = torch.from_numpy(_np((k, n), 41)).to(cuda_device)
        blocks = dict(block_m=ops.clamp_block(128, m), block_k=ops.clamp_block(16, k),
                      block_n=ops.clamp_block(128, n))
        got = tt_gemm.tt_gemm(a, b, dataflow=dataflow, **blocks)
        want = tt_gemm.tt_gemm_plain(a, b, dataflow=dataflow, **blocks)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
        # a row never depends on the other rows of the launch
        row = tt_gemm.tt_gemm(a[:1].contiguous(), b, dataflow=dataflow, **blocks)
        assert torch.equal(row[0], got[0])
    assert launches.COUNTS[f"tt_gemm_{dataflow.lower()}"] == 2 * len(GEMM_SHAPES)


@pytest.mark.cuda
def test_tt_gemm_cuda_dataflows_bit_identical(cuda_device):
    a = torch.from_numpy(_np((200, 300), 42)).to(cuda_device)
    b = torch.from_numpy(_np((300, 90), 43)).to(cuda_device)
    outs = [tt_gemm.tt_gemm(a, b, dataflow=df, block_m=bm, block_k=32, block_n=bn)
            for df in DATAFLOWS for bm, bn in ((32, 32), (128, 64))]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.cuda
def test_tt_gemm_cuda_rejects_cpu_mix_and_bad_dtype(cuda_device):
    a = torch.ones(8, 8, device=cuda_device)
    with pytest.raises(ValueError):
        tt_gemm.tt_gemm(a, torch.ones(8, 8))
    with pytest.raises(TypeError):
        tt_gemm.tt_gemm(a.double(), a.double())


@pytest.mark.cuda
@pytest.mark.parametrize("plan_file,name", streaming_cases())
def test_streaming_tt_cuda_matches_plain(cuda_device, plan_file, name):
    lp, tn = plan_layer(plan_file, name)
    launches.reset()
    for tokens in (1, 4, 37):
        bt = ops.clamp_block(lp["tiling"]["block_tokens"], tokens)
        tn_block = streaming_tt._rebatch(tn, bt)
        path = as_candidate_path(tn_block, lp["path_steps"])
        cores = [torch.from_numpy(_np(n.dims, 50 + i, 0.2)).to(cuda_device)
                 for i, n in enumerate(tn.nodes) if n.kind != "input"]
        x = torch.from_numpy(_np((tokens, int(np.prod(tn.nodes[-1].dims[1:]))),
                                 51)).to(cuda_device)
        got = streaming_tt.streaming_tt_linear(x, cores, tn_block, path,
                                               block_tokens=bt)
        want = streaming_tt.streaming_tt_linear_plain(x, cores, tn_block, path)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)
        row = streaming_tt.streaming_tt_linear(x[:1].contiguous(), cores, tn_block,
                                               path, block_tokens=bt)
        assert torch.equal(row[0], got[0])
    assert launches.COUNTS["streaming_tt"] == 6
