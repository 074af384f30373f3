"""The CUDA kernels of ``repro_torch`` against their plain versions, on the card.

K1 (``streaming_tt``), K2-K4 (``tt_gemm``) and K5 (``fused_path``), their
gradients, and one planned projection's backward pass on the card against
the CPU.  K5 must equal the per-step CUDA ``tt_gemm`` route bit for bit.

Every test here needs a CUDA device and skips without one.  The module
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)  TF32 is
off: the model is fp32 and the kernels use full fp32 FMAs.  Tolerances:
1e-5 for GEMMs and 1e-4 for TT contractions, as the CPU parity tests use;
kernel and plain version sum in another order; bf16 operands at 8e-2, the
reference's bf16 tolerance (``tests/test_kernels.py:47``).  Row
independence and the dataflows' agreement are exact, in bf16 too.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import dse_cli
from repro_torch.configs import get_config
from repro_torch.core import find_topk_paths, fusion, tt_linear_network
from repro_torch.core.backward import grad_input_network
from repro_torch.dse_cli import model_dse_layers
from repro_torch.kernels import fused_path, launches, ops, streaming_tt, tt_gemm
from repro_torch.plan import LayerPlan, Tiling, load_plan
from repro_torch.plan.executor import as_candidate_path, planned_tt_linear
from test_torch_rank_kernels import CANDIDATES, _families

DATAFLOWS = ("OS", "WS", "IS")
GEMM_SHAPES = [(32, 32, 32), (64, 96, 32), (128, 64, 96), (33, 47, 65), (1, 128, 128),
               (32000, 16, 37), (37, 768, 16)]
PLANS = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"
SEGMENTED = ("tt-lm-smoke.tt_gemm.json", "tt-lm-smoke.train.tt_gemm.json",
             "tt-lm-100m.train.tt_gemm.json")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def streaming_cases(pattern: str = "tt-lm-*.json"):
    """(plan file, layer) for every distinct streaming_tt layer of the
    committed plans matching ``pattern`` (the tt-lm plans by default; the
    family pairs' layers have their own tests): each is a path geometry
    the CUDA kernel must run."""
    cases, seen = [], set()
    for f in sorted(PLANS.glob(pattern)):
        plan = json.loads(f.read_text())
        for lp in plan["layers"]:
            key = (plan["arch"], "smoke" in f.name, lp["name"],
                   json.dumps(lp["path_steps"]), lp["tiling"]["block_tokens"],
                   json.dumps(lp.get("factorization")))
            if lp["backend"] == "streaming_tt" and key not in seen:
                seen.add(key)
                cases.append((f.name, lp["name"]))
    return cases


def plan_layer(plan_file: str, name: str):
    """(layer plan JSON, the network of that projection in the plan's arch,
    under the plan's searched factorizations where it has them)."""
    smoke = "smoke" in plan_file
    plan = json.loads((PLANS / plan_file).read_text())
    layers = plan["layers"]
    lp = next(l for l in layers if l["name"] == name)
    facts = {l["name"]: (tuple(l["factorization"]["out_modes"]),
                         tuple(l["factorization"]["in_modes"]),
                         tuple(l["factorization"]["ranks"]))
             for l in layers if l.get("factorization")}
    families = dict(model_dse_layers(get_config(plan["arch"], smoke=smoke), tokens=8,
                                     factorizations=facts or None))
    tn = families.get(name) or families[f"{name}[0]"]
    return lp, tn


#: the committed train plans whose dx networks stream through K1
STREAMING_TRAIN_PLANS = ("tt-lm-100m.train.json", "tt-lm-smoke.train.json")


def dx_cases():
    """(plan file, layer) for every layer of :data:`STREAMING_TRAIN_PLANS`
    whose dx network streams through K1."""
    return [(f, lp["name"]) for f in STREAMING_TRAIN_PLANS
            for lp in json.loads((PLANS / f).read_text())["layers"]
            if any(op["wrt"] == "dx" and op["backend"] == "streaming_tt"
                   for op in lp["backward"])]


def dx_network(plan_file: str, name: str, tokens: int):
    """(the layer's grad-input network at ``tokens``, its planned path), as
    ``ops.tt_linear_backward`` streams dY through K1."""
    lp, tn = plan_layer(plan_file, name)
    op = next(op for op in lp["backward"] if op["wrt"] == "dx")
    net = grad_input_network(streaming_tt._rebatch(tn, tokens))
    return net, streaming_tt._path_for(net, op["path_steps"])


#: a 3-mode network whose top paths include every step shape the compiler
#: handles: X read through strides or gathered once per tile, Q = 1,
#: intermediates permuted on write
SMALL_TT = ((2, 4, 4), (4, 4, 2), (4,) * 5)


def small_tt_paths():
    tn = tt_linear_network(8, *SMALL_TT)
    return tn, find_topk_paths(tn, k=400)


def wide_free_case():
    """A network and path whose free-phase operands (a 64 x 16 x 64 core)
    do not fit shared memory: the free phase runs in one block through the
    workspace."""
    tn = tt_linear_network(8, (16, 16), (16, 16), (64, 64, 64))
    return tn, as_candidate_path(tn, ((3, 4), (2, 3), (0, 1), (0, 1)))


def k1_inputs(tn, tokens: int, device, seed: int, scale: float = 0.2):
    """(x, cores) for a K1 call over ``tn`` at ``tokens``, from ``seed``;
    the cores scaled by ``scale``."""
    cores = [torch.from_numpy(_np(n.dims, seed + i, scale)).to(device)
             for i, n in enumerate(tn.nodes) if n.kind != "input"]
    n_in = int(np.prod(streaming_tt._stream_node(tn).dims[1:]))
    return torch.from_numpy(_np((tokens, n_in), seed + 99)).to(device), cores


def _replay(work, i, j, contract=None):
    """One execute_path step over a work list of (edges, value) entries;
    ``contract=None`` tracks shapes only (values are shape tuples)."""
    (ea, ta), (eb, tb) = work[i], work[j]
    shared = [x for x in ea if x in eb]
    ec = tuple(x for x in ea if x not in shared) + tuple(x for x in eb if x not in shared)
    if contract is None:
        val = tuple(d for x, d in zip(ea, ta) if x not in shared) + tuple(
            d for x, d in zip(eb, tb) if x not in shared)
    else:
        val = contract(ta, tb, ([ea.index(x) for x in shared],
                                [eb.index(x) for x in shared]))
    return [w for k, w in enumerate(work) if k not in (i, j)] + [(ec, val)]


def _chain_case(tokens: int, mid_as_a: bool):
    """A two-step chain on a small TT layer: X @ (G3 G4) then the other
    core merge, with the interior result as operand B (the plans' order)
    or, with the last pair swapped, as operand A."""
    from repro_torch.core import tt_linear_network

    in_modes, out_modes, ranks = (4, 6), (8, 4), (3, 5, 2)
    tn = tt_linear_network(tokens, in_modes, out_modes, ranks)
    # G1 G2 -> (i1 i2 r2), G3 G4 -> (r2 j1 j2); then X with the input half
    steps = [(0, 1), (0, 1), (0, 2), (0, 1)]
    work = [(n.edges, torch.from_numpy(_np(n.dims, 10 + k, 0.5)))
            for k, n in enumerate(tn.nodes)]
    for (i, j) in steps[:2]:
        work = _replay(work, i, j, lambda a, b, ax: torch.tensordot(a, b, dims=ax))
    chain = [(0, 2), (1, 0) if mid_as_a else (0, 1)]
    return work, chain


def segment_cases(max_tokens=None):
    """(plan file, layer, tokens) for every fused segment of the committed
    plans, at a ragged token count and at the plan's own; with
    ``max_tokens``, a plan whose token count exceeds it keeps the ragged
    count only (full width at 2048 tokens runs on the card)."""
    cases = []
    for name in SEGMENTED:
        d = json.loads((PLANS / name).read_text())
        counts = (37,) if d["tokens"] > (max_tokens or d["tokens"]) else (37, d["tokens"])
        for lp in d["layers"]:
            if lp["name"] != "head" and lp.get("segments"):
                cases.extend((name, lp["name"], tokens) for tokens in counts)
    return cases


def _segment(plan_file: str, name: str, tokens: int):
    """(work-list entries as (edges, dims), chain steps, layer plan JSON)
    at the opening of the layer's fused segment."""
    lp = next(l for l in json.loads((PLANS / plan_file).read_text())["layers"]
              if l["name"] == name)
    smoke = "smoke" in plan_file
    tn = dict((n.split("[")[0], t) for n, t in model_dse_layers(
        get_config("tt-lm-100m", smoke=smoke), tokens=tokens))[name]
    steps = [tuple(s) for s in lp["path_steps"]]
    (s, e) = next(tuple(g) for g in lp["segments"] if g[1] - g[0] >= 2)
    work = [(n.edges, n.dims) for n in tn.nodes]
    for (i, j) in steps[:s]:
        work = _replay(work, i, j)
    return work, steps[s:e], lp


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


#: the train plans' weight-gradient shapes with their blocks, the serve
#: shapes 37 and 1 x 2048 x 16, and a ragged case
WS_CASES = [((2048, 2048, 16), (128, 128, 16)), ((768, 2048, 16), (128, 128, 16)),
            ((2048, 768, 16), (128, 128, 16)), ((2048, 768, 16), (128, 16, 16)),
            ((37, 2048, 16), (128, 128, 16)), ((1, 2048, 16), (128, 128, 16)),
            ((200, 300, 90), (32, 32, 32))]


def _ws_case(shape, blocks, device, seed):
    (m, k, n), (bm, bk, bn) = shape, blocks
    a = torch.from_numpy(_np((m, k), seed)).to(device)
    b = torch.from_numpy(_np((k, n), seed + 1)).to(device)
    return a, b, dict(block_m=ops.clamp_block(bm, m), block_k=ops.clamp_block(bk, k),
                      block_n=ops.clamp_block(bn, n))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,blocks", WS_CASES)
def test_tt_gemm_cuda_ws_equals_os_and_is(cuda_device, shape, blocks):
    """The split WS grid against the unsplit OS and IS kernels, bit for bit,
    and against the plain version at 1e-5 of the output's scale (K runs to
    2048 here, so outputs near 0 carry the rounding of terms of size ~50)."""
    a, b, blk = _ws_case(shape, blocks, cuda_device, 44)
    ws = tt_gemm.tt_gemm(a, b, dataflow="WS", **blk)
    for df in ("OS", "IS"):
        assert torch.equal(ws, tt_gemm.tt_gemm(a, b, dataflow=df, **blk)), df
    want = tt_gemm.tt_gemm_plain(a, b, dataflow="WS", **blk)
    scale = max(1.0, want.abs().max().item())
    np.testing.assert_allclose(ws.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * scale)
    row = tt_gemm.tt_gemm(a[-1:].contiguous(), b, dataflow="WS", **blk)
    assert torch.equal(row[0], ws[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,blocks", WS_CASES)
def test_tt_gemm_cuda_ws_does_not_depend_on_the_grid(cuda_device, shape, blocks):
    """The same call over grids for other SM counts and over hand-made
    m-range / k-group splits (the private launch helper's test-only grid
    argument) gives the same bits."""
    a, b, blk = _ws_case(shape, blocks, cuda_device, 46)
    (m, k, n) = shape
    grids = [tt_gemm.ws_grid(m, k, n, n_sm=sm, **blk) for sm in (1, 7, 132, 1000)]
    g = grids[2]
    grids += [dataclasses.replace(g, mtiles_per_range=mr, kblocks_per_group=kg)
              for mr, kg in ((1, 1), (3, 5), (2, g.n_kblocks))]
    grids.append(dataclasses.replace(g, rows_per_thread=1, row_groups=5))
    launches.reset()
    outs = [tt_gemm._ws_gemm(a, b, grid) for grid in grids]
    assert launches.COUNTS["tt_gemm_ws"] == len(grids)
    for grid, o in zip(grids[1:], outs[1:]):
        assert torch.equal(o, outs[0]), grid


#: every OS and IS GEMM of a decode step under tt-lm-100m.pair.decode.json
#: at 4 lanes, (M, K, N) with the plan's blocks clamped as the executor
#: clamps them (tests/test_torch_kernels.py re-derives the list)
DECODE_CASES = [((128, 8, 8), (32, 8, 8)), ((12, 12, 128), (16, 16, 16)),
                ((48, 64, 16), (32, 64, 16)), ((16, 192, 4), (16, 64, 8)),
                ((128, 16, 4), (32, 16, 8)), ((96, 16, 32), (32, 16, 16)),
                ((256, 8, 8), (64, 8, 8)), ((64, 128, 16), (64, 128, 16)),
                ((16, 256, 4), (16, 128, 8)), ((128, 16, 4), (64, 16, 8)),
                ((96, 16, 32), (64, 16, 16)), ((8, 8, 384), (8, 8, 128)),
                ((16, 64, 48), (16, 16, 64)), ((16, 192, 4), (16, 16, 8)),
                ((16, 16, 256), (16, 16, 128)), ((32, 16, 256), (32, 16, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,blocks", DECODE_CASES)
def test_tt_gemm_cuda_decode_shapes_dataflows_bit_identical(cuda_device, shape,
                                                            blocks):
    """OS == WS == IS bit for bit at every decode shape, each within 1e-5
    of the output's scale of the plain version, row 0 as a one-row call."""
    a, b, blk = _ws_case(shape, blocks, cuda_device, 50)
    want = tt_gemm.tt_gemm_plain(a, b, **blk)
    scale = max(1.0, want.abs().max().item())
    outs = {df: tt_gemm.tt_gemm(a, b, dataflow=df, **blk) for df in DATAFLOWS}
    for df, got in outs.items():
        assert torch.equal(got, outs["WS"]), df
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5 * scale)
        row = tt_gemm.tt_gemm(a[:1].contiguous(), b, dataflow=df, **blk)
        assert torch.equal(row[0], got[0]), df


def _band_grids(dataflow, shape, blk):
    """The OS or IS grid of a call for other SM counts and hand-made ones:
    fewer rows a thread, the two-stage ring and one pass, and for IS every
    n-tile in one group and the band staged per k-block; those that fit
    shared memory."""
    (m, k, n) = shape
    make = tt_gemm.os_grid if dataflow == "OS" else tt_gemm.is_grid
    grids = [make(m, k, n, n_sm=sm, **blk) for sm in (1, 7, 132, 1000)]
    g = dataclasses.replace(grids[2], one_pass=False)
    grids += [g, dataclasses.replace(g, rows_per_thread=1,
                                     row_groups=min(5, 256 // -(-g.tile_n // 4)))]
    if g.a_whole or g.ntiles_per_group == 1:
        grids.append(dataclasses.replace(g, one_pass=True))
    if dataflow == "IS":
        grids += [dataclasses.replace(g, ntiles_per_group=g.n_ntiles),
                  dataclasses.replace(g, ntiles_per_group=g.n_ntiles, a_whole=True,
                                      one_pass=True),
                  dataclasses.replace(g, a_whole=not g.a_whole),
                  dataclasses.replace(g, a_whole=False, ntiles_per_group=g.n_ntiles)]
    return [gr for gr in grids if gr.smem_bytes <= tt_gemm.SMEM_LIMIT_BYTES]


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", ["OS", "IS"])
@pytest.mark.parametrize("shape,blocks", DECODE_CASES + WS_CASES)
def test_tt_gemm_cuda_os_is_do_not_depend_on_the_grid(cuda_device, dataflow, shape,
                                                      blocks):
    """The same call over grids for other SM counts and over hand-made
    tiles, rings, n-groups and A stagings (the private launch helper's
    test-only grid argument) gives WS's bits."""
    a, b, blk = _ws_case(shape, blocks, cuda_device, 52)
    ws = tt_gemm.tt_gemm(a, b, dataflow="WS", **blk)
    grids = _band_grids(dataflow, shape, blk)
    launches.reset()
    outs = [tt_gemm._band_gemm(a, b, grid) for grid in grids]
    assert launches.COUNTS[f"tt_gemm_{dataflow.lower()}"] == len(grids)
    for grid, o in zip(grids, outs):
        assert torch.equal(o, ws), grid


#: IS calls with several n-tiles (hand-made narrow n-tiles where N is
#: narrow), so one block's group can fold through C
IS_ROUTE_CASES = [((32, 16, 256), (32, 16, 128), 32), ((8, 8, 384), (8, 8, 128), 128),
                  ((16, 64, 48), (16, 16, 64), 8), ((16, 192, 4), (16, 16, 8), 1),
                  ((37, 2048, 16), (128, 128, 16), 4), ((200, 300, 90), (32, 32, 32), 12),
                  ((33, 47, 65), (7, 5, 3), 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,blocks,tile_n", IS_ROUTE_CASES)
def test_tt_gemm_cuda_is_c_route_equals_register_fold(cuda_device, shape, blocks,
                                                      tile_n):
    """IS with the band staged per k-block and every n-tile in one group
    folds its partials through C; with the band whole it folds in
    registers.  Both give the same bits, and WS's."""
    a, b, blk = _ws_case(shape, blocks, cuda_device, 54)
    (m, k, n) = shape
    g = tt_gemm.is_grid(m, k, n, **blk)
    g = dataclasses.replace(g, tile_n=tile_n,
                            row_groups=min(g.row_groups, 256 // -(-tile_n // 4)))
    via_c = dataclasses.replace(g, a_whole=False, ntiles_per_group=g.n_ntiles,
                                one_pass=False)
    in_regs = dataclasses.replace(g, a_whole=True, ntiles_per_group=g.n_ntiles,
                                  one_pass=False)
    assert g.n_ntiles > 1
    assert all(step[3] for step in via_c.block_steps(0))
    assert not any(step[3] for step in in_regs.block_steps(0))
    ws = tt_gemm.tt_gemm(a, b, dataflow="WS", **blk)
    got = [tt_gemm._band_gemm(a, b, gr) for gr in (via_c, in_regs)]
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], ws)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(7, 5, 3), (1, 1, 1), (5, 13, 6)])
@pytest.mark.parametrize("shape", [(33, 47, 65), (1, 9, 2), (130, 300, 17)])
def test_tt_gemm_cuda_ws_odd_blocks_equal_os(cuda_device, shape, blocks):
    """Blocks that are no multiple of 4 (the WS kernel's scalar staging and
    padded register tiles) and shapes with K % 4 != 0: WS == OS == IS."""
    (m, k, n), (bm, bk, bn) = shape, blocks
    a = torch.from_numpy(_np((m, k), 48)).to(cuda_device)
    b = torch.from_numpy(_np((k, n), 49)).to(cuda_device)
    blk = dict(block_m=bm, block_k=bk, block_n=bn)
    ws = tt_gemm.tt_gemm(a, b, dataflow="WS", **blk)
    for df in ("OS", "IS"):
        assert torch.equal(ws, tt_gemm.tt_gemm(a, b, dataflow=df, **blk)), df


@pytest.mark.cuda
def test_tt_gemm_cuda_rejects_cpu_mix_and_bad_dtype(cuda_device):
    a = torch.ones(8, 8, device=cuda_device)
    with pytest.raises(ValueError):
        tt_gemm.tt_gemm(a, torch.ones(8, 8))
    with pytest.raises(TypeError):
        tt_gemm.tt_gemm(a.double(), a.double())


K1_TOKENS = (1, 4, 5, 32, 37, 2048)


def _k1_check(net, path, tokens, device, seed, block, scale=0.2):
    """One K1 call against its plain version; row 0 bit for bit against a
    one-row call.  Returns the output."""
    x, cores = k1_inputs(net, tokens, device, seed, scale)
    got = streaming_tt.streaming_tt_linear(x, cores, net, path, block_tokens=block)
    want = streaming_tt.streaming_tt_linear_plain(x, cores, net, path)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    row = streaming_tt.streaming_tt_linear(x[:1].contiguous(), cores, net, path,
                                           block_tokens=block)
    assert torch.equal(row[0], got[0])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("plan_file,name", streaming_cases())
def test_streaming_tt_cuda_matches_plain(cuda_device, plan_file, name):
    lp, tn = plan_layer(plan_file, name)
    launches.reset()
    for tokens in K1_TOKENS:
        bt = ops.clamp_block(lp["tiling"]["block_tokens"], tokens)
        tn_block = streaming_tt._rebatch(tn, bt)
        path = as_candidate_path(tn_block, lp["path_steps"])
        _k1_check(tn_block, path, tokens, cuda_device, 50, bt)
    assert launches.COUNTS["streaming_tt"] == 2 * len(K1_TOKENS)


@pytest.mark.cuda
@pytest.mark.parametrize("plan_file,name", dx_cases())
def test_streaming_tt_cuda_dx_matches_plain(cuda_device, plan_file, name):
    """The dx network of every streaming train layer (dY streamed over the
    grad-input network, as the backward pass runs it)."""
    net, path = dx_network(plan_file, name, 256)
    for tokens in K1_TOKENS:
        _k1_check(net, path, tokens, cuda_device, 60, 256)


@pytest.mark.cuda
def test_streaming_tt_cuda_every_small_path_matches_plain(cuda_device):
    """Every top path of a small 3-mode network: X gathered once per tile
    or read through strides, a step of one output column, chains of
    token steps."""
    tn, paths = small_tt_paths()
    relayout = 0
    for path in paths:
        relayout += streaming_tt.program_for(tn, path).relayout is not None
        for tokens in (1, 37):
            _k1_check(tn, path, tokens, cuda_device, 70, 8)
    assert relayout > 0


@pytest.mark.cuda
def test_streaming_tt_cuda_free_phase_through_the_workspace(cuda_device):
    tn, path = wide_free_case()
    assert not streaming_tt.program_for(tn, path).free_plan.in_smem
    for tokens in (1, 37):   # rank 64: smaller cores keep the output near 1
        _k1_check(tn, path, tokens, cuda_device, 75, 8, scale=0.05)


def _cases_and_dx():
    return ([("fwd", f, n) for f, n in streaming_cases()]
            + [("dx", f, n) for f, n in dx_cases()])


def _net_and_path(kind, plan_file, name):
    if kind == "dx":
        return dx_network(plan_file, name, 8)
    lp, tn = plan_layer(plan_file, name)
    return tn, as_candidate_path(tn, lp["path_steps"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,plan_file,name", _cases_and_dx())
def test_streaming_tt_cuda_rows_are_independent(cuda_device, kind, plan_file, name):
    """A row's bits depend on that row and the cores alone: the first 5
    rows of a 2048-token call equal a 5-token call, row 0 a 1-token call."""
    net, path = _net_and_path(kind, plan_file, name)
    x, cores = k1_inputs(net, 2048, cuda_device, 80)
    outs = [streaming_tt.streaming_tt_linear(x[:t].contiguous(), cores, net, path)
            for t in (2048, 5, 1)]
    assert torch.equal(outs[1], outs[0][:5])
    assert torch.equal(outs[2], outs[0][:1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,plan_file,name", _cases_and_dx())
def test_streaming_tt_cuda_does_not_depend_on_the_grid(cuda_device, kind, plan_file,
                                                       name):
    """The same call over the grids of other SM counts and over forced
    tiles, column slices, block counts and X read in place (the test-only
    ``grid`` argument) gives the same bits."""
    net, path = _net_and_path(kind, plan_file, name)
    prog = streaming_tt.program_for(net, path)
    qv = prog.tok_ops[-1].Qp // 4
    for tokens in (5, 37, 300):
        x, cores = k1_inputs(net, tokens, cuda_device, 90)
        grids = [streaming_tt.launch_grid(prog, tokens, n_sm) for n_sm in (1, 7, 132, 1000)]
        for tile, slices, blocks, xg in ((4, 1, 1, None), (4, qv, None, None),
                                         (8, 3, 2, None), (16, 2, 1, None),
                                         (16, 1, None, None), (4, 5, 3, None),
                                         (8, 2, None, True)):
            if xg and prog.relayout is not None:
                continue
            try:
                grids.append(streaming_tt.launch_grid(
                    prog, tokens, tile=tile, slices=min(slices, qv), blocks=blocks,
                    x_global=xg))
            except ValueError:   # over shared memory or more blocks than tiles
                pass
        launches.reset()
        outs = [streaming_tt.streaming_tt_linear(x, cores, net, path, grid=g)
                for g in grids]
        assert launches.COUNTS["streaming_tt"] == len(grids) >= 6
        for g, o in zip(grids[1:], outs[1:]):
            assert torch.equal(o, outs[0]), g


def _segment_tensors(entries, device, seed):
    return [(e, torch.from_numpy(_np(d, seed + k, 0.3)).to(device))
            for k, (e, d) in enumerate(entries)]


@pytest.mark.cuda
@pytest.mark.parametrize("plan_file,name,tokens", segment_cases())
def test_fused_path_cuda_matches_plain_and_per_step_route(cuda_device, plan_file,
                                                          name, tokens):
    """K5 against its plain version (1e-5), and bit for bit against the
    per-step CUDA tt_gemm route under each dataflow."""
    entries, chain, lp = _segment(plan_file, name, tokens)
    work = _segment_tensors(entries, cuda_device, 60)
    t = lp["tiling"]
    blocks = dict(block_m=t["block_m"], block_k=t["block_k"], block_n=t["block_n"])
    launches.reset()
    ec, got = fused_path.fused_segment_contract(
        work, chain, block_tokens=t["block_tokens"], **blocks)
    assert launches.COUNTS["fused_path"] == 1
    ec2, want = fused_path.fused_segment_contract_plain(work, chain, **blocks)
    torch.cuda.synchronize()
    assert ec == ec2
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    for dataflow in DATAFLOWS:
        w = list(work)
        contract = ops.gemm_contract(dataflow=dataflow, **blocks)
        for (i, j) in chain:
            w = _replay(w, i, j, contract)
        assert w[-1][0] == ec
        assert torch.equal(w[-1][1], got), dataflow


@pytest.mark.cuda
@pytest.mark.parametrize("plan_file,name,tokens", [c for c in segment_cases()
                                                   if c[2] == 37])
def test_fused_path_cuda_one_token_equals_per_step_route(cuda_device, plan_file,
                                                        name, tokens):
    """One token (a decode-sized call): bit for bit the per-step route."""
    entries, chain, lp = _segment(plan_file, name, 1)
    work = _segment_tensors(entries, cuda_device, 64)
    t = lp["tiling"]
    blocks = dict(block_m=t["block_m"], block_k=t["block_k"], block_n=t["block_n"])
    ec, got = fused_path.fused_segment_contract(
        work, chain, block_tokens=t["block_tokens"], **blocks)
    w = list(work)
    contract = ops.gemm_contract(dataflow=lp["dataflow"], **blocks)
    for (i, j) in chain:
        w = _replay(w, i, j, contract)
    assert w[-1][0] == ec and torch.equal(w[-1][1], got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["attn.wq", "mlp.wg", "mlp.wd"])
def test_fused_path_cuda_does_not_depend_on_the_token_block(cuda_device, name):
    """Full-width segments at 2048 and 37 tokens through programs of other
    token blocks (the private launch helper's test-only program
    argument): the same bits."""
    for tokens in (2048, 37):
        entries, chain, lp = _segment("tt-lm-100m.train.tt_gemm.json", name, tokens)
        work = _segment_tensors(entries, cuda_device, 66)
        bk = lp["tiling"]["block_k"]
        progs = [fused_path.compile_program(entries, chain, block_k=bk,
                                            block_tokens=bt)
                 for bt in (1, 2, 8, 16, 24, 32, 64)]
        launches.reset()
        outs = [fused_path._run(work, prog)[1] for prog in progs]
        assert launches.COUNTS["fused_path"] == len(progs)
        for prog, o in zip(progs[1:], outs[1:]):
            assert torch.equal(o, outs[0]), (tokens, prog.block_tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("mid_as_a", [False, True])
@pytest.mark.parametrize("tokens", [1, 37, 64])
@pytest.mark.parametrize("blocks", [(128, 128, 128), (32, 8, 16), (8, 16, 8)])
def test_fused_path_cuda_small_chains_equal_per_step_route(cuda_device, blocks,
                                                          tokens, mid_as_a):
    """A chain whose interior result is operand A (the last step's weight
    side is then B) as well as B, at several token blocks: bit for bit the
    per-step CUDA route."""
    work, chain = _chain_case(tokens, mid_as_a)
    work = [(e, t.to(cuda_device)) for e, t in work]
    bm, bk, bn = blocks
    w = list(work)
    contract = ops.gemm_contract(dataflow="WS", block_m=bm, block_k=bk, block_n=bn)
    for (i, j) in chain:
        w = _replay(w, i, j, contract)
    entries = [(e, tuple(t.shape)) for e, t in work]
    progs = [fused_path.compile_program(entries, chain, block_k=bk, block_tokens=bt)
             for bt in (1, 2, 8, 16, 24, 64)]
    for prog in progs:
        ec, got = fused_path._run(work, prog)
        assert ec == w[-1][0]
        assert torch.equal(got, w[-1][1]), prog.block_tokens


@pytest.mark.cuda
def test_fused_path_cuda_rows_are_independent(cuda_device):
    entries, chain, lp = _segment("tt-lm-100m.train.tt_gemm.json", "mlp.wd", 2049)
    work = _segment_tensors(entries, cuda_device, 70)
    _, full = fused_path.fused_segment_contract(work, chain, block_k=128)
    one = [(e, v[:1].contiguous() if e[0] == "b" else v) for e, v in work]
    _, row = fused_path.fused_segment_contract(one, chain, block_k=128)
    assert torch.equal(row[..., 0], full[..., 0])


@pytest.mark.cuda
def test_fused_path_cuda_refuses_a_block_k_off_4(cuda_device):
    """The kernel stages k-blocks 4-aligned; a block_k that clamps to no
    multiple of 4 raises instead of launching."""
    entries, chain, lp = _segment("tt-lm-100m.train.tt_gemm.json", "mlp.wd", 37)
    work = _segment_tensors(entries, cuda_device, 72)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_path.fused_segment_contract(work, chain, block_k=10)


#: the example at which the reference's fused == per-step property fails
#: in the last ulp (``tests/test_fused_exec.py::
#: test_fused_execution_bit_identical_property``, Pallas interpret mode):
#: in modes (8, 8), out modes (8, 8), ranks (4, 8, 4), 64 tokens, path 2 of
#: the top 4, block_tokens 64, a 64 KiB budget, OS
FUSED_EXAMPLE = dict(in_modes=(8, 8), out_modes=(8, 8), ranks=(4, 8, 4), tokens=64,
                     path_idx=2, block_tokens=64, budget_kib=64, dataflow="OS")


def fused_example(device):
    """(per-step layer plan, segmented layer plan, x, cores, (in modes, out
    modes, ranks)) of :data:`FUSED_EXAMPLE`, segmented by the port's
    ``fusion.segment_path``; the inputs drawn as the reference's property
    test draws them (``standard_normal`` from seed 0, X then the cores)."""
    e = FUSED_EXAMPLE
    tn = tt_linear_network(e["tokens"], e["in_modes"], e["out_modes"], e["ranks"])
    paths = find_topk_paths(tn, k=4)
    steps = tuple(tuple(s) for s in paths[min(e["path_idx"], len(paths) - 1)].steps)
    segs = fusion.segment_path(tn, steps, block_tokens=e["block_tokens"],
                               budget_bytes=e["budget_kib"] * 1024)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((e["tokens"], math.prod(e["in_modes"]))).astype(np.float32)
    cores = [torch.from_numpy(rng.standard_normal(n.dims).astype(np.float32)).to(device)
             for n in tn.nodes if n.kind != "input"]

    def lp(segments):
        return LayerPlan(name="l", path_index=0, path_steps=steps,
                         dataflow=e["dataflow"], partitioning=(1, 1),
                         backend="tt_gemm", tiling=Tiling(block_tokens=e["block_tokens"]),
                         segments=segments)

    return (lp(None), lp(segs), torch.from_numpy(x).to(device), cores,
            (e["in_modes"], e["out_modes"], e["ranks"]))


@pytest.mark.cuda
def test_fused_path_cuda_at_the_references_counterexample(cuda_device):
    """At :data:`FUSED_EXAMPLE` the segmented layer (K5 on its fused run,
    the per-step CUDA ``tt_gemm`` route on the rest) equals the unsegmented
    layer on the per-step CUDA route bit for bit."""
    per_step, segmented, x, cores, geometry = fused_example(cuda_device)
    assert fusion.has_fused(segmented.segments)
    plain = planned_tt_linear(per_step, x, cores, *geometry)
    launches.reset()
    seg = planned_tt_linear(segmented, x, cores, *geometry)
    torch.cuda.synchronize()
    assert launches.COUNTS["fused_path"] > 0
    assert torch.equal(plain, seg)


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_tt_gemm_vjp_cuda_matches_plain(cuda_device, dataflow):
    a, b, w = _np((64, 96), 80), _np((96, 40), 81), _np((64, 40), 82)
    blocks = dict(block_m=32, block_k=16, block_n=32)
    grads = []
    for dev in ("cpu", cuda_device):
        ta = torch.from_numpy(a).to(dev).requires_grad_(True)
        tb = torch.from_numpy(b).to(dev).requires_grad_(True)
        y = ops.gemm(ta, tb, dataflow=dataflow, differentiable=True, **blocks)
        (y * torch.from_numpy(w).to(dev)).sum().backward()
        grads.append((ta.grad.cpu(), tb.grad.cpu()))
    for got, want in zip(grads[1], grads[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("plan_file,name", streaming_cases())
def test_streaming_tt_vjp_cuda_matches_plain(cuda_device, plan_file, name):
    lp, tn = plan_layer(plan_file, name)
    tokens, bt = 37, ops.clamp_block(lp["tiling"]["block_tokens"], 37)
    tn_block = streaming_tt._rebatch(tn, bt)
    path = as_candidate_path(tn_block, lp["path_steps"])
    cores = [_np(n.dims, 90 + i, 0.2) for i, n in enumerate(tn.nodes) if n.kind != "input"]
    x = _np((tokens, int(np.prod(tn.nodes[-1].dims[1:]))), 91)
    grads = []
    for dev in ("cpu", cuda_device):
        tx = torch.from_numpy(x).to(dev).requires_grad_(True)
        tc = [torch.from_numpy(c).to(dev).requires_grad_(True) for c in cores]
        y = ops.tt_linear(tx, tc, tn_block, path, block_tokens=bt, differentiable=True)
        w = torch.from_numpy(_np(tuple(y.shape), 92)).to(dev)
        (y * w).sum().backward()
        grads.append([tx.grad.cpu()] + [c.grad.cpu() for c in tc])
    for got, want in zip(grads[1], grads[0]):
        scale = max(1.0, want.abs().max().item())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("plan_file", ["tt-lm-100m.train.json",
                                       "tt-lm-100m.train.tt_gemm.json"])
def test_planned_layer_backward_cuda_matches_cpu(cuda_device, plan_file):
    """One full-width planned projection, forward and backward, on the card
    (through K1/K5 and tt_gemm) against the same call on the CPU."""
    lp = load_plan(str(PLANS / plan_file)).layer("mlp.wd")
    spec = {s.name: s for s, _, _ in dse_cli._block_specs(get_config("tt-lm-100m"))}["mlp.wd"]
    geometry = (spec.in_modes, spec.out_modes, spec.tt_ranks)
    tokens = 67
    x = _np((tokens, spec.d_in), 100)
    cores = [_np(n.dims, 101 + k, 0.3)
             for k, n in enumerate(spec.network(tokens).nodes) if n.kind != "input"]
    w = _np((tokens, spec.d_out), 110)
    out = []
    launches.reset()
    for dev in ("cpu", cuda_device):
        tx = torch.from_numpy(x).to(dev).requires_grad_(True)
        tc = [torch.from_numpy(c).to(dev).requires_grad_(True) for c in cores]
        y = planned_tt_linear(lp, tx, tc, *geometry)
        (y * torch.from_numpy(w).to(dev)).sum().backward()
        out.append([y.detach().cpu(), tx.grad.cpu()] + [c.grad.cpu() for c in tc])
    kernels = {k for k, v in launches.COUNTS.items() if v}
    assert kernels >= ({"fused_path", "tt_gemm_ws"} if "tt_gemm" in plan_file
                       else {"streaming_tt", "tt_gemm_ws"})
    for got, want in zip(out[1], out[0]):
        scale = max(1.0, want.abs().max().item())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale)


# ---------------------------------------------------------------------------
# bf16 operands: the wrappers widen them to fp32 before the launch and cast
# the fp32 result once (the reference's bf16 tolerance, 8e-2)
# ---------------------------------------------------------------------------

BF16 = dict(rtol=8e-2, atol=8e-2)


def _bf16_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMM_SHAPES + [(64, 128, 16), (37, 2048, 16),
                                                 (32, 16, 256), (64, 256, 48),
                                                 (100, 512, 33), (16, 640, 8)])
def test_tt_gemm_cuda_bf16_matches_plain_dataflows_bit_identical(cuda_device, shape):
    m, k, n = shape
    a = torch.from_numpy(_np((m, k), 120)).to(cuda_device, torch.bfloat16)
    b = torch.from_numpy(_np((k, n), 121)).to(cuda_device, torch.bfloat16)
    blk = dict(block_m=32, block_k=32, block_n=32)
    launches.reset()
    outs = [tt_gemm.tt_gemm(a, b, dataflow=df, **blk) for df in DATAFLOWS]
    assert launches.COUNTS["tt_gemm_os"] == launches.COUNTS["tt_gemm_ws"] == \
        launches.COUNTS["tt_gemm_is"] == 1
    _bf16_close(outs[0], tt_gemm.tt_gemm_plain(a, b, **blk))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    wide = tt_gemm.tt_gemm(a, b, out_dtype=torch.float32, **blk)
    assert torch.equal(wide, tt_gemm.tt_gemm(a.float(), b.float(), **blk))


@pytest.mark.cuda
@pytest.mark.parametrize("plan_file,name", streaming_cases())
def test_streaming_tt_cuda_bf16_matches_plain(cuda_device, plan_file, name):
    lp, tn = plan_layer(plan_file, name)
    for tokens in (4, 37):
        bt = ops.clamp_block(lp["tiling"]["block_tokens"], tokens)
        net = streaming_tt._rebatch(tn, bt)
        path = as_candidate_path(net, lp["path_steps"])
        x, cores = k1_inputs(net, tokens, cuda_device, 130)
        x, cores = x.to(torch.bfloat16), [c.to(torch.bfloat16) for c in cores]
        got = streaming_tt.streaming_tt_linear(x, cores, net, path, block_tokens=bt)
        _bf16_close(got, streaming_tt.streaming_tt_linear_plain(x, cores, net, path))
        wide = streaming_tt.streaming_tt_linear(x, cores, net, path, block_tokens=bt,
                                                out_dtype=torch.float32)
        assert torch.equal(wide, streaming_tt.streaming_tt_linear(
            x.float(), [c.float() for c in cores], net, path, block_tokens=bt))


@pytest.mark.cuda
@pytest.mark.parametrize("plan_file,name,tokens", segment_cases(max_tokens=64))
def test_fused_path_cuda_bf16_matches_plain(cuda_device, plan_file, name, tokens):
    entries, chain, lp = _segment(plan_file, name, tokens)
    work = [(e, t.to(torch.bfloat16))
            for e, t in _segment_tensors(entries, cuda_device, 140)]
    t = lp["tiling"]
    blocks = dict(block_m=t["block_m"], block_k=t["block_k"], block_n=t["block_n"])
    ec, got = fused_path.fused_segment_contract(
        work, chain, block_tokens=t["block_tokens"], **blocks)
    ec2, want = fused_path.fused_segment_contract_plain(work, chain, **blocks)
    assert ec == ec2
    _bf16_close(got, want)
    wide = [(e, v.float()) for e, v in work]
    assert torch.equal(
        fused_path.fused_segment_contract(work, chain, block_tokens=t["block_tokens"],
                                          out_dtype=torch.float32, **blocks)[1],
        fused_path.fused_segment_contract(wide, chain, block_tokens=t["block_tokens"],
                                          **blocks)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_cuda_kernels_refuse_other_dtypes(cuda_device, dtype):
    a = torch.ones(8, 8, device=cuda_device, dtype=dtype)
    with pytest.raises(TypeError):
        tt_gemm.tt_gemm(a, a)
    tn = tt_linear_network(4, (4, 4), (4, 4), (4, 4, 4))
    cores = [torch.ones(n.dims, device=cuda_device, dtype=dtype)
             for n in tn.nodes if n.name != "X"]
    with pytest.raises(TypeError):
        streaming_tt.streaming_tt_linear(torch.ones(4, 16, device=cuda_device,
                                                    dtype=dtype),
                                         cores, tn, find_topk_paths(tn, k=1)[0])
    work, chain = _chain_case(8, False)
    with pytest.raises(TypeError):
        fused_path.fused_segment_contract(
            [(e, v.to(cuda_device, dtype)) for e, v in work], chain, block_k=8)


# ---------------------------------------------------------------------------
# the rank space of full-width tt-lm-100m (the searched decompositions)
# ---------------------------------------------------------------------------

#: candidate name -> {family: network at 1024 tokens} of the rank space of
#: full-width tt-lm-100m (15 candidates, 1-4 modes a side, ranks 4-24; the
#: tied head never executes and is left out), as the CPU tests walk it
RANK_SPACE = {name: _families(name) for name in CANDIDATES}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RANK_SPACE))
def test_streaming_tt_cuda_rank_space_matches_plain(cuda_device, name):
    """K1 at every candidate's layers: every top-4 path at 4 and 32
    tokens, the best at 2048, against the plain version; row 0 bit for bit
    against a one-row call."""
    launches.reset()
    n = 0
    for fam, tn in RANK_SPACE[name].items():
        net = streaming_tt._rebatch(tn, 256)
        for rank, path in enumerate(find_topk_paths(tn, k=4)):
            cp = as_candidate_path(net, path.steps)
            for tokens in ((4, 32, 2048) if rank == 0 else (4, 32)):
                _k1_check(net, cp, tokens, cuda_device, 150 + n, 256)
                n += 1
    assert launches.COUNTS["streaming_tt"] == 2 * n


def rank_gemm_shapes():
    """Every GEMM of the candidates' best paths at 4 and 37 tokens, with
    the blocks clamped as the executor clamps them."""
    shapes = set()
    for fams in RANK_SPACE.values():
        for tn in fams.values():
            path = find_topk_paths(tn, k=1)[0]
            for t in (4, 37):
                for g in streaming_tt._rebatch(tn, t).gemm_sequence(path.steps):
                    shapes.add((g.M, g.K, g.N))
    return sorted(shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", rank_gemm_shapes())
def test_tt_gemm_cuda_rank_space_matches_plain_dataflows_bit_identical(cuda_device,
                                                                     shape):
    """K2-K4 at the rank space's GEMMs (a 4-wide B and a 4-deep fold among
    them): the plain version within 1e-5, WS == OS == IS bit for bit, and
    row 0 bit for bit against a one-row call."""
    m, k, n = shape
    a = torch.from_numpy(_np((m, k), 160)).to(cuda_device)
    b = torch.from_numpy(_np((k, n), 161)).to(cuda_device)
    blk = dict(block_m=ops.clamp_block(128, m), block_k=ops.clamp_block(128, k),
               block_n=ops.clamp_block(128, n))
    outs = [tt_gemm.tt_gemm(a, b, dataflow=df, **blk) for df in DATAFLOWS]
    want = tt_gemm.tt_gemm_plain(a, b, **blk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(outs[0].cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * max(1.0, want.abs().max().item()))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    row = tt_gemm.tt_gemm(a[:1].contiguous(), b, dataflow="OS", **blk)
    assert torch.equal(row[0], outs[0][0])


@pytest.mark.cuda
def test_activation_calibration_cuda_matches_cpu(cuda_device):
    """The rank search's calibration forward (tt-lm-smoke under its rank
    plan, K1 forced on every layer) on the card against the CPU, rtol
    1e-4."""
    from repro_torch.nn import install_plan
    from repro_torch.rank import activation_calibration

    cfg = get_config("tt-lm-100m", smoke=True)
    install_plan(load_plan(str(PLANS / "tt-lm-smoke.rank.json")),
                 force_backend="streaming_tt")
    try:
        launches.reset()
        got = activation_calibration(cfg, device=cuda_device)
        assert launches.COUNTS["streaming_tt"] > 0
        want = activation_calibration(cfg, device="cpu")
    finally:
        install_plan(None)
    assert sorted(got) == sorted(want) and got
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4)


# ---------------------------------------------------------------------------
# the autotuner (repro_torch.tune) on the card
# ---------------------------------------------------------------------------

def _tune_unit_network(tokens):
    tn = tt_linear_network(tokens, (8, 16), (16, 16), (1, 8, 1))
    return tn, find_topk_paths(tn, k=1)[0].steps


@pytest.mark.cuda
def test_measure_functions_time_by_graph_replay_on_the_card(cuda_device,
                                                           monkeypatch):
    """Each measure function times CUDA-graph replays (the harness's
    ``_graph_seconds``, once per measurement) of calls that launch its
    kernel, and returns seconds."""
    import math

    from repro_torch.core import fusion
    from repro_torch.plan.compiler import rebatch
    from repro_torch.tune import measure

    graphs = []
    real = measure._graph_seconds
    monkeypatch.setattr(measure, "_graph_seconds",
                        lambda *a: graphs.append(a) or real(*a))
    tn, steps = _tune_unit_network(64)
    segs = fusion.segment_path(tn, steps, block_tokens=64,
                               budget_bytes=8 * 2**20)
    assert fusion.has_fused(segs)
    launches.reset()
    secs = [measure.measure_gemm(64, 128, 16, df, (64, 128, 16),
                                 device=cuda_device) for df in DATAFLOWS]
    secs.append(measure.measure_streaming(rebatch(tn, 16), steps, 64, 16,
                                          device=cuda_device))
    secs.append(measure.measure_fused(tn, steps, segs, 64, device=cuda_device))
    secs.append(measure.measure_per_step(tn, steps, device=cuda_device))
    assert len(graphs) == len(secs)
    assert all(math.isfinite(s) and 0 < s < 0.1 for s in secs), secs
    # every unbatched kernel (the tuner measures no experts' batched launch)
    assert all(v > 0 for k, v in launches.snapshot().items()
               if not k.endswith("_batched")), launches.snapshot()


@pytest.mark.cuda
def test_measure_capture_failure_raises(cuda_device):
    """A call the card cannot capture (a read back to the host) raises; it
    is never timed on the wall clock instead.  The card works after it."""
    from repro_torch.tune import measure

    x = torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError, match="could not be captured"):
        measure.measure_callable(lambda: x.sum().item(), device=cuda_device)
    assert measure.measure_gemm(32, 32, 32, "OS", (32, 32, 32),
                                device=cuda_device) > 0


@pytest.mark.cuda
def test_cuda_autotuner_writes_the_cards_device_kind(cuda_device):
    from repro_torch.tune import Autotuner, TuningCache

    tuner = Autotuner(TuningCache(), "cache", device=cuda_device)
    kind = torch.cuda.get_device_name(cuda_device).replace(" ", "_")
    assert (tuner.device_kind, tuner.interpret) == (kind, False)
    tn, steps = _tune_unit_network(32)
    tuner.tune_gemm(64, 128, 16, "IS")
    assert tuner.tune_streaming(tn, steps, 32, include=[32]) is not None
    assert tuner.n_measured == sum(len(e.measured_s)
                                   for e in tuner.cache.entries.values()) > 0
    for e in tuner.cache.entries.values():
        assert e.device_kind == kind and e.interpret is False
        assert f":{kind}:native:s1:" in e.key


@pytest.mark.cuda
def test_cuda_measured_plan_replays_from_a_warm_cache(cuda_device, tmp_path,
                                                      monkeypatch):
    """``repro_torch.dse --tune cache`` on the card measures and emits a
    measured plan; a second call over the warm cache, with measure
    functions that raise, emits the same bytes."""
    import os

    from repro_torch.tune import measure

    def argv(name):
        return ["--arch", "tt-lm-100m", "--smoke", "--top-k", "2", "--tokens",
                "32", "--tune", "cache", "--tune-cache",
                str(tmp_path / "cache.json"), "--emit-plan",
                str(tmp_path / name), "--out", os.devnull]

    assert dse_cli.main(argv("a.json")) == 0
    text = (tmp_path / "a.json").read_text()
    assert json.loads(text)["tilings"] == "measured"

    def fail(*a, **kw):
        raise AssertionError("measurement requested on a warm cache")

    for name in ("measure_gemm", "measure_streaming", "measure_fused",
                 "measure_per_step"):
        monkeypatch.setattr(measure, name, fail)
    assert dse_cli.main(argv("b.json")) == 0
    assert (tmp_path / "b.json").read_text() == text


def _scaled_close(got, want, tol):
    scale = max(1.0, want.abs().max().item())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=tol, atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_tt_gemm_cuda_at_every_swept_variant(cuda_device, dataflow):
    """K2-K4 at every (shape, tiling) the full-width tune sweeps measure,
    against the plain version at 1e-5 of the output's scale."""
    from test_torch_tune_kernels import sweep_variants

    n = 0
    for m, k, nn, df, (bm, bk, bn) in sorted(sweep_variants()["gemm"]):
        if df != dataflow:
            continue
        a = torch.from_numpy(_np((m, k), 170)).to(cuda_device)
        b = torch.from_numpy(_np((k, nn), 171)).to(cuda_device)
        blk = dict(block_m=bm, block_k=bk, block_n=bn)
        got = tt_gemm.tt_gemm(a, b, dataflow=df, **blk)
        _scaled_close(got, tt_gemm.tt_gemm_plain(a, b, **blk), 1e-5)
        n += 1
    assert n > 0


@pytest.mark.cuda
def test_streaming_tt_cuda_at_every_swept_variant(cuda_device):
    """K1 at every (network, tokens, block_tokens) the full-width sweeps
    measure, against the plain version (on the card) at 1e-4; the variants
    of one problem agree bit for bit (K1 builds one program whatever the
    plan's block)."""
    from repro_torch.tune.measure import synthesize_tensors
    from test_torch_tune_kernels import sweep_variants

    by_problem: dict = {}
    for key, (tn_block, steps) in sorted(sweep_variants()["streaming"].items(),
                                         key=lambda kv: repr(kv[0])):
        sig = tuple((n.name, n.edges, n.dims, n.kind)
                    for n in streaming_tt._rebatch(tn_block, 1).nodes)
        by_problem.setdefault((sig, key[1], key[2]), []).append(
            (tn_block, steps, key[3]))
    for (_, _, tokens), variants in by_problem.items():
        tn0, steps0, _ = variants[0]
        path0 = as_candidate_path(tn0, steps0)
        _, cores = synthesize_tensors(tn0, cuda_device)
        x = torch.from_numpy(_np((tokens, math.prod(
            next(n for n in tn0.nodes if n.kind == "input").dims[1:])),
            172)).to(cuda_device)
        want = streaming_tt.streaming_tt_linear_plain(x, cores, tn0, path0)
        outs = [streaming_tt.streaming_tt_linear(
                    x, cores, tn_block, as_candidate_path(tn_block, steps),
                    block_tokens=bt) for tn_block, steps, bt in variants]
        _scaled_close(outs[0], want, 1e-4)
        assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.cuda
def test_fused_path_cuda_at_every_swept_variant(cuda_device):
    """K5 at every fused variant (segments and token block) of the
    full-width ``--fused-cost`` sweeps, the segment's inputs from the
    per-step route, against the plain version (on the card) at 1e-4."""
    from repro_torch.tune.measure import synthesize_network_tensors
    from test_torch_tune_kernels import sweep_variants

    contract = ops.gemm_contract()
    n = 0
    for tn, steps, segments, bt, block_k in sweep_variants()["fused"].values():
        steps = [tuple(s) for s in steps]
        ts = synthesize_network_tensors(tn, cuda_device)
        work = [(node.edges, ts[node.name]) for node in tn.nodes]
        for s, e in segments:
            if e - s >= 2:
                ec, got = fused_path.fused_segment_contract(
                    work, steps[s:e], block_tokens=bt, block_k=block_k)
                wec, want = fused_path.fused_segment_contract_plain(
                    work, steps[s:e], block_k=block_k)
                assert ec == wec
                _scaled_close(got, want, 1e-4)
                n += 1
            for i, j in steps[s:e]:
                (ea, ta), (eb, tb) = work[i], work[j]
                shared = [x for x in ea if x in eb]
                val = contract(ta, tb, ([ea.index(x) for x in shared],
                                        [eb.index(x) for x in shared]))
                work = [w for q, w in enumerate(work) if q not in (i, j)]
                work.append((tuple(x for x in ea if x not in shared)
                             + tuple(x for x in eb if x not in shared), val))
    assert n >= len(sweep_variants()["fused"])


# ---------------------------------------------------------------------------
# the MoE, hybrid (Mamba2), RWKV6 and VLM families
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("qwen2-moe-a2.7b", "zamba2-1.2b", "rwkv6-7b", "internvl2-2b")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["streaming_tt", "tt_gemm"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_smoke_forward_cuda_matches_plain(cuda_device, arch, backend, tmp_path):
    """Each family's smoke model on the card under a plan pair forced to
    one kernel backend (emitted by the port's DSE): prefill logits (a VLM
    with its frontend prefix) and two decode steps with per-lane positions
    against the plain executor on the card, within 1e-4 of the logits'
    scale; the backend's kernels launched."""
    import contextlib
    import io
    import os

    from repro_torch.models import api
    from repro_torch.nn import install_plan, plan_context

    prefix = str(tmp_path / "pair")
    with contextlib.redirect_stdout(io.StringIO()):
        assert dse_cli.main(["--arch", arch, "--smoke", "--top-k", "2", "--tokens",
                             "16", "--serve-slots", "2", "--plan-backend", backend,
                             "--emit-plan-pair", prefix, "--out", os.devnull]) == 0
    pre, dec = (load_plan(f"{prefix}.{p}.json") for p in ("prefill", "decode"))
    cfg = get_config(arch, smoke=True)
    m = api(cfg, plan=None, device=cuda_device)
    params = m.init_params(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12))).to(
        cuda_device)}
    if cfg.family == "vlm":
        batch["frontend"] = torch.from_numpy(
            _np((2, cfg.n_frontend_tokens, cfg.d_model), 3)).to(cuda_device)
    n_prefix = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    outs = {}
    try:
        for label, force in (("kernels", None), ("plain", "jnp")):
            launches.reset()
            with plan_context(pre, force_backend=force):
                logits, caches = m.prefill_full(params, batch, 16 + n_prefix)
            got = [logits]
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            pos = torch.tensor([12 + n_prefix, 7], device=cuda_device)
            for step in range(2):
                with plan_context(dec, force_backend=force):
                    step_logits, caches = m.decode_step(params, tok, caches, pos + step)
                got.append(step_logits)
                tok = torch.argmax(step_logits, dim=-1)[:, None]
            torch.cuda.synchronize()
            outs[label] = (got, dict(launches.COUNTS))
    finally:
        install_plan(None)
    kernels = ("streaming_tt",) if backend == "streaming_tt" else (
        "tt_gemm_os", "tt_gemm_ws", "tt_gemm_is", "fused_path")
    assert sum(outs["kernels"][1][k] for k in kernels) > 0
    assert sum(outs["plain"][1].values()) == 0
    for got, want in zip(outs["kernels"][0], outs["plain"][0]):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, want.abs().max().item()))


#: (plan file, layer) of every distinct streaming_tt layer of the committed
#: full-width family pairs (qwen2-moe-a2.7b, zamba2-1.2b, rwkv6-7b)
FAMILY_STREAMING = streaming_cases("*.pair.*.json")
FAMILY_STREAMING = [c for c in FAMILY_STREAMING if not c[0].startswith("tt-lm")]


@pytest.mark.cuda
@pytest.mark.parametrize("plan_file,name", FAMILY_STREAMING)
def test_streaming_tt_cuda_family_layers_match_plain(cuda_device, plan_file, name):
    """K1 at every streaming layer of the family pairs (the experts' out
    mode of 11, rwkv6's 16 x 16 x 16 inputs and 14336-wide channel mix):
    at 1, 4, 32, 37 and 2048 tokens within 1e-4 of the output's scale (the
    outputs of these fan-ins reach ~10); row 0 bit for bit against a
    one-row call, the first 5 rows of 2048 against a 5-token call; in bf16
    at 4 tokens against the plain version at 8e-2 of the output's scale."""
    lp, tn = plan_layer(plan_file, name)
    launches.reset()
    for tokens in (1, 4, 32, 37, 2048):
        bt = ops.clamp_block(lp["tiling"]["block_tokens"], tokens)
        net = streaming_tt._rebatch(tn, bt)
        path = as_candidate_path(net, lp["path_steps"])
        x, cores = k1_inputs(net, tokens, cuda_device, 180)
        got = streaming_tt.streaming_tt_linear(x, cores, net, path, block_tokens=bt)
        want = streaming_tt.streaming_tt_linear_plain(x, cores, net, path)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, want.abs().max().item()))
        for rows in (1, 5):
            part = streaming_tt.streaming_tt_linear(x[:rows].contiguous(), cores, net,
                                                    path, block_tokens=bt)
            assert torch.equal(part, got[:rows])
        if tokens == 4:
            xb, cb = x.to(torch.bfloat16), [c.to(torch.bfloat16) for c in cores]
            got = streaming_tt.streaming_tt_linear(xb, cb, net, path, block_tokens=bt)
            want = streaming_tt.streaming_tt_linear_plain(xb, cb, net, path).float()
            np.testing.assert_allclose(
                got.float().cpu().numpy(), want.cpu().numpy(), rtol=BF16["rtol"],
                atol=BF16["atol"] * max(1.0, want.abs().max().item()))
    assert launches.COUNTS["streaming_tt"] == 5 * 3 + 1


def family_gemm_shapes():
    """(M, K, N) and clamped blocks of every GEMM the committed family
    prefill plans run on tt_gemm (``test_torch_family_kernels.GEMMS``)."""
    from test_torch_family_kernels import GEMMS

    return sorted({case[2:] for case in GEMMS})


@pytest.mark.cuda
@pytest.mark.parametrize("case", family_gemm_shapes())
def test_tt_gemm_cuda_family_shapes_match_plain_dataflows_bit_identical(cuda_device,
                                                                      case):
    """K2-K4 at the full-width family plans' GEMMs (zamba2's 8384 = 131 x 64
    rows, rwkv6's 14336 channel mix) with the plan's clamped blocks: the
    plain version within 1e-5, WS == OS == IS bit for bit, and row 0 bit
    for bit against a one-row call."""
    m, k, n, bm, bk, bn = case
    a = torch.from_numpy(_np((m, k), 170)).to(cuda_device)
    b = torch.from_numpy(_np((k, n), 171)).to(cuda_device)
    blk = dict(block_m=bm, block_k=bk, block_n=bn)
    outs = [tt_gemm.tt_gemm(a, b, dataflow=df, **blk) for df in DATAFLOWS]
    want = tt_gemm.tt_gemm_plain(a, b, **blk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(outs[0].cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * max(1.0, want.abs().max().item()))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    row = tt_gemm.tt_gemm(a[:1].contiguous(), b, dataflow="WS", **blk)
    assert torch.equal(row[0], outs[1][0])


# ---------------------------------------------------------------------------
# training the MoE, hybrid (Mamba2), RWKV6 and VLM families
# ---------------------------------------------------------------------------

def _family_train_plan(arch: str, backend: str, path) -> str:
    import contextlib
    import io
    import os

    with contextlib.redirect_stdout(io.StringIO()):
        assert dse_cli.main(["--arch", arch, "--smoke", "--mode", "train", "--top-k",
                             "2", "--tokens", "32", "--plan-backend", backend,
                             "--emit-plan", str(path), "--out", os.devnull]) == 0
    return str(path)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["streaming_tt", "tt_gemm"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_smoke_train_step_cuda_matches_plain(cuda_device, arch, backend,
                                                    tmp_path):
    """Each family's smoke model, loss and every gradient, on the card under
    its smoke train plan forced to one kernel backend (K1 forward and dx,
    or K2-K4 + K5; weight gradients on K2-K4, the smoke plans' OS and IS
    dataflows) against the plain executor on the card: within 1e-4 of each
    tensor's scale; the kernels launched."""
    from repro_torch.models import api
    from repro_torch.nn import install_plan
    from repro_torch.tree import leaves

    plan = load_plan(_family_train_plan(arch, backend, tmp_path / "train.json"))
    cfg = get_config(arch, smoke=True).with_(loss_chunk=8)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))).to(cuda_device)
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["frontend"] = torch.from_numpy(
            _np((2, cfg.n_frontend_tokens, cfg.d_model), 4)).to(cuda_device)
    outs = {}
    try:
        for label, force in (("kernels", None), ("plain", "jnp")):
            m = api(cfg, plan=plan, plan_backend=force, device=cuda_device)
            params = m.init_params(0)
            for p in leaves(params):
                p.requires_grad_(True)
            launches.reset()
            loss = m.train_loss(params, batch)
            loss.backward()
            torch.cuda.synchronize()
            outs[label] = ([loss.detach()] + [p.grad for p in leaves(params)],
                           dict(launches.COUNTS))
    finally:
        install_plan(None)
    counts = outs["kernels"][1]
    assert sum(counts[f"tt_gemm_{df}"] for df in ("os", "ws", "is")) > 0
    assert counts["streaming_tt" if backend == "streaming_tt" else "fused_path"] > 0
    assert sum(outs["plain"][1].values()) == 0
    for got, want in zip(outs["kernels"][0], outs["plain"][0]):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, want.abs().max().item()))


@pytest.mark.cuda
def test_grad_compress_train_step_cuda_matches_cpu(cuda_device, tmp_path):
    """``python -m repro_torch.launch.train --grad-compress`` on zamba2's
    smoke model under its streaming train plan, two steps on the card (K1,
    K2-K4) and on the CPU (plain versions): losses and gradient norms within
    rel 1e-4."""
    from repro_torch.launch.train import run

    plan = _family_train_plan("zamba2-1.2b", "streaming_tt", tmp_path / "train.json")
    argv = ["--arch", "zamba2-1.2b", "--smoke", "--plan", plan, "--grad-compress",
            "--steps", "2", "--batch", "2", "--seq", "16"]
    got = run(argv + ["--device", str(cuda_device), "--ckpt-dir", str(tmp_path / "g")])
    want = run(argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "c")])
    assert got.code == want.code == 0
    assert got.launches[0]["streaming_tt"] > 0
    assert sum(got.launches[0][f"tt_gemm_{df}"] for df in ("os", "ws", "is")) > 0
    np.testing.assert_allclose(got.losses + got.grad_norms,
                               want.losses + want.grad_norms, rtol=1e-4)


# ---------------------------------------------------------------------------
# the experts' batched launch (full-width qwen2-moe-a2.7b)
# ---------------------------------------------------------------------------

MOE_EXPERTS = 60
#: (plan file, layer, slots an expert): the decode step's 4 lanes (4
#: slots), and the train step's 4 x 512 tokens (4 groups x 43 slots)
MOE_BATCHED = [("qwen2-moe-a2.7b.pair.decode.json", "moe.ed", 4),
               ("qwen2-moe-a2.7b.train.json", "moe.eu", 172),
               ("qwen2-moe-a2.7b.train.json", "moe.ed", 172)]


def _moe_layer(plan_file: str, name: str):
    """(LayerPlan, the projection's network) of a committed qwen2-moe plan."""
    _, tn = plan_layer(plan_file, name)
    lp = next(l for l in load_plan(str(PLANS / plan_file)).layers if l.name == name)
    return lp, tn


def _stacked(shapes, seed, device, scale=1.0):
    return [torch.from_numpy(_np((MOE_EXPERTS,) + tuple(d), seed + i, scale)).to(device)
            for i, d in enumerate(shapes)]


@pytest.mark.cuda
@pytest.mark.parametrize("plan_file,name,slots", MOE_BATCHED)
def test_streaming_tt_batched_cuda_matches_plain_and_unbatched(cuda_device, plan_file,
                                                               name, slots):
    """Batched K1 over all 60 experts at the full-width decode and train
    shapes, forward and (train plan) the dx network along its planned
    backward path: one launch sequence, one count; within 1e-4 of the
    output's scale against the batched plain version; every expert bit for
    bit the unbatched launch on its own rows."""
    lp, tn = _moe_layer(plan_file, name)
    calls = [(tn, lp.path_steps, lp.tiling.block_tokens)]
    calls += [(grad_input_network(tn), op.path_steps, op.tiling.block_tokens)
              for op in lp.backward if op.wrt == "dx"]
    for net, steps, block in calls:
        bt = ops.clamp_block(block, slots)
        net = streaming_tt._rebatch(net, bt)
        path = as_candidate_path(net, steps)
        n_in = int(np.prod(streaming_tt._stream_node(net).dims[1:]))
        cores = _stacked([n.dims for n in net.nodes if n.kind != "input"], 300,
                         cuda_device, 0.2)
        x = _stacked([(slots, n_in)], 310, cuda_device)[0]
        launches.reset()
        got = streaming_tt.streaming_tt_linear_batched(x, cores, net, path)
        assert launches.COUNTS["streaming_tt_batched"] == 1
        want = streaming_tt.streaming_tt_linear_batched_plain(x, cores, net, path)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, want.abs().max().item()))
        for e in range(MOE_EXPERTS):
            one = streaming_tt.streaming_tt_linear(x[e], [c[e] for c in cores], net,
                                                   path, block_tokens=bt)
            assert torch.equal(got[e], one), e
        assert launches.COUNTS["streaming_tt"] == MOE_EXPERTS


def moe_grad_gemms():
    """(M, K, N) and the clamped blocks of every weight-gradient GEMM of the
    full-width train plan's ``moe.eu`` and ``moe.ed`` at 172 slots."""
    from repro_torch.core.backward import backward_networks

    out = set()
    for _, name, slots in MOE_BATCHED[1:]:
        lp, tn = _moe_layer("qwen2-moe-a2.7b.train.json", name)
        ops_ = {op.wrt: op for op in lp.backward}
        for wrt, net in backward_networks(streaming_tt._rebatch(tn, slots)):
            if wrt == "dx":
                continue
            t = ops_[wrt].tiling
            for g in net.gemm_sequence(ops_[wrt].path_steps):
                out.add((g.M, g.K, g.N, ops.clamp_block(t.block_m, g.M),
                         ops.clamp_block(t.block_k, g.K),
                         ops.clamp_block(t.block_n, g.N)))
    return sorted(out)


@pytest.mark.cuda
@pytest.mark.parametrize("case", moe_grad_gemms())
def test_tt_gemm_batched_cuda_matches_plain_and_unbatched(cuda_device, case):
    """Batched K3 (WS) over all 60 experts at every weight-gradient GEMM of
    the experts' train plan: one launch sequence, one count; within 1e-5 of
    the output's scale against the batched plain version; every expert bit
    for bit the unbatched K3 launch."""
    m, k, n, bm, bk, bn = case
    a, = _stacked([(m, k)], 320, cuda_device)
    b, = _stacked([(k, n)], 321, cuda_device)
    blk = dict(block_m=bm, block_k=bk, block_n=bn)
    launches.reset()
    got = tt_gemm.tt_gemm_batched(a, b, dataflow="WS", **blk)
    assert launches.COUNTS["tt_gemm_ws_batched"] == 1
    want = tt_gemm.tt_gemm_batched_plain(a, b, dataflow="WS", **blk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5,
                               atol=1e-5 * max(1.0, want.abs().max().item()))
    for e in range(MOE_EXPERTS):
        assert torch.equal(got[e], tt_gemm.tt_gemm(a[e], b[e], dataflow="WS", **blk))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["eu", "ed"])
def test_planned_batched_projection_cuda_equals_unbatched_calls(cuda_device, name):
    """The train plan's expert projection at 60 x 172 slots through
    ``planned_tt_linear_batched`` (batched K1 forward and dx, batched K3
    for every core gradient): the output and every gradient bit for bit
    those of 60 unbatched ``planned_tt_linear`` calls; the batched call
    launches only the batched kernels."""
    from repro_torch.models import blocks
    from repro_torch.plan import planned_tt_linear_batched

    spec = {"eu": blocks.moe_spec(get_config("qwen2-moe-a2.7b")).expert_up,
            "ed": blocks.moe_spec(get_config("qwen2-moe-a2.7b")).expert_down}[name]
    lp, _ = _moe_layer("qwen2-moe-a2.7b.train.json", f"moe.{name}")
    geometry = (spec.in_modes, spec.out_modes, spec.tt_ranks)
    cores = _stacked([n.dims for n in spec.network(172).nodes if n.kind != "input"],
                     330, cuda_device, 0.2)
    x, w = _stacked([(172, spec.d_in), (172, spec.d_out)], 340, cuda_device)
    leaves = [x.clone().requires_grad_(True)] + [c.clone().requires_grad_(True)
                                                 for c in cores]
    launches.reset()
    y = planned_tt_linear_batched(lp, leaves[0], leaves[1:], *geometry)
    (y * w).sum().backward()
    torch.cuda.synchronize()
    counts = dict(launches.COUNTS)
    assert counts["streaming_tt_batched"] == 2 and counts["tt_gemm_ws_batched"] > 0
    assert sum(v for k, v in counts.items() if not k.endswith("_batched")) == 0
    for e in range(MOE_EXPERTS):
        one = [x[e].clone().requires_grad_(True)] + [c[e].clone().requires_grad_(True)
                                                     for c in cores]
        ye = planned_tt_linear(lp, one[0], one[1:], *geometry)
        (ye * w[e]).sum().backward()
        assert torch.equal(y[e], ye), e
        for batched, single in zip(leaves, one):
            assert torch.equal(batched.grad[e], single.grad), e


@pytest.mark.cuda
def test_moe_layer_makes_no_host_sync_on_the_card(cuda_device):
    """One full-width qwen2-moe-a2.7b MoE layer (60 experts, bf16 as
    configured) under the train plan, batch 4 x seq 512: after one warm-up
    call, a forward and backward under ``torch.cuda.set_sync_debug_mode
    ("error")`` raise nothing; the experts ran on the batched kernels."""
    from repro_torch.models import blocks
    from repro_torch.nn import install_plan, moe

    from repro_torch.tree import leaves

    cfg = get_config("qwen2-moe-a2.7b")
    spec = blocks.moe_spec(cfg)
    dtype = getattr(torch, cfg.dtype)
    params = moe.moe_init(spec, torch.Generator().manual_seed(0), dtype, cuda_device)
    for p in leaves(params):
        p.requires_grad_(True)
    x = torch.from_numpy(_np((4, 512, cfg.d_model), 360)).to(
        cuda_device, dtype).requires_grad_(True)
    install_plan(load_plan(str(PLANS / "qwen2-moe-a2.7b.train.json")))
    try:
        y, aux = moe.moe_apply(spec, params, x)
        (y.float().sum() + aux).backward()
        torch.cuda.synchronize()
        launches.reset()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe.moe_apply(spec, params, x)
            (y.float().sum() + aux).backward()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    finally:
        install_plan(None)
    assert torch.isfinite(y.float()).all() and torch.isfinite(x.grad.float()).all()
    assert launches.COUNTS["streaming_tt_batched"] == 6
    assert launches.COUNTS["tt_gemm_ws_batched"] > 0


# ---------------------------------------------------------------------------
# the encoder-decoder family (seamless-m4t-medium)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["streaming_tt", "tt_gemm"])
def test_encdec_smoke_serving_cuda_matches_plain(cuda_device, backend, tmp_path):
    """The smoke encoder-decoder on the card under a plan pair forced to one
    kernel backend: ``make_prefill_step`` (12 frames, a 10-token prompt)
    and 3 ``make_decode_step`` steps at scalar positions against the plain
    executor on the card, within 1e-4 of the logits' scale; the backend's
    kernels launched in prefill and in decode."""
    import contextlib
    import io
    import os

    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import api
    from repro_torch.nn import install_plan, plan_context

    arch = "seamless-m4t-medium"
    prefix = str(tmp_path / "pair")
    with contextlib.redirect_stdout(io.StringIO()):
        assert dse_cli.main(["--arch", arch, "--smoke", "--top-k", "2", "--tokens",
                             "16", "--serve-slots", "2", "--plan-backend", backend,
                             "--emit-plan-pair", prefix, "--out", os.devnull]) == 0
    pre, dec = (load_plan(f"{prefix}.{p}.json") for p in ("prefill", "decode"))
    cfg = get_config(arch, smoke=True)
    params = api(cfg, plan=None, device=cuda_device).init_params(0)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 13))).to(cuda_device)
    batch = {"tokens": tokens[:, :10],
             "frontend": torch.from_numpy(_np((2, 12, cfg.d_model), 3)).to(cuda_device)}
    prefill, decode = make_prefill_step(cfg, max_seq=16), make_decode_step(cfg)
    kernels = ("streaming_tt",) if backend == "streaming_tt" else (
        "tt_gemm_os", "tt_gemm_ws", "tt_gemm_is", "fused_path")
    outs = {}
    try:
        for label, force in (("kernels", None), ("plain", "jnp")):
            launches.reset()
            with plan_context(pre, force_backend=force):
                logits, caches = prefill(params, batch)
            got, counts = [logits], [dict(launches.COUNTS)]
            for i in range(3):
                launches.reset()
                with plan_context(dec, force_backend=force):
                    logits, caches = decode(params, tokens[:, 10 + i:11 + i], caches,
                                            torch.tensor(10 + i, device=cuda_device))
                got.append(logits)
                counts.append(dict(launches.COUNTS))
            torch.cuda.synchronize()
            outs[label] = (got, counts)
    finally:
        install_plan(None)
    for per_call in outs["kernels"][1]:
        assert sum(per_call[k] for k in kernels) > 0
    assert not any(sum(c.values()) for c in outs["plain"][1])
    for got, want in zip(outs["kernels"][0], outs["plain"][0]):
        assert got.shape == (2, cfg.vocab) and torch.isfinite(got).all()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, want.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["streaming_tt", "tt_gemm"])
def test_encdec_smoke_train_step_cuda_matches_plain(cuda_device, backend, tmp_path):
    """The smoke encoder-decoder's loss and every gradient on the card under
    its smoke train plan forced to one kernel backend (K1 forward and dx, or
    K2-K4 + K5; weight gradients on K2-K4), with ``remat="full"``, against
    the plain executor on the card: within 1e-4 of each tensor's scale;
    the kernels launched.  Then one ``make_train_step`` step on each."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.nn import install_plan
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves

    plan = load_plan(_family_train_plan("seamless-m4t-medium", backend,
                                        tmp_path / "train.json"))
    cfg = get_config("seamless-m4t-medium", smoke=True).with_(remat="full")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))).to(cuda_device)
             for k in ("tokens", "labels")}
    batch["frontend"] = torch.from_numpy(_np((2, 12, cfg.d_model), 4)).to(cuda_device)
    outs = {}
    try:
        for label, force in (("kernels", None), ("plain", "jnp")):
            m = api(cfg, plan=plan, plan_backend=force, device=cuda_device)
            params = m.init_params(0)
            for p in leaves(params):
                p.requires_grad_(True)
            launches.reset()
            loss = m.train_loss(params, batch)
            loss.backward()
            torch.cuda.synchronize()
            grads = [p.grad for p in leaves(params)]
            counts = dict(launches.COUNTS)
            params, _, metrics = make_train_step(cfg)(params, adamw_init(params), batch)
            outs[label] = ([loss.detach()] + grads + [metrics["grad_norm"]], counts)
    finally:
        install_plan(None)
    counts = outs["kernels"][1]
    assert sum(counts[f"tt_gemm_{df}"] for df in ("os", "ws", "is")) > 0
    assert counts["streaming_tt" if backend == "streaming_tt" else "fused_path"] > 0
    assert sum(outs["plain"][1].values()) == 0
    for got, want in zip(outs["kernels"][0], outs["plain"][0]):
        assert got is not None and torch.isfinite(got).all()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, want.abs().max().item()))


# ---------------------------------------------------------------------------
# training across ranks that share the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_two_ranks_sharing_the_card_train_as_one_device(cuda_device, tmp_path):
    """tt-lm-smoke's step 0 on 2 ``gloo`` ranks sharing the card
    (``data=2``: one of the 2 sequences, 16 of the 32 tokens, a rank, the
    gradients summed over the ranks) against one device, under the K1
    train plan and the tt_gemm one (K5 segments): the loss within rel
    1e-4 and every gradient leaf within rel 1e-4 of its norm (the ranks
    sum the two blocks' gradients in another order)."""
    from _torch_shard_ranks import TRAIN_PLANS, smoke_step0, spawn

    ranks = spawn("cuda_train", 2, {}, tmp_path)
    for plan_file in TRAIN_PLANS:
        want = smoke_step0(plan_file, cuda_device)
        # both plans put every GEMM on the OS dataflow
        need = ("fused_path", "tt_gemm_os") if "tt_gemm" in plan_file else \
            ("streaming_tt", "tt_gemm_os")
        assert all(want["launches"][k] > 0 for k in need)
        for rank in ranks:
            got = rank["cuda_train"][plan_file]
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
            assert got["meshes"] == ["data=2"]
            assert all(got["launches"][k] > 0 for k in need), got["launches"]
            assert sorted(got["grads"]) == sorted(want["grads"])
            for name, g in got["grads"].items():
                w = want["grads"][name]
                gap = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
                assert gap <= 1e-4, (plan_file, name, gap)


@pytest.mark.cuda
def test_four_ranks_sharing_the_card_split_the_model_axis(cuda_device, tmp_path):
    """tt-lm-smoke's step 0 on 4 ``gloo`` ranks sharing the card (``data=2 x
    model=2`` with ``tt_model_reduce``: a sequence a data rank, and on each
    rank of a model group 1 of the 2 kv heads, half of d_ff and half of the
    vocab, through ``model_block``, ``model_gather`` and ``model_copy`` on
    CUDA tensors) against one device, under both smoke train plans: the
    loss within rel 1e-4, every gradient leaf within rel 1e-4 of its norm,
    and every rank with the same gradients."""
    from _torch_shard_ranks import TRAIN_PLANS, smoke_step0, spawn

    ranks = spawn("cuda_train", 4, {"reduce": True}, tmp_path)
    for plan_file in TRAIN_PLANS:
        want = smoke_step0(plan_file, cuda_device)
        for rank in ranks:
            got = rank["cuda_train"][plan_file]
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
            assert got["meshes"] == ["data=2+reduce(model=2)"]
            assert sorted(got["grads"]) == sorted(want["grads"])
            for name, g in got["grads"].items():
                w = want["grads"][name]
                gap = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
                assert gap <= 1e-4, (plan_file, name, gap)
                assert torch.equal(g, ranks[0]["cuda_train"][plan_file]["grads"][name])


@pytest.mark.cuda
def test_sequence_split_gather_and_decode_combine_on_the_card(cuda_device, tmp_path):
    """At chatglm3-6b's shapes on 4 ``gloo`` ranks sharing the card
    (``data=1 x model=4``): ``seq_gather`` of a rank's 128 of 512 positions
    of K and V gives the whole tensor bit for bit, and its backward the sum
    of every rank's gradient at the rank's block (1e-6 of its scale: the
    ranks add in another order); a decode step of 16 lanes over a rank's
    8 192 of 32 768 cache positions (``_decode_blocks``: each lane's new K/V
    written by the rank that holds its position, the blocks' softmax
    combined) equals the single-process softmax over the whole cache
    within 1e-4 x max |output|, on every rank."""
    from _torch_shard_ranks import spawn

    ranks = spawn("cuda_sp", 4, {}, tmp_path, timeout=300)
    assert sum(rank["cuda_sp"]["held"] for rank in ranks) == 16
    for rank in ranks:
        got = rank["cuda_sp"]
        assert got["gather_equal"] and got["writes_equal"]
        assert got["grad_gap"] <= 1e-6
        assert got["decode_gap"] <= 1e-4 * got["scale"]


@pytest.mark.cuda
def test_scan_hand_off_and_conv_halo_on_the_card(cuda_device, tmp_path):
    """At zamba2-1.2b's SSD and conv widths on 4 ``gloo`` ranks sharing the
    card (``data=1 x model=4``, 128 of 512 positions a rank): the blockwise
    scan with its state hand-off (one ``seq_stack`` of the end states and
    decays) and the conv over a rank's block with the ranks' halo give the
    single-process scan's output, end state and conv within 1e-4 of their
    scale, the halo bit for bit, and the backward every input's gradient
    at the rank's block within 1e-4 (the stack's backward sums every
    rank's share once)."""
    from _torch_shard_ranks import spawn

    ranks = spawn("cuda_sps", 4, {}, tmp_path, timeout=300)
    for rank in ranks:
        got = dict(rank["cuda_sps"])
        assert got.pop("halo_equal")
        assert got and all(gap <= 1e-4 for gap in got.values()), got
