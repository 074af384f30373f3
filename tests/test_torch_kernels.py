"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version; the JAX side runs the Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does.  The step tables the CUDA streaming kernel
executes are checked here through their torch mirror
(``run_program_plain``).  The CUDA kernels themselves are held against
their plain versions in ``tests/test_torch_cuda.py``, on the card.

Tolerances: 1e-5 for GEMMs and 1e-4 for TT contractions, the reference's
own (``tests/test_kernels.py:34,89``): both sides sum in fp32, in another
order, so they differ by a few ulp times the contraction depth.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import find_topk_paths as ref_find_topk_paths
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.streaming_tt import build_block_network as ref_block_network
from repro_torch.configs import get_config
from repro_torch.core import find_topk_paths, tt_linear_network
from repro_torch.dse_cli import model_dse_layers
from repro_torch.kernels import launches, ops, ref, streaming_tt, tt_gemm
from repro_torch.plan.executor import as_candidate_path
from repro_torch.plan import load_plan
from test_torch_cuda import (DECODE_CASES, IS_ROUTE_CASES, PLANS, dx_cases,
                             dx_network, k1_inputs, plan_layer, small_tt_paths,
                             streaming_cases, wide_free_case)

torch.set_num_threads(2)

DATAFLOWS = ("OS", "WS", "IS")
GEMM_SHAPES = [(32, 32, 32), (64, 96, 32), (128, 64, 96), (33, 47, 65), (1, 128, 128)]


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# tt_gemm (K2-K4): plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_gemm_plain_vs_pallas(dataflow, shape):
    m, k, n = shape
    a, b = _np((m, k), 1), _np((k, n), 2)
    want = ref_ops.gemm(jnp.asarray(a), jnp.asarray(b), dataflow=dataflow,
                        block_m=32, block_k=32, block_n=32, interpret=True)
    got = ops.gemm(torch.from_numpy(a), torch.from_numpy(b), dataflow=dataflow,
                   block_m=32, block_k=32, block_n=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the plain ground truths agree too
    np.testing.assert_allclose(
        ref.gemm_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ref_ref.gemm_ref(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_gemm_contract_vs_pallas(dataflow):
    """One path step lowered through ``gemm_contract`` on both sides."""
    ta, tb = _np((6, 8, 5), 3), _np((5, 4, 8), 4)
    axes = ([1, 2], [2, 0])
    want = ref_ops.gemm_contract(dataflow, 16, 16, 16, interpret=True)(
        jnp.asarray(ta), jnp.asarray(tb), axes)
    got = ops.gemm_contract(dataflow, 16, 16, 16)(
        torch.from_numpy(ta), torch.from_numpy(tb), axes)
    assert tuple(got.shape) == tuple(want.shape) == (6, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_clamp_block_matches_reference():
    for block in (8, 16, 100, 128, 256):
        for dim in (1, 4, 8, 9, 33, 768, 32000):
            assert ops.clamp_block(block, dim) == ref_ops.clamp_block(block, dim)


def test_gemm_plain_is_one_function_of_block_k():
    """All dataflows share one k-fold accumulation, so at one ``block_k``
    they agree bit for bit and ``block_m``/``block_n`` change nothing."""
    a, b = torch.from_numpy(_np((40, 70), 5)), torch.from_numpy(_np((70, 24), 6))
    outs = [tt_gemm.tt_gemm_plain(a, b, dataflow=df, block_m=bm, block_k=16,
                                  block_n=bn)
            for df in DATAFLOWS for bm, bn in ((8, 8), (32, 128))]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_gemm_rejects_bad_arguments():
    a = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="dataflow"):
        tt_gemm.tt_gemm(a, a, dataflow="XS")
    with pytest.raises(ValueError, match="block_k"):
        tt_gemm.tt_gemm(a, a, block_k=0)


# ---------------------------------------------------------------------------
# the WS kernel's grid (K3): cover, size and the split-K fold, on the CPU
# ---------------------------------------------------------------------------

#: (M, K, N) with the plan's blocks, clamped as the executor clamps them:
#: the three weight-gradient shapes of the train plans, the serve shapes,
#: and a ragged case
WS_GRID_CASES = [((2048, 2048, 16), (128, 128, 16)),
                 ((768, 2048, 16), (128, 128, 16)),
                 ((2048, 768, 16), (128, 128, 16)),
                 ((37, 2048, 16), (128, 128, 16)),
                 ((1, 2048, 16), (128, 128, 16)),
                 ((200, 300, 90), (32, 32, 32)),
                 ((200, 300, 90), (128, 32, 64))]


def _ws_grid(shape, blocks, n_sm=132):
    (m, k, n), (bm, bk, bn) = shape, blocks
    return tt_gemm.ws_grid(m, k, n, block_m=ops.clamp_block(bm, m),
                           block_k=ops.clamp_block(bk, k),
                           block_n=ops.clamp_block(bn, n), n_sm=n_sm)


@pytest.mark.parametrize("n_sm", [132, 7])
@pytest.mark.parametrize("shape,blocks", WS_GRID_CASES)
def test_ws_grid_covers_every_row_and_kblock_once(shape, blocks, n_sm):
    g = _ws_grid(shape, blocks, n_sm)
    m, k, n = shape
    seen = np.zeros((g.n_kblocks, m, n), np.int32)
    for rows, kbs, cols in g.blocks_work():
        assert len(rows) and len(kbs) and len(cols)
        seen[kbs.start:kbs.stop, rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (seen == 1).all()
    assert g.smem_bytes <= tt_gemm.SMEM_LIMIT_BYTES
    assert 1 <= g.rows_per_thread <= tt_gemm.WS_TILE_ROWS
    assert g.row_groups * -(-g.block_n // 4) <= 256


@pytest.mark.parametrize("shape,blocks", WS_GRID_CASES)
def test_ws_grid_fills_the_card(shape, blocks):
    """At least 132 blocks wherever the n-bands x rows x k-blocks allow
    it (an m-tile keeps WS_MIN_TILE_ROWS rows), about 2 x 132 at the
    weight-gradient shapes."""
    g = _ws_grid(shape, blocks)
    m, _, _ = shape
    most = g.n_nbands * -(-m // tt_gemm.WS_MIN_TILE_ROWS) * g.n_kblocks
    assert g.blocks >= min(132, most)
    if shape[0] >= 37:
        assert g.blocks >= 132
    if shape in ((2048, 2048, 16), (768, 2048, 16), (2048, 768, 16)):
        assert 264 <= g.blocks <= 2 * 264


@pytest.mark.parametrize("shape,blocks", WS_GRID_CASES)
def test_ws_grid_workspace_is_one_partial_per_kblock(shape, blocks):
    g = _ws_grid(shape, blocks)
    m, k, n = shape
    n_kb = -(-k // g.block_k)
    assert g.n_kblocks == n_kb
    assert g.workspace_elems == (n_kb * m * n if g.n_kgroups > 1 else 0)
    # one k-block: nothing to split, no workspace
    one = tt_gemm.ws_grid(m, k, n, block_m=128, block_k=ops.clamp_block(k, k),
                          block_n=g.block_n)
    assert one.n_kgroups == 1 and one.workspace_elems == 0


@pytest.mark.parametrize("n_sm", [132, 7])
@pytest.mark.parametrize("shape,blocks", WS_GRID_CASES[3:])
def test_ws_split_fold_mirror_equals_plain(shape, blocks, n_sm):
    """Partials per k-block into the workspace, then the ascending fold:
    bit for bit the plain version's k-fold."""
    m, k, n = shape
    a, b = torch.from_numpy(_np((m, k), 7)), torch.from_numpy(_np((k, n), 8))
    g = _ws_grid(shape, blocks, n_sm)
    got = tt_gemm.run_ws_grid_plain(a, b, g)
    want = tt_gemm.tt_gemm_plain(a, b, dataflow="WS", block_m=128,
                                 block_k=g.block_k, block_n=g.block_n)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the OS and IS kernels' grids (K2, K4): cover, k-block order, size and the
# fold, on the CPU
# ---------------------------------------------------------------------------

#: the decode shapes (blocks clamped as the executor clamps them), ragged
#: shapes with odd blocks, and a deep K of 16 k-blocks
BAND_GRID_CASES = DECODE_CASES + [((33, 47, 65), (7, 5, 3)), ((1, 9, 2), (1, 1, 1)),
                                  ((200, 300, 90), (32, 32, 32)),
                                  ((37, 2048, 16), (64, 128, 16))]


def _band_grid(dataflow, shape, blocks, n_sm=132):
    (m, k, n), (bm, bk, bn) = shape, blocks
    make = tt_gemm.os_grid if dataflow == "OS" else tt_gemm.is_grid
    return make(m, k, n, block_m=bm, block_k=bk, block_n=bn, n_sm=n_sm)


def _is_route_grid(shape, blocks, tile_n):
    """IS with the band staged per k-block and every n-tile in one group:
    the route that folds through C (as tests/test_torch_cuda.py runs it)."""
    g = _band_grid("IS", shape, tuple(ops.clamp_block(b, d) for b, d in
                                      zip(blocks, shape)))
    g = dataclasses.replace(g, tile_n=tile_n,
                            row_groups=min(g.row_groups, 256 // -(-tile_n // 4)))
    return dataclasses.replace(g, a_whole=False, ntiles_per_group=g.n_ntiles,
                               one_pass=False)


def _assert_cover(g):
    """Every output of the call is computed by one block, its k-blocks
    0, 1, ... in ascending order, each once; the grid fits the kernel."""
    m, _, n = g.m, g.k, g.n
    last = np.full((m, n), -1)
    for b in range(g.blocks):
        steps = g.block_steps(b)
        assert steps
        for rows, cols, kb, _ in steps:
            assert len(rows) and len(cols)
            r, c = slice(rows.start, rows.stop), slice(cols.start, cols.stop)
            assert (last[r, c] == kb - 1).all()
            last[r, c] = kb
    assert (last == g.n_kblocks - 1).all()
    assert g.smem_bytes <= tt_gemm.SMEM_LIMIT_BYTES
    assert 1 <= g.rows_per_thread <= tt_gemm.WS_TILE_ROWS
    assert g.row_groups * -(-g.tile_n // 4) <= 256
    if g.one_pass:
        assert g.block_k % 4 == 0 and (g.a_whole or g.ntiles_per_group == 1)


@pytest.mark.parametrize("n_sm", [132, 7])
@pytest.mark.parametrize("dataflow", ["OS", "IS"])
@pytest.mark.parametrize("shape,blocks", BAND_GRID_CASES)
def test_band_grid_covers_every_output_once_in_kblock_order(shape, blocks, dataflow,
                                                            n_sm):
    g = _band_grid(dataflow, shape, blocks, n_sm)
    assert g.dataflow == dataflow
    _assert_cover(g)
    # one pass wherever a block's tiles across all of K fit; else the ring
    fits = (g.block_k % 4 == 0 and (g.a_whole or g.ntiles_per_group == 1)
            and dataclasses.replace(g, one_pass=True).smem_bytes
            <= tt_gemm.SMEM_LIMIT_BYTES)
    assert g.one_pass == fits


@pytest.mark.parametrize("dataflow", ["OS", "IS"])
@pytest.mark.parametrize("shape,blocks", BAND_GRID_CASES)
def test_band_grid_fills_the_card(shape, blocks, dataflow):
    """At least 132 blocks wherever the tiles allow it (a tile keeps
    BAND_MIN_ROWS rows and the plan's n-tiles), and no tile larger than
    the plan's blocks."""
    g = _band_grid(dataflow, shape, blocks)
    m, _, n = shape
    most = -(-m // tt_gemm.BAND_MIN_ROWS) * g.n_ntiles
    assert g.blocks >= min(132, most)
    assert g.tile_m <= max(blocks[0], 1) and g.tile_n <= blocks[2]
    if (shape, blocks) in DECODE_CASES:
        assert g.one_pass
    if dataflow == "OS" and shape == (64, 128, 16):
        assert 16 <= g.blocks <= 64
    if dataflow == "IS" and shape == (32, 16, 256):
        assert g.blocks >= 16 and g.a_whole


@pytest.mark.parametrize("n_sm", [132, 7])
@pytest.mark.parametrize("dataflow", ["OS", "IS"])
@pytest.mark.parametrize("shape,blocks", BAND_GRID_CASES)
def test_band_grid_mirror_equals_plain(shape, blocks, dataflow, n_sm):
    """The blocks' tiles folded in the kernel's order: bit for bit the
    plain version's k-fold."""
    m, k, n = shape
    a, b = torch.from_numpy(_np((m, k), 9)), torch.from_numpy(_np((k, n), 10))
    g = _band_grid(dataflow, shape, blocks, n_sm)
    want = tt_gemm.tt_gemm_plain(a, b, dataflow=dataflow, block_m=blocks[0],
                                 block_k=blocks[1], block_n=blocks[2])
    assert torch.equal(tt_gemm.run_band_grid_plain(a, b, g), want)


@pytest.mark.parametrize("shape,blocks,tile_n", IS_ROUTE_CASES)
def test_is_grid_through_c_covers_and_equals_plain(shape, blocks, tile_n):
    """The IS route that folds through C (k-blocks outside, n-tiles
    inside): every output once per k-block in ascending order, and its
    mirror equals the plain version."""
    g = _is_route_grid(shape, blocks, tile_n)
    assert all(step[3] for b in range(g.blocks) for step in g.block_steps(b))
    _assert_cover(g)
    m, k, n = shape
    a, b = torch.from_numpy(_np((m, k), 11)), torch.from_numpy(_np((k, n), 12))
    want = tt_gemm.tt_gemm_plain(a, b, dataflow="IS", block_m=8,
                                 block_k=g.block_k, block_n=8)
    assert torch.equal(tt_gemm.run_band_grid_plain(a, b, g), want)


def test_os_grid_rejects_an_is_layout():
    g = tt_gemm.os_grid(64, 128, 16, block_m=64, block_k=128, block_n=16)
    for change in (dict(a_whole=True), dict(ntiles_per_group=2)):
        with pytest.raises(ValueError, match="OS"):
            dataclasses.replace(g, **change)


@pytest.mark.parametrize("dataflow", ["OS", "IS"])
def test_band_grid_odd_block_k_streams_padded_kblocks(dataflow):
    """A block_k that is no multiple of 4 streams its k-blocks through the
    two-stage ring (each staged 4-aligned, zero-filled): no whole band of
    A and no one pass, and a grid that asks for either is refused."""
    g = _band_grid(dataflow, (33, 47, 65), (7, 5, 3))
    assert not g.one_pass and not g.a_whole
    for change in (dict(one_pass=True), dict(a_whole=True)):
        with pytest.raises(ValueError, match="multiple of 4"):
            dataclasses.replace(g, **change)


def test_decode_cases_are_the_decode_plan_gemms():
    """DECODE_CASES, which the card tests run, are exactly the distinct OS
    and IS GEMMs of a 4-lane decode step under the committed decode plan."""
    plan = load_plan(PLANS / "tt-lm-100m.pair.decode.json")
    families = {name.split("[")[0]: tn for name, tn in
                model_dse_layers(get_config("tt-lm-100m"), tokens=4)}
    got = set()
    for lp in plan.layers:
        if lp.name == "head":
            continue   # tied to the embedding: never executes
        assert lp.dataflow in ("OS", "IS")
        t = lp.tiling
        for g in families[lp.name].gemm_sequence(lp.path_steps):
            got.add(((g.M, g.K, g.N), (ops.clamp_block(t.block_m, g.M),
                                       ops.clamp_block(t.block_k, g.K),
                                       ops.clamp_block(t.block_n, g.N))))
    assert got == set(DECODE_CASES)


# ---------------------------------------------------------------------------
# streaming_tt (K1): plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_modes,out_modes,rank", [
    ((4, 4), (4, 4), 4),
    ((4, 8), (8, 4), 8),
    ((2, 4, 4), (4, 4, 2), 4),
])
def test_tt_linear_plain_vs_pallas(in_modes, out_modes, rank):
    block = 8
    ranks = (rank,) * (len(in_modes) + len(out_modes) - 1)
    ref_tn = ref_block_network(block, in_modes, out_modes, ranks)
    ref_path = ref_find_topk_paths(ref_tn, k=1)[0]
    tn = tt_linear_network(block, in_modes, out_modes, ranks)
    path = find_topk_paths(tn, k=1)[0]
    assert path.steps == ref_path.steps and path.macs == ref_path.macs
    cores = [_np(n.dims, 11 + i, 0.3) for i, n in enumerate(tn.nodes) if n.name != "X"]
    x = _np((24, int(np.prod(in_modes))), 12)
    want = ref_ops.tt_linear(jnp.asarray(x), [jnp.asarray(c) for c in cores],
                             ref_tn, ref_path, block_tokens=block, interpret=True)
    got = ops.tt_linear(torch.from_numpy(x), [torch.from_numpy(c) for c in cores],
                        tn, path, block_tokens=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    expect = ref_ref.tt_linear_ref(jnp.asarray(x), [jnp.asarray(c) for c in cores],
                                   ref_tn, ref_path)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4, atol=1e-4)


def test_tt_linear_all_topk_paths_agree():
    tn = tt_linear_network(8, (4, 4), (4, 4), (4, 4, 4))
    cores = [torch.from_numpy(_np(n.dims, 20 + i, 0.3))
             for i, n in enumerate(tn.nodes) if n.name != "X"]
    x = torch.from_numpy(_np((8, 16), 21))
    outs = [ops.tt_linear(x, cores, tn, p, block_tokens=8)
            for p in find_topk_paths(tn, k=4)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the CUDA streaming kernel's step tables, executed by their torch mirror
# ---------------------------------------------------------------------------

PROGRAM_TOKENS = [1, 4, 37, 256]


def _mirror_check(net, path, tokens, seed, scale=0.2):
    prog = streaming_tt.program_for(net, path)
    grid = streaming_tt.launch_grid(prog, tokens)
    assert grid.smem_bytes <= streaming_tt.SMEM_LIMIT_BYTES
    assert grid.tile % 4 == 0 and grid.tile * grid.n_tiles >= tokens
    x, cores = k1_inputs(net, tokens, "cpu", seed, scale)
    want = streaming_tt.streaming_tt_linear_plain(x, cores, net, path)
    got = streaming_tt.run_program_plain(prog, x, cores)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tokens", PROGRAM_TOKENS)
@pytest.mark.parametrize("plan_file,name", streaming_cases())
def test_step_program_matches_plain(plan_file, name, tokens):
    lp, tn = plan_layer(plan_file, name)
    bt = ops.clamp_block(lp["tiling"]["block_tokens"], tokens)
    tn_block = streaming_tt._rebatch(tn, bt)
    _mirror_check(tn_block, as_candidate_path(tn_block, lp["path_steps"]), tokens, 30)


@pytest.mark.parametrize("tokens", PROGRAM_TOKENS)
@pytest.mark.parametrize("plan_file,name", dx_cases())
def test_step_program_dx_matches_plain(plan_file, name, tokens):
    """The dx network of every streaming train layer, as the backward pass
    streams dY through K1."""
    net, path = dx_network(plan_file, name, 256)
    _mirror_check(net, path, tokens, 40)


def _small_path_cases():
    """Indices of the small network's top paths: every one that gathers X
    once per tile, and every 16th of the rest."""
    tn, paths = small_tt_paths()
    return [i for i, p in enumerate(paths)
            if streaming_tt.program_for(tn, p).relayout is not None or i % 16 == 0]


@pytest.mark.parametrize("index", _small_path_cases())
def test_step_program_small_paths_match_plain(index):
    tn, paths = small_tt_paths()
    for tokens in (1, 37):
        _mirror_check(tn, paths[index], tokens, 45)


def test_step_program_free_phase_through_the_workspace_matches_plain():
    tn, path = wide_free_case()
    assert not streaming_tt.program_for(tn, path).free_plan.in_smem
    for tokens in (1, 37):   # rank 64: smaller cores keep the output near 1
        _mirror_check(tn, path, tokens, 46, scale=0.05)


def _all_programs():
    out = []
    for plan_file, name in streaming_cases():
        lp, tn = plan_layer(plan_file, name)
        out.append((plan_file, tn, as_candidate_path(tn, lp["path_steps"])))
    for plan_file, name in dx_cases():
        out.append((plan_file, *dx_network(plan_file, name, 8)))
    return out


@pytest.mark.parametrize("case", range(len(streaming_cases()) + len(dx_cases())))
def test_token_steps_read_dense_operands(case):
    """After the relayout, every token step reads its token-free operand as
    a dense (K, Qp) workspace region that the free phase fills exactly
    once (a copy walking it in order), and its token operand through strides (the
    committed paths read X in place); the last step of every full-width
    path writes Y as whole float4 vectors."""
    plan_file, net, path = _all_programs()[case]
    prog = streaming_tt.program_for(net, path)
    assert prog.relayout is None
    written = {}
    tab = prog.tables.astype(np.int64)

    def walk(m, n):
        stride, off = m
        return tab[off:off + n] if off >= 0 else np.arange(n) * stride

    for op in prog.free_ops:
        rel = walk(op.orow, op.M)[:, None] + walk(op.ocol, op.N)[None, :]
        for o in (op.out + rel).reshape(-1).tolist():
            written[o] = written.get(o, 0) + 1
        if op.b is None:   # a copy walks its destinations: inv inverts the maps
            inv = walk(op.inv, op.dst_len)
            live = inv >= 0
            assert sorted(inv[live].tolist()) == list(range(op.M * op.N))
            assert np.array_equal(np.flatnonzero(live), np.sort(rel.reshape(-1)))
    for op in prog.tok_ops:
        assert isinstance(op.ps, int) and isinstance(op.ks, int) and op.ks in (0, 1)
        dense = op.w + (np.arange(op.K)[:, None] * op.Qp + np.arange(op.Q)[None, :])
        assert all(written.get(o) == 1 for o in dense.reshape(-1).tolist())
    assert all(v == 1 for v in written.values())
    if "pair.decode" not in plan_file:
        assert prog.tok_ops[-1].vec_store


def test_program_is_one_object_for_every_token_count():
    """One program per (network geometry, path): its K split, tables and
    layouts are fixed before any token count is seen, so a row's bits
    cannot depend on the token count."""
    for plan_file, net, path in _all_programs():
        progs = {id(streaming_tt.program_for(streaming_tt._rebatch(net, t), path))
                 for t in (1, 4, 8, 37, 256, 2048)}
        assert len(progs) == 1
        prog = streaming_tt.program_for(net, path)
        for op in prog.tok_ops:
            assert op.G == streaming_tt.k_groups(op.K, op.P, op.Qp)
            assert 1 <= op.G <= min(op.K, streaming_tt.MAX_K_GROUPS)


def test_kernel_token_block_fits_shared_memory():
    """Full-width families stream at any token count in 4-token multiples
    under the shared-memory limit, over half the SMs or more at decode
    sizes; a
    path whose single tile overflows shared memory is refused."""
    families = dict(model_dse_layers(get_config("tt-lm-100m"), tokens=256))
    for name in ("attn.wq[0]", "mlp.wg[0]", "mlp.wd[0]"):
        tn = families[name]
        prog = streaming_tt.compile_program(tn, find_topk_paths(tn, k=1)[0].steps)
        for tokens in (1, 4, 32, 37, 2048, 5000):
            g = streaming_tt.launch_grid(prog, tokens, n_sm=132)
            assert g.tile in streaming_tt.TILES and g.tile * g.n_tiles >= tokens
            assert g.smem_bytes <= streaming_tt.SMEM_LIMIT_BYTES
            assert g.blocks <= g.n_tiles and 1 <= g.slices <= prog.tok_ops[-1].Qp // 4
            if tokens <= 32:   # a short call still spreads over the card
                assert g.blocks * g.slices >= min(66, g.n_tiles * prog.tok_ops[-1].Qp // 32)
    # X meets its last core first: 64^3 floats per token before any merge
    wide = tt_linear_network(8, (64, 64, 64), (8, 8, 8), (64,) * 5)
    steps = ((5, 6), (4, 5), (3, 4), (2, 3), (1, 2), (0, 1))
    with pytest.raises(ValueError, match="shared memory"):
        streaming_tt.launch_grid(streaming_tt.compile_program(wide, steps), 8)


def test_plain_versions_do_not_count_launches():
    launches.reset()
    a = torch.ones(8, 8)
    tt_gemm.tt_gemm(a, a, dataflow="WS")
    tn = tt_linear_network(4, (4, 4), (4, 4), (4, 4, 4))
    cores = [torch.ones(n.dims) for n in tn.nodes if n.name != "X"]
    ops.tt_linear(torch.ones(4, 16), cores, tn, find_topk_paths(tn, k=1)[0], 4)
    assert all(v == 0 for v in launches.snapshot().values())


# ---------------------------------------------------------------------------
# bf16 operands: fp32 fold, one cast to out_dtype (the reference's
# tests/test_kernels.py:38-51 and tests/test_fused_exec.py:243-255)
# ---------------------------------------------------------------------------

#: the reference's bf16 tolerance (``tests/test_kernels.py:47``)
BF16_TOL = dict(rtol=8e-2, atol=8e-2)


def _bf16(x: np.ndarray) -> torch.Tensor:
    """fp32 data rounded to bf16 (to nearest even, as ``jnp.asarray`` rounds)."""
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_gemm_bf16_vs_pallas(dataflow):
    a, b = _np((64, 64), 7), _np((64, 64), 8)
    want = ref_ops.gemm(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                        dataflow=dataflow, block_m=32, block_k=32, block_n=32,
                        interpret=True)
    got = ops.gemm(_bf16(a), _bf16(b), dataflow=dataflow, block_m=32,
                   block_k=32, block_n=32)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **BF16_TOL)


@pytest.mark.parametrize("shape", [(64, 256, 48), (100, 512, 33), (16, 640, 8)])
def test_gemm_bf16_dataflows_bit_identical(shape):
    """Every dataflow folds its k-blocks in fp32 and casts once, so the bf16
    results agree bit for bit (K deep enough that a bf16 fold would not)."""
    m, k, n = shape
    a, b = _bf16(_np((m, k), m * 31 + n)), _bf16(_np((k, n), m * 31 + n + 1))
    outs = [ops.gemm(a, b, dataflow=df) for df in DATAFLOWS]
    assert all(o.dtype == torch.bfloat16 for o in outs)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    want = ref_ops.gemm(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                        jnp.asarray(b.float().numpy(), jnp.bfloat16),
                        dataflow="OS", interpret=True)
    np.testing.assert_allclose(outs[0].float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("in_modes,out_modes,rank", [
    ((4, 4), (4, 4), 4),
    ((2, 4, 4), (4, 4, 2), 4),
])
def test_tt_linear_bf16_vs_pallas(in_modes, out_modes, rank):
    block = 8
    ranks = (rank,) * (len(in_modes) + len(out_modes) - 1)
    ref_tn = ref_block_network(block, in_modes, out_modes, ranks)
    ref_path = ref_find_topk_paths(ref_tn, k=1)[0]
    tn = tt_linear_network(block, in_modes, out_modes, ranks)
    path = find_topk_paths(tn, k=1)[0]
    cores = [_np(n.dims, 31 + i, 0.3) for i, n in enumerate(tn.nodes) if n.name != "X"]
    x = _np((24, int(np.prod(in_modes))), 32)
    want = ref_ops.tt_linear(jnp.asarray(x, jnp.bfloat16),
                             [jnp.asarray(c, jnp.bfloat16) for c in cores],
                             ref_tn, ref_path, block_tokens=block, interpret=True)
    got = ops.tt_linear(_bf16(x), [_bf16(c) for c in cores], tn, path,
                        block_tokens=block)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **BF16_TOL)


def _out_dtype_calls():
    """(name, call(tensors, out_dtype)) for each wrapper with ``out_dtype``."""
    tn = tt_linear_network(8, (2, 4, 4), (4, 4, 2), (4,) * 5)
    path = find_topk_paths(tn, k=1)[0]
    from test_torch_cuda import _chain_case

    work, chain = _chain_case(37, False)
    return {
        "gemm": ([_np((40, 70), 41), _np((70, 24), 42)],
                 lambda t, dt: ops.gemm(t[0], t[1], block_k=16, out_dtype=dt)),
        "tt_linear": ([_np((24, 32), 43)] + [_np(n.dims, 44 + i, 0.3) for i, n in
                                             enumerate(tn.nodes) if n.name != "X"],
                      lambda t, dt: ops.tt_linear(t[0], t[1:], tn, path,
                                                  block_tokens=8, out_dtype=dt)),
        "fused_segment": ([w.numpy() for _, w in work],
                          lambda t, dt: ops.fused_segment(
                              [(e, v) for (e, _), v in zip(work, t)], chain,
                              block_m=32, block_k=8, block_n=16,
                              out_dtype=dt)[1]),
    }


@pytest.mark.parametrize("kind", ["gemm", "tt_linear", "fused_segment"])
def test_out_dtype(kind):
    """``out_dtype`` is the one cast of the fp32 fold: bf16 operands with
    ``out_dtype=float32`` give the fp32 result of the widened operands bit
    for bit, and the default is the (streamed) operand's dtype."""
    arrays, call = _out_dtype_calls()[kind]
    bf = [_bf16(x) for x in arrays]
    widened = call([t.float() for t in bf], None)
    got = call(bf, torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, widened)
    assert call(bf, None).dtype == torch.bfloat16
    assert torch.equal(call(bf, None), widened.to(torch.bfloat16))
    assert call([torch.from_numpy(x) for x in arrays], torch.bfloat16).dtype \
        == torch.bfloat16


def test_fused_segment_bf16_vs_pallas_and_per_step_rounding():
    """K5 keeps its interior in fp32 in bf16 too (the reference's fused
    kernel), while the per-step route rounds each step to bf16 (the
    reference's ``gemm_contract``): both within the bf16 tolerance of the
    reference's fused kernel."""
    from test_torch_cuda import _chain_case

    work, chain = _chain_case(37, True)
    work = [(e, t.to(torch.bfloat16)) for e, t in work]
    ec, got = ops.fused_segment(work, chain, block_m=32, block_k=8, block_n=16)
    rec, want = ref_ops.fused_segment(
        [(e, jnp.asarray(t.float().numpy(), jnp.bfloat16)) for e, t in work],
        chain, block_tokens=16, block_m=32, block_k=8, block_n=16, interpret=True)
    assert ec == rec and got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **BF16_TOL)
    contract = ops.gemm_contract("OS", 32, 8, 16)
    w = list(work)
    for (i, j) in chain:
        w = _replay_step(w, i, j, contract)
        assert w[-1][1].dtype == torch.bfloat16
    np.testing.assert_allclose(w[-1][1].float().numpy(), np.asarray(want, np.float32),
                               **BF16_TOL)


def _replay_step(work, i, j, contract):
    (ea, ta), (eb, tb) = work[i], work[j]
    shared = [x for x in ea if x in eb]
    val = contract(ta, tb, ([ea.index(x) for x in shared],
                            [eb.index(x) for x in shared]))
    ec = tuple(x for x in ea if x not in shared) + tuple(
        x for x in eb if x not in shared)
    return [w for k, w in enumerate(work) if k not in (i, j)] + [(ec, val)]
