"""The kernels' programs and grids over the rank space of full-width
tt-lm-100m, on the CPU.

The rank search re-factorizes every projection family (1-4 modes a side,
ranks 4-24: 15 candidates), so K1 (``streaming_tt``) and K2-K4
(``tt_gemm``) meet networks and GEMM shapes no frozen plan gave them:
the served plan's d = 1, rank-4 layers are two-core networks (X . G . G,
no token-free step; a 4-wide operand in every GEMM).  What is plain
Python here is what the card runs: K1's compiled program and launch grid
(shared memory included, so a layer K1 would refuse shows without a
card), and the OS/IS/WS grids of K2-K4.  Their CPU mirrors
(``run_program_plain``, ``run_band_grid_plain``, ``run_ws_grid_plain``)
are held against the plain versions: within 1e-4 of the output's scale
for K1 (the reference's streaming tolerance), bit for bit for the GEMMs.

Each candidate's layers are checked along every top-4 path the DSE ranks
at 1024 tokens (a superset of what any plan of that candidate runs), at
4 and 32 tokens, and along the best (the one every layer of the served
plan takes) at 2048.  The tied LM head never
executes (tt-lm-100m ties it to the embedding) and is left out.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import find_topk_paths
from repro_torch.dse_cli import model_dse_layers
from repro_torch.kernels import ops, streaming_tt, tt_gemm
from repro_torch.plan import load_plan
from repro_torch.plan.executor import as_candidate_path
from repro_torch.rank import RankSpace

torch.set_num_threads(2)

PLANS = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"
CFG = get_config("tt-lm-100m")
CANDIDATES = {c.name: c for c in RankSpace.from_config(CFG).candidates()}


@functools.lru_cache(maxsize=None)
def _families(name: str) -> dict:
    """Family -> network at 1024 tokens under candidate ``name``."""
    out = {}
    for inst, tn in model_dse_layers(CFG, 1024,
                                     factorizations=CANDIDATES[name].factorization_map()):
        fam = inst.split("[")[0]
        if fam != "head":
            out.setdefault(fam, tn)
    return out


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_served_rank_plan_is_a_rank_space_candidate():
    """The committed plan's factorizations are candidate d1_r4's, and each
    layer's path is one of the top-4 the tests below cover."""
    plan = load_plan(str(PLANS / "tt-lm-100m.rank.json"))
    cand = CANDIDATES["d1_r4"]
    assert {lp.name: lp.factorization.triple for lp in plan.layers} == \
        cand.factorization_map()
    for lp in plan.layers:
        if lp.name == "head":
            continue
        tn = _families("d1_r4")[lp.name]
        assert lp.path_steps in [p.steps for p in find_topk_paths(tn, k=4)]
        assert lp.backend == "streaming_tt"


@pytest.mark.parametrize("name", sorted(CANDIDATES))
def test_streaming_program_and_grid_over_the_rank_space(name):
    gen = torch.Generator().manual_seed(0)
    for fam, tn in _families(name).items():
        for rank, path in enumerate(find_topk_paths(tn, k=4)):
            tn_b = streaming_tt._rebatch(tn, 256)
            cp = as_candidate_path(tn_b, path.steps)
            prog = streaming_tt.program_for(tn_b, cp)
            cores = [torch.randn(n.dims, generator=gen) * 0.2
                     for n in tn.nodes if n.kind != "input"]
            for tokens in ((4, 32, 2048) if rank == 0 else (4, 32)):
                grid = streaming_tt.launch_grid(prog, tokens)
                assert grid.smem_bytes <= streaming_tt.SMEM_LIMIT_BYTES
                x = torch.randn(tokens, prog.n_in, generator=gen)
                got = streaming_tt.run_program_plain(prog, x, cores)
                want = streaming_tt.streaming_tt_linear_plain(x, cores, tn_b, cp)
                tol = 1e-4 * max(1.0, want.abs().max().item())
                err = (got - want).abs().max().item()
                assert err <= tol, (name, fam, path.steps, tokens, err)


def test_d1_program_has_two_token_steps_and_only_core_copies():
    """The served layers' network: the first token step reduces d_in into
    the rank (a 4-wide result), the last widens it; the free phase only
    copies the two cores into the workspace."""
    tn = _families("d1_r4")["mlp.wg"]
    path = find_topk_paths(tn, k=1)[0]
    prog = streaming_tt.program_for(streaming_tt._rebatch(tn, 256),
                                    as_candidate_path(tn, path.steps))
    assert [(op.K, op.Q) for op in prog.tok_ops] == [(768, 4), (4, 2048)]
    assert all(op.b is None for op in prog.free_ops) and len(prog.free_ops) == 2


def _rank_gemm_cases():
    """(M, K, N) and the plan's blocks, clamped as the executor clamps
    them, of every GEMM the served rank plan runs on ``tt_gemm`` (decode
    at 4 lanes, prefill at 32, 37 and 1 tokens), and of the MAC-optimal
    path of every candidate at 4 tokens."""
    cases = set()
    plan = load_plan(str(PLANS / "tt-lm-100m.rank.json"))
    for lp in plan.layers:
        if lp.name == "head":
            continue
        tn = _families("d1_r4")[lp.name]
        for t in (4, 32, 37, 1):
            for g in streaming_tt._rebatch(tn, t).gemm_sequence(lp.path_steps):
                cases.add((g.M, g.K, g.N, ops.clamp_block(lp.tiling.block_m, g.M),
                           ops.clamp_block(lp.tiling.block_k, g.K),
                           ops.clamp_block(lp.tiling.block_n, g.N)))
    for name in CANDIDATES:
        for tn in _families(name).values():
            path = find_topk_paths(tn, k=1)[0]
            for g in streaming_tt._rebatch(tn, 4).gemm_sequence(path.steps):
                cases.add((g.M, g.K, g.N, ops.clamp_block(128, g.M),
                           ops.clamp_block(128, g.K), ops.clamp_block(128, g.N)))
    return sorted(cases)


RANK_GEMMS = _rank_gemm_cases()


def test_rank_gemms_include_four_wide_and_four_deep_shapes():
    assert any(n == 4 for _, _, n, _, _, _ in RANK_GEMMS)
    assert any(k == 4 for _, k, _, _, _, _ in RANK_GEMMS)


@pytest.mark.parametrize("n_sm", [132, 7])
def test_gemm_grids_over_the_rank_space_equal_plain(n_sm):
    """OS, IS and WS grids at every rank-space GEMM: each mirror equals the
    plain version bit for bit, and WS == OS == IS."""
    for i, (m, k, n, bm, bk, bn) in enumerate(RANK_GEMMS):
        a, b = torch.from_numpy(_np((m, k), 2 * i)), torch.from_numpy(_np((k, n), 2 * i + 1))
        blocks = dict(block_m=bm, block_k=bk, block_n=bn)
        want = tt_gemm.tt_gemm_plain(a, b, dataflow="OS", **blocks)
        for df in ("WS", "IS"):
            assert torch.equal(tt_gemm.tt_gemm_plain(a, b, dataflow=df, **blocks), want)
        for make in (tt_gemm.os_grid, tt_gemm.is_grid):
            g = make(m, k, n, n_sm=n_sm, **blocks)
            assert g.smem_bytes <= tt_gemm.SMEM_LIMIT_BYTES
            assert torch.equal(tt_gemm.run_band_grid_plain(a, b, g), want), (m, k, n)
        g = tt_gemm.ws_grid(m, k, n, n_sm=n_sm, **blocks)
        assert torch.equal(tt_gemm.run_ws_grid_plain(a, b, g), want), (m, k, n)
