"""The kernels' programs and grids at every layer of the committed
full-width plan pairs of qwen2-moe-a2.7b, zamba2-1.2b and rwkv6-7b, on
the CPU.

These plans put K1 (``streaming_tt``) and K2-K4 (``tt_gemm``) on networks
no tt-lm-100m plan gave them: the MoE experts' d_ff 1408 (= 11 x 128, an
out mode of 11), zamba2's in-projection 2048 -> 8384 (= 131 x 64, a prime
mode) and rwkv6's 16 x 16 x 16 inputs with the channel mix's 14336.  What
is plain Python here is what the card runs: K1's compiled program and
launch grid (shared memory included, so a layer K1 would refuse shows
without a card) and the OS/IS/WS grids of K2-K4.  Their CPU mirrors are
held against the plain versions: within 1e-4 of the output's scale for
K1 (the reference's streaming tolerance), bit for bit for the GEMMs.

Every ``streaming_tt`` layer runs along its planned path at 4 tokens (a
decode step of 4 lanes, and one expert's 4 capacity slots), 32 (a served
prompt) and 2048; every ``tt_gemm`` layer's GEMMs at 32, 37 and 1
tokens with the plan's blocks clamped as the executor clamps them.  The
tied LM heads never execute and are left out.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dse_cli import model_dse_layers
from repro_torch.kernels import ops, streaming_tt, tt_gemm
from repro_torch.plan import load_plan
from repro_torch.plan.executor import as_candidate_path

torch.set_num_threads(2)

PLANS = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"
ARCHS = ("qwen2-moe-a2.7b", "zamba2-1.2b", "rwkv6-7b")
PHASES = ("prefill", "decode")


@functools.lru_cache(maxsize=None)
def _families(arch: str) -> dict:
    """Projection family -> its network at 1024 tokens."""
    out = {}
    for inst, tn in model_dse_layers(get_config(arch), 1024):
        out.setdefault(inst.split("[")[0], tn)
    return out


def _layers(arch: str, phase: str, backend: str):
    plan = load_plan(str(PLANS / f"{arch}.pair.{phase}.json"))
    assert get_config(arch).tie_embeddings
    return [(lp, _families(arch)[lp.name]) for lp in plan.layers
            if lp.backend == backend and lp.name != "head"]


def test_plans_put_the_expected_layers_on_each_kernel():
    """K1 everywhere in decode but for the MoE's eg/eu (plain); K3 (tt_gemm
    WS) at zamba2's ssm.win and rwkv6's cmk/cmr in prefill."""
    gemm = {a: sorted(lp.name for lp, _ in _layers(a, "prefill", "tt_gemm"))
            for a in ARCHS}
    assert gemm == {"qwen2-moe-a2.7b": [], "zamba2-1.2b": ["ssm.win"],
                    "rwkv6-7b": ["rwkv.cmk", "rwkv.cmr"]}
    for a in ARCHS:
        assert not _layers(a, "decode", "tt_gemm")
        for lp, _ in _layers(a, "prefill", "tt_gemm"):
            assert lp.dataflow == "WS" and not lp.segments
    plain = load_plan(str(PLANS / "qwen2-moe-a2.7b.pair.decode.json"))
    assert sorted(lp.name for lp in plain.layers if lp.backend == "jnp") == \
        ["moe.eg", "moe.eu"]
    ssm_win = _families("zamba2-1.2b")["ssm.win"]
    assert any(131 in n.dims for n in ssm_win.nodes)     # 8384 = 131 x 64


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_streaming_program_and_grid_at_every_planned_layer(arch, phase):
    gen = torch.Generator().manual_seed(0)
    layers = _layers(arch, phase, "streaming_tt")
    assert layers
    for lp, tn in layers:
        cores = [torch.randn(n.dims, generator=gen) * 0.2
                 for n in tn.nodes if n.kind != "input"]
        for tokens in (4, 32, 2048):
            bt = ops.clamp_block(lp.tiling.block_tokens, tokens)
            tn_b = streaming_tt._rebatch(tn, bt)
            cp = as_candidate_path(tn_b, lp.path_steps)
            prog = streaming_tt.program_for(tn_b, cp)
            grid = streaming_tt.launch_grid(prog, tokens)
            assert grid.smem_bytes <= streaming_tt.SMEM_LIMIT_BYTES, \
                (arch, lp.name, tokens, grid.smem_bytes)
            x = torch.randn(tokens, prog.n_in, generator=gen)
            got = streaming_tt.run_program_plain(prog, x, cores)
            want = streaming_tt.streaming_tt_linear_plain(x, cores, tn_b, cp)
            tol = 1e-4 * max(1.0, want.abs().max().item())
            err = (got - want).abs().max().item()
            assert err <= tol, (arch, phase, lp.name, tokens, err)


def _gemm_cases():
    """(arch, layer, M, K, N, blocks) of every GEMM the prefill plans run
    on tt_gemm, at 32, 37 and 1 tokens."""
    cases = set()
    for arch in ARCHS:
        for lp, tn in _layers(arch, "prefill", "tt_gemm"):
            for t in (32, 37, 1):
                for g in streaming_tt._rebatch(tn, t).gemm_sequence(lp.path_steps):
                    cases.add((arch, lp.name, g.M, g.K, g.N,
                               ops.clamp_block(lp.tiling.block_m, g.M),
                               ops.clamp_block(lp.tiling.block_k, g.K),
                               ops.clamp_block(lp.tiling.block_n, g.N)))
    return sorted(cases)


GEMMS = _gemm_cases()


@pytest.mark.parametrize("n_sm", [132, 7])
def test_gemm_grids_at_every_planned_shape_equal_plain(n_sm):
    """OS, IS and WS grids at every tt_gemm shape of the prefill plans:
    each mirror equals the plain version bit for bit, and WS == OS == IS."""
    assert any(m % 131 == 0 for _, _, m, _, _, _, _, _ in GEMMS)
    for i, (arch, name, m, k, n, bm, bk, bn) in enumerate(GEMMS):
        rng = np.random.default_rng(i)
        a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
        blocks = dict(block_m=bm, block_k=bk, block_n=bn)
        want = tt_gemm.tt_gemm_plain(a, b, dataflow="OS", **blocks)
        for df in ("WS", "IS"):
            assert torch.equal(tt_gemm.tt_gemm_plain(a, b, dataflow=df, **blocks), want)
        for make in (tt_gemm.os_grid, tt_gemm.is_grid):
            g = make(m, k, n, n_sm=n_sm, **blocks)
            assert g.smem_bytes <= tt_gemm.SMEM_LIMIT_BYTES
            assert torch.equal(tt_gemm.run_band_grid_plain(a, b, g), want), \
                (arch, name, m, k, n)
        g = tt_gemm.ws_grid(m, k, n, n_sm=n_sm, **blocks)
        assert torch.equal(tt_gemm.run_ws_grid_plain(a, b, g), want), \
            (arch, name, m, k, n)
