"""The kernels' programs and grids at every layer of the committed
full-width chatglm3-6b plans, on the CPU, at the token counts its
sequence-parallel path gives them on 4 ranks and on one device.

chatglm3-6b's d_ff 13 696 = 107 x 128 gives its MLP networks a mode of
107.  Its pair puts every decode projection on K1 (``streaming_tt``) and
the MLP's prefill projections on K3 (``tt_gemm`` WS); its train plan runs
``attn.wq``/``attn.wo`` forward and dx on K1 and the MLP forward, dx and
every weight gradient on K3.  Token counts: a decode step of 16 lanes (4
a rank: the rows split over ``model``), a 32-token prompt (8 a rank under
SP), a 4 x 512 train batch (512 a rank) and their whole counts.  What is
plain Python here is what the card runs: K1's compiled program and launch
grid (shared memory included, so a layer K1 would refuse shows without a
card: the closest, ``attn.wq`` at 512 tokens and more, takes 231 424 of
the 232 448 B a Hopper block can use) and K3's WS grid.  Their CPU
mirrors are held against the plain versions: within 1e-4 of the output's
scale for K1, bit for bit for K3.  The tied LM head never executes and is
left out.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.backward import backward_networks, grad_input_network
from repro_torch.dse_cli import model_dse_layers
from repro_torch.kernels import ops, streaming_tt, tt_gemm
from repro_torch.plan import load_plan

torch.set_num_threads(2)

PLANS = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"
ARCH = "chatglm3-6b"
#: each plan and the token counts it runs at: a rank's and one device's
TOKENS = {"chatglm3-6b.pair.decode.json": (4, 16),
          "chatglm3-6b.pair.prefill.json": (8, 32),
          "chatglm3-6b.train.json": (512, 2048)}


@functools.lru_cache(maxsize=None)
def _families() -> dict:
    out = {}
    for inst, tn in model_dse_layers(get_config(ARCH), 1024):
        out.setdefault(inst.split("[")[0], tn)
    return out


def _layers(plan_file: str, backend: str):
    assert get_config(ARCH).tie_embeddings
    return [(lp, _families()[lp.name]) for lp in load_plan(str(PLANS / plan_file)).layers
            if lp.backend == backend and lp.name != "head"]


def test_plans_put_the_expected_layers_on_each_kernel():
    """K1 at every decode projection; K3 at the MLP's in prefill and train;
    a mode of 107 in the MLP networks; the attention's kv projections (256
    wide, under ``min_dim`` 512) dense and unplanned."""
    k1 = {f: sorted(lp.name for lp, _ in _layers(f, "streaming_tt")) for f in TOKENS}
    assert k1 == {"chatglm3-6b.pair.decode.json": ["attn.wo", "attn.wq", "mlp.wd",
                                                   "mlp.wg", "mlp.wu"],
                  "chatglm3-6b.pair.prefill.json": ["attn.wo", "attn.wq"],
                  "chatglm3-6b.train.json": ["attn.wo", "attn.wq"]}
    for f in ("chatglm3-6b.pair.prefill.json", "chatglm3-6b.train.json"):
        gemm = _layers(f, "tt_gemm")
        assert sorted(lp.name for lp, _ in gemm) == ["mlp.wd", "mlp.wg", "mlp.wu"]
        assert {lp.dataflow for lp, _ in gemm} == {"WS"}
    assert any(107 in n.dims for n in _families()["mlp.wd"].nodes)
    assert "attn.wk" not in _families()


def _check_k1(tn, steps, tokens, block, gen, label) -> int:
    bt = ops.clamp_block(block, tokens)
    tn_b = streaming_tt._rebatch(tn, bt)
    cp = streaming_tt._path_for(tn_b, steps)
    prog = streaming_tt.program_for(tn_b, cp)
    grid = streaming_tt.launch_grid(prog, tokens)
    assert grid.smem_bytes <= streaming_tt.SMEM_LIMIT_BYTES, (label, grid.smem_bytes)
    cores = [torch.randn(n.dims, generator=gen) * 0.2
             for n in tn.nodes if n.kind not in ("input", "grad")]
    x = torch.randn(tokens, prog.n_in, generator=gen)
    got = streaming_tt.run_program_plain(prog, x, cores)
    want = streaming_tt.streaming_tt_linear_plain(x, cores, tn_b, cp)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item()), (label, err)
    return grid.smem_bytes


@pytest.mark.parametrize("plan_file", sorted(TOKENS))
def test_k1_forward_and_dx_programs_at_every_streaming_layer(plan_file):
    gen = torch.Generator().manual_seed(0)
    worst = 0
    for lp, tn in _layers(plan_file, "streaming_tt"):
        dx = [op for op in lp.backward if op.wrt == "dx"]
        for tokens in TOKENS[plan_file]:
            worst = max(worst, _check_k1(tn, lp.path_steps, tokens,
                                         lp.tiling.block_tokens, gen,
                                         (lp.name, "fwd", tokens)))
            for op in dx:
                assert op.backend == "streaming_tt"
                worst = max(worst, _check_k1(grad_input_network(tn), op.path_steps,
                                             tokens, op.tiling.block_tokens, gen,
                                             (lp.name, "dx", tokens)))
    assert worst > 0


def _gemm_cases(plan_file: str, tokens: int):
    """(layer, M, K, N, blocks) of every GEMM a step runs on tt_gemm at
    ``tokens``: each tt_gemm forward and each tt_gemm backward op."""
    cases = set()
    for lp in load_plan(str(PLANS / plan_file)).layers:
        if lp.name == "head":
            continue
        tn = streaming_tt._rebatch(_families()[lp.name], tokens)
        seqs = [(tn, lp.path_steps, lp.tiling)] if lp.backend == "tt_gemm" else []
        nets = dict(backward_networks(tn))
        seqs += [(nets[op.wrt], op.path_steps, op.tiling) for op in lp.backward
                 if op.backend == "tt_gemm"]
        for net, steps, t in seqs:
            for g in net.gemm_sequence(steps):
                cases.add((lp.name, g.M, g.K, g.N, ops.clamp_block(t.block_m, g.M),
                           ops.clamp_block(t.block_k, g.K),
                           ops.clamp_block(t.block_n, g.N)))
    return sorted(cases)


@pytest.mark.parametrize("plan_file,tokens", [("chatglm3-6b.train.json", 512),
                                              ("chatglm3-6b.pair.prefill.json", 8)])
def test_ws_grids_at_every_gemm_equal_plain(plan_file, tokens):
    """K3's WS grid at each GEMM of a rank's step (the train plan's weight
    gradients with K = 512 tokens, tt_gemm forwards and dx; the prefill
    plan's MLP forwards at 8 tokens): the mirror equals the plain OS fold
    bit for bit, on 132 SMs."""
    cases = _gemm_cases(plan_file, tokens)
    assert cases
    for i, (name, m, k, n, bm, bk, bn) in enumerate(cases):
        rng = np.random.default_rng(i)
        a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
        blocks = dict(block_m=bm, block_k=bk, block_n=bn)
        want = tt_gemm.tt_gemm_plain(a, b, dataflow="OS", **blocks)
        g = tt_gemm.ws_grid(m, k, n, n_sm=132, **blocks)
        assert torch.equal(tt_gemm.run_ws_grid_plain(a, b, g), want), (name, m, k, n)
