"""The kernels' programs and grids at every layer of the committed
full-width train plans of qwen2-moe-a2.7b, zamba2-1.2b and rwkv6-7b, on
the CPU.

Training runs the kernels where no plan gave them work before: K1
(``streaming_tt``) streams each layer's forward and, through the
grad-input network, its dx; K3 (``tt_gemm`` WS) contracts every weight
gradient with K = the tokens of the step (six per layer instance), and
the forward and dx of zamba2's ``ssm.win`` and rwkv6's ``cmk``/``cmr``;
under ``zamba2-1.2b.train.tt_gemm.json`` K5 (``fused_path``) runs the
fused segment of ``ssm.wout`` and of the four shared-attention
projections.  What is plain Python here is what the card runs: K1's
compiled program and launch grid (shared memory included, so a layer K1
would refuse shows without a card), K3's WS grid and K5's program.
Their CPU mirrors are held against the plain versions: within 1e-4 of
the output's scale for K1 (the reference's streaming tolerance), bit for
bit for K3, at 1e-5 (of the output's scale) for K5.

Token counts: 4, 37 (ragged) and 2048 (the plans' ``--tokens``, a batch of
4 x 512); the MoE experts also at 172, the capacity slots of one expert
call at 2048 tokens (4 routing groups of 512, 43 slots each).  The tied
LM heads never execute and are left out.  The plans' bytes are held to
both DSEs by ``tests/test_torch_plan.py`` and ``tests/test_torch_dse_cli.py``
(the four files are entries of their ``EMIT``).
"""

from __future__ import annotations

import functools
import math
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.backward import backward_networks, grad_input_network
from repro_torch.dse_cli import model_dse_layers
from repro_torch.kernels import fused_path, ops, streaming_tt, tt_gemm
from repro_torch.nn.moe import MoESpec
from repro_torch.plan import load_plan

torch.set_num_threads(2)

PLANS = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"
TRAIN_PLANS = {"qwen2-moe-a2.7b": "qwen2-moe-a2.7b.train.json",
               "zamba2-1.2b": "zamba2-1.2b.train.json",
               "rwkv6-7b": "rwkv6-7b.train.json"}
FUSED_PLAN = "zamba2-1.2b.train.tt_gemm.json"
TOKENS = 2048


def _expert_slots(arch: str, tokens: int) -> int:
    """Capacity slots of one expert call at ``tokens`` (``nn/moe.py``)."""
    cfg = get_config(arch)
    spec = MoESpec("moe", cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.moe_top_k,
                   capacity_factor=cfg.capacity_factor)
    g = min(spec.router_group, tokens)
    cap = max(4, min(math.ceil(spec.top_k * g * spec.capacity_factor
                               / spec.n_experts), g))
    return -(-tokens // g) * cap


@functools.lru_cache(maxsize=None)
def _families(arch: str) -> dict:
    out = {}
    for inst, tn in model_dse_layers(get_config(arch), 1024):
        out.setdefault(inst.split("[")[0], tn)
    return out


def _layers(plan_file: str, backend: str):
    arch = plan_file.split(".train")[0]
    assert get_config(arch).tie_embeddings
    return [(lp, _families(arch)[lp.name])
            for lp in load_plan(str(PLANS / plan_file)).layers
            if lp.backend == backend and lp.name != "head"]


def _token_counts(name: str) -> tuple[int, ...]:
    extra = (_expert_slots("qwen2-moe-a2.7b", TOKENS),) if name.startswith("moe.e") else ()
    return (4, 37, TOKENS) + extra


def test_expert_calls_carry_172_slots_at_2048_tokens():
    assert _expert_slots("qwen2-moe-a2.7b", TOKENS) == 172   # 172 % 8 == 4


def test_train_plans_put_the_expected_layers_on_each_kernel():
    """Every layer WS; K1 forward and dx everywhere but zamba2's ssm.win and
    rwkv6's cmk/cmr (K3 forward and dx); six K3 weight gradients per layer;
    under the tt_gemm plan a two-step fused segment at ssm.wout and each
    shared-attention projection."""
    gemm = {a: sorted(lp.name for lp, _ in _layers(f, "tt_gemm"))
            for a, f in TRAIN_PLANS.items()}
    assert gemm == {"qwen2-moe-a2.7b": [], "zamba2-1.2b": ["ssm.win"],
                    "rwkv6-7b": ["rwkv.cmk", "rwkv.cmr"]}
    for f in TRAIN_PLANS.values():
        plan = load_plan(str(PLANS / f))
        assert plan.tokens == TOKENS and {lp.dataflow for lp in plan.layers} == {"WS"}
        for lp in plan.layers:
            by = {op.wrt: op.backend for op in lp.backward}
            assert by.pop("dx") == lp.backend
            assert by == {f"G{k}": "tt_gemm" for k in range(1, 7)}
    fused = {lp.name: lp.segments for lp, _ in _layers(FUSED_PLAN, "tt_gemm")
             if any(e - s >= 2 for s, e in lp.segments or ())}
    assert sorted(fused) == ["shared_attn.wk", "shared_attn.wo", "shared_attn.wq",
                             "shared_attn.wv", "ssm.wout"]


def _check_k1(tn, steps, tokens, block, gen, label):
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


@pytest.mark.parametrize("arch", sorted(TRAIN_PLANS))
def test_k1_forward_and_dx_programs_at_every_streaming_layer(arch):
    """K1's program and grid at each streaming layer's forward network and
    dx (grad-input) network, along the planned paths, at every token count:
    within the shared-memory limit, the mirror against the plain version."""
    gen = torch.Generator().manual_seed(0)
    layers = _layers(TRAIN_PLANS[arch], "streaming_tt")
    assert layers
    worst = 0
    for lp, tn in layers:
        dx = next(op for op in lp.backward if op.wrt == "dx")
        for tokens in _token_counts(lp.name):
            worst = max(worst, _check_k1(tn, lp.path_steps, tokens,
                                         lp.tiling.block_tokens, gen,
                                         (lp.name, "fwd", tokens)))
            worst = max(worst, _check_k1(grad_input_network(tn), dx.path_steps,
                                         tokens, dx.tiling.block_tokens, gen,
                                         (lp.name, "dx", tokens)))
    assert worst > 0


def _gemm_cases(plan_file: str):
    """(layer, M, K, N, blocks) of every GEMM a train step runs on tt_gemm
    at 2048 tokens (the experts at their 172 slots): the forward of a
    tt_gemm layer without fused segments and each tt_gemm backward op."""
    cases = set()
    for lp in load_plan(str(PLANS / plan_file)).layers:
        if lp.name == "head":
            continue
        tn0 = _families(plan_file.split(".train")[0])[lp.name]
        tokens = _token_counts(lp.name)[-1] if lp.name.startswith("moe.e") else TOKENS
        tn = streaming_tt._rebatch(tn0, tokens)
        seqs = []
        if lp.backend == "tt_gemm" and not any(e - s >= 2 for s, e in lp.segments or ()):
            seqs.append((tn, lp.path_steps, lp.tiling))
        nets = dict(backward_networks(tn))
        seqs += [(nets[op.wrt], op.path_steps, op.tiling) for op in lp.backward
                 if op.backend == "tt_gemm"]
        for net, steps, t in seqs:
            for g in net.gemm_sequence(steps):
                cases.add((lp.name, g.M, g.K, g.N, ops.clamp_block(t.block_m, g.M),
                           ops.clamp_block(t.block_k, g.K),
                           ops.clamp_block(t.block_n, g.N)))
    return sorted(cases)


@pytest.mark.parametrize("plan_file", sorted(TRAIN_PLANS.values()) + [FUSED_PLAN])
def test_ws_grids_at_every_train_gemm_equal_plain(plan_file):
    """K3's WS grid at each GEMM of a train step (weight gradients with
    K = 2048 tokens or 172 slots, tt_gemm forwards and dx): the mirror
    equals the plain OS fold bit for bit, on 132 SMs and on 7."""
    cases = _gemm_cases(plan_file)
    assert any(k >= 172 for _, _, k, _, _, _, _ in cases)
    for i, (name, m, k, n, bm, bk, bn) in enumerate(cases):
        rng = np.random.default_rng(i)
        a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
        blocks = dict(block_m=bm, block_k=bk, block_n=bn)
        want = tt_gemm.tt_gemm_plain(a, b, dataflow="OS", **blocks)
        assert torch.equal(tt_gemm.tt_gemm_plain(a, b, dataflow="WS", **blocks), want)
        for n_sm in (132, 7):
            g = tt_gemm.ws_grid(m, k, n, n_sm=n_sm, **blocks)
            assert torch.equal(tt_gemm.run_ws_grid_plain(a, b, g), want), \
                (plan_file, name, m, k, n, n_sm)


def _replay_shapes(work, steps):
    for (i, j) in steps:
        (ea, da), (eb, db) = work[i], work[j]
        shared = [x for x in ea if x in eb]
        ec = tuple(x for x in ea if x not in shared) + tuple(x for x in eb if x not in shared)
        dc = tuple(d for x, d in zip(ea, da) if x not in shared) + tuple(
            d for x, d in zip(eb, db) if x not in shared)
        work = [w for k, w in enumerate(work) if k not in (i, j)] + [(ec, dc)]
    return work


@pytest.mark.parametrize("tokens", [37, TOKENS])
def test_fused_segment_programs_of_the_tt_gemm_train_plan(tokens):
    """K5's program (the token block the card picks, on 132 SMs) at each
    fused segment of ``zamba2-1.2b.train.tt_gemm.json``: the mirror of its
    tables against the plain version, at rtol 1e-5 and atol 1e-5 of the
    output's scale (outputs reach ~20 at full width, where two fp32 sum
    orders part by ~1e-5)."""
    layers = [(lp, tn) for lp, tn in _layers(FUSED_PLAN, "tt_gemm")
              if any(e - s >= 2 for s, e in lp.segments or ())]
    assert len(layers) == 5
    gen = torch.Generator().manual_seed(1)
    for lp, tn0 in layers:
        tn = streaming_tt._rebatch(tn0, tokens)
        steps = [tuple(s) for s in lp.path_steps]
        s, e = next(g for g in lp.segments if g[1] - g[0] >= 2)
        entries = _replay_shapes([(n.edges, n.dims) for n in tn.nodes], steps[:s])
        work = [(ed, torch.randn(d, generator=gen) * 0.3) for ed, d in entries]
        t = lp.tiling
        prog = fused_path.program_for(work, steps[s:e], block_k=t.block_k,
                                      block_tokens=t.block_tokens)
        assert prog.smem_bytes <= fused_path.SMEM_LIMIT_BYTES
        _, want = fused_path.fused_segment_contract_plain(
            work, steps[s:e], block_m=t.block_m, block_k=t.block_k, block_n=t.block_n)
        got = fused_path.run_program_plain(prog, [work[p][1] for p in prog.input_positions])
        scale = max(1.0, want.abs().max().item())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=lp.name)
