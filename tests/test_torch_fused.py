"""The fused-segment kernel (K5): port against the JAX package, and against
the port's own per-step route.

* ``_compile_segment`` is host bookkeeping: the port's output equals the
  reference's exactly.
* ``fused_segment_contract_plain`` against the reference's
  ``fused_segment_contract`` in Pallas interpret mode at rtol/atol 1e-5,
  the GEMM tolerance of ``tests/test_kernels.py:34``: both sum in fp32, in
  another order.
* Inside the port, fused == the per-step ``tt_gemm`` route bit for bit
  (the reference's contract, ``src/repro/kernels/fused_path.py:14-28``).
* The offset tables the CUDA kernel reads are checked through their torch
  mirror ``run_program_plain``; the kernel itself is held against the
  plain version and the per-step CUDA route in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as ref_fusion
from repro.core.paths import find_topk_paths as ref_find_topk_paths
from repro.core.tensor_network import tt_linear_network as ref_tt_linear_network
from repro.kernels import fused_path as ref_fused
from repro_torch.kernels import fused_path, launches, ops
from repro_torch.plan import LayerPlan, Tiling, execution_log, reset_execution_log
from repro_torch.plan.executor import planned_tt_linear
from test_torch_cuda import (FUSED_EXAMPLE, _chain_case, _replay, _segment,
                             fused_example, segment_cases)

torch.set_num_threads(2)

DATAFLOWS = ("OS", "WS", "IS")
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("plan_file,name,tokens", segment_cases())
def test_compile_segment_equals_reference(plan_file, name, tokens):
    work, chain, _ = _segment(plan_file, name, tokens)
    assert fused_path._compile_segment(work, chain, "b") == \
        ref_fused._compile_segment(work, chain, "b")


@pytest.mark.parametrize("mid_as_a", [False, True])
@pytest.mark.parametrize("tokens", [1, 37, 64])
@pytest.mark.parametrize("blocks", [(128, 128, 128), (32, 8, 16), (8, 16, 8)])
def test_fused_plain_matches_pallas_fused(blocks, tokens, mid_as_a):
    work, chain = _chain_case(tokens, mid_as_a)
    bm, bk, bn = blocks
    ec, got = fused_path.fused_segment_contract_plain(
        work, chain, block_m=bm, block_k=bk, block_n=bn)
    rec, want = ref_fused.fused_segment_contract(
        [(e, jnp.asarray(t.numpy())) for e, t in work], chain, block_tokens=16,
        block_m=bm, block_k=bk, block_n=bn, interpret=True)
    assert ec == tuple(rec)
    assert ec.index("b") == (0 if mid_as_a else len(ec) - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("plan_file,name,tokens", segment_cases(max_tokens=256))
def test_fused_plain_matches_pallas_on_plan_segments(plan_file, name, tokens):
    entries, chain, lp = _segment(plan_file, name, tokens)
    work = [(e, torch.from_numpy(_np(d, 20 + k, 0.3)))
            for k, (e, d) in enumerate(entries)]
    t = lp["tiling"]
    ec, got = fused_path.fused_segment_contract_plain(
        work, chain, block_m=t["block_m"], block_k=t["block_k"],
        block_n=t["block_n"])
    rec, want = ref_fused.fused_segment_contract(
        [(e, jnp.asarray(v.numpy())) for e, v in work], chain,
        block_tokens=t["block_tokens"], block_m=t["block_m"],
        block_k=t["block_k"], block_n=t["block_n"], interpret=True)
    assert ec == tuple(rec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _plan_segment(plan_file, name, tokens, seed):
    entries, chain, lp = _segment(plan_file, name, tokens)
    work = [(e, torch.from_numpy(_np(d, seed + k, 0.3)))
            for k, (e, d) in enumerate(entries)]
    t = lp["tiling"]
    blocks = dict(block_m=t["block_m"], block_k=t["block_k"], block_n=t["block_n"])
    return entries, work, chain, t["block_tokens"], blocks


@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("plan_file,name,tokens", segment_cases(max_tokens=256))
def test_fused_equals_per_step_route_bit_for_bit(plan_file, name, tokens, dataflow):
    """The fused chain (the plain version on the CPU) against the per-step
    ``tt_gemm`` route under each dataflow."""
    _, work, chain, bt, blocks = _plan_segment(plan_file, name, tokens, 30)
    ec, fused = ops.fused_segment(work, chain, block_tokens=bt, **blocks)
    contract = ops.gemm_contract(dataflow=dataflow, **blocks)
    w = list(work)
    for (i, j) in chain:
        w = _replay(w, i, j, contract)
    assert w[-1][0] == ec
    assert torch.equal(w[-1][1], fused)


@pytest.mark.parametrize("plan_file,name,tokens", segment_cases(max_tokens=256))
def test_offset_tables_mirror_the_plain_version(plan_file, name, tokens):
    """The tables the CUDA kernel reads, executed by their torch mirror at
    several token blocks, against the plain version."""
    entries, work, chain, _, blocks = _plan_segment(plan_file, name, tokens, 40)
    _, want = fused_path.fused_segment_contract_plain(work, chain, **blocks)
    for bt in (1, 8, 16):
        prog = fused_path.compile_program(entries, chain, block_k=blocks["block_k"],
                                          block_tokens=bt)
        got = fused_path.run_program_plain(
            prog, [work[p][1] for p in prog.input_positions])
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("tokens", [12, 100])
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_segmented_layer_equals_unsegmented_bit_for_bit(tokens, dataflow):
    """The executor with the reference compiler's segmentation against the
    same layer without segments (the reference's property test)."""
    in_modes, out_modes, ranks = (8, 8), (8, 8), (4, 8, 4)
    tn = ref_tt_linear_network(tokens, in_modes, out_modes, ranks)
    steps = tuple(tuple(s) for s in ref_find_topk_paths(tn, k=1)[0].steps)
    segs = ref_fusion.segment_path(tn, steps, block_tokens=32,
                                   budget_bytes=8 * 2**20)
    assert ref_fusion.has_fused(segs)

    def lp(segments):
        return LayerPlan(name="l", path_index=0, path_steps=steps,
                         dataflow=dataflow, partitioning=(1, 1),
                         backend="tt_gemm", tiling=Tiling(block_tokens=32),
                         segments=segments)

    x = torch.from_numpy(_np((tokens, 64), 1))
    cores = [torch.from_numpy(_np(n.dims, 2 + k))
             for k, n in enumerate(tn.nodes) if n.kind != "input"]
    plain = planned_tt_linear(lp(None), x, cores, in_modes, out_modes, ranks)
    reset_execution_log()
    seg = planned_tt_linear(lp(segs), x, cores, in_modes, out_modes, ranks)
    assert torch.equal(plain, seg)
    recs = [r for r in execution_log() if "segment" in r]
    assert [tuple(r["segment"]) for r in recs] == list(segs)


def test_the_references_counterexample_is_bit_identical_here():
    """At the example where the reference's fused == per-step property
    fails in the last ulp (interpret mode; ``FUSED_EXAMPLE``), the port
    segments the path as the reference compiler does, and its fused route
    (K5's plain version) equals its per-step route bit for bit, one record
    per segment."""
    e = FUSED_EXAMPLE
    per_step, segmented, x, cores, geometry = fused_example("cpu")
    tn = ref_tt_linear_network(e["tokens"], e["in_modes"], e["out_modes"], e["ranks"])
    paths = ref_find_topk_paths(tn, k=4)
    steps = tuple(tuple(s) for s in paths[min(e["path_idx"], len(paths) - 1)].steps)
    assert steps == segmented.path_steps
    assert segmented.segments == ref_fusion.segment_path(
        tn, steps, block_tokens=e["block_tokens"],
        budget_bytes=e["budget_kib"] * 1024) == ((0, 1), (1, 2), (2, 4))
    plain = planned_tt_linear(per_step, x, cores, *geometry)
    reset_execution_log()
    seg = planned_tt_linear(segmented, x, cores, *geometry)
    assert torch.equal(plain, seg)
    recs = [r for r in execution_log() if "segment" in r]
    assert [tuple(r["segment"]) for r in recs] == list(segmented.segments)


def test_segment_smem_bytes_known_shapes():
    """fp32 interior (token block x 16, rounded to 4 floats) plus the
    staging tiles of the largest round, which takes as many k-blocks as
    fit in 24 576 floats.  Full-width attn.wq at a 16-token block: a 16 x
    16 interior; its first step (16 x 768 @ 768 x 16, block_k 128) stages
    5 k-blocks a round, a 16 x (640 + 4) A tile and a 640 x 16 B tile."""
    entries, chain, lp = _segment("tt-lm-100m.train.tt_gemm.json", "attn.wq", 64)
    work = [(e, torch.zeros(d)) for e, d in entries]
    assert fused_path.segment_smem_bytes(work, chain, block_tokens=16,
                                         block_k=128) == \
        4 * (16 * 16 + 16 * (640 + 4) + 640 * 16)
    # mlp.wg plans block_k 16: its first step stages 47 k-blocks of 16 a
    # round (752 of the 768), more than the second step's tiles need
    entries, chain, _ = _segment("tt-lm-100m.train.tt_gemm.json", "mlp.wg", 64)
    work = [(e, torch.zeros(d)) for e, d in entries]
    assert fused_path.segment_smem_bytes(work, chain, block_tokens=16,
                                         block_k=16) == \
        4 * (16 * 16 + 16 * (752 + 4) + 752 * 16)


def test_choose_block_tokens_fills_the_card():
    entries, chain, _ = _segment("tt-lm-100m.train.tt_gemm.json", "mlp.wd", 2048)
    # 2048 tokens: halve from 64 until the call has >= 132 blocks
    assert fused_path.choose_block_tokens(entries, chain, block_k=128,
                                          plan_block=256) == 8
    assert fused_path.choose_block_tokens(entries, chain, block_k=128,
                                          plan_block=256, n_sm=16) == 64
    assert fused_path.choose_block_tokens(entries, chain, block_k=128,
                                          plan_block=4, n_sm=16) == 4
    prog = fused_path.compile_program(entries, chain, block_k=128, block_tokens=8)
    assert prog.n_token_blocks == 256
    # 37 tokens: the block is not cut below 8 tokens, so 5 blocks
    entries, chain, _ = _segment("tt-lm-100m.train.tt_gemm.json", "mlp.wd", 37)
    bt = fused_path.choose_block_tokens(entries, chain, block_k=128, plan_block=256)
    prog = fused_path.compile_program(entries, chain, block_k=128, block_tokens=bt)
    assert bt == 8 and prog.n_token_blocks == 5


def _smoke_train_segments():
    return [c for c in segment_cases()
            if c[0] in ("tt-lm-smoke.train.tt_gemm.json", "tt-lm-smoke.tt_gemm.json")
            and c[2] == 37]


@pytest.mark.parametrize("block_tokens", [1, 2, 4, 8, 16, 24, 32, 48, 64])
@pytest.mark.parametrize("tokens", [1, 37, 100])
@pytest.mark.parametrize("plan_file,name,_tokens", _smoke_train_segments())
def test_offset_tables_mirror_with_packs(plan_file, name, _tokens, tokens,
                                         block_tokens):
    """The packed batch-free operands at 1-64-token blocks (powers of two
    and not) and ragged token counts, through the torch mirror of the
    kernel's grid, against the plain version."""
    entries, work, chain, _, blocks = _plan_segment(plan_file, name, tokens, 50)
    _, want = fused_path.fused_segment_contract_plain(work, chain, **blocks)
    prog = fused_path.compile_program(entries, chain, block_k=blocks["block_k"],
                                      block_tokens=block_tokens)
    assert prog.packed_elems == sum(-(-p.rows * p.cols // 4) * 4 for p in prog.packs)
    assert prog.n_token_blocks == -(-tokens // block_tokens)
    got = fused_path.run_program_plain(prog, [work[p][1] for p in prog.input_positions])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("block_tokens", [1, 2, 4, 8, 16, 24, 32, 48, 64])
@pytest.mark.parametrize("tokens", [1, 37])
@pytest.mark.parametrize("mid_as_a", [False, True])
def test_small_chain_mirror_with_packs(mid_as_a, tokens, block_tokens):
    """The mirror on a chain whose interior result is operand A as well as
    B (the last step's packed operand is then B)."""
    work, chain = _chain_case(tokens, mid_as_a)
    _, want = fused_path.fused_segment_contract_plain(work, chain, block_k=8)
    entries = [(e, tuple(t.shape)) for e, t in work]
    prog = fused_path.compile_program(entries, chain, block_k=8,
                                      block_tokens=block_tokens)
    assert prog.steps[-1].w_is_a != mid_as_a
    got = fused_path.run_program_plain(prog, [work[p][1] for p in prog.input_positions])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    work, chain = _chain_case(9, False)
    launches.reset()
    ec, got = fused_path.fused_segment_contract(work, chain)
    assert launches.COUNTS["fused_path"] == 0
    ec2, want = fused_path.fused_segment_contract_plain(work, chain)
    assert ec == ec2 and torch.equal(got, want)
    with pytest.raises(ValueError, match="two steps"):
        fused_path.fused_segment_contract(work, chain[:1])
