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
from test_torch_cuda import plan_layer, streaming_cases

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

@pytest.mark.parametrize("tokens", [1, 4, 37])
@pytest.mark.parametrize("plan_file,name", streaming_cases())
def test_step_program_matches_plain(plan_file, name, tokens):
    lp, tn = plan_layer(plan_file, name)
    bt = ops.clamp_block(lp["tiling"]["block_tokens"], tokens)
    tn_block = streaming_tt._rebatch(tn, bt)
    path = as_candidate_path(tn_block, lp["path_steps"])
    prog = streaming_tt.program_for(tn_block, path, bt)
    assert prog.smem_bytes <= streaming_tt.SMEM_LIMIT_BYTES
    assert prog.block_tokens <= bt
    cores = [torch.from_numpy(_np(n.dims, 30 + i, 0.2))
             for i, n in enumerate(tn.nodes) if n.kind != "input"]
    x = torch.from_numpy(_np((tokens, prog.n_in), 31))
    want = streaming_tt.streaming_tt_linear_plain(x, cores, tn_block, path)
    got = streaming_tt.run_program_plain(prog, x, cores)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def test_kernel_token_block_fits_shared_memory():
    """Full-width families stream at a power-of-two block under the target;
    a path whose single token overflows shared memory is refused."""
    families = dict(model_dse_layers(get_config("tt-lm-100m"), tokens=256))
    for name in ("attn.wq[0]", "mlp.wg[0]", "mlp.wd[0]"):
        tn = families[name]
        steps = find_topk_paths(tn, k=1)[0].steps
        bt = streaming_tt.choose_block_tokens(tn, steps, 256)
        assert bt & (bt - 1) == 0 and bt >= 1
        assert streaming_tt.compile_program(tn, steps, bt).smem_bytes \
            <= streaming_tt.SMEM_TARGET_BYTES
    wide = tt_linear_network(8, (64, 64, 64), (8,), (64, 64, 64))
    with pytest.raises(ValueError, match="shared memory"):
        streaming_tt.choose_block_tokens(
            wide, find_topk_paths(wide, k=1)[0].steps, 8)


def test_plain_versions_do_not_count_launches():
    launches.reset()
    a = torch.ones(8, 8)
    tt_gemm.tt_gemm(a, a, dataflow="WS")
    tn = tt_linear_network(4, (4, 4), (4, 4), (4, 4, 4))
    cores = [torch.ones(n.dims) for n in tn.nodes if n.name != "X"]
    ops.tt_linear(torch.ones(4, 16), cores, tn, find_topk_paths(tn, k=1)[0], 4)
    assert all(v == 0 for v in launches.snapshot().values())
