"""Int8 gradient compression (``repro_torch.optim.grad_compress``) against
the reference's, on the CPU: codes, scales, dequantized gradients and
error-feedback residuals bit for bit.  Training each family's smoke model
against the reference is in ``test_torch_train_{moe,hybrid,rwkv,vlm}.py``
(the cases of ``_torch_family_train.py``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress_decompress as ref_compress_decompress
from repro.optim import compress_init as ref_compress_init
from repro.optim import int8_quantize as ref_int8_quantize
from repro_torch.optim import compress_decompress, compress_init, int8_quantize
from repro_torch.tree import leaves, map_tree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_decompress_matches_reference(seed):
    """Identical gradients and residuals in: the same int8 codes, the same
    scales, the same dequantized gradients (in their dtype) and residuals.
    Seed 2 puts exact .5 ties on the grid (``round`` half to even on both
    sides) and an all-zero tensor (scale 1)."""
    rng = np.random.default_rng(seed)
    tree = {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": [rng.normal(size=(3,)).astype(np.float32) * 1e-3,
                  (rng.normal(size=(4, 4)) * 50).astype(np.float32)],
            "z": np.zeros((2, 3), np.float32)}
    if seed == 2:
        tree["a"] = (np.arange(35, dtype=np.float32).reshape(5, 7) - 17) * 0.5
        tree["a"][0, 0] = 127.0
    res = jax.tree.map(lambda a: (a * 0.01).astype(np.float32), tree)
    for a in jax.tree.leaves(tree):
        q, s = int8_quantize(torch.from_numpy(a))
        rq, rs = ref_int8_quantize(jnp.asarray(a))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert s.item() == float(rs)
    tt = map_tree(torch.from_numpy, tree)
    g, st = compress_decompress(tt, compress_init(tt)._replace(
        residual=map_tree(torch.from_numpy, res)))
    rg, rst = ref_compress_decompress(jax.tree.map(jnp.asarray, tree),
                                      ref_compress_init(tree)._replace(
                                          residual=jax.tree.map(jnp.asarray, res)))
    for got, want in zip(leaves(g) + leaves(st.residual),
                         jax.tree.leaves(rg) + jax.tree.leaves(rst.residual)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_a_layer_stack_shares_one_scale_per_leaf():
    """The reference quantizes each leaf of its tree, whose layers are
    stacked on a leading axis; the port's list of per-layer dicts gets one
    scale per leaf across its layers, so the codes match the stacked
    reference's (a layer of small gradients beside one of large)."""
    rng = np.random.default_rng(5)
    layers = [{"w": {"core0": (rng.normal(size=(3, 4)) * s).astype(np.float32)},
               "b": (rng.normal(size=(5,)) * s).astype(np.float32)}
              for s in (1.0, 1e-3, 0.2)]
    stacked = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *layers)
    rg, rst = ref_compress_decompress({"blocks": stacked},
                                      ref_compress_init({"blocks": stacked}))
    tree = {"blocks": [map_tree(torch.from_numpy, t) for t in layers]}
    g, st = compress_decompress(tree, compress_init(tree))
    for i in range(len(layers)):
        for got, want in ((g, rg), (st.residual, rst.residual)):
            np.testing.assert_array_equal(got["blocks"][i]["w"]["core0"].numpy(),
                                          np.asarray(want["blocks"]["w"]["core0"][i]))
            np.testing.assert_array_equal(got["blocks"][i]["b"].numpy(),
                                          np.asarray(want["blocks"]["b"][i]))


def test_compress_keeps_bf16_gradients_bf16():
    g = {"w": torch.randn(4, 4, generator=torch.Generator().manual_seed(0)).bfloat16()}
    out, st = compress_decompress(g, compress_init(g))
    assert out["w"].dtype == torch.bfloat16
    assert st.residual["w"].dtype == torch.float32
