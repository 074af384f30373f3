"""The MoE, Mamba2 (SSD) and RWKV6 layers, and the weights that carry them,
through the port against the reference, on the CPU.

Weights come from the JAX package's ``init_params`` of each smoke config
(``qwen2moe-smoke``, ``zamba2-smoke``, ``rwkv6-smoke``) and cross over as
numpy arrays (``repro_torch.convert.params_from_jax``); inputs are made
from a seed with numpy.  Layer 0's parameters drive each module.

Tolerances: routing indices exact, then the MoE output and aux loss at
1e-5; the SSM and RWKV outputs and recurrent states at 1e-5 (both sides
accumulate in fp32, in another order).  Shapes are chosen so the paths the
reference takes all run: a padded routing group and dropped (token,
choice) pairs; several SSD and WKV chunks.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models import blocks as ref_blocks
from repro.nn import moe as ref_moe
from repro.nn import rwkv as ref_rwkv
from repro.nn import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as port_serve
from repro_torch.models import api, blocks
from repro_torch.nn import moe, rwkv, ssm
from test_torch_plan import one_blas_thread  # noqa: F401

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = {"moe": "qwen2-moe-a2.7b", "hybrid": "zamba2-1.2b", "rwkv": "rwkv6-7b"}


@pytest.fixture(scope="module")
def weights():
    """family -> (reference params, port params, port config) of its smoke
    model, from ``PRNGKey(0)``."""
    out = {}
    for family, arch in ARCHS.items():
        rparams = jax.jit(ref_api(ref_get_config(arch, smoke=True)).init_params)(
            jax.random.PRNGKey(0))
        out[family] = (rparams, params_from_jax(jax.tree.map(np.asarray, rparams)),
                       get_config(arch, smoke=True))
    return out


def _layer0(rparams):
    return jax.tree.map(lambda a: a[0], rparams["blocks"])


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_params_carry_across_with_the_reference_keys(weights, family):
    """Every leaf crosses over under the reference's key names: the experts'
    cores stacked on a leading expert axis inside each layer, the hybrid's
    top-level ``shared_attn``, the SSM's and RWKV's plain leaves."""
    rparams, params, cfg = weights[family]
    want = jax.tree.map(lambda a: tuple(a.shape), rparams)
    want["blocks"] = [jax.tree.map(lambda s: s[1:], want["blocks"],
                                   is_leaf=lambda s: isinstance(s, tuple))
                      ] * cfg.n_layers
    assert _tree_shapes(params) == want
    port = api(cfg, device="cpu").init_params(0)
    assert _tree_shapes(port) == _tree_shapes(params)
    if family == "moe":
        assert params["blocks"][1]["moe"]["eu"]["core0"].shape[0] == cfg.moe_experts
        np.testing.assert_array_equal(params["blocks"][1]["moe"]["router"].numpy(),
                                      np.asarray(rparams["blocks"]["moe"]["router"][1]))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {
    # (batch, seq, router_group, capacity_factor)
    "one group": (2, 8, 512, 1.25),
    "padded groups": (2, 7, 6, 1.25),
    "dropped pairs": (3, 8, 24, 0.3),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference(weights, case):
    rparams, params, cfg = weights["moe"]
    b, s, group, cf = MOE_CASES[case]
    spec = dataclasses.replace(blocks.moe_spec(cfg), router_group=group,
                               capacity_factor=cf)
    rspec = dataclasses.replace(ref_blocks.moe_spec(ref_get_config(
        ARCHS["moe"], smoke=True)), router_group=group, capacity_factor=cf)
    rp, p = _layer0(rparams)["moe"], params["blocks"][0]["moe"]
    x = _x((b, s, cfg.d_model), seed=len(case))

    # routing first: the chosen experts exactly
    g = min(group, b * s)
    xf = np.concatenate([x.reshape(-1, cfg.d_model),
                         np.zeros(((-b * s) % g, cfg.d_model), np.float32)])
    rlogits = jnp.einsum("gtd,de->gte", jnp.asarray(xf.reshape(-1, g, cfg.d_model)),
                         rp["router"])
    _, ridx = jax.lax.top_k(jax.nn.softmax(rlogits, axis=-1), spec.top_k)
    _, _, idx = moe.route(spec, p, torch.from_numpy(xf.reshape(-1, g, cfg.d_model)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))

    ry, raux = jax.jit(lambda p_, x_: ref_moe.moe_apply(rspec, p_, x_))(
        rp, jnp.asarray(x))
    y, aux = moe.moe_apply(spec, p, torch.from_numpy(x))
    _close(y, ry)
    _close(aux, raux)
    if case == "dropped pairs":   # the case drops some (token, choice) pairs
        cap = max(4, min(int(np.ceil(spec.top_k * g * cf / spec.n_experts)), g))
        counts = np.bincount(np.asarray(ridx).reshape(-1), minlength=spec.n_experts)
        assert counts.max() > cap


def test_moe_block_returns_the_aux_loss(weights):
    rparams, params, cfg = weights["moe"]
    rcfg = ref_get_config(ARCHS["moe"], smoke=True)
    x = _x((2, 6, cfg.d_model), seed=7)
    rx, _, raux = jax.jit(lambda p_, x_: ref_blocks.block_apply(
        rcfg, p_, x_, None, None, None))(_layer0(rparams), jnp.asarray(x))
    px, cache, aux = blocks.block_apply(cfg, params["blocks"][0], torch.from_numpy(x),
                                        None, None, None)
    assert cache is None
    _close(px, rx)
    _close(aux, raux)
    assert float(aux) > 0


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def _ssm_specs(cfg, chunk):
    rcfg = ref_get_config(ARCHS["hybrid"], smoke=True)
    return (dataclasses.replace(blocks.ssm_spec(cfg), chunk=chunk),
            dataclasses.replace(ref_blocks.ssm_spec(rcfg), chunk=chunk))


@pytest.mark.parametrize("chunk,seq", [(128, 12), (4, 12), (5, 12)])
def test_ssm_apply_prefill_and_decode_match_reference(weights, chunk, seq):
    """Prefill into a zero state (one chunk, three chunks, and a ragged
    length on one chunk), then two decode steps: outputs, conv history and
    SSD state at 1e-5."""
    rparams, params, cfg = weights["hybrid"]
    spec, rspec = _ssm_specs(cfg, chunk)
    rp, p = _layer0(rparams)["ssm"], params["blocks"][0]["ssm"]
    x = _x((2, seq + 2, cfg.d_model), seed=chunk)
    rstate = ref_ssm.init_ssm_state(rspec, 2)
    state = ssm.init_ssm_state(spec, 2, device="cpu")
    ref_apply = jax.jit(lambda p_, x_, st: ref_ssm.ssm_apply(rspec, p_, x_, st))
    for lo, hi in ((0, seq), (seq, seq + 1), (seq + 1, seq + 2)):
        ry, rstate = ref_apply(rp, jnp.asarray(x[:, lo:hi]), rstate)
        y, state = ssm.ssm_apply(spec, p, torch.from_numpy(x[:, lo:hi]), state)
        _close(y, ry)
        _close(state.conv, rstate.conv)
        _close(state.ssm, rstate.ssm)
    ry, none = jax.jit(lambda p_, x_: ref_ssm.ssm_apply(rspec, p_, x_))(
        rp, jnp.asarray(x))
    y, state = ssm.ssm_apply(spec, p, torch.from_numpy(x))
    assert none is None and state is None
    _close(y, ry)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,seq", [(16, 32), (8, 12), (16, 12)])
def test_rwkv_time_and_channel_mix_match_reference(weights, chunk, seq):
    """Time mix and channel mix (the block hands both the one ``tm`` dict)
    on a prompt from a zero state, then two decode steps: outputs, token
    shifts and the WKV state at 1e-5."""
    rparams, params, cfg = weights["rwkv"]
    rcfg = ref_get_config(ARCHS["rwkv"], smoke=True)
    spec = dataclasses.replace(blocks.rwkv_spec(cfg), chunk=chunk)
    rspec = dataclasses.replace(ref_blocks.rwkv_spec(rcfg), chunk=chunk)
    rp, p = _layer0(rparams)["tm"], params["blocks"][0]["tm"]
    x = _x((2, seq + 2, cfg.d_model), seed=seq)
    rstate = ref_rwkv.init_rwkv_state(rspec, 2)
    state = rwkv.init_rwkv_state(spec, 2, device="cpu")
    ref_tm = jax.jit(lambda p_, x_, st: ref_rwkv.rwkv_time_mix(rspec, p_, x_, st))
    ref_cm = jax.jit(lambda p_, x_, st: ref_rwkv.rwkv_channel_mix(rspec, p_, x_, st))
    for lo, hi in ((0, seq), (seq, seq + 1), (seq + 1, seq + 2)):
        xs, rxs = torch.from_numpy(x[:, lo:hi]), jnp.asarray(x[:, lo:hi])
        ry, rshift, rwkv_s = ref_tm(rp, rxs, rstate)
        y, shift, wkv = rwkv.rwkv_time_mix(spec, p, xs, state)
        _close(y, ry)
        _close(shift, rshift)
        _close(wkv, rwkv_s)
        rc, rshift_cm = ref_cm(rp, rxs, rstate)
        c, shift_cm = rwkv.rwkv_channel_mix(spec, p, xs, state)
        _close(c, rc)
        _close(shift_cm, rshift_cm)
        rstate = ref_rwkv.RWKVState(rshift, rshift_cm, rwkv_s)
        state = rwkv.RWKVState(shift, shift_cm, wkv)
    ry, _, _ = jax.jit(lambda p_, x_: ref_rwkv.rwkv_time_mix(rspec, p_, x_))(
        rp, jnp.asarray(x))
    y, shift, wkv = rwkv.rwkv_time_mix(spec, p, torch.from_numpy(x))
    assert shift is None and wkv is None
    _close(y, ry)


# ---------------------------------------------------------------------------
# what is not ported yet
# ---------------------------------------------------------------------------

def test_encdec_raises_naming_the_next_slice(capsys):
    cfg = get_config("seamless-m4t-medium", smoke=True)
    with pytest.raises(NotImplementedError, match="Queue A item 12b"):
        api(cfg, device="cpu")
    from repro_torch.serve import ServeEngine

    with pytest.raises(ValueError, match="causal-LM only"):
        ServeEngine(cfg, {"ln_f": {"scale": torch.ones(1)}}, n_slots=1, max_seq=8)
    assert port_serve.main(["--arch", "seamless-m4t-medium", "--smoke",
                            "--device", "cpu"]) == 2
    assert "causal-LM only" in capsys.readouterr().err
