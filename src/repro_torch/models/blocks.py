"""Per-family decoder blocks (port of ``models/blocks.py``) with a
uniform ``(x, cache) -> (x, cache, aux)`` interface, so the layer loop in
``lm.py`` is family-agnostic.

Block params are plain dicts.  ``cache`` is family-specific: a
:class:`KVCache` for attention blocks (updated in place), an
:class:`SSMState` for Mamba2 and an :class:`RWKVState` for RWKV6 (new
states returned); ``None`` without one.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn import (
    AttentionSpec,
    MLPSpec,
    MoESpec,
    RWKVSpec,
    RWKVState,
    SSMSpec,
    attention_apply,
    attention_init,
    mlp_apply,
    mlp_init,
    moe_apply,
    moe_init,
    rmsnorm,
    rmsnorm_init,
    rwkv_channel_mix,
    rwkv_init,
    rwkv_time_mix,
    ssm_apply,
    ssm_init,
)
from .config import ModelConfig


def attn_spec(cfg: ModelConfig, name: str = "attn", causal: bool = True) -> AttentionSpec:
    return AttentionSpec(
        name=name,
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd,
        rope=cfg.rope,
        qkv_bias=cfg.qkv_bias,
        causal=causal,
        q_chunk=cfg.q_chunk,
        tt=cfg.tt,
    )


def mlp_spec(cfg: ModelConfig, name: str = "mlp") -> MLPSpec:
    return MLPSpec(name, cfg.d_model, cfg.d_ff, cfg.mlp_kind, cfg.tt)


def moe_spec(cfg: ModelConfig, name: str = "moe") -> MoESpec:
    return MoESpec(
        name=name,
        d_model=cfg.d_model,
        d_ff=cfg.d_ff,
        n_experts=cfg.moe_experts,
        top_k=cfg.moe_top_k,
        n_shared=cfg.moe_shared,
        shared_d_ff=cfg.moe_shared_d_ff,
        capacity_factor=cfg.capacity_factor,
        kind=cfg.mlp_kind,
        tt=cfg.tt,
    )


def ssm_spec(cfg: ModelConfig, name: str = "ssm") -> SSMSpec:
    return SSMSpec(
        name=name,
        d_model=cfg.d_model,
        d_state=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim,
        tt=cfg.tt,
    )


def rwkv_spec(cfg: ModelConfig, name: str = "rwkv") -> RWKVSpec:
    return RWKVSpec(
        name=name,
        d_model=cfg.d_model,
        head_dim=cfg.hd,
        d_ff=cfg.d_ff,
        tt=cfg.tt,
    )


def block_init(cfg: ModelConfig, generator: torch.Generator,
               dtype: torch.dtype, device) -> dict:
    """One decoder block of ``cfg.family`` (hybrid: one Mamba layer)."""
    d = cfg.d_model
    if cfg.family in ("dense", "vlm", "encdec"):
        return {
            "ln1": rmsnorm_init(d, dtype, device),
            "attn": attention_init(attn_spec(cfg), generator, dtype, device),
            "ln2": rmsnorm_init(d, dtype, device),
            "mlp": mlp_init(mlp_spec(cfg), generator, dtype, device),
        }
    if cfg.family == "moe":
        return {
            "ln1": rmsnorm_init(d, dtype, device),
            "attn": attention_init(attn_spec(cfg), generator, dtype, device),
            "ln2": rmsnorm_init(d, dtype, device),
            "moe": moe_init(moe_spec(cfg), generator, dtype, device),
        }
    if cfg.family == "hybrid":
        return {
            "ln": rmsnorm_init(d, dtype, device),
            "ssm": ssm_init(ssm_spec(cfg), generator, dtype, device),
        }
    if cfg.family == "rwkv":
        return {
            "ln1": rmsnorm_init(d, dtype, device),
            "tm": rwkv_init(rwkv_spec(cfg), generator, dtype, device),
            "ln2": rmsnorm_init(d, dtype, device),
        }
    raise ValueError(cfg.family)


def shared_attn_init(cfg: ModelConfig, generator: torch.Generator,
                     dtype: torch.dtype, device) -> dict:
    """Zamba2's shared attention block (one parameter set, applied once per
    group of ``attn_every`` Mamba layers)."""
    return {
        "ln": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attention_init(attn_spec(cfg, name="shared_attn"), generator,
                               dtype, device),
    }


def block_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
                positions: Optional[torch.Tensor], cache, cache_pos):
    """Returns (x, new_cache, aux_loss)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "vlm", "encdec", "moe"):
        h, new_cache = attention_apply(attn_spec(cfg), params["attn"],
                                       rmsnorm(params["ln1"], x), positions,
                                       cache, cache_pos)
        x = x + h
        if cfg.family == "moe":
            h2, aux = moe_apply(moe_spec(cfg), params["moe"],
                                rmsnorm(params["ln2"], x))
            return x + h2, new_cache, aux
        h2 = mlp_apply(mlp_spec(cfg), params["mlp"], rmsnorm(params["ln2"], x))
        return x + h2, new_cache, zero
    if cfg.family == "hybrid":
        h, new_state = ssm_apply(ssm_spec(cfg), params["ssm"],
                                 rmsnorm(params["ln"], x), cache)
        return x + h, new_state, zero
    if cfg.family == "rwkv":
        # the channel mix reads its cm_* parameters from the same dict
        h, shift_tm, wkv = rwkv_time_mix(rwkv_spec(cfg), params["tm"],
                                         rmsnorm(params["ln1"], x), cache)
        x = x + h
        h2, shift_cm = rwkv_channel_mix(rwkv_spec(cfg), params["tm"],
                                        rmsnorm(params["ln2"], x), cache)
        x = x + h2
        new_cache = None
        if cache is not None:
            new_cache = RWKVState(shift_tm=shift_tm, shift_cm=shift_cm, wkv=wkv)
        return x, new_cache, zero
    raise ValueError(cfg.family)


def shared_attn_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
                      positions: Optional[torch.Tensor], cache, cache_pos):
    h, new_cache = attention_apply(
        attn_spec(cfg, name="shared_attn"), params["attn"],
        rmsnorm(params["ln"], x), positions, cache, cache_pos)
    return x + h, new_cache
