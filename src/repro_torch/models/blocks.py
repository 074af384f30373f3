"""The dense decoder block (port of the dense branch of ``models/blocks.py``).

Block params are plain dicts; ``cache`` is the block's :class:`KVCache`
(``None`` without one).  The spec builders of every family are ported
(the DSE enumerates their projections); the blocks of the other families
raise until they are ported (ROADMAP.md, Queue A item 12).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn import (
    AttentionSpec,
    MLPSpec,
    MoESpec,
    RWKVSpec,
    SSMSpec,
    attention_apply,
    attention_init,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
)
from .config import ModelConfig


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet "
            "(ROADMAP.md, Queue A item 12)")


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
    """One dense decoder block."""
    _dense_only(cfg)
    d = cfg.d_model
    return {
        "ln1": rmsnorm_init(d, dtype, device),
        "attn": attention_init(attn_spec(cfg), generator, dtype, device),
        "ln2": rmsnorm_init(d, dtype, device),
        "mlp": mlp_init(mlp_spec(cfg), generator, dtype, device),
    }


def block_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
                positions: Optional[torch.Tensor], cache, cache_pos):
    """Returns (x, cache)."""
    _dense_only(cfg)
    h, cache = attention_apply(attn_spec(cfg), params["attn"],
                               rmsnorm(params["ln1"], x), positions, cache,
                               cache_pos)
    x = x + h
    h2 = mlp_apply(mlp_spec(cfg), params["mlp"], rmsnorm(params["ln2"], x))
    return x + h2, cache
