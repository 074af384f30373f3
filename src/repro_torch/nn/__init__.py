"""Layers (ports of ``src/repro/nn/``): TT/dense linear, norms, RoPE,
embedding, MLP, GQA attention, the capacity-routed MoE FFN, the Mamba2
(SSD) block and the RWKV6 time/channel mix."""

from .linear import (
    LinearSpec,
    TTConfig,
    capture_activation_rms,
    install_plan,
    installed_factorizations,
    kept_plan,
    linear_apply,
    linear_flops,
    linear_init,
    plan_context,
    planned_layer,
    planned_path_index,
)
from .norms import layernorm, layernorm_init, rmsnorm, rmsnorm_init
from .rope import apply_rope, rope_for
from .embedding import EmbeddingSpec, embedding_apply, embedding_init, head_apply
from .mlp import MLPSpec, mlp_apply, mlp_init
from .attention import (
    AttentionSpec,
    KVCache,
    attention_apply,
    attention_init,
    init_kv_cache,
)
from .moe import MoESpec, moe_apply, moe_init
from .ssm import SSMSpec, SSMState, init_ssm_state, ssm_apply, ssm_init
from .rwkv import (
    RWKVSpec,
    RWKVState,
    init_rwkv_state,
    rwkv_channel_mix,
    rwkv_init,
    rwkv_time_mix,
)

__all__ = [
    "LinearSpec", "TTConfig", "capture_activation_rms", "install_plan",
    "installed_factorizations", "kept_plan",
    "linear_apply", "linear_flops", "linear_init", "plan_context",
    "planned_layer", "planned_path_index",
    "layernorm", "layernorm_init", "rmsnorm", "rmsnorm_init",
    "apply_rope", "rope_for",
    "EmbeddingSpec", "embedding_apply", "embedding_init", "head_apply",
    "MLPSpec", "mlp_apply", "mlp_init",
    "AttentionSpec", "KVCache", "attention_apply", "attention_init",
    "init_kv_cache", "MoESpec", "moe_apply", "moe_init",
    "SSMSpec", "SSMState", "init_ssm_state", "ssm_apply", "ssm_init",
    "RWKVSpec", "RWKVState", "init_rwkv_state", "rwkv_channel_mix",
    "rwkv_init", "rwkv_time_mix",
]
