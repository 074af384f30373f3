"""Layers of the dense family: TT/dense linear, norms, RoPE, embedding,
MLP and GQA attention (ports of ``src/repro/nn/``), and the specs of the
MoE, SSM and RWKV layers (their forward passes wait for ROADMAP.md Queue
A item 12)."""

from .linear import (
    LinearSpec,
    TTConfig,
    capture_activation_rms,
    install_plan,
    installed_factorizations,
    linear_apply,
    linear_flops,
    linear_init,
    plan_context,
    planned_layer,
    planned_path_index,
)
from .norms import rmsnorm, rmsnorm_init
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
from .moe import MoESpec
from .ssm import SSMSpec
from .rwkv import RWKVSpec

__all__ = [
    "LinearSpec", "TTConfig", "capture_activation_rms", "install_plan",
    "installed_factorizations",
    "linear_apply", "linear_flops", "linear_init", "plan_context",
    "planned_layer", "planned_path_index",
    "rmsnorm", "rmsnorm_init", "apply_rope", "rope_for",
    "EmbeddingSpec", "embedding_apply", "embedding_init", "head_apply",
    "MLPSpec", "mlp_apply", "mlp_init",
    "AttentionSpec", "KVCache", "attention_apply", "attention_init",
    "init_kv_cache", "MoESpec", "SSMSpec", "RWKVSpec",
]
