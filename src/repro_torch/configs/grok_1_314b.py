"""grok-1-314b [moe] — 8 experts, top-2 routing.

Copy of ``src/repro/configs/grok_1_314b.py``.

Assigned dims: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 (per expert)
vocab=131072, MoE 8e top-2  [hf:xai-org/grok-1; unverified].
"""

from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import TTConfig

_TT = TTConfig(enabled=True, d=3, rank=16, min_dim=512,
               targets=("attn", "mlp", "head", "moe", "embed"))

FULL = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131_072,
    head_dim=128,
    moe_experts=8,
    moe_top_k=2,
    loss_chunk=256,
    tt=_TT,
)

SMOKE = FULL.with_(
    name="grok-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    moe_experts=4,
    moe_top_k=2,
    dtype="float32",
    remat="none",
    q_chunk=16,
    tt=TTConfig(enabled=True, d=2, rank=4, min_dim=32,
                targets=("attn", "mlp", "head", "moe", "embed")),
)
