"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts.

Copy of ``src/repro/configs/qwen2_moe_a2_7b.py``.

Assigned dims: 24L d_model=2048 16H (kv=16) d_ff=1408 (per routed expert)
vocab=151936, MoE 60e top-4  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].  The 4
shared experts are merged into one always-on FFN of width 4*1408=5632
(mathematically identical, fewer kernels).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import TTConfig

_TT = TTConfig(enabled=True, d=3, rank=16, min_dim=512,
               targets=("attn", "mlp", "head", "moe", "embed"))

FULL = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151_936,
    head_dim=128,
    moe_experts=60,
    moe_top_k=4,
    moe_shared=4,
    moe_shared_d_ff=5632,
    qkv_bias=True,
    loss_chunk=256,
    tt=_TT,
)

SMOKE = FULL.with_(
    name="qwen2moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=48,
    vocab=256,
    head_dim=16,
    moe_experts=6,
    moe_top_k=2,
    moe_shared=2,
    moe_shared_d_ff=96,
    dtype="float32",
    remat="none",
    q_chunk=16,
    tt=TTConfig(enabled=True, d=2, rank=4, min_dim=32,
                targets=("attn", "mlp", "head", "moe", "embed")),
)
