"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

Copy of ``src/repro/configs/zamba2_1_2b.py``.

Assigned dims: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000
ssm_state=64  [arXiv:2411.15242; hf].  Shared attention applied every 6
Mamba layers (one parameter set reused — Zamba2's signature trick).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import TTConfig

_TT = TTConfig(enabled=True, d=3, rank=16, min_dim=512,
               targets=("attn", "mlp", "head", "moe", "embed"))

FULL = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32_000,
    head_dim=64,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    loss_chunk=256,
    tt=_TT,
)

SMOKE = FULL.with_(
    name="zamba2-smoke",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    head_dim=16,
    ssm_state=8,
    ssm_head_dim=16,
    attn_every=2,
    dtype="float32",
    remat="none",
    q_chunk=16,
    tt=TTConfig(enabled=True, d=2, rank=4, min_dim=32,
                targets=("attn", "mlp", "head", "moe", "embed")),
)
