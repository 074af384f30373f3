"""chatglm3-6b [dense] — GLM 2d partial RoPE, extreme GQA (kv=2).

Copy of ``src/repro/configs/chatglm3_6b.py``.

Assigned dims: 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024
[arXiv:2406.12793; hf].
"""

from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import TTConfig

_TT = TTConfig(enabled=True, d=3, rank=16, min_dim=512,
               targets=("attn", "mlp", "head", "moe", "embed"))

FULL = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65_024,
    head_dim=128,
    rope="glm2d",
    qkv_bias=True,
    loss_chunk=256,
    tt=_TT,
)

SMOKE = FULL.with_(
    name="chatglm3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    dtype="float32",
    remat="none",
    q_chunk=16,
    tt=TTConfig(enabled=True, d=2, rank=4, min_dim=32,
                targets=("attn", "mlp", "head", "moe", "embed")),
)
