"""qwen1.5-110b [dense] — QKV bias, the largest dense assigned arch.

Copy of ``src/repro/configs/qwen1_5_110b.py``.

Assigned dims: 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064
[hf:Qwen/Qwen1.5-0.5B; hf].
"""

from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import TTConfig

_TT = TTConfig(enabled=True, d=3, rank=16, min_dim=512,
               targets=("attn", "mlp", "head", "moe", "embed"))

FULL = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152_064,
    head_dim=128,
    qkv_bias=True,
    loss_chunk=256,
    tt=_TT,
)

SMOKE = FULL.with_(
    name="qwen1.5-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab=256,
    head_dim=16,
    dtype="float32",
    remat="none",
    q_chunk=16,
    tt=TTConfig(enabled=True, d=2, rank=4, min_dim=32,
                targets=("attn", "mlp", "head", "moe", "embed")),
)
