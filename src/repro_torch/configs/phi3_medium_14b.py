"""phi3-medium-14b [dense] — RoPE SwiGLU GQA.

Copy of ``src/repro/configs/phi3_medium_14b.py``.

Assigned dims: 40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
[arXiv:2404.14219; unverified].
"""

from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import TTConfig

_TT = TTConfig(enabled=True, d=3, rank=16, min_dim=512,
               targets=("attn", "mlp", "head", "moe", "embed"))

FULL = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100_352,
    head_dim=128,
    loss_chunk=256,
    tt=_TT,
)

SMOKE = FULL.with_(
    name="phi3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=256,
    head_dim=16,
    dtype="float32",
    remat="none",
    q_chunk=16,
    tt=TTConfig(enabled=True, d=2, rank=4, min_dim=32,
                targets=("attn", "mlp", "head", "moe", "embed")),
)
