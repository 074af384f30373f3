"""glm4-9b [dense] — RoPE, GQA kv=2, large vocab.

Copy of ``src/repro/configs/glm4_9b.py``.

Assigned dims: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552
[hf:THUDM/glm-4-9b; hf].
"""

from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import TTConfig

_TT = TTConfig(enabled=True, d=3, rank=16, min_dim=512,
               targets=("attn", "mlp", "head", "moe", "embed"))

FULL = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151_552,
    head_dim=128,
    loss_chunk=256,
    tt=_TT,
)

SMOKE = FULL.with_(
    name="glm4-smoke",
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
