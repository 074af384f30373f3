"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay.

Copy of ``src/repro/configs/rwkv6_7b.py``.

Assigned dims: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536
[arXiv:2404.05892; hf].  head_dim=64 (RWKV standard), so 64 WKV heads.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import TTConfig

_TT = TTConfig(enabled=True, d=3, rank=16, min_dim=512,
               targets=("attn", "mlp", "head", "moe", "embed"))

FULL = ModelConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # d_model / head_dim WKV heads
    n_kv_heads=64,
    d_ff=14336,
    vocab=65_536,
    head_dim=64,
    loss_chunk=256,
    tt=_TT,
)

SMOKE = FULL.with_(
    name="rwkv6-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=224,
    vocab=256,
    head_dim=16,
    dtype="float32",
    remat="none",
    q_chunk=16,
    tt=TTConfig(enabled=True, d=2, rank=4, min_dim=32,
                targets=("attn", "mlp", "head", "moe", "embed")),
)
