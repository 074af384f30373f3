"""internvl2-2b [vlm] — InternViT frontend (stub) + InternLM2 backbone.

Copy of ``src/repro/configs/internvl2_2b.py``.

Assigned dims: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821; hf].  The ViT frontend is a STUB: ``input_specs()``
supplies 256 precomputed patch embeddings (B, 256, D) prepended to the
text tokens.

vocab 92553 is odd (not shardable on the model axis) -> chunked loss.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import TTConfig

_TT = TTConfig(enabled=True, d=3, rank=16, min_dim=512,
               targets=("attn", "mlp", "head", "moe", "embed"))

FULL = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92_553,
    head_dim=128,
    frontend="patches",
    n_frontend_tokens=256,
    loss_chunk=256,
    tt=_TT,
)

SMOKE = FULL.with_(
    name="internvl2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=253,        # odd vocab: exercises the chunked loss
    head_dim=16,
    n_frontend_tokens=8,
    loss_chunk=8,
    dtype="float32",
    remat="none",
    q_chunk=16,
    tt=TTConfig(enabled=True, d=2, rank=4, min_dim=32,
                targets=("attn", "mlp", "head", "moe", "embed")),
)
