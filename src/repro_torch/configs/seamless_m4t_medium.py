"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.

Copy of ``src/repro/configs/seamless_m4t_medium.py``.

Assigned dims: 12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206
[arXiv:2308.11596; hf].  12 encoder + 12 decoder layers; the audio
frontend is a STUB — ``input_specs()`` supplies precomputed frame
embeddings (B, S_enc, D).

vocab 256206 is not divisible by the 16-way model axis, so logits cannot
vocab-shard; ``loss_chunk`` bounds the train-time logits buffer instead
(fused head + cross-entropy over sequence chunks).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import TTConfig

_TT = TTConfig(enabled=True, d=3, rank=16, min_dim=512,
               targets=("attn", "mlp", "head", "moe", "embed"))

FULL = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256_206,
    head_dim=64,
    mlp_kind="gelu",
    frontend="frames",
    loss_chunk=256,
    tt=_TT,
)

SMOKE = FULL.with_(
    name="seamless-smoke",
    n_layers=2,
    encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=254,        # deliberately odd-sized: exercises the chunked loss
    head_dim=16,
    loss_chunk=8,
    dtype="float32",
    remat="none",
    q_chunk=16,
    tt=TTConfig(enabled=True, d=2, rank=4, min_dim=32,
                targets=("attn", "mlp", "head", "moe", "embed")),
)
