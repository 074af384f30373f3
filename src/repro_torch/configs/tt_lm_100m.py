"""tt-lm-100m — the end-to-end training example model (~100M dense-equiv).

Copy of ``src/repro/configs/tt_lm_100m.py``.

Not an assigned arch: a small dense GQA LM whose projections are
TT-factorized, used by ``examples/train_tt_lm.py`` to run a real training
loop (optimizer, data pipeline, checkpointing) on CPU within minutes.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import TTConfig

FULL = ModelConfig(
    name="tt-lm-100m",
    family="dense",
    n_layers=8,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab=32_000,
    head_dim=64,
    dtype="float32",
    remat="none",
    q_chunk=512,
    tt=TTConfig(enabled=True, d=3, rank=16, min_dim=512,
                targets=("attn", "mlp", "head", "moe", "embed")),
)

SMOKE = FULL.with_(
    name="tt-lm-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    q_chunk=32,
    tt=TTConfig(enabled=True, d=2, rank=8, min_dim=64,
                targets=("attn", "mlp", "head", "moe", "embed")),
)
