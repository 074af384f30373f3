"""Unified model configuration covering all assigned architecture families.

Framework-neutral copy of ``src/repro/models/config.py`` (the port
never imports the JAX package).

One dataclass drives decoder-only dense/GQA, MoE, SSM-hybrid (Zamba2),
attention-free (RWKV6), encoder-decoder (Seamless) and VLM (InternVL2)
backbones.  ``family`` selects the block program; everything else is
dimensioning.  ``tt`` is the paper's technique switch: with
``tt.enabled=True`` every qualifying projection/embedding in the model is
TT-factorized and contracted along DSE-searched paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.nn.linear import TTConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | rwkv | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    rope: str = "full"           # full | glm2d | none
    qkv_bias: bool = False
    mlp_kind: str = "swiglu"

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0
    moe_shared_d_ff: Optional[int] = None
    capacity_factor: float = 1.25

    # hybrid (Zamba2): Mamba2 backbone + a shared attention block applied
    # every ``attn_every`` layers (single shared parameter set)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    attn_every: int = 0

    # encoder-decoder
    encoder_layers: int = 0

    # modality frontend (stub): precomputed embeddings via input_specs()
    frontend: str = "none"       # none | patches | frames
    n_frontend_tokens: int = 0

    # the paper's technique
    tt: TTConfig = dataclasses.field(default_factory=TTConfig)

    # execution
    dtype: str = "bfloat16"
    remat: str = "full"          # none | full | dots
    scan_layers: bool = True
    q_chunk: int = 4096          # attention query-chunk (1 chunk at 4k train)
    tie_embeddings: bool = True
    aux_loss_weight: float = 0.01
    # sequence-chunked head+CE (fused linear-cross-entropy): bounds the
    # (B, S, V) logits buffer when the vocab cannot shard on the model axis
    loss_chunk: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_causal_lm(self) -> bool:
        return self.family in ("dense", "moe", "hybrid", "rwkv", "vlm")

    @property
    def supports_long_context(self) -> bool:
        """O(1)-state decode (SSM / hybrid / linear-attention families)."""
        return self.family in ("hybrid", "rwkv")

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs decode (enc-dec decodes text)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assigned grid."""

    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    step: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.step == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable?, reason).  long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: 500k decode skipped (documented)"
    return True, ""
