"""RWKV-6 (Finch) block: the spec (port of ``nn/rwkv.py``'s ``RWKVSpec``).

Only the spec dataclass is ported, which the DSE reads to enumerate the
time-mix and channel-mix projections (``dse_cli._block_specs``).  The
WKV recurrence is not ported yet (ROADMAP.md, Queue A item 12);
``repro_torch.models.api`` refuses the rwkv family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .linear import LinearSpec, TTConfig


@dataclasses.dataclass(frozen=True)
class RWKVSpec:
    name: str
    d_model: int
    head_dim: int = 64
    d_ff: Optional[int] = None          # channel-mix width (default 3.5x)
    lora_r: int = 64                    # decay/mix LoRA rank
    chunk: int = 16                     # see _wkv_chunked numerics bound
    tt: Optional[TTConfig] = None

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim

    @property
    def ffn(self) -> int:
        return self.d_ff if self.d_ff else int(3.5 * self.d_model)

    def proj(self, tag: str, d_out: Optional[int] = None) -> LinearSpec:
        return LinearSpec(
            f"{self.name}.{tag}", self.d_model, d_out or self.d_model,
            False, "attn", self.tt,
        )
