"""Mamba2 (SSD) block: the spec (port of ``nn/ssm.py``'s ``SSMSpec``).

Only the spec dataclass is ported, which the DSE reads to enumerate the
in/out projections (``dse_cli._block_specs``).  The chunked scan and the
O(1) decode are not ported yet (ROADMAP.md, Queue A item 12);
``repro_torch.models.api`` refuses the hybrid family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .linear import LinearSpec, TTConfig


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    name: str
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128
    tt: Optional[TTConfig] = None

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def d_in_proj(self) -> int:
        # z, x, B, C, dt
        return 2 * self.d_inner + 2 * self.d_state + self.n_heads

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.d_state

    @property
    def in_spec(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.win", self.d_model, self.d_in_proj, False, "attn", self.tt)

    @property
    def out_spec(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.wout", self.d_inner, self.d_model, False, "attn", self.tt)
