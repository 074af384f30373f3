"""Mixture-of-Experts FFN: the spec (port of ``nn/moe.py``'s ``MoESpec``).

Only the spec dataclass is ported, which the DSE reads to enumerate the
expert projections (``dse_cli._block_specs``).  The routed forward pass
(capacity dispatch, shared experts) is not ported yet (ROADMAP.md, Queue
A item 12); ``repro_torch.models.api`` refuses the moe family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .linear import LinearSpec, TTConfig
from .mlp import MLPSpec


@dataclasses.dataclass(frozen=True)
class MoESpec:
    name: str
    d_model: int
    d_ff: int                      # per routed expert
    n_experts: int
    top_k: int
    n_shared: int = 0              # always-on shared experts (merged)
    shared_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    router_group: int = 512        # tokens per routing group
    kind: str = "swiglu"
    tt: Optional[TTConfig] = None

    @property
    def expert_gate(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.eg", self.d_model, self.d_ff, False, "moe", self.tt)

    @property
    def expert_up(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.eu", self.d_model, self.d_ff, False, "moe", self.tt)

    @property
    def expert_down(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.ed", self.d_ff, self.d_model, False, "moe", self.tt)

    @property
    def shared_spec(self) -> Optional[MLPSpec]:
        if not self.n_shared:
            return None
        ff = self.shared_d_ff if self.shared_d_ff else self.n_shared * self.d_ff
        return MLPSpec(f"{self.name}.shared", self.d_model, ff, self.kind, self.tt)
