"""A model's tensorized projections as named contraction problems.

Dense-family copy of ``model_dse_layers`` from ``src/repro/dse_cli.py``,
the enumeration :func:`repro_torch.plan.compiler.check_plan_for_config`
validates plans against.  The DSE itself is not ported yet (ROADMAP.md,
Queue A item 9).
"""

from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.tensor_network import TensorNetwork
from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import LinearSpec


def _block_specs(cfg: ModelConfig) -> list[tuple[LinearSpec, int, float]]:
    """(spec, instance_count, token_scale) for every projection family."""
    from repro_torch.models.blocks import attn_spec, mlp_spec
    from repro_torch.models.lm import head_spec

    if cfg.family != "dense":
        raise ValueError(
            f"config {cfg.name!r}: family {cfg.family!r} is not ported yet "
            "(ROADMAP.md, Queue A item 12)")
    L = cfg.n_layers
    a, m = attn_spec(cfg), mlp_spec(cfg)
    out = [(a.q_spec, L, 1.0), (a.k_spec, L, 1.0), (a.v_spec, L, 1.0),
           (a.o_spec, L, 1.0)]
    if m.kind == "swiglu":
        out.append((m.gate_spec, L, 1.0))
    out.extend([(m.up_spec, L, 1.0), (m.down_spec, L, 1.0)])
    out.append((head_spec(cfg), 1, 1.0))
    return out


def model_dse_layers(
    cfg: ModelConfig, tokens: int,
    factorizations: Optional[dict] = None,
) -> list[tuple[str, TensorNetwork]]:
    """Tensorized projections of ``cfg``, one entry per instance, with the
    streamed token count as the batch edge."""
    layers: list[tuple[str, TensorNetwork]] = []
    for spec, count, scale in _block_specs(cfg):
        if factorizations is not None and spec.name in factorizations:
            spec = spec.with_factorization(*factorizations[spec.name])
        if not spec.tensorized:
            continue
        t = max(1, math.ceil(tokens * scale))
        tn = spec.network(t)
        for i in range(count):
            layers.append((f"{spec.name}[{i}]" if count > 1 else spec.name, tn))
    if not layers:
        raise ValueError(
            f"config {cfg.name!r} has no tensorized projections "
            f"(tt.enabled={cfg.tt.enabled}, min_dim={cfg.tt.min_dim})"
        )
    return layers
