"""Feed-forward blocks: SwiGLU / GELU, dense or TT-factorized (port of
``nn/mlp.py``).

Where the installed rules split d_ff over the model axis (the reference's
``("batch", "seq", "model")`` on the up and gate outputs;
:func:`repro_torch.sharding.ff_split`: not under SP, whose sequence
takes the axis first), each rank of a model group takes its block of the
up and gate outputs, runs the activation on it, and hands the block to
``wd``, which takes it as its column block under the model reduction and
gathers it otherwise (:func:`repro_torch.nn.linear.linear_apply`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import ff_split, get_rules

from .linear import LinearSpec, TTConfig, linear_apply, linear_init


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    name: str
    d_model: int
    d_ff: int
    kind: str = "swiglu"          # swiglu | gelu
    tt: Optional[TTConfig] = None

    @property
    def gate_spec(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.wg", self.d_model, self.d_ff, False, "mlp", self.tt)

    @property
    def up_spec(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.wu", self.d_model, self.d_ff, False, "mlp", self.tt)

    @property
    def down_spec(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.wd", self.d_ff, self.d_model, False, "mlp", self.tt)


def mlp_init(spec: MLPSpec, generator: torch.Generator,
             dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    params = {}
    if spec.kind == "swiglu":
        params["wg"] = linear_init(spec.gate_spec, generator, dtype, device)
    params["wu"] = linear_init(spec.up_spec, generator, dtype, device)
    params["wd"] = linear_init(spec.down_spec, generator, dtype, device)
    return params


def mlp_apply(spec: MLPSpec, params: dict, x: torch.Tensor) -> torch.Tensor:
    from repro_torch.plan.sharded import model_axis_split, model_block

    split = None
    if ff_split(x.shape[:-1], spec.d_ff):
        split = model_axis_split(get_rules())

    def block(t):
        return t if split is None else model_block(t, -1, split)

    up = block(linear_apply(spec.up_spec, params["wu"], x))
    if spec.kind == "swiglu":
        gate = block(linear_apply(spec.gate_spec, params["wg"], x))
        h = F.silu(gate) * up
    elif spec.kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(spec.kind)
    return linear_apply(spec.down_spec, params["wd"], h, x_split=split)
