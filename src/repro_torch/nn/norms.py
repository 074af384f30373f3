"""RMS normalization (port of ``nn/norms.py``, functional param-dict style)."""

from __future__ import annotations

import torch


def rmsnorm_init(d: int, dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)
