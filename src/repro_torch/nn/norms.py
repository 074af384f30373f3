"""RMS and layer normalization (port of ``nn/norms.py``, functional
param-dict style)."""

from __future__ import annotations

import torch


def rmsnorm_init(d: int, dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def layernorm_init(d: int, dtype: torch.dtype = torch.float32,
                   device="cuda") -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) / sqrt(var + eps) * scale + bias`` over the last axis,
    in fp32 (the population variance, as ``jnp.var``), cast back to x's
    dtype."""
    x32 = x.to(torch.float32)
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)
    return y.to(x.dtype)
