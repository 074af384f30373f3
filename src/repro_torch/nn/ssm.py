"""Mamba2 (SSD) block: chunked selective-state-space scan + O(1) decode
(port of ``nn/ssm.py``).

Prefill uses the SSD chunked algorithm (Dao & Gu 2024): the sequence is
split into chunks; within a chunk the recurrence is expanded into an
attention-like lower-triangular form, across chunks a Python loop (the
reference's ``lax.scan``) carries the (heads, d_state, head_dim) state.
Decode advances the state one token at a time.

All projections route through ``repro_torch.nn.linear`` and are
tensorizable.  n_groups is fixed at 1 (B/C shared across heads), matching
Zamba2.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .linear import LinearSpec, TTConfig, linear_apply, linear_init, shape_only
from .norms import rmsnorm, rmsnorm_init


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


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_channels): trailing conv inputs
    ssm: torch.Tensor    # (B, n_heads, d_state, head_dim), fp32


def ssm_init(spec: SSMSpec, generator: torch.Generator,
             dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    h = spec.n_heads
    # A in [1, 16), log-spaced (the mamba2 default)
    a_init = torch.log(1.0 + torch.arange(h, dtype=torch.float32) * 15.0
                       / max(h - 1, 1))
    conv_w = (torch.empty((spec.d_conv, spec.conv_channels), device="meta")
              if shape_only(device) else
              torch.randn((spec.d_conv, spec.conv_channels), generator=generator) * 0.1)
    return {
        "win": linear_init(spec.in_spec, generator, dtype, device),
        "wout": linear_init(spec.out_spec, generator, dtype, device),
        "conv_w": conv_w.to(dtype=dtype, device=device),
        "conv_b": torch.zeros((spec.conv_channels,), dtype=dtype, device=device),
        "A_log": a_init.to(device),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "norm": rmsnorm_init(spec.d_inner, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d.  x (B, S, C), w (K, C); history (B, K-1, C)
    prepends cached inputs (decode) or zeros (prefill)."""
    k = w.shape[0]
    if history is None:
        history = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([history.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P), already scaled by dt
    da: torch.Tensor,     # (B, S, H), log-decay increments (<= 0)
    bmat: torch.Tensor,   # (B, S, N)
    cmat: torch.Tensor,   # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, N, P)
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan: y_t = C_t^T h_t,  h_t = exp(da_t) h_{t-1} + B_t x_t^T.

    Returns (y (B,S,H,P), final_state (B,H,N,P)).
    """
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    l = min(chunk, s)
    if s > 8192:
        l = min(l, 64)  # bound the (b,c,l,l,h) decay tensor at long context
    if s % l:
        l = s  # ragged fallback: a single chunk
    c = s // l
    xc = x.reshape(b, c, l, h, p)
    dac = da.reshape(b, c, l, h)
    bc = bmat.reshape(b, c, l, n)
    cc = cmat.reshape(b, c, l, n)

    cum = torch.cumsum(dac, dim=2)                         # (b, c, l, h)
    # intra-chunk attention-like term.  Mask the exponent BEFORE exp: at
    # masked (j > t) positions diff is large-positive, and exp-then-mask
    # gives 0 * inf = NaN.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,c,l,l,h)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    diff = torch.where(mask[None, None, :, :, None], diff,
                       torch.full_like(diff, -1e30))
    decay = torch.exp(diff)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)       # (b,c,l,l)
    att = (scores[..., None] * decay).to(x.dtype)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xc)

    # chunk-boundary states
    to_end = torch.exp(cum[:, :, -1:, :] - cum)            # (b,c,l,h)
    s_chunk = torch.einsum("bcln,bclh,bclhp->bchnp", bc, to_end.to(x.dtype), xc)
    total = cum[:, :, -1, :]                               # (b,c,h)

    state = (init_state if init_state is not None
             else torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device))
    s_prev = []
    for ci in range(c):                                    # the reference's scan
        s_prev.append(state)                               # state BEFORE chunk ci
        state = (state * torch.exp(total[:, ci])[..., None, None]
                 + s_chunk[:, ci].to(torch.float32))
    prev = torch.stack(s_prev, dim=1)                      # (b,c,h,n,p)

    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", cc,
                           torch.exp(cum).to(x.dtype), prev.to(x.dtype))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, state


def ssm_apply(
    spec: SSMSpec,
    params: dict,
    u: torch.Tensor,                       # (B, S, D)
    state: Optional[SSMState] = None,
) -> tuple[torch.Tensor, Optional[SSMState]]:
    """Returns (y, new_state).  ``state`` given: the conv history and the
    SSD state continue from it (decode, or prefill into a cache)."""
    b, s, _ = u.shape
    h, p, n = spec.n_heads, spec.head_dim, spec.d_state
    zxbcdt = linear_apply(spec.in_spec, params["win"], u)
    z, xbc, dt = torch.split(
        zxbcdt, [spec.d_inner, spec.conv_channels, spec.n_heads], dim=-1)
    conv_hist = state.conv if state is not None else None
    xbc_conv = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"], conv_hist))
    x, bmat, cmat = torch.split(xbc_conv, [spec.d_inner, n, n], dim=-1)
    x = x.reshape(b, s, h, p)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])      # (b,s,h)
    da = -torch.exp(params["A_log"])[None, None, :] * dt             # <= 0
    xd = x * dt[..., None].to(x.dtype)

    init = state.ssm if state is not None else None
    y, final = _ssd_chunked(xd, da, bmat, cmat, spec.chunk, init)
    y = y + params["D"][None, None, :, None].to(y.dtype) * x
    y = y.reshape(b, s, spec.d_inner)
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = linear_apply(spec.out_spec, params["wout"], y)

    new_state = None
    if state is not None:
        k = spec.d_conv
        hist = torch.cat([state.conv, xbc.to(state.conv.dtype)], dim=1)[:, -(k - 1):, :]
        new_state = SSMState(conv=hist, ssm=final)
    return out, new_state


def init_ssm_state(spec: SSMSpec, batch: int, dtype: torch.dtype = torch.float32,
                   device="cuda") -> SSMState:
    return SSMState(
        conv=torch.zeros((batch, spec.d_conv - 1, spec.conv_channels),
                         dtype=dtype, device=device),
        ssm=torch.zeros((batch, spec.n_heads, spec.d_state, spec.head_dim),
                        dtype=torch.float32, device=device),
    )
