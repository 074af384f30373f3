"""RWKV-6 (Finch) block: data-dependent decay WKV, chunked for prefill
(port of ``nn/rwkv.py``).

Time-mix: token-shift interpolation with a data-dependent mix (ddlerp via
a low-rank MLP), R/K/V/G projections, per-channel data-dependent decay
``w_t`` (LoRA-conditioned), bonus ``u`` for the current token, grouped
heads with per-head (key x value) state matrices.

The WKV recurrence
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
is evaluated chunk-parallel (an intra-chunk lower-triangular attention
term + an inter-chunk state loop, the reference's ``lax.scan``); decode
advances S one token at a time.

Channel-mix: squared-ReLU MLP with token shift.  All projections route
through ``repro_torch.nn.linear``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .linear import LinearSpec, TTConfig, linear_apply, linear_init, shape_only


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

    @property
    def cmr_spec(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.cmr", self.ffn, self.d_model, False,
                          "attn", self.tt)


class RWKVState(NamedTuple):
    shift_tm: torch.Tensor   # (B, D) last token (time-mix shift)
    shift_cm: torch.Tensor   # (B, D) last token (channel-mix shift)
    wkv: torch.Tensor        # (B, H, N, N) per-head key->value state, fp32


def rwkv_init(spec: RWKVSpec, generator: torch.Generator,
              dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """Time-mix and channel-mix parameters in one dict (as the reference)."""
    d, r = spec.d_model, spec.lora_r
    h, n = spec.n_heads, spec.head_dim

    def rand(shape, scale, shift=0.0, uniform=False):
        if shape_only(device):
            return torch.empty(shape, dtype=dtype, device="meta")
        t = (torch.rand(shape, generator=generator) if uniform
             else torch.randn(shape, generator=generator))
        return (t * scale + shift).to(dtype=dtype, device=device)

    def lora(d_out):
        return {"a": rand((d, r), 0.01), "b": rand((r, d_out), 0.01)}

    def lin(ls):
        return linear_init(ls, generator, dtype, device)

    return {
        "mix_base": rand((5, d), 0.5, 0.25, uniform=True),
        "mix_lora": lora(5 * d),
        "wr": lin(spec.proj("wr")),
        "wk": lin(spec.proj("wk")),
        "wv": lin(spec.proj("wv")),
        "wg": lin(spec.proj("wg")),
        "wo": lin(spec.proj("wo")),
        "decay_base": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "decay_lora": lora(d),
        "bonus": (torch.empty((h, n), device="meta") if shape_only(device) else
                  (torch.randn((h, n), generator=generator) * 0.05).to(device)),
        "ln_x_scale": torch.ones((d,), dtype=dtype, device=device),
        # channel mix
        "cm_mix": rand((2, d), 0.5, 0.25, uniform=True),
        "cm_k": lin(spec.proj("cmk", spec.ffn)),
        "cm_v": lin(spec.proj("cmv")),
        "cm_r": lin(spec.cmr_spec),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """Previous token per position; ``last`` fills position 0 (decode cache)."""
    if last is None:
        last = torch.zeros_like(x[:, :1, :])
    else:
        last = last[:, None, :].to(x.dtype)
    return torch.cat([last, x[:, :-1, :]], dim=1)


def _wkv_chunked(
    r: torch.Tensor,      # (B, S, H, N)
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,   # (B, S, H, N) log-decay (< 0)
    bonus: torch.Tensor,  # (H, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # (B, H, N, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel WKV.  Returns (y (B,S,H,N), final_state).

    Numerics: the intra-chunk factorisation
    ``exp(cum_{i-1} - cum_j) = exp(cum_{i-1} - cum_mid) * exp(cum_mid - cum_j)``
    is anchored at the chunk midpoint, so each factor's exponent is
    bounded by ``(chunk/2) * |logw|``; with ``logw`` clamped at -7.5 and
    chunk 16 the worst exponent is 60 < fp32's exp overflow (~88).  All
    inter-chunk factors are boundary-anchored and always <= 1.
    """
    b, s, h, n = r.shape
    l = min(chunk, s)
    if s % l:
        l = s
    c = s // l
    rc = r.reshape(b, c, l, h, n)
    kc = k.reshape(b, c, l, h, n)
    vc = v.reshape(b, c, l, h, n)
    wc = logw.reshape(b, c, l, h, n)
    cum = torch.cumsum(wc, dim=2)                       # (b,c,l,h,n)
    mid = cum[:, :, l // 2: l // 2 + 1]                 # midpoint anchor

    # intra-chunk: y_i <- sum_{j<i} (r_i . exp(cum_{i-1}-cum_j) . k_j) v_j
    r_intra = rc * torch.exp(cum - wc - mid).to(r.dtype)
    k_intra = kc * torch.exp(mid - cum).to(r.dtype)
    att = torch.einsum("bcihn,bcjhn->bchij", r_intra, k_intra)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=r.device),
                      diagonal=-1)                      # strictly lower
    att = torch.where(mask[None, None, None], att, torch.zeros_like(att))
    # diagonal bonus term: (r_i . u . k_i) v_i
    diag = torch.einsum("bcihn,hn,bcihn->bcih", rc, bonus.to(r.dtype), kc)
    y = torch.einsum("bchij,bcjhn->bcihn", att.to(r.dtype), vc)
    y = y + diag[..., None] * vc

    # inter-chunk: carry S; y_i += (r_i * exp(cum_{i-1})) @ S_prev
    to_end = torch.exp(cum[:, :, -1:, :, :] - cum)      # (b,c,l,h,n)
    s_chunk = torch.einsum("bclhn,bclhm->bchnm", kc * to_end.to(k.dtype), vc)
    total = cum[:, :, -1]                               # (b,c,h,n)

    state = (init_state if init_state is not None
             else torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device))
    s_prev = []
    for ci in range(c):                                 # the reference's scan
        s_prev.append(state)
        state = (state * torch.exp(total[:, ci])[..., None]
                 + s_chunk[:, ci].to(torch.float32))
    prev = torch.stack(s_prev, dim=1)                   # (b,c,h,n,m)
    # inter-chunk read: r_i * exp(cum_{i-1}) (chunk-start anchored, <= 1)
    r_inter = rc * torch.exp(cum - wc).to(r.dtype)
    y = y + torch.einsum("bcihn,bchnm->bcihm", r_inter, prev.to(r.dtype))
    return y.reshape(b, s, h, n), state


def rwkv_time_mix(
    spec: RWKVSpec,
    params: dict,
    x: torch.Tensor,                        # (B, S, D)
    state: Optional[RWKVState] = None,
) -> tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Returns (y, new_shift_tm, new_wkv_state)."""
    b, s, d = x.shape
    h, n = spec.n_heads, spec.head_dim
    prev = _token_shift(x, state.shift_tm if state is not None else None)
    delta = prev - x
    # ddlerp: base mix + LoRA(x + 0.5*delta) -> 5 per-channel mixes
    lo = torch.tanh((x + 0.5 * delta) @ params["mix_lora"]["a"]) @ params["mix_lora"]["b"]
    mixes = params["mix_base"][None, None] + lo.reshape(b, s, 5, d)
    xr, xk, xv, xg, xw = [x + delta * mixes[:, :, i, :] for i in range(5)]
    r = linear_apply(spec.proj("wr"), params["wr"], xr).reshape(b, s, h, n)
    k = linear_apply(spec.proj("wk"), params["wk"], xk).reshape(b, s, h, n)
    v = linear_apply(spec.proj("wv"), params["wv"], xv).reshape(b, s, h, n)
    g = F.silu(linear_apply(spec.proj("wg"), params["wg"], xg))

    dl = torch.tanh(xw @ params["decay_lora"]["a"]) @ params["decay_lora"]["b"]
    logw = -torch.exp(
        params["decay_base"][None, None] + dl.to(torch.float32)
    ).reshape(b, s, h, n)                               # log w_t < 0
    # clamp: w >= e^-7.5 keeps the chunked factorisation inside fp32 range
    logw = torch.clamp(logw, min=-7.5)

    init = state.wkv if state is not None else None
    y, final = _wkv_chunked(r, k, v, logw, params["bonus"], spec.chunk, init)
    # per-head group norm (ln_x in the reference implementation)
    yg = y.reshape(b, s, h, n).to(torch.float32)
    mu = torch.mean(yg, dim=-1, keepdim=True)
    var = torch.var(yg, dim=-1, keepdim=True, unbiased=False)
    yg = (yg - mu) * torch.rsqrt(var + 1e-5)
    y = (yg.reshape(b, s, d) * params["ln_x_scale"].to(torch.float32)).to(x.dtype)
    out = linear_apply(spec.proj("wo"), params["wo"], y * g)
    new_shift = x[:, -1, :] if state is not None else None
    return out, new_shift, (final if state is not None else None)


def rwkv_channel_mix(
    spec: RWKVSpec,
    params: dict,
    x: torch.Tensor,
    state: Optional[RWKVState] = None,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    prev = _token_shift(x, state.shift_cm if state is not None else None)
    delta = prev - x
    xk = x + delta * params["cm_mix"][0][None, None]
    xr = x + delta * params["cm_mix"][1][None, None]
    kk = linear_apply(spec.proj("cmk", spec.ffn), params["cm_k"], xk)
    kk = torch.square(F.relu(kk))
    vv = linear_apply(spec.cmr_spec, params["cm_r"], kk)
    rr = torch.sigmoid(linear_apply(spec.proj("cmv"), params["cm_v"], xr))
    new_shift = x[:, -1, :] if state is not None else None
    return rr * vv, new_shift


def init_rwkv_state(spec: RWKVSpec, batch: int, dtype: torch.dtype = torch.float32,
                    device="cuda") -> RWKVState:
    return RWKVState(
        shift_tm=torch.zeros((batch, spec.d_model), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, spec.d_model), dtype=dtype, device=device),
        wkv=torch.zeros((batch, spec.n_heads, spec.head_dim, spec.head_dim),
                        dtype=torch.float32, device=device),
    )
