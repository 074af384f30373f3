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

Where the installed rules split the heads over the model axis (the
reference's ``("batch", "seq", "model", None)`` on x;
:func:`repro_torch.sharding.state_heads`), each rank of a model group
computes only its block of them: ``win`` stays whole and the rank takes
its heads' block of z, x and dt from its output (three offsets of one
row), with B and C whole (one group; their gradients, which each rank
computes only in part, are summed once by ``model_copy``), and its
block of ``dt_bias``, ``A_log``, ``D`` and of the depthwise conv's x
channels.  The SSD scan runs on the rank's heads, and its state is the
rank's block of the decode state's heads.  The gated RMSNorm normalises
over all of d_inner, so the gated output is all-gathered over the model
axis first; the norm and ``wout`` then run whole on every rank (``wout``
splits its own input columns under ``tt_model_reduce``).  The conv
history is held whole: the reference's spec splits its 4 224 channels
contiguously, a block that mixes the two heads' blocks with B and C, and
each rank holds ``win``'s whole output, so the whole history costs no
collective.

Under SP (``ShardingRules.seq_split``: the hybrid's sequence holds the
model axis) a rank holds positions ``[r * S / tp, (r + 1) * S / tp)`` of
every head, and the scan hands two things from rank to rank, each in one
all-gather (:func:`~repro_torch.plan.sharded.seq_stack`, whose backward
sums the gradient once):

* the conv's halo: every rank's last ``min(d_conv - 1, S / tp)`` inputs
  (all conv channels); a rank's ``d_conv - 1`` inputs before its block
  are the last of the ranks' before it (:func:`conv_halo`; a block shorter
  than ``d_conv - 1`` takes them from several ranks), after zeros or the
  cache's history;
* the SSD state: a rank scans its block from a zero state
  (:func:`_ssd_chunked`, its chunk length chosen from the whole sequence:
  :func:`chunk_len`), sends its end state and its block's total log-decay
  per head, folds the ranks' in rank order (:func:`fold_states`) and adds
  the term of the state entering its block, ``C_t . exp(cum_t) . init``
  (:func:`init_term`): ``y`` is linear in the initial state, so this
  equals a rerun of the block from it.

The whole sequence's end state and conv history come out of the same two
gathers on every rank, so a prefill into a cache stores them (the end
state cut to the rank's block of the heads where the cache holds one).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import get_rules, state_heads

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
    ssm: torch.Tensor    # (B, n_heads, d_state, head_dim), fp32 (the rank's heads)


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


def chunk_len(s: int, chunk: int, seq_len: Optional[int] = None) -> int:
    """The SSD chunk length of a scan over ``s`` positions: the reference's
    rule (``chunk``, 64 past 8 192 positions, one chunk where it does not
    divide) applied to the whole sequence's ``seq_len`` positions (``s``
    when not given: the whole sequence is scanned), and one chunk for a
    block of ``s`` positions that it does not divide."""
    total = seq_len or s
    l = min(chunk, total)
    if total > 8192:
        l = min(l, 64)  # bound the (b,c,l,l,h) decay tensor at long context
    if total % l:
        l = total  # ragged fallback: a single chunk
    return l if s % l == 0 else s


def _ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P), already scaled by dt
    da: torch.Tensor,     # (B, S, H), log-decay increments (<= 0)
    bmat: torch.Tensor,   # (B, S, N)
    cmat: torch.Tensor,   # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, N, P)
    seq_len: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan: y_t = C_t^T h_t,  h_t = exp(da_t) h_{t-1} + B_t x_t^T.

    Returns (y (B,S,H,P), final_state (B,H,N,P)).  ``seq_len``: the whole
    sequence's positions, where ``x`` is a block of it (:func:`chunk_len`).
    """
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    l = chunk_len(s, chunk, seq_len)
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


def conv_halo(tails: torch.Tensor, upto: int, history: Optional[torch.Tensor],
              k: int) -> torch.Tensor:
    """The ``k - 1`` conv inputs before block ``upto`` of a sequence split
    into blocks: ``tails (tp, B, t, C)`` holds every block's last ``t =
    min(k - 1, block)`` inputs in block order, ``history (B, k - 1, C)`` the
    inputs before the sequence (None: zeros).  ``upto = tp`` gives the
    whole sequence's last ``k - 1`` inputs (the next call's history).  The
    result is a slice of all of ``tails``: every block's gradient flows
    through it (as zeros where it is not read)."""
    n, b, t, c = tails.shape
    if history is None:
        history = tails.new_zeros((b, k - 1, c))
    rows = torch.cat([history.to(tails.dtype), tails.transpose(0, 1).reshape(b, n * t, c)],
                     dim=1)
    return rows[:, upto * t:upto * t + k - 1]


def fold_states(ends: torch.Tensor, totals: torch.Tensor,
                init: Optional[torch.Tensor], index: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD state entering block ``index`` and the one leaving the last
    block, from every block's end state when scanned from zero ``ends (tp,
    B, H, N, P)`` and total log-decay ``totals (tp, B, H)``, in block order,
    after the state ``init (B, H, N, P)`` before the sequence (None: zero):
    ``state_j = exp(T_j) state_{j-1} + S_j``, the chunk recurrence of
    :func:`_ssd_chunked` over blocks.  Both are read from the stack of
    every state, so every block's gradient flows through them."""
    state = init if init is not None else torch.zeros_like(ends[0])
    states = [state]
    for j in range(ends.shape[0]):
        state = state * torch.exp(totals[j])[..., None, None] + ends[j]
        states.append(state)
    states = torch.stack(states)
    return states[index], states[-1]


def init_term(cmat: torch.Tensor, da: torch.Tensor, init: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The part of a block's SSD output that its entering state ``init (B,
    H, N, P)`` gives: ``C_t . exp(cum_t) . init`` with ``cum_t`` the block's
    cumulative log-decay ``da (B, S, H)`` up to t; ``(B, S, H, P)``."""
    decay = torch.exp(torch.cumsum(da, dim=1)).to(dtype)
    return torch.einsum("bsn,bsh,bhnp->bshp", cmat, decay, init.to(dtype))


def _ssd_handoff(x, da, bmat, cmat, chunk: int, init_state, seq):
    """:func:`_ssd_chunked` of the rank's block of the positions under SP
    (``seq``: :func:`~repro_torch.plan.sharded.seq_axis_split`): the block
    scanned from zero, then the term of the state entering it, from every
    rank's end state and total log-decay (one all-gather, with the rank's
    block of ``init_state``'s heads where it holds a block).  Returns the
    block's ``y`` and the whole sequence's end state (every head)."""
    from repro_torch.plan.sharded import seq_stack

    b, s, h, p = x.shape
    n = bmat.shape[-1]
    _, index, tp = seq
    y, end = _ssd_chunked(x, da, bmat, cmat, chunk, seq_len=s * tp)
    parts = [end.reshape(b, -1), da.sum(dim=1)]
    held = init_state is not None and init_state.shape[1] != h
    if held:                 # a block of the cache's heads: sent alongside
        parts.append(init_state.reshape(b, -1).to(end.dtype))
    msgs = seq_stack(torch.cat(parts, dim=1), seq)         # (tp, B, ...)
    ends = msgs[..., :h * n * p].reshape(tp, b, h, n, p)
    totals = msgs[..., h * n * p:h * n * p + h]
    if held:
        init_state = msgs[..., h * n * p + h:].reshape(tp, b, h // tp, n, p)
        init_state = init_state.transpose(0, 1).reshape(b, h, n, p)
    start, final = fold_states(ends, totals, init_state, index)
    return y + init_term(cmat, da, start, x.dtype), final


def _head_block(spec: SSMSpec, params: dict, split, zxbcdt: torch.Tensor,
                conv_hist: Optional[torch.Tensor]):
    """This rank's share of ``win``'s whole output ``[z | x | B | C | dt]``
    and of the per-head parameters: ``(z, xbc, dt, conv_w, conv_b,
    conv_hist, (dt_bias, A_log, D))``, where z, dt and the x channels of
    xbc, the conv's weights and its history are the rank's heads' blocks
    and B and C whole; with ``split`` None, all of them."""
    from repro_torch.plan.sharded import model_block, model_copy

    di, k = spec.d_inner, spec.d_conv
    per_head = (params["dt_bias"], params["A_log"], params["D"])
    z, xbc, dt = torch.split(zxbcdt, [di, spec.conv_channels, spec.n_heads], dim=-1)
    if split is None:
        return z, xbc, dt, params["conv_w"], params["conv_b"], conv_hist, per_head
    # z and x: one block of the (2, d_inner) pair; dt and the per-head
    # parameters: one block each along the heads
    zx = model_block(zxbcdt[..., :2 * di].unflatten(-1, (2, di)), -1, split)
    dt = model_block(dt, -1, split)
    dt_bias, a_log, d = model_block(torch.stack(per_head), -1, split).unbind(0)
    # the conv's weights and bias as one (d_conv + 1, channels) tensor
    wb = torch.cat([params["conv_w"], params["conv_b"][None]], dim=0)
    wb_x = model_block(wb[:, :di], -1, split)
    bc, wb_bc = model_copy(split, xbc[..., di:], wb[:, di:])
    w = torch.cat([wb_x, wb_bc], dim=-1)
    if conv_hist is not None:
        _, index, tp = split
        cols = di // tp
        conv_hist = torch.cat([conv_hist[..., index * cols:(index + 1) * cols],
                               conv_hist[..., di:]], dim=-1)
    return (zx[..., 0, :], torch.cat([zx[..., 1, :], bc], dim=-1), dt, w[:k], w[k],
            conv_hist, (dt_bias, a_log, d))


def _scan_heads(spec: SSMSpec, z, xbc, dt, conv_w, conv_b, conv_hist,
                per_head, init_state: Optional[torch.Tensor] = None, seq=None):
    """The conv, the SSD scan and the gate on the heads that
    :func:`_head_block` gives (all of them, or a rank's block): ``(y * silu(z)
    (B, S, heads * head_dim), final state (B, heads, d_state, head_dim))``.
    Under SP (``seq``) ``xbc`` is the rank's block of the positions,
    ``conv_hist`` its halo (:func:`conv_halo`), and the scan hands its
    state on (:func:`_ssd_handoff`): the final state is the whole
    sequence's."""
    b, s, _ = z.shape
    p, n = spec.head_dim, spec.d_state
    dt_bias, a_log, d = per_head
    xbc_conv = F.silu(_causal_conv(xbc, conv_w, conv_b, conv_hist))
    x, bmat, cmat = torch.split(xbc_conv, [z.shape[-1], n, n], dim=-1)
    x = x.reshape(b, s, -1, p)
    dt = F.softplus(dt.to(torch.float32) + dt_bias)                 # (b,s,h)
    da = -torch.exp(a_log)[None, None, :] * dt                       # <= 0
    xd = x * dt[..., None].to(x.dtype)
    if seq is None:
        y, final = _ssd_chunked(xd, da, bmat, cmat, spec.chunk, init_state)
    else:
        y, final = _ssd_handoff(xd, da, bmat, cmat, spec.chunk, init_state, seq)
    y = y + d[None, None, :, None].to(y.dtype) * x
    return y.reshape(b, s, -1) * F.silu(z), final


def ssm_apply(
    spec: SSMSpec,
    params: dict,
    u: torch.Tensor,                       # (B, S, D)
    state: Optional[SSMState] = None,
) -> tuple[torch.Tensor, Optional[SSMState]]:
    """Returns (y, new_state).  ``state`` given: the conv history and the
    SSD state continue from it (decode, or prefill into a cache).  Under
    a model-axis split of the heads (:func:`~repro_torch.sharding.
    state_heads`) the rank computes its block of them and ``state.ssm``
    holds its heads (:func:`init_ssm_state`).  Under SP ``u`` is the rank's
    block of the positions (every head); the new state is the whole
    sequence's, its heads cut to the block ``state.ssm`` holds."""
    from repro_torch.plan.sharded import (model_axis_split, model_gather,
                                          seq_axis_split, seq_stack)

    rules = get_rules()
    seq = seq_axis_split(rules)
    split = model_axis_split(rules) if state_heads(spec.n_heads) else None
    k = spec.d_conv
    zxbcdt = linear_apply(spec.in_spec, params["win"], u)
    z, xbc, dt, conv_w, conv_b, hist, per_head = _head_block(
        spec, params, split, zxbcdt, state.conv if state is not None else None)
    tails = None
    if seq is not None:         # every rank's last inputs: the halo (one gather)
        s = xbc.shape[1]
        tails = seq_stack(xbc[:, s - min(k - 1, s):], seq)       # (tp, B, t, C)
        hist = conv_halo(tails, seq[1], hist, k)
    y, final = _scan_heads(spec, z, xbc, dt, conv_w, conv_b, hist, per_head,
                           state.ssm if state is not None else None, seq)
    if split is not None:
        y = model_gather(y, -1, split)          # the norm reads all of d_inner
    out = linear_apply(spec.out_spec, params["wout"], rmsnorm(params["norm"], y))

    new_state = None
    if state is not None:
        if tails is not None:                   # the whole sequence's, under SP
            hist = conv_halo(tails, seq[2], state.conv, k).to(state.conv.dtype)
            held = state.ssm.shape[1]
            if held != spec.n_heads:            # the cache's block of the heads
                final = final.narrow(1, seq[1] * held, held)
        else:
            whole = zxbcdt[..., spec.d_inner:spec.d_inner + spec.conv_channels]
            hist = torch.cat([state.conv, whole.to(state.conv.dtype)],
                             dim=1)[:, -(k - 1):, :]
        new_state = SSMState(conv=hist, ssm=final)
    return out, new_state


def init_ssm_state(spec: SSMSpec, batch: int, dtype: torch.dtype = torch.float32,
                   device="cuda") -> SSMState:
    """Zeroed conv history (all channels) and SSD state: under the
    installed rules' split of the heads (:func:`~repro_torch.sharding.
    state_heads`) this rank's block of them, else all of them."""
    h = spec.n_heads
    if state_heads(h):
        h //= get_rules().tp
    return SSMState(
        conv=torch.zeros((batch, spec.d_conv - 1, spec.conv_channels),
                         dtype=dtype, device=device),
        ssm=torch.zeros((batch, h, spec.d_state, spec.head_dim),
                        dtype=torch.float32, device=device),
    )
