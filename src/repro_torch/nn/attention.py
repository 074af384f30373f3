"""GQA attention with chunked softmax and KV-cache decode.

Port of ``nn/attention.py``.  Prefill attends in query chunks so the
score tensor is (B, g, Hkv, q_chunk, S) rather than (B, H, S, S); decode
attends one new token against the cache with a per-lane ``(B,)`` cache
position, the continuous-batching form.  Query heads group INTERLEAVED
over the kv heads (head j serves kv head j % Hkv).

Under sharding rules with a model axis that the group size does not
divide, prefill takes the reference's other form, repeated-KV flat heads
(:func:`_repeat_kv`), as the reference does; the two forms compute the
same function in another order of operations.

On a mesh whose model axis splits the heads (the reference's
``_shard_heads``; :func:`repro_torch.sharding.head_layout`) each rank of
a model group computes only its block of them; the q/k/v projections
stay whole and the rank takes its block of their output:

* ``kv_major`` (the kv heads divide the axis): the rank's contiguous block
  of the kv heads, of K and V and of the KV cache (``_cache_pspec``'s
  split), and the query heads those kv heads serve, head ``j`` serving kv
  head ``j % n_kv_heads``: a block along the kv-minor axis of the
  ``(g, n_kv_heads)`` head grid.  Prefill and decode attention send no
  collective; the output is all-gathered over the model axis back into
  head order before ``wo``.  The reference's GSPMD layout gives q
  contiguous head blocks instead and gathers K and V (or the cache) to
  serve them; the port holds the same cache blocks and computes the same
  values without that gather.
* ``q_block`` (only the query heads divide it): the rank's contiguous
  block of the query heads, K and V whole on every rank
  (:func:`~repro_torch.plan.sharded.model_copy`: their partial gradients
  are summed once).  The output block is ``wo``'s input column block, so
  ``wo`` takes it as it is under the model reduction.
* ``whole``: every rank computes every head.

Under SP (``ShardingRules.seq_split``: a step's sequence holds the model
axis) every head is the rank's, and so are only its block of the
positions: q, k and v come from the rank's rows, RoPE turns them at
their global positions, K and V are all-gathered over the axis in one
:func:`~repro_torch.plan.sharded.seq_gather` and the rank's queries
attend over all of them from the block's first position on (causal, or
the encoder's bidirectional attention), in query chunks of ``q_chunk /
tp``: a rank scores every head, so that chunk keeps its scores at the
reference layout's, whose device scores ``q_chunk`` queries of
``H / tp`` heads (or of a block of the positions).  A prefill into a cache
that holds the rank's block of the kv heads (the decode layout, where
the kv heads divide the axis) writes that block of every position.  The
reference moves q from the sequence to the heads where the query heads
divide the axis (Megatron-SP, ``_shard_heads``); the values are the
same.  A KV cache under ``cache_seq_split`` holds the rank's block of
the positions: a prefill writes the part of the (gathered) prompt that
falls in it, and a decode step scores each rank's block and combines the
blocks' softmax statistics (:func:`_combine_blocks`, one all-gather of
``B x H x (Dh + 2)`` floats a layer, not the cache).

The caches are updated in place: the JAX reference returned new cache
arrays (donated by the engine), this port writes the new K/V rows into
the given cache tensors and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.sharding import get_rules, head_layout

from .linear import LinearSpec, TTConfig, linear_apply, linear_init
from .rope import apply_rope, rope_for

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope: str = "full"           # full | glm2d | none
    qkv_bias: bool = False
    causal: bool = True
    q_chunk: int = 512
    tt: Optional[TTConfig] = None

    @property
    def q_spec(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.wq", self.d_model,
                          self.n_heads * self.head_dim, self.qkv_bias, "attn", self.tt)

    @property
    def k_spec(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.wk", self.d_model,
                          self.n_kv_heads * self.head_dim, self.qkv_bias, "attn", self.tt)

    @property
    def v_spec(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.wv", self.d_model,
                          self.n_kv_heads * self.head_dim, self.qkv_bias, "attn", self.tt)

    @property
    def o_spec(self) -> LinearSpec:
        return LinearSpec(f"{self.name}.wo", self.n_heads * self.head_dim,
                          self.d_model, False, "attn", self.tt)


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_max, H_kv, Dh)
    v: torch.Tensor


def attention_init(spec: AttentionSpec, generator: torch.Generator,
                   dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    return {
        "wq": linear_init(spec.q_spec, generator, dtype, device),
        "wk": linear_init(spec.k_spec, generator, dtype, device),
        "wv": linear_init(spec.v_spec, generator, dtype, device),
        "wo": linear_init(spec.o_spec, generator, dtype, device),
    }


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """INTERLEAVED kv repeat: repeated head j serves kv head j % hkv, the
    grouped form's convention, so the two forms are interchangeable."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return torch.broadcast_to(x[:, :, None], (b, s, n_rep, h, d)).reshape(
        b, s, n_rep * h, d)


def _grouped_form(n_heads: int, n_kv_heads: int) -> bool:
    """The reference's choice of form: grouped when the group size divides
    the installed rules' model axis (its head sharding can take it), else
    repeated-KV flat heads."""
    rules = get_rules()
    tp = rules.axis_sizes.get(rules.model_axis or "", 1) if rules else 1
    g = n_heads // n_kv_heads
    return g > 1 and (tp <= 1 or g % tp == 0)


def _chunked_attention(
    q: torch.Tensor,            # (B, Sq, H, Dh)
    k: torch.Tensor,            # (B, Sk, Hkv, Dh) - kv heads not repeated
    v: torch.Tensor,
    causal: bool,
    q_chunk: int,
    grouped: bool,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA attention over query chunks, fp32 scores.

    ``grouped`` (the layer's :func:`_grouped_form`, which a rank's block of
    its heads keeps): q heads contract against the raw K/V per kv head;
    else, as in the reference, repeated-KV flat heads.
    """
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(dh)
    chunk = min(q_chunk, sq)
    if sq % chunk:
        chunk = sq  # a single chunk for ragged sizes
    n_chunks = sq // chunk
    kv_pos = torch.arange(sk, device=q.device)
    grouped = grouped and g > 1
    if not grouped and g > 1:
        k = _repeat_kv(k, g)
        v = _repeat_kv(v, g)
    outs = []
    for idx in range(n_chunks):
        qi = q[:, idx * chunk:(idx + 1) * chunk]
        if grouped:                        # (B, chunk, g, Hkv, Dh)
            qi = qi.reshape(b, chunk, g, hkv, dh)
            scores = torch.einsum("bqghd,bkhd->bghqk", qi.float(), k.float()) * scale
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", qi.float(), k.float()) * scale
        if causal:
            q_pos = q_offset + idx * chunk + torch.arange(chunk, device=q.device)
            mask = kv_pos[None, :] <= q_pos[:, None]
            scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        if grouped:
            out = torch.einsum("bghqk,bkhd->bqghd", probs, v)
        else:
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        outs.append(out.reshape(b, chunk, h, dh))
    return torch.cat(outs, dim=1)


def _local_heads(spec: AttentionSpec, layout: str, split, q, k, v):
    """This rank's heads under ``layout``: q ``(B, S, Hl, Dh)`` and k, v
    ``(B, S, Hkv_l, Dh)``, local query head ``i`` serving local kv head
    ``i % Hkv_l``."""
    from repro_torch.plan.sharded import model_block, model_copy

    if layout == "kv_major":
        b, s, h, dh = q.shape
        hkv = spec.n_kv_heads
        q = model_block(q.reshape(b, s, h // hkv, hkv, dh), 3, split)
        return (q.reshape(b, s, -1, dh), model_block(k, 2, split),
                model_block(v, 2, split))
    if layout == "q_block":
        k, v = model_copy(split, k, v)
        return model_block(q, 2, split), k, v
    return q, k, v


def _kv_for_heads(spec: AttentionSpec, layout: str, split, n_local: int, k, v):
    """K and V for a block of ``n_local`` query heads under ``q_block`` whose
    heads do not cycle through the kv heads whole: the kv head of each
    query head (global head ``j`` serves ``j % n_kv_heads``), so that local
    head ``i`` serves local kv head ``i``; else ``k, v`` as they are."""
    hkv = spec.n_kv_heads
    if layout != "q_block" or n_local % hkv == 0:
        return k, v
    idx = (split[1] * n_local + torch.arange(n_local, device=k.device)) % hkv
    return k.index_select(2, idx), v.index_select(2, idx)


def attention_apply(
    spec: AttentionSpec,
    params: dict,
    x: torch.Tensor,                          # (B, S, D)
    positions: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    cache_pos: Optional[torch.Tensor] = None,  # () or (B,): tokens cached
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (output, cache).

    Prefill: ``cache is None`` (or given with S > 1 and a scalar
    ``cache_pos``: the prompt's K/V are written at ``cache_pos``).
    Decode: ``x`` is (B, 1, D); each lane writes its new K/V at its own
    ``cache_pos`` entry and attends over its valid prefix, so a lane's
    output depends only on that lane's cache, token and position.  Under a
    model-axis head layout the cache holds this rank's kv heads
    (:func:`init_kv_cache`).
    """
    from repro_torch.plan.sharded import (model_axis_split, model_gather,
                                          seq_axis_split, seq_gather)

    b, s, _ = x.shape
    if positions is None:
        base = cache_pos if cache_pos is not None else torch.zeros((), dtype=torch.long)
        base = torch.as_tensor(base, device=x.device)
        ar = torch.arange(s, device=x.device)
        positions = base[:, None] + ar[None, :] if base.dim() == 1 else base + ar[None, :]
        positions = torch.broadcast_to(positions, (b, s))

    layout = head_layout(spec.n_heads, spec.n_kv_heads)
    split = model_axis_split(get_rules()) if layout != "whole" else None
    grouped = _grouped_form(spec.n_heads, spec.n_kv_heads)   # the layer's form
    q = linear_apply(spec.q_spec, params["wq"], x).reshape(b, s, spec.n_heads, spec.head_dim)
    k = linear_apply(spec.k_spec, params["wk"], x).reshape(b, s, spec.n_kv_heads, spec.head_dim)
    v = linear_apply(spec.v_spec, params["wv"], x).reshape(b, s, spec.n_kv_heads, spec.head_dim)
    q, k, v = _local_heads(spec, layout, split, q, k, v)
    n_local = q.shape[2]

    rp = rope_for(spec.rope)
    if rp is not None:
        frac, base_f = rp
        q = apply_rope(q, positions, base=base_f, rotary_fraction=frac)
        k = apply_rope(k, positions, base=base_f, rotary_fraction=frac)

    rules = get_rules()
    seq = seq_axis_split(rules)
    q_offset, q_chunk = 0, spec.q_chunk
    if seq is not None:
        # the rank's positions: K and V of every position, one gather
        hkv = k.shape[2]
        kv = seq_gather(torch.cat([k, v], dim=2), 1, seq)
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]
        q_offset = seq[1] * s
        # every head's scores of 1/tp of the reference layout's query chunk
        q_chunk = max(q_chunk // seq[2], 1)
    cache_block = (model_axis_split(rules) if cache is not None
                   and rules is not None and rules.cache_seq_split else None)

    if cache is not None and s > 1:
        # prefill-with-cache: write the prompt's K/V at cache_pos and attend
        # over the just-computed K/V
        idx = torch.as_tensor(cache_pos if cache_pos is not None else 0)
        if idx.dim() == 1:
            raise ValueError(
                "per-lane (B,) cache_pos is decode-only; prefill writes "
                "one contiguous prompt per call (the serve scheduler "
                "prefills each request at batch 1)")
        ck, cv = k, v
        held = cache.k.shape[2]
        if seq is not None and held != k.shape[2]:
            # an SP prefill into a cache of the rank's kv heads (the decode
            # layout): every position gathered, the rank's heads written
            ck, cv = (t.narrow(2, seq[1] * held, held) for t in (k, v))
        _write_prompt(cache, ck, cv, int(idx), cache_block)
    if cache is None or s > 1:
        out = _chunked_attention(q, *_kv_for_heads(spec, layout, split, n_local, k, v),
                                 spec.causal, q_chunk, grouped, q_offset)
    elif cache_block is not None:
        out = _decode_blocks(spec, q, k, v, cache, cache_pos, cache_block)
    else:
        idx = torch.as_tensor(cache_pos if cache_pos is not None else 0,
                              device=x.device)
        kv_pos = torch.arange(cache.k.shape[1], device=x.device)
        lanes = torch.arange(b, device=x.device)
        if idx.dim() == 1:
            cache.k[lanes, idx] = k[:, 0].to(cache.k.dtype)
            cache.v[lanes, idx] = v[:, 0].to(cache.v.dtype)
            vmask = (kv_pos[None, :] <= idx[:, None])[:, None, None, None, :]
        else:
            # index_copy_, not ``cache.k[:, idx] =``: a 0-d tensor index is
            # read on the host, which a meta tensor (the dry run) cannot do
            at = idx.reshape(1).long()
            cache.k.index_copy_(1, at, k.to(cache.k.dtype))
            cache.v.index_copy_(1, at, v.to(cache.v.dtype))
            vmask = (kv_pos <= idx)[None, None, None, None, :]
        ck, cv = _kv_for_heads(spec, layout, split, n_local, cache.k, cache.v)
        hkv = ck.shape[2]
        scale = 1.0 / math.sqrt(spec.head_dim)
        qg = q.reshape(b, 1, n_local // hkv, hkv, spec.head_dim)   # interleaved
        scores = torch.einsum("bqghd,bkhd->bghqk", qg.float(), ck.float()) * scale
        scores = torch.where(vmask, scores, torch.full_like(scores, _NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(cv.dtype)
        out = torch.einsum("bghqk,bkhd->bqghd", probs, cv)

    if layout == "kv_major":
        # back into head order: (g, Hkv_l) blocks gathered along Hkv
        out = model_gather(out.reshape(b, s, spec.n_heads // spec.n_kv_heads, -1,
                                       spec.head_dim), 3, split)
    out = out.reshape(b, s, -1)
    y = linear_apply(spec.o_spec, params["wo"], out,
                     x_split=split if layout == "q_block" else None)
    return y, cache


def _write_prompt(cache: KVCache, k, v, start: int, block) -> None:
    """Write a prompt's K/V (every position of it, ``(B, S, Hkv, Dh)``)
    at positions ``[start, start + S)`` of ``cache``: of its whole length,
    or under ``block`` (:func:`~repro_torch.plan.sharded.model_axis_split`
    of a cache split over the positions) the part in the rank's block."""
    n = cache.k.shape[1]
    first = block[1] * n if block is not None else 0
    lo, hi = max(start, first), min(start + k.shape[1], first + n)
    if hi > lo:
        cache.k[:, lo - first:hi - first] = k[:, lo - start:hi - start].to(cache.k.dtype)
        cache.v[:, lo - first:hi - first] = v[:, lo - start:hi - start].to(cache.v.dtype)


def _decode_blocks(spec: AttentionSpec, q, k, v, cache: KVCache, cache_pos,
                   block) -> torch.Tensor:
    """One decode step over a cache split over the positions (``block``:
    :func:`~repro_torch.plan.sharded.model_axis_split`): the rank that holds
    a lane's position writes its new K/V there, every rank scores its block
    of the positions with every head, and :func:`_combine_blocks` merges
    the blocks' softmax.  ``(B, 1, H, Dh)`` on every rank."""
    b = q.shape[0]
    n = cache.k.shape[1]
    first = block[1] * n
    idx = torch.as_tensor(cache_pos if cache_pos is not None else 0, device=q.device)
    local = idx.long() - first
    held = (local >= 0) & (local < n)
    at = local.clamp(0, n - 1)
    kv_pos = first + torch.arange(n, device=q.device)
    if idx.dim() == 1:
        lanes = torch.arange(b, device=q.device)
        for c, new in ((cache.k, k), (cache.v, v)):
            c[lanes, at] = torch.where(held[:, None, None], new[:, 0].to(c.dtype),
                                       c[lanes, at])
        vmask = (kv_pos[None, :] <= idx[:, None])[:, None, None, None, :]
    else:
        at = at.reshape(1)
        for c, new in ((cache.k, k), (cache.v, v)):
            # index_copy_, not ``c[:, at] =``: no host read (the dry run's meta)
            c.index_copy_(1, at, torch.where(held, new.to(c.dtype), c.index_select(1, at)))
        vmask = (kv_pos <= idx)[None, None, None, None, :]
    hkv = cache.k.shape[2]
    qg = q.reshape(b, 1, spec.n_heads // hkv, hkv, spec.head_dim)   # interleaved
    scores = torch.einsum("bqghd,bkhd->bghqk", qg.float(), cache.k.float())
    scores = scores * (1.0 / math.sqrt(spec.head_dim))
    scores = torch.where(vmask, scores, torch.full_like(scores, _NEG_INF))
    return _combine_blocks(scores, cache.v, block).reshape(b, 1, spec.n_heads,
                                                             spec.head_dim)


def _combine_blocks(scores: torch.Tensor, cv: torch.Tensor, block) -> torch.Tensor:
    """The softmax-weighted sum over every rank's block of the positions, from
    this rank's fp32 ``scores (B, g, Hkv, 1, n)`` and values ``cv (B, n,
    Hkv, Dh)``: each rank's maximum, exp-sum and unnormalised output are
    all-gathered over ``block``'s group in one buffer and merged in rank
    order (a log-sum-exp), so every rank gets the same ``(B, 1, g, Hkv,
    Dh)``.  Not bit-identical to one softmax over the whole cache."""
    from repro_torch.plan.sharded import collective

    group, _, tp = block
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    out = torch.einsum("bghqk,bkhd->bqghd", p.to(cv.dtype), cv).float()
    b = out.shape[0]
    stats = torch.cat([out.reshape(b, -1), m.reshape(b, -1),
                       p.sum(dim=-1).reshape(b, -1)], dim=1)
    parts = collective("all_gather", stats, group).reshape(tp, b, -1)
    n_out = out[0].numel()
    outs = parts[..., :n_out].reshape((tp,) + out.shape)
    ms, ls = parts[..., n_out:].reshape(tp, b, 2, -1).unbind(dim=2)
    top = ms.amax(dim=0)
    w = torch.exp(ms - top)                                   # (tp, B, g * Hkv)
    den = (w * ls).sum(dim=0)
    w = w.reshape((tp, b, 1) + out.shape[2:4] + (1,))
    res = (w * outs).sum(dim=0) / den.reshape((b, 1) + out.shape[2:4] + (1,))
    return res.to(cv.dtype)


def init_kv_cache(spec: AttentionSpec, batch: int, max_seq: int,
                  dtype: torch.dtype = torch.float32, device="cuda") -> KVCache:
    """Zeroed K/V of ``batch`` lanes: under the installed rules' ``kv_major``
    head layout this rank's block of the kv heads, else all of them; under
    their ``cache_seq_split`` this rank's block of the ``max_seq``
    positions, else all of them."""
    hkv = spec.n_kv_heads
    if head_layout(spec.n_heads, hkv) == "kv_major":
        hkv //= get_rules().tp
    rules = get_rules()
    if rules is not None and rules.cache_seq_split:
        max_seq //= rules.tp
    shape = (batch, max_seq, hkv, spec.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
