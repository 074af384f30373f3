"""GQA attention with chunked softmax and KV-cache decode.

Port of ``nn/attention.py``.  Prefill attends in query chunks so the
score tensor is (B, g, Hkv, q_chunk, S) rather than (B, H, S, S); decode
attends one new token against the cache with a per-lane ``(B,)`` cache
position, the continuous-batching form.  Query heads group INTERLEAVED
over the kv heads (head j serves kv head j % Hkv).

Under sharding rules with a model axis that the group size does not
divide, prefill takes the reference's other form, repeated-KV flat heads
(:func:`_repeat_kv`), as the reference does; the two forms compute the
same function in another order of operations.  The reference's head and
sequence layout constraints (``_shard_heads``) change no value and are not
ported: every rank holds all heads.

The caches are updated in place: the JAX reference returned new cache
arrays (donated by the engine), this port writes the new K/V rows into
the given cache tensors and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.sharding import get_rules

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


def _chunked_attention(
    q: torch.Tensor,            # (B, Sq, H, Dh)
    k: torch.Tensor,            # (B, Sk, Hkv, Dh) - kv heads not repeated
    v: torch.Tensor,
    causal: bool,
    q_chunk: int,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA attention over query chunks, fp32 scores.

    Grouped (q heads contract against the raw K/V per kv head) unless the
    installed rules' model axis does not divide the group size; then, as in
    the reference, repeated-KV flat heads.
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
    # the reference picks the form its head sharding can take: grouped
    # when g divides the model axis, else repeated-KV flat heads
    rules = get_rules()
    tp = rules.axis_sizes.get(rules.model_axis or "", 1) if rules else 1
    grouped = g > 1 and (tp <= 1 or g % tp == 0)
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
    output depends only on that lane's cache, token and position.
    """
    b, s, _ = x.shape
    if positions is None:
        base = cache_pos if cache_pos is not None else torch.zeros((), dtype=torch.long)
        base = torch.as_tensor(base, device=x.device)
        ar = torch.arange(s, device=x.device)
        positions = base[:, None] + ar[None, :] if base.dim() == 1 else base + ar[None, :]
        positions = torch.broadcast_to(positions, (b, s))

    q = linear_apply(spec.q_spec, params["wq"], x).reshape(b, s, spec.n_heads, spec.head_dim)
    k = linear_apply(spec.k_spec, params["wk"], x).reshape(b, s, spec.n_kv_heads, spec.head_dim)
    v = linear_apply(spec.v_spec, params["wv"], x).reshape(b, s, spec.n_kv_heads, spec.head_dim)

    rp = rope_for(spec.rope)
    if rp is not None:
        frac, base_f = rp
        q = apply_rope(q, positions, base=base_f, rotary_fraction=frac)
        k = apply_rope(k, positions, base=base_f, rotary_fraction=frac)

    if cache is None:
        out = _chunked_attention(q, k, v, spec.causal, spec.q_chunk)
    elif s > 1:
        # prefill-with-cache: write the prompt's K/V at cache_pos and attend
        # over the just-computed K/V
        idx = torch.as_tensor(cache_pos if cache_pos is not None else 0)
        if idx.dim() == 1:
            raise ValueError(
                "per-lane (B,) cache_pos is decode-only; prefill writes "
                "one contiguous prompt per call (the serve scheduler "
                "prefills each request at batch 1)")
        start = int(idx)
        cache.k[:, start:start + s] = k.to(cache.k.dtype)
        cache.v[:, start:start + s] = v.to(cache.v.dtype)
        out = _chunked_attention(q, k, v, spec.causal, spec.q_chunk)
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
        hkv = spec.n_kv_heads
        g = spec.n_heads // hkv
        scale = 1.0 / math.sqrt(spec.head_dim)
        qg = q.reshape(b, 1, g, hkv, spec.head_dim)   # interleaved grouping
        scores = torch.einsum("bqghd,bkhd->bghqk", qg.float(),
                              cache.k.float()) * scale
        scores = torch.where(vmask, scores, torch.full_like(scores, _NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(cache.v.dtype)
        out = torch.einsum("bghqk,bkhd->bqghd", probs, cache.v)
        out = out.reshape(b, 1, spec.n_heads, spec.head_dim)

    out = out.reshape(b, s, spec.n_heads * spec.head_dim)
    y = linear_apply(spec.o_spec, params["wo"], out)
    return y, cache


def init_kv_cache(spec: AttentionSpec, batch: int, max_seq: int,
                  dtype: torch.dtype = torch.float32, device="cuda") -> KVCache:
    shape = (batch, max_seq, spec.n_kv_heads, spec.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
