"""Encoder-decoder backbone, the Seamless-M4T medium shape (port of
``models/encdec.py``).

The audio frontend is a stub, as in the reference: the caller supplies
precomputed frame embeddings (B, S_enc, D) as ``batch["frontend"]``.  The
encoder is a bidirectional transformer over the frames; the decoder a
causal LM with cross-attention into the encoder memory.

The reference stacks each layer stack on a leading axis; here
``params["enc_blocks"]`` and ``params["dec_blocks"]`` are lists of
per-layer dicts, and the cross K/V a list of per-layer tensors.  Decode
caches: per decoder layer a self-attention :class:`KVCache` (updated in
place, as in ``lm.py``) and the cross-attention K/V, computed once at
prefill and static afterwards.  The decoder takes a scalar ``cache_pos``:
the batch decodes in step (the reference's serving form for this family).

Projection names follow the reference's lookups (``enc_attn.*``,
``enc_mlp.*``, ``dec_attn.*``, ``xattn.*``, ``dec_mlp.*``).  The DSE names
the decoder's self-attention and MLP ``attn.*`` and ``mlp.*``, so under a
plan those two run unplanned on the plain contraction, in both packages.

On a mesh whose model axis divides the kv heads (the cross K/V cache's
split in the reference's ``_cache_pspec``; :func:`repro_torch.sharding.
head_layout` ``kv_major``) each rank of a model group computes only its
block of the cross-attention: its contiguous block of the memory's kv
heads (the cross K/V and their cache) and of the query heads they serve
(head ``h`` reads kv head ``h // n_rep``, so that block is contiguous
too).  ``xattn.wq``, ``wk`` and ``wv`` stay whole and the rank takes its
block of their output; ``xattn.wo`` takes the output as its column block
under ``tt_model_reduce`` and gathers it otherwise.  The logits are the
rank's block of the vocab where the rules split it (``lm.apply_head``;
``lm.whole_logits`` gathers them); the self-attention and the MLPs split
as in ``lm.py``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.nn import (
    KVCache,
    LinearSpec,
    attention_apply,
    attention_init,
    embedding_apply,
    embedding_init,
    init_kv_cache,
    linear_apply,
    linear_init,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.sharding import get_rules, head_layout

from .blocks import attn_spec, mlp_spec
from .config import ModelConfig
from .lm import (
    _dtype,
    _remat,
    apply_head,
    batch_share,
    chunked_cross_entropy,
    cross_entropy,
    embed_spec,
    head_spec,
)


class EncDecCaches(NamedTuple):
    self_kv: list           # per decoder layer: KVCache (B, S_max, H_kv, Dh)
    cross_k: list           # per decoder layer: (B, S_enc, H_kv, Dh), the rank's kv heads
    cross_v: list


def _cross_split(cfg: ModelConfig):
    """:func:`~repro_torch.plan.sharded.model_axis_split` where the
    installed rules split the cross-attention's kv heads over the model
    axis (the ``kv_major`` head layout), else None."""
    from repro_torch.plan.sharded import model_axis_split

    if head_layout(cfg.n_heads, cfg.n_kv_heads) != "kv_major":
        return None
    return model_axis_split(get_rules())


def _xattn_specs(cfg: ModelConfig) -> dict[str, LinearSpec]:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    kv = cfg.n_kv_heads
    return {
        "wq": LinearSpec("xattn.wq", d, h * hd, False, "attn", cfg.tt),
        "wk": LinearSpec("xattn.wk", d, kv * hd, False, "attn", cfg.tt),
        "wv": LinearSpec("xattn.wv", d, kv * hd, False, "attn", cfg.tt),
        "wo": LinearSpec("xattn.wo", h * hd, d, False, "attn", cfg.tt),
    }


def _enc_block_init(cfg: ModelConfig, generator, dtype, device) -> dict:
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attention_init(attn_spec(cfg, "enc_attn", causal=False), generator,
                               dtype, device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": mlp_init(mlp_spec(cfg, "enc_mlp"), generator, dtype, device),
    }


def _dec_block_init(cfg: ModelConfig, generator, dtype, device) -> dict:
    xs = _xattn_specs(cfg)
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attention_init(attn_spec(cfg, "dec_attn"), generator, dtype, device),
        "lnx": rmsnorm_init(cfg.d_model, dtype, device),
        "xattn": {nm: linear_init(xs[nm], generator, dtype, device) for nm in xs},
        "ln2": rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": mlp_init(mlp_spec(cfg, "dec_mlp"), generator, dtype, device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters with the reference's shapes and standard
    deviations, drawn on the CPU from ``generator`` and moved to
    ``device``."""
    dtype = _dtype(cfg)
    params = {
        "enc_blocks": [_enc_block_init(cfg, generator, dtype, device)
                       for _ in range(cfg.encoder_layers)],
        "enc_ln_f": rmsnorm_init(cfg.d_model, dtype, device),
        "embed": embedding_init(embed_spec(cfg), generator, dtype, device),
        "dec_blocks": [_dec_block_init(cfg, generator, dtype, device)
                       for _ in range(cfg.n_layers)],
        "ln_f": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = linear_init(head_spec(cfg), generator, dtype, device)
    return params


def _attend_memory(q: torch.Tensor, mem_k: torch.Tensor,
                   mem_v: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, H, Dh) attends into memory K/V (B, Sk, Hkv, Dh): (B, Sq,
    H, Dh).  Memory heads repeat CONSECUTIVELY (query head h reads kv head
    ``h // (H / Hkv)``), as in the reference; self-attention groups heads
    interleaved instead.  Scores in fp32, probabilities in ``mem_v``'s
    dtype."""
    b, sq, h, hd = q.shape
    n_rep = h // mem_k.shape[2]
    if n_rep > 1:
        bb, sk, hh, dd = mem_k.shape
        mem_k = mem_k[:, :, :, None, :].expand(bb, sk, hh, n_rep, dd).reshape(
            bb, sk, h, dd)
        mem_v = mem_v[:, :, :, None, :].expand(bb, sk, hh, n_rep, dd).reshape(
            bb, sk, h, dd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), mem_k.float()) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(mem_v.dtype), mem_v)


def _cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     mem_k: torch.Tensor, mem_v: torch.Tensor) -> torch.Tensor:
    """x (B, Sq, D) attends into precomputed memory K/V (B, Sk, Hkv, Dh)
    (:func:`_attend_memory`).  Under a split of the kv heads
    (:func:`_cross_split`) the memory K/V are the rank's block of them and
    the rank attends with the contiguous block of the query heads they
    serve."""
    from repro_torch.plan.sharded import model_block

    xs = _xattn_specs(cfg)
    b, sq, _ = x.shape
    split = _cross_split(cfg)
    q = linear_apply(xs["wq"], p["wq"], x).reshape(b, sq, cfg.n_heads, cfg.hd)
    if split is not None:
        q = model_block(q, 2, split)
    out = _attend_memory(q, mem_k, mem_v)
    return linear_apply(xs["wo"], p["wo"], out.reshape(b, sq, -1), x_split=split)


def _memory_kv(cfg: ModelConfig, p: dict, memory: torch.Tensor):
    """The cross K and V of ``memory``: (B, S_enc, Hkv, Dh) each, the
    rank's block of the kv heads under :func:`_cross_split`."""
    from repro_torch.plan.sharded import model_block

    xs = _xattn_specs(cfg)
    b, sk, _ = memory.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    split = _cross_split(cfg)
    k = linear_apply(xs["wk"], p["wk"], memory).reshape(b, sk, kv, hd)
    v = linear_apply(xs["wv"], p["wv"], memory).reshape(b, sk, kv, hd)
    if split is not None:
        k, v = model_block(k, 2, split), model_block(v, 2, split)
    return k, v


def _enc_block(cfg: ModelConfig, x: torch.Tensor, p_l: dict,
               positions: torch.Tensor) -> torch.Tensor:
    spec = attn_spec(cfg, "enc_attn", causal=False)
    h, _ = attention_apply(spec, p_l["attn"], rmsnorm(p_l["ln1"], x), positions)
    x = x + h
    return x + mlp_apply(mlp_spec(cfg, "enc_mlp"), p_l["mlp"], rmsnorm(p_l["ln2"], x))


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, D) -> encoder memory (B, S_enc, D).

    Each layer runs under ``cfg.remat``, its parameters passed in, so that
    the first layer, whose input (the frames) needs no gradient, is
    recomputed too, as under the reference's ``jax.checkpoint``."""
    x = frames
    b, s, _ = x.shape
    positions = torch.broadcast_to(torch.arange(s, device=x.device)[None, :], (b, s))
    body = _remat(cfg, functools.partial(_enc_block, cfg))
    for p_l in params["enc_blocks"]:
        x = body(x, p_l, positions)
    return rmsnorm(params["enc_ln_f"], x)


def _dec_block(cfg: ModelConfig, p_l: dict, x: torch.Tensor, positions, xk, xv,
               cache: Optional[KVCache], cache_pos):
    h, new_cache = attention_apply(attn_spec(cfg, "dec_attn"), p_l["attn"],
                                   rmsnorm(p_l["ln1"], x), positions, cache, cache_pos)
    x = x + h
    x = x + _cross_attention(cfg, p_l["xattn"], rmsnorm(p_l["lnx"], x), xk, xv)
    x = x + mlp_apply(mlp_spec(cfg, "dec_mlp"), p_l["mlp"], rmsnorm(p_l["ln2"], x))
    return x, new_cache


def _decoder(cfg: ModelConfig, params: dict, tokens: torch.Tensor, memory_kv,
             caches: Optional[list], cache_pos, return_hidden: bool = False):
    """``memory_kv``: (per-layer cross K, per-layer cross V).  Returns
    (logits or, with ``return_hidden``, the final-norm hidden states; the
    new self-attention caches or None)."""
    x = embedding_apply(embed_spec(cfg), params["embed"], tokens)
    b, s, _ = x.shape
    base = torch.as_tensor(cache_pos if cache_pos is not None else 0, device=x.device)
    positions = torch.broadcast_to(base + torch.arange(s, device=x.device)[None, :],
                                   (b, s))
    xks, xvs = memory_kv
    new_caches = [] if caches is not None else None
    for layer, p_l in enumerate(params["dec_blocks"]):
        body = _remat(cfg, functools.partial(_dec_block, cfg, p_l))
        x, nc = body(x, positions, xks[layer], xvs[layer],
                     caches[layer] if caches is not None else None, cache_pos)
        if new_caches is not None:
            new_caches.append(nc)
    x = rmsnorm(params["ln_f"], x)
    if return_hidden:
        return x, new_caches
    return apply_head(cfg, params, x), new_caches


def _stacked_memory_kv(cfg: ModelConfig, params: dict, memory: torch.Tensor):
    """Cross K/V for every decoder layer: ([(B, S_enc, Hkv, Dh)] * L) x2,
    one planned call per projection and layer (the reference's ``vmap``
    over the stacked layers), outside the decoder's remat; the rank's kv
    heads under :func:`_cross_split`."""
    kvs = [_memory_kv(cfg, p_l["xattn"], memory) for p_l in params["dec_blocks"]]
    return [k for k, _ in kvs], [v for _, v in kvs]


def train_loss(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Next-token loss of ``batch = {"tokens", "labels", "frontend"}``
    (tokens and labels (B, S), frames (B, S_enc, D)), chunked when
    ``cfg.loss_chunk`` is set (the rank's share under ``batch_split``:
    ``lm.batch_share``).  The cross K/V stay in the projections' dtype, as
    in the reference."""
    memory = encode(cfg, params, batch["frontend"])
    mem_kv = _stacked_memory_kv(cfg, params, memory)
    if cfg.loss_chunk:
        hidden, _ = _decoder(cfg, params, batch["tokens"], mem_kv, None, None,
                             return_hidden=True)
        return batch_share(chunked_cross_entropy(
            lambda h: apply_head(cfg, params, h), hidden, batch["labels"],
            cfg.loss_chunk, cfg.vocab))
    logits, _ = _decoder(cfg, params, batch["tokens"], mem_kv, None, None)
    return batch_share(cross_entropy(logits, batch["labels"], cfg.vocab))


def _self_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype, device) -> list:
    spec = attn_spec(cfg, "dec_attn")
    return [init_kv_cache(spec, batch, max_seq, dtype, device)
            for _ in range(cfg.n_layers)]


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, enc_len: int,
                dtype: Optional[torch.dtype] = None, device="cuda") -> EncDecCaches:
    """Zero decode caches in ``cfg.dtype`` unless told otherwise: self K/V
    of ``max_seq`` positions and cross K/V of ``enc_len`` frames per
    decoder layer, each the rank's kv heads under the installed rules."""
    dtype = dtype or _dtype(cfg)
    kv = cfg.n_kv_heads
    if _cross_split(cfg) is not None:
        kv //= get_rules().tp
    shape = (batch, enc_len, kv, cfg.hd)

    def zeros():
        return [torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(cfg.n_layers)]

    return EncDecCaches(_self_caches(cfg, batch, max_seq, dtype, device),
                        zeros(), zeros())


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_seq: int):
    """Encode the frames and run the decoder prompt: returns (last-token
    logits (B, V), caches); the cross K/V are cast to ``cfg.dtype``.
    Under a vocab split the logits are the rank's block of the vocab
    (``lm.whole_logits`` gathers them)."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    dtype = _dtype(cfg)
    memory = encode(cfg, params, batch["frontend"])
    xk, xv = _stacked_memory_kv(cfg, params, memory)
    self0 = _self_caches(cfg, b, max_seq, dtype, params["ln_f"]["scale"].device)
    logits, self_kv = _decoder(cfg, params, tokens, (xk, xv), self0,
                               torch.zeros((), dtype=torch.long))
    return logits[:, -1], EncDecCaches(self_kv, [k.to(dtype) for k in xk],
                                       [v.to(dtype) for v in xv])


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                caches: EncDecCaches, cache_pos):
    """One decode step at the scalar position ``cache_pos``: returns
    (logits (B, V), caches), the logits as :func:`prefill`'s."""
    logits, new_self = _decoder(cfg, params, token, (caches.cross_k, caches.cross_v),
                                caches.self_kv, cache_pos)
    return logits[:, -1], EncDecCaches(new_self, caches.cross_k, caches.cross_v)
