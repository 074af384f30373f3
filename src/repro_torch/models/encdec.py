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

Under SP (``sharding.splits_sequence``: where the installed rules give
the frames' or the tokens' positions the model axis, each on its own)
the encoder runs the rank's block of the frames and the decoder the
rank's block of the tokens (``lm.seq_block``), every head whole, and
attention gathers K and V over the axis (the encoder's bidirectional
attention too).  The cross K/V of the rank's frames are gathered over the
axis once a decoder layer, because every query reads every frame.  A
part whose sequence stays whole while the step is a training step under
SP runs whole on every rank with the model axis unused (:func:`_part`):
the rank's loss is its share, and a model-axis split would hand a rank
another rank's gradient.  The loss is the rank's share
(:func:`train_loss`), a prefill gathers the logits' positions, and the
caches hold the decode layout (:func:`init_caches`): the cross K/V the
rank's kv heads where they divide the axis, else, where ``_cache_pspec``
gives them its ``seq`` entry, the rank's block of the frames, whose
decode combines the ranks' softmax (:func:`_attend_blocks`).
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from repro_torch.sharding import get_rules, head_layout, kv_seq_split, use_rules

from .blocks import attn_spec, mlp_spec
from .config import ModelConfig
from .lm import (
    SeqBlock,
    _dtype,
    _gather_rows,
    _remat,
    _sequence_split,
    apply_head,
    batch_share,
    chunked_cross_entropy,
    cross_entropy,
    cache_rules,
    embed_spec,
    head_spec,
    seq_block,
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


def _attend_blocks(q: torch.Tensor, mem_k: torch.Tensor, mem_v: torch.Tensor,
                   block) -> torch.Tensor:
    """:func:`_attend_memory` of one query position ``q (B, 1, H, Dh)`` over
    memory K/V that hold the rank's block of the frames (``block``:
    ``model_axis_split``): each rank scores its block and the blocks'
    softmax is combined (``nn/attention.py::_combine_blocks``, one
    all-gather), the same ``(B, 1, H, Dh)`` on every rank."""
    from repro_torch.nn.attention import _combine_blocks

    b, sq, h, hd = q.shape
    hkv = mem_k.shape[2]
    # head j reads kv head j // g: the (Hkv, g) grid, as _combine_blocks'
    # (g, Hkv) groups
    qg = q.reshape(b, sq, hkv, h // hkv, hd).transpose(2, 3)
    scores = torch.einsum("bqghd,bkhd->bghqk", qg.float(), mem_k.float()) / math.sqrt(hd)
    out = _combine_blocks(scores, mem_v, block)
    return out.transpose(2, 3).reshape(b, sq, h, hd)


def _cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     mem_k: torch.Tensor, mem_v: torch.Tensor,
                     blocks: bool = False) -> torch.Tensor:
    """x (B, Sq, D) attends into precomputed memory K/V (B, Sk, Hkv, Dh)
    (:func:`_attend_memory`).  Under a split of the kv heads
    (:func:`_cross_split`) the memory K/V are the rank's block of them (or
    whole, and the rank takes its block) and the rank attends with the
    contiguous block of the query heads they serve.  ``blocks``: the
    memory K/V are the rank's block of the frames (a decode step over a
    cache split so, :func:`_attend_blocks`)."""
    from repro_torch.plan.sharded import model_axis_split, model_block

    xs = _xattn_specs(cfg)
    b, sq, _ = x.shape
    split = _cross_split(cfg)
    q = linear_apply(xs["wq"], p["wq"], x).reshape(b, sq, cfg.n_heads, cfg.hd)
    if split is not None:
        if mem_k.shape[2] == cfg.n_kv_heads:    # the whole heads of an SP prefill
            mem_k, mem_v = model_block(mem_k, 2, split), model_block(mem_v, 2, split)
        q = model_block(q, 2, split)
    if blocks:
        out = _attend_blocks(q, mem_k, mem_v, model_axis_split(get_rules()))
    else:
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


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
           blk: Optional[SeqBlock] = None) -> torch.Tensor:
    """frames (B, S_enc, D) -> encoder memory (B, S_enc, D); with ``blk``
    (SP, under its ``seq_split``: :func:`_part`) the memory of the rank's
    block of the frames (B, S_enc / tp, D).

    Each layer runs under ``cfg.remat``, its parameters passed in, so that
    the first layer, whose input (the frames) needs no gradient, is
    recomputed too, as under the reference's ``jax.checkpoint``."""
    x = frames
    b, s, _ = x.shape
    ar = torch.arange(s, device=x.device)
    if blk is not None:
        x = x.narrow(1, blk.start, blk.size)
        ar = ar[blk.start:blk.start + blk.size]
    positions = torch.broadcast_to(ar[None, :], (b, x.shape[1]))
    body = _remat(cfg, functools.partial(_enc_block, cfg))
    for p_l in params["enc_blocks"]:
        x = body(x, p_l, positions)
    return rmsnorm(params["enc_ln_f"], x)


def _dec_block(cfg: ModelConfig, p_l: dict, x: torch.Tensor, positions, xk, xv,
               cache: Optional[KVCache], cache_pos, blocks: bool = False):
    h, new_cache = attention_apply(attn_spec(cfg, "dec_attn"), p_l["attn"],
                                   rmsnorm(p_l["ln1"], x), positions, cache, cache_pos)
    x = x + h
    x = x + _cross_attention(cfg, p_l["xattn"], rmsnorm(p_l["lnx"], x), xk, xv, blocks)
    x = x + mlp_apply(mlp_spec(cfg, "dec_mlp"), p_l["mlp"], rmsnorm(p_l["ln2"], x))
    return x, new_cache


def _decoder(cfg: ModelConfig, params: dict, tokens: torch.Tensor, memory_kv,
             caches: Optional[list], cache_pos, return_hidden: bool = False,
             blk: Optional[SeqBlock] = None, blocks: bool = False):
    """``memory_kv``: (per-layer cross K, per-layer cross V).  Returns
    (logits or, with ``return_hidden``, the final-norm hidden states; the
    new self-attention caches or None).  ``blk`` (SP, under its
    ``seq_split``): the rank's block of the tokens, whose hidden states
    and logits it returns.  ``blocks``: the cross K/V are the rank's block
    of the frames (:func:`_cross_attention`)."""
    if blk is not None:
        tokens = tokens.narrow(1, blk.start, blk.size)
    x = embedding_apply(embed_spec(cfg), params["embed"], tokens)
    b, s, _ = x.shape
    base = torch.as_tensor(cache_pos if cache_pos is not None else 0, device=x.device)
    first = blk.start if blk is not None else 0
    positions = torch.broadcast_to(
        base + torch.arange(first, first + s, device=x.device)[None, :], (b, s))
    xks, xvs = memory_kv
    new_caches = [] if caches is not None else None
    for layer, p_l in enumerate(params["dec_blocks"]):
        body = _remat(cfg, functools.partial(_dec_block, cfg, p_l, blocks=blocks))
        x, nc = body(x, positions, xks[layer], xvs[layer],
                     caches[layer] if caches is not None else None, cache_pos)
        if new_caches is not None:
            new_caches.append(nc)
    x = rmsnorm(params["ln_f"], x)
    if return_hidden:
        return x, new_caches
    return apply_head(cfg, params, x), new_caches


def _stacked_memory_kv(cfg: ModelConfig, params: dict, memory: torch.Tensor,
                       blk: Optional[SeqBlock] = None):
    """Cross K/V for every decoder layer: ([(B, S_enc, Hkv, Dh)] * L) x2,
    one planned call per projection and layer (the reference's ``vmap``
    over the stacked layers), outside the decoder's remat; the rank's kv
    heads under :func:`_cross_split`.  With ``blk`` (SP, under its
    ``seq_split``) ``memory`` is the rank's block of the frames: its K and
    V are all-gathered over the axis (one ``seq_gather`` a layer), every
    frame and every head."""
    from repro_torch.plan.sharded import seq_gather

    ks, vs = [], []
    for p_l in params["dec_blocks"]:
        k, v = _memory_kv(cfg, p_l["xattn"], memory)
        if blk is not None:
            kv = seq_gather(torch.cat([k, v], dim=2), 1, (blk.group, blk.index, blk.tp))
            k, v = kv[:, :, :k.shape[2]], kv[:, :, k.shape[2]:]
        ks.append(k)
        vs.append(v)
    return ks, vs


def _blocks(cfg: ModelConfig, batch: dict) -> tuple[Optional[SeqBlock], ...]:
    """The rank's :class:`~repro_torch.models.lm.SeqBlock` of the frames and
    of the tokens of ``batch`` where the installed rules split each
    (``lm.seq_block``), else None."""
    return (seq_block(cfg, batch["frontend"][..., 0]), seq_block(cfg, batch["tokens"]))


def splits_batch_sequence(cfg: ModelConfig, batch: dict) -> bool:
    """Whether a step on ``batch`` splits the frames or the tokens (SP)."""
    return any(b is not None for b in _blocks(cfg, batch))


@contextlib.contextmanager
def _part(blk: Optional[SeqBlock], whole_alone: bool):
    """The rules one part of a step (the encoder, the decoder) runs under:
    its sequence's split under ``blk``; where its sequence stays whole and
    ``whole_alone`` (a training step whose other part SP splits: each
    rank's loss a share), the installed rules with the model axis unused,
    every rank computing the part whole with every head; else the
    installed rules."""
    if blk is not None:
        with _sequence_split(blk):
            yield
    elif whole_alone:
        with use_rules(dataclasses.replace(get_rules(), model_axis=None, seq_axis=None)):
            yield
    else:
        yield


def _memory(cfg: ModelConfig, params: dict, frames: torch.Tensor, fblk, tblk,
            whole_alone: bool):
    """The encoder on ``frames`` and the cross K/V of every decoder layer in
    the layout of the decoder's rules (:func:`_part` of ``tblk``): the
    rank's frames gathered under ``fblk``, computed under the decoder's
    rules otherwise."""
    with _part(fblk, whole_alone):
        memory = encode(cfg, params, frames, fblk)
        if fblk is not None:
            return _stacked_memory_kv(cfg, params, memory, fblk)
    with _part(tblk, whole_alone):
        return _stacked_memory_kv(cfg, params, memory)


def train_loss(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Next-token loss of ``batch = {"tokens", "labels", "frontend"}``
    (tokens and labels (B, S), frames (B, S_enc, D)), chunked when
    ``cfg.loss_chunk`` is set (the rank's share under ``batch_split``:
    ``lm.batch_share``).  The cross K/V stay in the projections' dtype, as
    in the reference.  Under SP (:func:`_blocks`) the rank's share: its
    tokens' mean times their part of the sequence, or, where the tokens
    stay whole, ``1 / tp`` of the loss; over the batch blocks."""
    fblk, tblk = _blocks(cfg, batch)
    sp = fblk is not None or tblk is not None
    mem_kv = _memory(cfg, params, batch["frontend"], fblk, tblk, sp)
    labels = batch["labels"]
    with _part(tblk, sp):
        if tblk is not None:
            labels = labels.narrow(1, tblk.start, tblk.size)
        if cfg.loss_chunk:
            hidden, _ = _decoder(cfg, params, batch["tokens"], mem_kv, None, None,
                                 return_hidden=True, blk=tblk)
            ce = chunked_cross_entropy(lambda h: apply_head(cfg, params, h), hidden,
                                       labels, cfg.loss_chunk, cfg.vocab)
        else:
            logits, _ = _decoder(cfg, params, batch["tokens"], mem_kv, None, None,
                                 blk=tblk)
            ce = cross_entropy(logits, labels, cfg.vocab)
    if not sp:
        return batch_share(ce)
    rules = get_rules()
    share = ce * (tblk.size / batch["labels"].shape[1]) if tblk is not None else ce / rules.tp
    return share / rules.split_dp


def _self_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype, device) -> list:
    spec = attn_spec(cfg, "dec_attn")
    return [init_kv_cache(spec, batch, max_seq, dtype, device)
            for _ in range(cfg.n_layers)]


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, enc_len: int,
                dtype: Optional[torch.dtype] = None, device="cuda") -> EncDecCaches:
    """Zero decode caches in ``cfg.dtype`` unless told otherwise: self K/V
    of ``max_seq`` positions and cross K/V of ``enc_len`` frames per
    decoder layer, each the rank's kv heads under the installed rules, or
    under SP, where ``_cache_pspec`` gives them their ``seq`` entry, the
    rank's block of the positions and of the frames (``lm.cache_rules``)."""
    with use_rules(cache_rules(cfg, max_seq)):
        return _init_caches(cfg, batch, max_seq, enc_len, dtype, device)


def _init_caches(cfg, batch, max_seq, enc_len, dtype, device) -> EncDecCaches:
    dtype = dtype or _dtype(cfg)
    kv = cfg.n_kv_heads
    rules = get_rules()
    frames = kv_seq_split(rules, cfg.family, kv, enc_len)
    if frames != bool(rules is not None and rules.cache_seq_split):
        raise ValueError(f"{enc_len} frames and {max_seq} positions do not both "
                         "divide the model axis: the decode cannot split one cache "
                         "over the axis and hold the other whole")
    if _cross_split(cfg) is not None:
        kv //= rules.tp
    elif frames:
        enc_len //= rules.tp
    shape = (batch, enc_len, kv, cfg.hd)

    def zeros():
        return [torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(cfg.n_layers)]

    return EncDecCaches(_self_caches(cfg, batch, max_seq, dtype, device),
                        zeros(), zeros())


def _cache_block(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Whole cross K/V ``t (B, S_enc, Hkv, Dh)`` as the cache leaf ``like``
    holds them: whole, the rank's block of the kv heads or of the frames
    (the model axis's coordinate)."""
    from repro_torch.plan.sharded import model_axis_split

    for dim in (2, 1):
        if t.shape[dim] != like.shape[dim]:
            n = like.shape[dim]
            return t.narrow(dim, model_axis_split(get_rules())[1] * n, n)
    return t


def _prefill(cfg: ModelConfig, params: dict, batch: dict, max_seq: int):
    """Encode the frames and run the decoder prompt into fresh caches:
    (logits, caches, the tokens' block under SP or None)."""
    tokens = batch["tokens"]
    dtype = _dtype(cfg)
    fblk, tblk = _blocks(cfg, batch)
    xk, xv = _memory(cfg, params, batch["frontend"], fblk, tblk, False)
    with use_rules(cache_rules(cfg, max_seq)):
        caches = _init_caches(cfg, tokens.shape[0], max_seq, batch["frontend"].shape[1],
                              dtype, params["ln_f"]["scale"].device)
        with _part(tblk, False):
            logits, self_kv = _decoder(cfg, params, tokens, (xk, xv), caches.self_kv,
                                       torch.zeros((), dtype=torch.long), blk=tblk)
        cross = [[_cache_block(t, c).to(dtype) for t, c in zip(ts, cs)]
                 for ts, cs in ((xk, caches.cross_k), (xv, caches.cross_v))]
    return logits, EncDecCaches(self_kv, *cross), tblk


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_seq: int):
    """Encode the frames and run the decoder prompt: returns (last-token
    logits (B, V), caches); the cross K/V are cast to ``cfg.dtype``.
    Under a vocab split the logits are the rank's block of the vocab
    (``lm.whole_logits`` gathers them); under SP the rank that holds the
    prompt's last token sends its row (one all-gather)."""
    logits, caches, blk = _prefill(cfg, params, batch, max_seq)
    if blk is None:
        return logits[:, -1], caches
    return _gather_rows(logits[:, -1:], blk, 1)[:, -1], caches


def prefill_full(cfg: ModelConfig, params: dict, batch: dict, max_seq: int):
    """:func:`prefill` with the logits of every position (B, S, V); under
    SP the ranks' blocks of the positions are all-gathered."""
    logits, caches, blk = _prefill(cfg, params, batch, max_seq)
    if blk is None:
        return logits, caches
    return _gather_rows(logits, blk, blk.size), caches


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                caches: EncDecCaches, cache_pos):
    """One decode step at the scalar position ``cache_pos``: returns
    (logits (B, V), caches), the logits as :func:`prefill`'s.  Caches split
    over their positions and frames (SP) are read under rules that say so
    (``lm.cache_rules``: ``cache_seq_split``)."""
    rules = get_rules()
    blocks = rules is not None and rules.cache_seq_split
    logits, new_self = _decoder(cfg, params, token, (caches.cross_k, caches.cross_v),
                                caches.self_kv, cache_pos, blocks=blocks)
    return logits[:, -1], EncDecCaches(new_self, caches.cross_k, caches.cross_v)
