"""Decoder-only LM: dense / MoE / hybrid (Zamba2) / RWKV6 / VLM (port of
``models/lm.py``).

The reference stacks layer parameters on a leading axis and runs them
under ``lax.scan``; here ``params["blocks"]`` is a list of per-layer dicts
and the layers run in a Python loop.  Caches: attention families hold a
list of per-layer :class:`KVCache` updated in place; RWKV a list of
per-layer :class:`RWKVState`; the hybrid ``{"ssm": [SSMState per layer],
"attn": [KVCache per group]}``.  Forward returns the new cache tree (new
recurrent states, the same KV tensors).

The hybrid family runs groups of ``attn_every`` Mamba layers with the one
shared attention block applied after each group, then the tail of
``n_layers % attn_every`` Mamba layers: Zamba2's parameter sharing.

``cfg.remat`` recomputes activations in the backward pass where the
reference wraps its scan bodies in ``jax.checkpoint``: each block, and
each hybrid group (its Mamba layers and the shared attention).

Under SP (:func:`repro_torch.sharding.splits_sequence`: every family but
RWKV, where the installed rules give a step's sequence the model axis) a
rank takes its block of the positions after the embedding and the VLM
prefix (the reference's ``lm.py:251``; without a prefix the tokens' block
is embedded alone) and runs the layers, the final norm and the head on
it under ``seq_split``: RoPE and the causal mask read the block's global
positions, attention gathers K and V, and the hybrid's Mamba2 layers
hand their conv inputs and SSD state from rank to rank (``nn/ssm.py``).
The prefix rows are dropped on the ranks that hold them.  The loss is the
rank's share (:func:`train_loss`), and the prefill gathers the logits'
positions (:func:`prefill_full`, :func:`prefill`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.nn import (
    EmbeddingSpec,
    LinearSpec,
    embedding_apply,
    embedding_init,
    head_apply,
    init_kv_cache,
    init_rwkv_state,
    init_ssm_state,
    linear_apply,
    linear_init,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.sharding import (
    get_rules,
    kv_layout,
    splits_sequence,
    use_rules,
    vocab_split,
)
from repro_torch.tree import leaves
from .blocks import (
    attn_spec,
    block_apply,
    block_init,
    rwkv_spec,
    shared_attn_apply,
    shared_attn_init,
    ssm_spec,
)
from .config import ModelConfig


def embed_spec(cfg: ModelConfig) -> EmbeddingSpec:
    return EmbeddingSpec("embed", cfg.vocab, cfg.d_model, cfg.tt)


def head_spec(cfg: ModelConfig) -> LinearSpec:
    return LinearSpec("head", cfg.d_model, cfg.vocab, False, "head", cfg.tt)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _save_dots(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of
    unbatched matrix products, recompute everything else (batched
    products and the kernels' autograd Functions included)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, *args, **kwargs):
    """``fn(*args)``, recomputed in the backward pass when a tensor among
    its arguments (the hidden states; the encoder's layer parameters, whose
    first layer's input, the frames, needs no gradient) is part of an
    autograd graph.  The model draws no random numbers, so the RNG state is
    not replayed."""
    if not (torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in leaves(args))):
        return fn(*args)
    rules = get_rules()

    def body(*xs):
        # the recompute runs on the autograd engine's thread (on the card,
        # the device's own), where this thread's sharding rules are not
        # installed: hand them over, so it splits as the forward did
        with use_rules(rules):
            return fn(*xs)

    return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False,
                      **kwargs)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat`` (the reference's ``_remat``).

    ``"full"`` keeps only ``fn``'s inputs for the backward pass and runs
    ``fn`` again there; ``"dots"`` also keeps the outputs of unbatched
    matrix products.  Non-reentrant, so the parameters that reach ``fn``
    through its closure get their gradients.  Outside autograd (serving)
    there is nothing to recompute and ``fn`` runs as is.
    """
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return functools.partial(_checkpointed, fn, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    return functools.partial(_checkpointed, fn)


def _hybrid_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, remainder_layers) for the hybrid family."""
    g = cfg.attn_every if cfg.attn_every else cfg.n_layers
    return cfg.n_layers // g, cfg.n_layers % g


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters with the reference's shapes and standard deviations.

    Drawn on the CPU from ``generator`` and moved to ``device``, so one seed
    gives the same weights on every device.
    """
    dtype = _dtype(cfg)
    params: dict[str, Any] = {
        "embed": embedding_init(embed_spec(cfg), generator, dtype, device),
        "ln_f": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = linear_init(head_spec(cfg), generator, dtype, device)
    params["blocks"] = [block_init(cfg, generator, dtype, device)
                        for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        params["shared_attn"] = shared_attn_init(cfg, generator, dtype, device)
    return params


def cache_rules(cfg: ModelConfig, max_seq: int):
    """The installed rules for caches of ``max_seq`` positions (their
    ``cache_seq_split``: :func:`repro_torch.sharding.kv_layout`), or None
    without rules."""
    return kv_layout(get_rules(), cfg.family, cfg.n_kv_heads, max_seq)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype: Optional[torch.dtype] = None, device="cuda"):
    """Per-layer decode caches in ``cfg.dtype`` unless told otherwise;
    under the installed rules each a rank's block of the heads where they
    split (``init_kv_cache``, ``init_ssm_state``, ``init_rwkv_state``) and
    of the KV positions under SP (:func:`cache_rules`)."""
    with use_rules(cache_rules(cfg, max_seq)):
        return _init_caches(cfg, batch, max_seq, dtype, device)


def _init_caches(cfg, batch, max_seq, dtype, device):
    dtype = dtype or _dtype(cfg)

    def kv():
        return init_kv_cache(attn_spec(cfg), batch, max_seq, dtype, device)

    if cfg.family in ("dense", "moe", "vlm"):
        return [kv() for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        n_groups, _ = _hybrid_groups(cfg)
        return {"ssm": [init_ssm_state(ssm_spec(cfg), batch, dtype, device)
                        for _ in range(cfg.n_layers)],
                "attn": [kv() for _ in range(n_groups)]}
    if cfg.family == "rwkv":
        return [init_rwkv_state(rwkv_spec(cfg), batch, dtype, device)
                for _ in range(cfg.n_layers)]
    raise ValueError(cfg.family)


def _device(params: dict) -> torch.device:
    return params["ln_f"]["scale"].device


def _run_layers(cfg, blocks, layers, x, positions, caches, cache_pos, aux):
    """Run ``blocks[l]`` for ``l`` in ``layers``, each under ``cfg.remat``;
    returns (x, new caches of those layers or None, aux)."""
    new = [] if caches is not None else None
    for layer in layers:
        c_l = caches[layer] if caches is not None else None
        body = _remat(cfg, functools.partial(block_apply, cfg, blocks[layer]))
        x, nc, a = body(x, positions, c_l, cache_pos)
        aux = aux + a
        if new is not None:
            new.append(nc)
    return x, new, aux


def _run_blocks(cfg, params, x, positions, caches, cache_pos):
    """Run every layer.  Returns (x, new_caches, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        return _run_hybrid(cfg, params, x, positions, caches, cache_pos, aux)
    return _run_layers(cfg, params["blocks"], range(cfg.n_layers), x, positions,
                       caches, cache_pos, aux)


def _run_hybrid(cfg, params, x, positions, caches, cache_pos, aux):
    """Groups of ``attn_every`` Mamba layers + shared attention per group,
    each group under ``cfg.remat`` (as are its layers, the reference's
    nested ``jax.checkpoint``), then the remainder layers."""
    n_groups, _ = _hybrid_groups(cfg)
    g = cfg.attn_every if cfg.attn_every else cfg.n_layers
    has_cache = caches is not None
    ssm_c = caches["ssm"] if has_cache else None
    new_ssm: list = []
    new_attn: list = []

    def group(x, aux, gi, attn_cache):
        x, ns, aux = _run_layers(cfg, params["blocks"], range(gi * g, (gi + 1) * g),
                                 x, positions, ssm_c, cache_pos, aux)
        x, na = shared_attn_apply(cfg, params["shared_attn"], x, positions,
                                  attn_cache, cache_pos)
        return x, aux, ns, na

    group = _remat(cfg, group)
    for gi in range(n_groups):
        x, aux, ns, na = group(x, aux, gi,
                               caches["attn"][gi] if has_cache else None)
        if has_cache:
            new_ssm += ns
            new_attn.append(na)
    x, ns, aux = _run_layers(cfg, params["blocks"], range(n_groups * g, cfg.n_layers),
                             x, positions, ssm_c, cache_pos, aux)
    new_caches = {"ssm": new_ssm + ns, "attn": new_attn} if has_cache else None
    return x, new_caches, aux


class SeqBlock(NamedTuple):
    """A rank's block of a step's positions under SP: the sequence's group,
    the rank's index and the number of blocks, the block's first position
    and its length, over all ``n_prefix + text`` positions."""

    group: Any
    index: int
    tp: int
    start: int
    size: int
    n_prefix: int

    @property
    def text(self) -> tuple[int, int]:
        """The rank's text positions ``[lo, hi)`` (the prefix's left out)."""
        lo = max(self.start - self.n_prefix, 0)
        return lo, max(self.start + self.size - self.n_prefix, lo)


def _n_prefix(cfg: ModelConfig, frontend) -> int:
    return frontend.shape[1] if cfg.family == "vlm" and frontend is not None else 0


def seq_block(cfg: ModelConfig, tokens: torch.Tensor,
              frontend: Optional[torch.Tensor] = None) -> Optional[SeqBlock]:
    """The rank's :class:`SeqBlock` of a step on ``tokens`` (B, S) (after a
    VLM's ``frontend`` prefix) when the installed rules split its sequence
    (:func:`~repro_torch.sharding.splits_sequence`, or already
    ``seq_split``), else None."""
    from repro_torch.plan.sharded import model_axis_split

    rules = get_rules()
    n_prefix = _n_prefix(cfg, frontend)
    s_all = tokens.shape[1] + n_prefix
    inside = rules is not None and rules.seq_split
    if not inside and not splits_sequence(cfg.family, tokens.shape[0], s_all):
        return None
    group, index, tp = model_axis_split(rules)
    size = s_all // tp
    return SeqBlock(group, index, tp, index * size, size, n_prefix)


def splits_batch_sequence(cfg: ModelConfig, batch: dict) -> bool:
    """Whether a step on ``batch`` runs its sequence split (:func:`seq_block`)."""
    return seq_block(cfg, batch["tokens"], batch.get("frontend")) is not None


@contextlib.contextmanager
def _sequence_split(blk: Optional[SeqBlock]):
    """The installed rules with ``seq_split`` set under ``blk``."""
    if blk is None:
        yield
        return
    with use_rules(dataclasses.replace(get_rules(), seq_split=True)):
        yield


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor] = None, caches=None,
            cache_pos=None, return_hidden: bool = False):
    """Returns (logits, caches, aux_loss).

    Prefill: the full sequence; decode: S == 1 with a scalar or per-lane
    ``(B,)`` ``cache_pos``.  VLM: the ``frontend`` prefix (B, P, D) is
    prepended to the token embeddings (prefill only) and its positions are
    cut from the logits.  ``return_hidden`` returns the final-norm hidden
    states (B, S, D) in place of the logits (the chunked-loss path).  Under
    rules that split the vocab the logits are this rank's block of it
    (:func:`apply_head`; :func:`whole_logits` gathers them).  Under SP
    (:func:`seq_block`) the hidden states and logits are the rank's text
    positions (:attr:`SeqBlock.text`), whole along the vocab.
    """
    blk = seq_block(cfg, tokens, frontend)
    n_prefix = _n_prefix(cfg, frontend)
    b = tokens.shape[0]
    s_all = tokens.shape[1] + n_prefix
    if blk is not None and not n_prefix:
        tokens = tokens.narrow(1, blk.start, blk.size)
    x = embedding_apply(embed_spec(cfg), params["embed"], tokens)
    if n_prefix:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
        if blk is not None:
            x = x.narrow(1, blk.start, blk.size)
    base = torch.as_tensor(cache_pos if cache_pos is not None else 0,
                           device=x.device)
    ar = torch.arange(s_all, device=x.device)
    if blk is not None:
        ar = ar[blk.start:blk.start + blk.size]
    positions = base[:, None] + ar[None, :] if base.dim() == 1 else base + ar[None, :]
    positions = torch.broadcast_to(positions, (b, x.shape[1]))
    with _sequence_split(blk):
        x, caches, aux = _run_blocks(cfg, params, x, positions, caches, cache_pos)
        x = rmsnorm(params["ln_f"], x)
        if n_prefix:
            lo = n_prefix if blk is None else blk.text[0] + n_prefix - blk.start
            x = x[:, lo:]
        if return_hidden:
            return x, caches, aux
        return apply_head(cfg, params, x), caches, aux


def _vocab_split(lead: tuple[int, ...], vocab: int):
    """:func:`~repro_torch.plan.sharded.model_axis_split` when the installed
    rules split the vocab of logits ``lead + (vocab,)`` over the model
    axis (:func:`~repro_torch.sharding.vocab_split`), else None."""
    from repro_torch.plan.sharded import model_axis_split

    return model_axis_split(get_rules()) if vocab_split(lead, vocab) else None


def apply_head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The logits of hidden states ``x``: under the installed rules' vocab
    split this rank's block of the vocab (the head stays whole: the rank
    takes its block of the output)."""
    from repro_torch.plan.sharded import model_block

    if cfg.tie_embeddings:
        logits = head_apply(embed_spec(cfg), params["embed"], x)
    else:
        logits = linear_apply(head_spec(cfg), params["head"], x)
    split = _vocab_split(tuple(x.shape[:-1]), cfg.vocab)
    return logits if split is None else model_block(logits, -1, split)


def whole_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Logits of the whole vocab from every rank's block of it (the vocab
    split of :func:`apply_head`, all-gathered over the model axis), or
    ``logits`` as they are where they hold the whole vocab already."""
    from repro_torch.plan.sharded import collective, model_axis_split

    if logits.shape[-1] == vocab:
        return logits
    group, _, _ = model_axis_split(get_rules())
    return collective("all_gather", logits, group, dim=-1)


def _token_terms(logits: torch.Tensor, labels: torch.Tensor, vocab: Optional[int]):
    """Per-token ``(logsumexp, label logit)`` of fp32 ``logits``.  Where the
    logits are this rank's block of a split vocab of ``vocab``, each rank
    takes its block's logsumexp and, where it holds the label, its logit;
    the two are all-gathered over the model axis (2 floats a token a rank)
    and combined: a logsumexp of the blocks' logsumexps, a sum of the
    label's logit (0 on the ranks without it).  The loss is then the same
    on every rank of the group, and the gather's backward hands each rank
    its block's share."""
    from repro_torch.plan.sharded import model_axis_split, model_gather

    lse = torch.logsumexp(logits, dim=-1)
    n = logits.shape[-1]
    if vocab is None or n == vocab:
        return lse, torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    split = model_axis_split(get_rules())
    local = labels.long() - split[1] * n
    held = (local >= 0) & (local < n)
    ll = torch.gather(logits, -1, local.clamp(0, n - 1).unsqueeze(-1)).squeeze(-1)
    ll = torch.where(held, ll, torch.zeros_like(ll))
    both = model_gather(torch.stack([lse, ll], dim=-1), -1, split)
    both = both.unflatten(-1, (split[2], 2))
    return torch.logsumexp(both[..., 0], dim=-1), both[..., 1].sum(dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Mean token cross-entropy, in fp32.  ``vocab``: the whole vocab, when
    ``logits`` may be this rank's block of it (:func:`apply_head`)."""
    lse, ll = _token_terms(logits.to(torch.float32), labels, vocab)
    return torch.mean(lse - ll)


def chunked_cross_entropy(head_fn, hidden: torch.Tensor, labels: torch.Tensor,
                          chunk: int, vocab: Optional[int] = None) -> torch.Tensor:
    """Fused head + cross-entropy over sequence chunks (the reference's
    scan): the live logits are bounded at (B * chunk, V).

    Chunks are interleaved as in the reference: token ``t`` of the
    flattened (B * S) tokens goes to chunk ``t % n``.  Each chunk's head
    and loss run under checkpoint (recomputed in the backward pass, the
    reference's ``jax.checkpoint`` on its scan body), its ``lse - ll``
    summed in fp32 and accumulated chunk by chunk, then divided by B * S.
    ``vocab`` as for :func:`cross_entropy`.
    """
    b, s, d = hidden.shape
    c = min(chunk, s)
    if s % c:
        c = s
    n = s // c
    tokens = b * s
    hs = hidden.reshape(tokens // n, n, d).transpose(0, 1)    # (n, T/n, D)
    ls = labels.reshape(tokens // n, n).transpose(0, 1)

    def body(h, lab):
        lse, ll = _token_terms(head_fn(h).to(torch.float32), lab, vocab)
        return torch.sum(lse - ll)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        total = total + _checkpointed(body, hs[i], ls[i])
    return total / (b * s)


def batch_share(loss: torch.Tensor) -> torch.Tensor:
    """This rank's share of a loss over the global batch: under the
    installed rules' ``batch_split`` the rank's own mean over its block,
    divided by the number of blocks (they are equal, the batch divides),
    so the shares of the ranks sum to the global mean; else the loss."""
    rules = get_rules()
    dp = rules.split_dp if rules is not None else 1
    return loss / dp if dp > 1 else loss


def train_loss(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Next-token loss of ``batch = {"tokens", "labels"[, "frontend"]}``
    (tokens and labels (B, S); a VLM's ``frontend`` prefix (B, P, D)):
    the cross-entropy, chunked when ``cfg.loss_chunk`` is set, plus
    ``cfg.aux_loss_weight`` times the auxiliary (MoE load-balance) loss.
    Under ``batch_split`` the rank's share (:func:`batch_share`): the
    batch is its block, and the aux loss, computed from global statistics
    (``nn/moe.py``), is the same on every rank.  Under SP (:func:`seq_block`)
    the labels are the rank's text positions too, and its share is their
    mean times their part of the text, plus its ``1/tp`` of the aux loss,
    over the batch blocks: the shares of every rank sum to the global loss.
    A rank that holds prefix positions alone adds no term, but its graph
    still runs backward (the other ranks' terms read its K and V)."""
    blk = seq_block(cfg, batch["tokens"], batch.get("frontend"))
    if blk is not None:
        return _seq_share(cfg, params, batch, blk)
    if cfg.loss_chunk:
        hidden, _, aux = forward(cfg, params, batch["tokens"],
                                 frontend=batch.get("frontend"), return_hidden=True)
        ce = chunked_cross_entropy(lambda h: apply_head(cfg, params, h), hidden,
                                   batch["labels"], cfg.loss_chunk, cfg.vocab)
        return batch_share(ce + cfg.aux_loss_weight * aux)
    logits, _, aux = forward(cfg, params, batch["tokens"],
                             frontend=batch.get("frontend"))
    return batch_share(cross_entropy(logits, batch["labels"], cfg.vocab)
                       + cfg.aux_loss_weight * aux)


def _seq_share(cfg: ModelConfig, params: dict, batch: dict,
               blk: SeqBlock) -> torch.Tensor:
    """:func:`train_loss`'s share of a rank whose sequence block is ``blk``."""
    with _sequence_split(blk):
        hidden, _, aux = forward(cfg, params, batch["tokens"],
                                 frontend=batch.get("frontend"), return_hidden=True)
        lo, hi = blk.text
        labels = batch["labels"][:, lo:hi]
        if hi == lo:
            ce = hidden.sum() * 0.0
        elif cfg.loss_chunk:
            ce = chunked_cross_entropy(lambda h: apply_head(cfg, params, h), hidden,
                                       labels, cfg.loss_chunk, cfg.vocab)
        else:
            ce = cross_entropy(apply_head(cfg, params, hidden), labels, cfg.vocab)
        share = (ce * ((hi - lo) / batch["labels"].shape[1])
                 + cfg.aux_loss_weight * aux / blk.tp)
        return share / get_rules().split_dp


def count_params(params) -> int:
    """Number of parameter elements (every leaf of the tree)."""
    return sum(int(math.prod(a.shape)) for a in leaves(params))


def _prefill(cfg: ModelConfig, params: dict, batch: dict, max_seq: int):
    """Run the prompt into fresh caches of ``max_seq`` positions: (logits,
    caches, the rank's :class:`SeqBlock` under SP or None)."""
    tokens = batch["tokens"]
    with use_rules(cache_rules(cfg, max_seq)):
        caches = init_caches(cfg, tokens.shape[0], max_seq, device=_device(params))
        logits, caches, _ = forward(cfg, params, tokens, frontend=batch.get("frontend"),
                                    caches=caches,
                                    cache_pos=torch.zeros((), dtype=torch.long))
        return logits, caches, seq_block(cfg, tokens, batch.get("frontend"))


def _gather_rows(rows: torch.Tensor, blk: SeqBlock, n: int) -> torch.Tensor:
    """Every rank's ``rows`` (B, <= n, ...), padded in front with zeros to
    ``n`` (the prefix rows a rank dropped), concatenated along dim 1 over
    the sequence's group: one all-gather."""
    from repro_torch.plan.sharded import collective

    pad = rows.new_zeros((rows.shape[0], n - rows.shape[1]) + tuple(rows.shape[2:]))
    return collective("all_gather", torch.cat([pad, rows], dim=1), blk.group, dim=1)


def prefill_full(cfg: ModelConfig, params: dict, batch: dict, max_seq: int):
    """Run the prompt (after ``batch["frontend"]`` for a VLM), returning the
    full (B, S, V) logits and primed caches; under SP the ranks' blocks of
    the positions are all-gathered (one collective)."""
    logits, caches, blk = _prefill(cfg, params, batch, max_seq)
    if blk is None:
        return logits, caches
    return _gather_rows(logits, blk, blk.size)[:, blk.n_prefix:], caches


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_seq: int):
    """Run the full prompt, returning (last-token logits (B, V), primed
    caches); under SP each rank sends its last row (the last rank's is the
    prompt's last token), one collective."""
    logits, caches, blk = _prefill(cfg, params, batch, max_seq)
    if blk is None:
        return logits[:, -1], caches
    return _gather_rows(logits[:, -1:], blk, 1)[:, -1], caches


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor, caches,
                cache_pos):
    """One decode step: returns (logits (B, V), caches)."""
    logits, caches, _ = forward(cfg, params, token, caches=caches,
                                cache_pos=cache_pos)
    return logits[:, -1], caches
