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
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional

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
    """``fn(*args)``, recomputed in the backward pass when its first
    argument (the hidden states) is part of an autograd graph.  The model
    draws no random numbers, so the RNG state is not replayed."""
    if not (torch.is_grad_enabled() and args[0].requires_grad):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
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


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype: Optional[torch.dtype] = None, device="cuda"):
    """Per-layer decode caches in ``cfg.dtype`` unless told otherwise."""
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


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor] = None, caches=None,
            cache_pos=None, return_hidden: bool = False):
    """Returns (logits, caches, aux_loss).

    Prefill: the full sequence; decode: S == 1 with a scalar or per-lane
    ``(B,)`` ``cache_pos``.  VLM: the ``frontend`` prefix (B, P, D) is
    prepended to the token embeddings (prefill only) and its positions are
    cut from the logits.  ``return_hidden`` returns the final-norm hidden
    states (B, S, D) in place of the logits (the chunked-loss path).
    """
    x = embedding_apply(embed_spec(cfg), params["embed"], tokens)
    n_prefix = 0
    if cfg.family == "vlm" and frontend is not None:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
        n_prefix = frontend.shape[1]
    b, s, _ = x.shape
    base = torch.as_tensor(cache_pos if cache_pos is not None else 0,
                           device=x.device)
    ar = torch.arange(s, device=x.device)
    positions = base[:, None] + ar[None, :] if base.dim() == 1 else base + ar[None, :]
    positions = torch.broadcast_to(positions, (b, s))
    x, caches, aux = _run_blocks(cfg, params, x, positions, caches, cache_pos)
    x = rmsnorm(params["ln_f"], x)
    if n_prefix:
        x = x[:, n_prefix:]
    if return_hidden:
        return x, caches, aux
    return apply_head(cfg, params, x), caches, aux


def apply_head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return head_apply(embed_spec(cfg), params["embed"], x)
    return linear_apply(head_spec(cfg), params["head"], x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, in fp32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return torch.mean(lse - ll)


def chunked_cross_entropy(head_fn, hidden: torch.Tensor, labels: torch.Tensor,
                          chunk: int) -> torch.Tensor:
    """Fused head + cross-entropy over sequence chunks (the reference's
    scan): the live logits are bounded at (B * chunk, V).

    Chunks are interleaved as in the reference: token ``t`` of the
    flattened (B * S) tokens goes to chunk ``t % n``.  Each chunk's head
    and loss run under checkpoint (recomputed in the backward pass, the
    reference's ``jax.checkpoint`` on its scan body), its ``lse - ll``
    summed in fp32 and accumulated chunk by chunk, then divided by B * S.
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
        logits = head_fn(h).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lab.long().unsqueeze(-1)).squeeze(-1)
        return torch.sum(lse - ll)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        total = total + _checkpointed(body, hs[i], ls[i])
    return total / (b * s)


def train_loss(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Next-token loss of ``batch = {"tokens", "labels"[, "frontend"]}``
    (tokens and labels (B, S); a VLM's ``frontend`` prefix (B, P, D)):
    the cross-entropy, chunked when ``cfg.loss_chunk`` is set, plus
    ``cfg.aux_loss_weight`` times the auxiliary (MoE load-balance) loss."""
    if cfg.loss_chunk:
        hidden, _, aux = forward(cfg, params, batch["tokens"],
                                 frontend=batch.get("frontend"), return_hidden=True)
        ce = chunked_cross_entropy(lambda h: apply_head(cfg, params, h), hidden,
                                   batch["labels"], cfg.loss_chunk)
        return ce + cfg.aux_loss_weight * aux
    logits, _, aux = forward(cfg, params, batch["tokens"],
                             frontend=batch.get("frontend"))
    return cross_entropy(logits, batch["labels"]) + cfg.aux_loss_weight * aux


def count_params(params) -> int:
    """Number of parameter elements (every leaf of the tree)."""
    return sum(int(math.prod(a.shape)) for a in leaves(params))


def prefill_full(cfg: ModelConfig, params: dict, batch: dict, max_seq: int):
    """Run the prompt (after ``batch["frontend"]`` for a VLM), returning the
    full (B, S, V) logits and primed caches."""
    tokens = batch["tokens"]
    caches = init_caches(cfg, tokens.shape[0], max_seq, device=_device(params))
    logits, caches, _ = forward(cfg, params, tokens, frontend=batch.get("frontend"),
                                caches=caches,
                                cache_pos=torch.zeros((), dtype=torch.long))
    return logits, caches


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_seq: int):
    """Run the full prompt, returning (last-token logits (B, V), primed caches)."""
    logits, caches = prefill_full(cfg, params, batch, max_seq)
    return logits[:, -1], caches


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor, caches,
                cache_pos):
    """One decode step: returns (logits (B, V), caches)."""
    logits, caches, _ = forward(cfg, params, token, caches=caches,
                                cache_pos=cache_pos)
    return logits[:, -1], caches
