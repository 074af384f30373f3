"""Decoder-only LM, dense family (port of ``models/lm.py``).

The reference stacks layer parameters on a leading axis and runs them
under ``lax.scan``; here ``params["blocks"]`` is a list of per-layer dicts
and the layers run in a Python loop.  Caches are a list of per-layer
:class:`KVCache` updated in place.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.nn import (
    EmbeddingSpec,
    LinearSpec,
    embedding_apply,
    embedding_init,
    head_apply,
    init_kv_cache,
    linear_apply,
    linear_init,
    rmsnorm,
    rmsnorm_init,
)
from .blocks import attn_spec, block_apply, block_init
from .config import ModelConfig


def embed_spec(cfg: ModelConfig) -> EmbeddingSpec:
    return EmbeddingSpec("embed", cfg.vocab, cfg.d_model, cfg.tt)


def head_spec(cfg: ModelConfig) -> LinearSpec:
    return LinearSpec("head", cfg.d_model, cfg.vocab, False, "head", cfg.tt)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


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
    return params


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype: Optional[torch.dtype] = None, device="cuda"):
    """Per-layer decode caches in ``cfg.dtype`` unless told otherwise."""
    dtype = dtype or _dtype(cfg)
    return [init_kv_cache(attn_spec(cfg), batch, max_seq, dtype, device)
            for _ in range(cfg.n_layers)]


def _device(params: dict) -> torch.device:
    return params["ln_f"]["scale"].device


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            caches=None, cache_pos=None):
    """Returns (logits, caches).  Prefill: full sequence; decode: S == 1
    with a scalar or per-lane ``(B,)`` ``cache_pos``."""
    x = embedding_apply(embed_spec(cfg), params["embed"], tokens)
    b, s, _ = x.shape
    base = torch.as_tensor(cache_pos if cache_pos is not None else 0,
                           device=x.device)
    ar = torch.arange(s, device=x.device)
    positions = base[:, None] + ar[None, :] if base.dim() == 1 else base + ar[None, :]
    positions = torch.broadcast_to(positions, (b, s))
    for layer, p_l in enumerate(params["blocks"]):
        c_l = caches[layer] if caches is not None else None
        x, _ = block_apply(cfg, p_l, x, positions, c_l, cache_pos)
    x = rmsnorm(params["ln_f"], x)
    return apply_head(cfg, params, x), caches


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


def train_loss(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Next-token loss of ``batch = {"tokens", "labels"}`` (both (B, S)).

    The dense family has no auxiliary loss, so this is the cross-entropy
    alone.  The reference's sequence-chunked head + loss
    (``cfg.loss_chunk``) and rematerialisation (``cfg.remat``) are not
    ported (ROADMAP.md, Queue A item 12): a config that chunks its loss
    raises, and the port keeps every activation for the backward pass.
    """
    if cfg.loss_chunk:
        raise NotImplementedError(
            f"{cfg.name}: loss_chunk={cfg.loss_chunk} (chunked cross-entropy) "
            "is not ported yet (ROADMAP.md, Queue A item 12)")
    logits, _ = forward(cfg, params, batch["tokens"])
    return cross_entropy(logits, batch["labels"])


def prefill_full(cfg: ModelConfig, params: dict, batch: dict, max_seq: int):
    """Run the prompt, returning the full (B, S, V) logits and primed caches."""
    tokens = batch["tokens"]
    caches = init_caches(cfg, tokens.shape[0], max_seq, device=_device(params))
    return forward(cfg, params, tokens, caches=caches,
                   cache_pos=torch.zeros((), dtype=torch.long))


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_seq: int):
    """Run the full prompt, returning (last-token logits (B, V), primed caches)."""
    logits, caches = prefill_full(cfg, params, batch, max_seq)
    return logits[:, -1], caches


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor, caches,
                cache_pos):
    """One decode step: returns (logits (B, V), caches)."""
    logits, caches = forward(cfg, params, token, caches=caches,
                             cache_pos=cache_pos)
    return logits[:, -1], caches

