"""Token embedding and tied LM head: dense or TT-factorized.

Port of ``nn/embedding.py``.  The TT table ``E in R^{V x D}`` is stored as
cores ``G_k in R^{r_{k-1} x v_k x d_k x r_k}``; a row gather decomposes the
token id into mixed-radix digits and contracts the per-digit core slices.
The tied head (``D -> V``) reuses the same cores, contracted right to
left.  Both are plain einsum chains, as in the reference (no planned
kernel runs here).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.tensor_network import factorize
from .linear import TTConfig, shape_only


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    name: str
    vocab: int
    d_model: int
    tt: Optional[TTConfig] = None

    @property
    def tensorized(self) -> bool:
        return self.tt is not None and self.tt.enabled and "embed" in self.tt.targets

    @property
    def vocab_modes(self) -> tuple[int, ...]:
        assert self.tt is not None
        return factorize(self.vocab, self.tt.d)

    @property
    def d_modes(self) -> tuple[int, ...]:
        assert self.tt is not None
        return factorize(self.d_model, self.tt.d)

    @property
    def tt_ranks(self) -> tuple[int, ...]:
        """Interior TT-matrix ranks (length d-1), clipped to full rank."""
        assert self.tt is not None
        vm, dm = self.vocab_modes, self.d_modes
        ranks = []
        left, right = 1, self.vocab * self.d_model
        for k in range(len(vm) - 1):
            left *= vm[k] * dm[k]
            right //= vm[k] * dm[k]
            ranks.append(min(self.tt.rank, left, right))
        return tuple(ranks)


def embedding_init(spec: EmbeddingSpec, generator: torch.Generator,
                   dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    def normal(shape, std):
        if shape_only(device):
            return torch.empty(shape, dtype=dtype, device="meta")
        t = torch.randn(shape, generator=generator, dtype=torch.float32) * std
        return t.to(dtype=dtype, device=device)

    if not spec.tensorized:
        return {"table": normal((spec.vocab, spec.d_model), 0.02)}
    vm, dm = spec.vocab_modes, spec.d_modes
    ranks = (1,) + spec.tt_ranks + (1,)
    d = len(vm)
    # product of d gaussian cores -> per-core std for overall 0.02 stddev
    prod_ranks = math.prod(spec.tt_ranks) or 1
    per_core_std = (0.02**2 / prod_ranks) ** (1.0 / (2 * d))
    return {
        f"core{k}": normal((ranks[k], vm[k], dm[k], ranks[k + 1]), per_core_std)
        for k in range(d)
    }


def _mixed_radix(ids: torch.Tensor, modes: tuple[int, ...]) -> list[torch.Tensor]:
    """Decompose ids into digits for the given mode radices (big-endian)."""
    digits = []
    rem = ids
    for radix in reversed(modes[1:]):
        digits.append(rem % radix)
        rem = rem // radix
    digits.append(rem % modes[0])
    return list(reversed(digits))


def embedding_apply(spec: EmbeddingSpec, params: dict,
                    ids: torch.Tensor) -> torch.Tensor:
    """ids (...,) int -> embeddings (..., d_model)."""
    if not spec.tensorized:
        return params["table"][ids]
    vm = spec.vocab_modes
    digits = _mixed_radix(ids.long(), vm)
    # left-to-right chain contraction: carry (..., r_k, D_prefix)
    out = None
    for k in range(len(vm)):
        core = params[f"core{k}"]             # (r_{k-1}, v_k, d_k, r_k)
        sl = core[:, digits[k]]               # (r_{k-1}, ..., d_k, r_k)
        sl = torch.movedim(sl, 0, -3)         # (..., r_{k-1}, d_k, r_k)
        if out is None:
            out = sl[..., 0, :, :]            # r_0 == 1 -> (..., d_0, r_1)
        else:
            # (..., P, r) x (..., r, d_k, r') -> (..., P, d_k, r')
            out = torch.einsum("...pr,...rds->...pds", out, sl)
            out = out.reshape(out.shape[:-3] + (out.shape[-3] * out.shape[-2],
                                                out.shape[-1]))
    out = out[..., 0]                         # r_d == 1
    return out.reshape(tuple(ids.shape) + (spec.d_model,))


def head_apply(spec: EmbeddingSpec, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: x (..., D) -> logits (..., V) through the same weights.

    Right-to-left chain: carry (T, d_1..d_k, V_suffix, r_k); step k folds
    d_k away and grows the vocab suffix by v_k (peak memory ~2x the logits).
    """
    if not spec.tensorized:
        return torch.einsum("...d,vd->...v", x, params["table"])
    vm, dm = spec.vocab_modes, spec.d_modes
    lead = tuple(x.shape[:-1])
    tokens = math.prod(lead) if lead else 1
    carry = x.reshape((tokens,) + tuple(dm))  # (T, d_1, ..., d_d)
    carry = carry[..., None, None]            # (T, d_1..d_d, V_s=1, r_d=1)
    for k in range(len(vm) - 1, -1, -1):
        core = params[f"core{k}"]             # (r_{k-1}, v_k, d_k, r_k)
        carry = torch.einsum("t...dvs,rwds->t...wvr", carry, core)
        shp = carry.shape                     # (t, ..., v_k, V_s, r_{k-1})
        carry = carry.reshape(shp[:-3] + (shp[-3] * shp[-2], shp[-1]))
    logits = carry[:, :, 0]                   # r_0 == 1 -> (T, V)
    return logits.reshape(lead + (spec.vocab,))
