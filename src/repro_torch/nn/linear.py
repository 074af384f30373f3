"""Unified linear layer: dense or TT-factorized (port of ``nn/linear.py``).

Every projection goes through this module.  TT weights are stored as
their cores; the forward pass contracts the input through the cores along
the installed plan's path (through the plan's kernel backend), or along
the MAC-optimal path when no plan is installed.  Path search is memoised
per network signature.

Differentiable: a projection planned for a kernel (forward or backward)
runs under the executor's ``torch.autograd.Function``, whose backward
contracts the plan's gradient networks on the planned kernels; the plain
executor uses native autograd.  Single-device only: the reference's
sharded branch (``shard_map`` over a mesh) is not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Iterator, Optional, Sequence

import torch

from repro_torch.core.contraction import execute_path
from repro_torch.core.paths import CandidatePath, find_topk_paths
from repro_torch.core.tensor_network import TensorNetwork, factorize, tt_linear_network


@dataclasses.dataclass(frozen=True)
class TTConfig:
    """Model-wide tensorization settings."""

    enabled: bool = False
    d: int = 3                      # modes per side
    rank: int = 16
    min_dim: int = 512              # tensorize only matrices with both dims >= this
    targets: tuple[str, ...] = ("attn", "mlp", "head")
    top_k: int = 4                  # candidate paths kept per layer (paper K)

    def applies(self, tag: str, d_in: int, d_out: int) -> bool:
        return (
            self.enabled
            and tag in self.targets
            and min(d_in, d_out) >= self.min_dim
        )


#: a per-layer TT factorization override: (out_modes, in_modes, ranks)
FactorizationTriple = tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """Static description of one projection.

    ``factorization`` overrides the TTConfig-derived (out_modes, in_modes,
    ranks); when unset, a model-level override installed from a v4 plan
    (:data:`_FACTORIZATION`) applies, else the modes derive from ``tt``.
    """

    name: str
    d_in: int
    d_out: int
    bias: bool = False
    tag: str = "mlp"                # attn | mlp | head | embed | other
    tt: Optional[TTConfig] = None
    factorization: Optional[FactorizationTriple] = None

    @property
    def tensorized(self) -> bool:
        return self.tt is not None and self.tt.applies(self.tag, self.d_in, self.d_out)

    def _factor(self) -> Optional[FactorizationTriple]:
        if self.factorization is not None:
            return self.factorization
        return _FACTORIZATION.get(self.name)

    def with_factorization(
        self,
        out_modes: Sequence[int],
        in_modes: Sequence[int],
        ranks: Sequence[int],
    ) -> "LinearSpec":
        """A copy pinned to an explicit (out_modes, in_modes, ranks)."""
        out_modes = tuple(int(m) for m in out_modes)
        in_modes = tuple(int(m) for m in in_modes)
        ranks = tuple(int(r) for r in ranks)
        if math.prod(out_modes) != self.d_out:
            raise ValueError(
                f"{self.name}: out_modes {out_modes} do not factor "
                f"d_out={self.d_out}")
        if math.prod(in_modes) != self.d_in:
            raise ValueError(
                f"{self.name}: in_modes {in_modes} do not factor "
                f"d_in={self.d_in}")
        if len(ranks) != len(out_modes) + len(in_modes) - 1:
            raise ValueError(
                f"{self.name}: need {len(out_modes) + len(in_modes) - 1} "
                f"interior ranks, got {len(ranks)}")
        return dataclasses.replace(
            self, factorization=(out_modes, in_modes, ranks))

    @property
    def in_modes(self) -> tuple[int, ...]:
        f = self._factor()
        if f is not None:
            return f[1]
        assert self.tt is not None
        return factorize(self.d_in, self.tt.d)

    @property
    def out_modes(self) -> tuple[int, ...]:
        f = self._factor()
        if f is not None:
            return f[0]
        assert self.tt is not None
        return factorize(self.d_out, self.tt.d)

    @property
    def tt_ranks(self) -> tuple[int, ...]:
        """Interior ranks, clipped to the full-rank bound at each cut."""
        f = self._factor()
        if f is not None:
            return f[2]
        assert self.tt is not None
        modes = self.out_modes + self.in_modes
        ranks = []
        left, right = 1, math.prod(modes)
        for k in range(len(modes) - 1):
            left *= modes[k]
            right //= modes[k]
            ranks.append(min(self.tt.rank, left, right))
        return tuple(ranks)

    def network(self, batch: int) -> TensorNetwork:
        return tt_linear_network(batch, self.in_modes, self.out_modes, self.tt_ranks)


# ---------------------------------------------------------------------------
# path cache + plan installation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def _topk_paths_cached(
    batch,                        # int or tuple of leading dims
    in_modes: tuple[int, ...],
    out_modes: tuple[int, ...],
    ranks: tuple[int, ...],
    k: int,
) -> tuple[CandidatePath, ...]:
    tn = tt_linear_network(batch, in_modes, out_modes, ranks)
    return tuple(find_topk_paths(tn, k=k))


_PLAN: dict[str, object] = {}  # linear name -> LayerPlan

#: linear name -> (out_modes, in_modes, ranks) from a v4 plan's searched
#: factorizations; they set parameter shapes, so install before init
_FACTORIZATION: dict[str, FactorizationTriple] = {}


def install_plan(plan, *, force_backend: Optional[str] = None) -> None:
    """Install a :class:`repro_torch.plan.ExecutionPlan` (``None`` clears).

    Any schema version the loader migrates is accepted, train-mode plans
    with ``backward`` entries and fused ``segments`` included.
    ``force_backend`` overrides every entry's backend, forward and
    backward (``LayerPlan.with_backend``).
    """
    from repro_torch.plan.schema import BACKENDS, ExecutionPlan

    if force_backend is not None and force_backend not in BACKENDS:
        raise ValueError(
            f"unknown force_backend {force_backend!r}; have {BACKENDS}")
    _PLAN.clear()
    _FACTORIZATION.clear()
    if plan is None:
        return
    if not isinstance(plan, ExecutionPlan):
        raise TypeError(f"cannot install plan of type {type(plan).__name__}")
    entries = {lp.name: lp for lp in plan.layers}
    _FACTORIZATION.update({
        lp.name: lp.factorization.triple
        for lp in plan.layers if lp.factorization is not None
    })
    if force_backend is not None:
        if force_backend != "jnp" and any(
                not v.path_steps for v in entries.values()):
            raise ValueError(
                f"force_backend={force_backend!r} requires plans with path "
                "steps; index-only entries execute via jnp only")
        entries = {k: v.with_backend(force_backend) for k, v in entries.items()}
    _PLAN.update(entries)


def planned_layer(name: str):
    """The installed LayerPlan for a projection, or None."""
    return _PLAN.get(name)


@contextlib.contextmanager
def plan_context(plan, *, force_backend: Optional[str] = None) -> Iterator[None]:
    """Temporarily install ``plan`` (``None`` = run unplanned), restoring
    whatever was installed before on exit: the serve engine's per-phase
    plan switch."""
    saved = dict(_PLAN)
    saved_fact = dict(_FACTORIZATION)
    install_plan(plan, force_backend=force_backend)
    try:
        yield
    finally:
        _PLAN.clear()
        _PLAN.update(saved)
        _FACTORIZATION.clear()
        _FACTORIZATION.update(saved_fact)


# ---------------------------------------------------------------------------
# init / apply
# ---------------------------------------------------------------------------

def linear_init(spec: LinearSpec, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device="cuda") -> dict:
    """Parameters with the reference's shapes and standard deviations.

    Drawn on the CPU from ``generator`` (one seed gives the same weights on
    every device), then moved to ``device``.
    """
    def normal(shape, std):
        t = torch.randn(shape, generator=generator, dtype=torch.float32) * std
        return t.to(dtype=dtype, device=device)

    if not spec.tensorized:
        std = math.sqrt(2.0 / (spec.d_in + spec.d_out))
        params = {"w": normal((spec.d_in, spec.d_out), std)}
    else:
        modes = spec.out_modes + spec.in_modes
        ranks = (1,) + spec.tt_ranks + (1,)
        target = math.sqrt(2.0 / (spec.d_in + spec.d_out))
        prod_ranks = math.prod(spec.tt_ranks) or 1
        per_core_std = (target**2 / prod_ranks) ** (1.0 / (2 * len(modes)))
        params = {}
        for k in range(len(modes)):
            shape: tuple[int, ...] = (ranks[k], modes[k], ranks[k + 1])
            # boundary ranks of 1 are squeezed (matches tensor-network nodes)
            if k == 0:
                shape = (modes[k], ranks[k + 1])
            elif k == len(modes) - 1:
                shape = (ranks[k], modes[k])
            params[f"core{k}"] = normal(shape, per_core_std)
    if spec.bias:
        params["b"] = torch.zeros((spec.d_out,), dtype=dtype, device=device)
    return params


def linear_apply(spec: LinearSpec, params: dict, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W + b with x: (..., d_in) -> (..., d_out)."""
    lead = tuple(x.shape[:-1])
    if not spec.tensorized:
        y = torch.einsum("...i,io->...o", x, params["w"])
    else:
        lp = planned_layer(spec.name)
        n_cores = len(spec.out_modes) + len(spec.in_modes)
        from repro_torch.plan.executor import (has_kernel_backward,
                                               planned_tt_linear)

        if lp is not None and (lp.backend != "jnp" or has_kernel_backward(lp)):
            # planned kernel execution, forward or backward (a jnp forward
            # with kernel backward ops too): flatten to (tokens, d_in) and
            # route through the plan's CUDA kernels, differentiable
            tokens = math.prod(lead) if lead else 1
            cores = [params[f"core{k}"] for k in range(n_cores)]
            y2d = planned_tt_linear(
                lp, x.reshape(tokens, spec.d_in), cores,
                spec.in_modes, spec.out_modes, spec.tt_ranks,
            )
            y = y2d.reshape(lead + (spec.d_out,)).to(x.dtype)
            if spec.bias:
                y = y + params["b"].to(y.dtype)
            return y
        # plain executor; (B, S) stay split batch edges as in the reference
        if len(lead) == 2:
            bdims: tuple | int = lead
            b_edges = ("b0", "b1")
        else:
            bdims = math.prod(lead) if lead else 1
            b_edges = ("b",)
        xs = x.reshape(tuple(lead if len(lead) == 2 else (bdims,))
                       + spec.in_modes)
        if lp is not None and lp.path_steps:
            steps: tuple[tuple[int, int], ...] = lp.path_steps
        else:
            paths = _topk_paths_cached(
                bdims, spec.in_modes, spec.out_modes, spec.tt_ranks,
                spec.tt.top_k
            )
            idx = lp.path_index if lp is not None else 0
            steps = paths[min(idx, len(paths) - 1)].steps
        if lp is not None:
            from repro_torch.plan.executor import record_execution

            record_execution(lp, math.prod(lead) if lead else 1)
        tn = tt_linear_network(bdims, spec.in_modes, spec.out_modes,
                               spec.tt_ranks)
        tensors = {"X": xs}
        core_names = [n.name for n in tn.nodes if n.name != "X"]
        for k, name in enumerate(core_names):
            tensors[name] = params[f"core{k}"]
        out_edges = b_edges + tuple(f"i{t+1}" for t in range(len(spec.out_modes)))
        y = execute_path(tn, steps, tensors, out_edges=out_edges)
        y = y.reshape(lead + (spec.d_out,))
    if spec.bias:
        y = y + params["b"].to(y.dtype)
    return y
