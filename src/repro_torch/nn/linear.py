"""Unified linear layer: dense or TT-factorized (port of ``nn/linear.py``).

Every projection goes through this module.  TT weights are stored as
their cores; the forward pass contracts the input through the cores along
the installed plan's path (through the plan's kernel backend), or along
the MAC-optimal path when no plan is installed.  Path search is memoised
per network signature.

Differentiable: a projection planned for a kernel (forward or backward)
runs under the executor's ``torch.autograd.Function``, whose backward
contracts the plan's gradient networks on the planned kernels; the plain
executor uses native autograd.

Across ranks (``repro_torch.sharding`` rules with an axis over 1
installed), a kernel-planned projection routes through
:mod:`repro_torch.plan.sharded` whenever :func:`shard_decision` accepts
it: under the rules' ``batch_split`` each rank runs the plan's kernel on
the rows it holds, its block of the batch, with no collective over the
batch axes; on a replicated batch each rank runs it on its token block
and collectives rebuild the output.  A caller holding only its column
block of the input along the model axis (the attention's head block, the
MLP's d_ff block) passes ``x_split``: the sharded route under the model
reduction takes that block as its own column block, any other route
gathers the columns first.  Where it declines (a replicated
batch whose tokens do not divide), every rank runs the plan's kernel on
the whole block, which it holds already, and the record carries no mesh.  (The reference falls back to the plain
executor there, because a global array cannot feed its per-device
kernel; here every rank has the whole activations.)  The reference's
layout constraints on TT intermediates (``_constrain_tokens``) change no
value and are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Iterator, Optional, Sequence

import numpy as np
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

    def n_params(self) -> int:
        if not self.tensorized:
            return self.d_in * self.d_out + (self.d_out if self.bias else 0)
        modes = self.out_modes + self.in_modes
        ranks = (1,) + self.tt_ranks + (1,)
        total = sum(ranks[k] * modes[k] * ranks[k + 1] for k in range(len(modes)))
        return total + (self.d_out if self.bias else 0)

    def network(self, batch: int) -> TensorNetwork:
        return tt_linear_network(batch, self.in_modes, self.out_modes, self.tt_ranks)


def _shard_decision(tokens: int, in_modes: tuple):
    """The installed multi-rank rules and their decision for ``tokens``
    rows (the rank's local rows under the rules' ``batch_split``), or
    ``None`` when a planned kernel runs locally: on one rank, or where
    :func:`shard_decision` declines."""
    from repro_torch.plan.sharded import shard_decision
    from repro_torch.sharding import get_rules

    rules = get_rules()
    if rules is None or all(v <= 1 for v in rules.axis_sizes.values()):
        return None
    decision = shard_decision(rules, tokens, in_modes)
    return None if decision is None else (rules, decision)


def runs_on_kernels(lp) -> bool:
    """Whether a projection planned as ``lp`` runs on the plan's kernels,
    forward or backward (a ``jnp`` forward with kernel backward ops too),
    rather than on the plain executor."""
    from repro_torch.plan.executor import has_kernel_backward

    return lp is not None and (lp.backend != "jnp" or has_kernel_backward(lp))


def sharded_route(spec: LinearSpec, lp, tokens: int):
    """The installed rules and their decision for the sharded route that
    ``spec``, planned as ``lp``, takes on ``tokens`` rows, or ``None``
    where it takes none: on the plain executor, on one rank, or where
    :func:`shard_decision` declines.  Under ``decision.model_reduce`` the
    route takes a caller's column block of ``d_in`` (``x_split``) as its
    own; every other projection gathers it first."""
    if not (spec.tensorized and runs_on_kernels(lp)):
        return None
    return _shard_decision(tokens, spec.in_modes)


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


def installed_factorizations() -> dict[str, FactorizationTriple]:
    """Snapshot of the model-level factorization overrides (name -> triple)."""
    return dict(_FACTORIZATION)


def install_plan(plan, *, force_backend: Optional[str] = None) -> None:
    """Install a :class:`repro_torch.plan.ExecutionPlan` (``None`` clears).

    Any schema version the loader migrates is accepted, train-mode plans
    with ``backward`` entries and fused ``segments`` included.  Legacy
    form: a ``{name: path_index}`` mapping, wrapped into jnp-backend layer
    plans whose steps resolve against the top-K list at run time.
    ``force_backend`` overrides every entry's backend, forward and
    backward (``LayerPlan.with_backend``).
    """
    from repro_torch.plan.schema import BACKENDS, ExecutionPlan, LayerPlan

    if force_backend is not None and force_backend not in BACKENDS:
        raise ValueError(
            f"unknown force_backend {force_backend!r}; have {BACKENDS}")
    _PLAN.clear()
    _FACTORIZATION.clear()
    if plan is None:
        return
    if isinstance(plan, ExecutionPlan):
        entries = {lp.name: lp for lp in plan.layers}
        _FACTORIZATION.update({
            lp.name: lp.factorization.triple
            for lp in plan.layers if lp.factorization is not None
        })
    elif isinstance(plan, dict):
        entries = {
            name: LayerPlan(name=name, path_index=int(idx), path_steps=(),
                            dataflow="OS", partitioning=(1, 1), backend="jnp")
            for name, idx in plan.items()
        }
    else:
        raise TypeError(f"cannot install plan of type {type(plan).__name__}")
    if force_backend is not None:
        if force_backend != "jnp" and any(
                not v.path_steps for v in entries.values()):
            raise ValueError(
                f"force_backend={force_backend!r} requires plans with path "
                "steps; legacy name->index entries execute via jnp only")
        entries = {k: v.with_backend(force_backend) for k, v in entries.items()}
    _PLAN.update(entries)


def planned_layer(name: str):
    """The installed LayerPlan for a projection, or None."""
    return _PLAN.get(name)


def planned_path_index(name: str) -> int:
    lp = _PLAN.get(name)
    return lp.path_index if lp is not None else 0


@contextlib.contextmanager
def kept_plan() -> Iterator[None]:
    """Restore the plan and factorizations installed on entry when the
    block exits, however it exits and whatever it installed meanwhile (the
    launchers' ``run``)."""
    saved = dict(_PLAN)
    saved_fact = dict(_FACTORIZATION)
    try:
        yield
    finally:
        _PLAN.clear()
        _PLAN.update(saved)
        _FACTORIZATION.clear()
        _FACTORIZATION.update(saved_fact)


@contextlib.contextmanager
def plan_context(plan, *, force_backend: Optional[str] = None) -> Iterator[None]:
    """Temporarily install ``plan`` (``None`` = run unplanned), restoring
    whatever was installed before on exit: the serve engine's per-phase
    plan switch."""
    with kept_plan():
        install_plan(plan, force_backend=force_backend)
        yield


_CAPTURE: Optional[dict[str, list[float]]] = None


@contextlib.contextmanager
def capture_activation_rms() -> Iterator[dict[str, float]]:
    """Record per-projection input RMS during forward passes.

    Feeds the rank search's optional activation-weighted accuracy proxy
    (``repro_torch.rank.proxy.activation_calibration``): families whose
    inputs run hot contribute more to the model-level reconstruction
    error.  The yielded dict is filled with ``{name: mean input RMS}`` on
    exit.  Each recorded call reads one scalar back to the host, so keep
    the capture to a calibration batch; no hook runs while no capture is
    open.
    """
    global _CAPTURE
    saved, _CAPTURE = _CAPTURE, {}
    out: dict[str, float] = {}
    try:
        yield out
    finally:
        rec, _CAPTURE = _CAPTURE, saved
        for name, vals in rec.items():
            out[name] = float(np.mean(vals))


# ---------------------------------------------------------------------------
# init / apply
# ---------------------------------------------------------------------------

def shape_only(device) -> bool:
    """True on the ``meta`` device, where an init makes empty tensors of
    the parameters' shapes and dtypes and draws nothing (the dry run's
    ``jax.eval_shape``)."""
    return torch.device(device).type == "meta"


def linear_init(spec: LinearSpec, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device="cuda") -> dict:
    """Parameters with the reference's shapes and standard deviations.

    Drawn on the CPU from ``generator`` (one seed gives the same weights on
    every device), then moved to ``device``; on ``meta``, shapes only.
    """
    def normal(shape, std):
        if shape_only(device):
            return torch.empty(shape, dtype=dtype, device="meta")
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


def linear_apply(
    spec: LinearSpec,
    params: dict,
    x: torch.Tensor,
    *,
    path_index: Optional[int] = None,
    x_split=None,
) -> torch.Tensor:
    """y = x @ W + b with x: (..., d_in) -> (..., d_out).

    An explicit ``path_index`` bypasses the installed plan: the plain
    executor contracts that entry of the top-K list.

    ``x_split`` (:func:`repro_torch.plan.sharded.model_axis_split`): ``x``
    is this rank's contiguous block of the ``d_in`` columns along the
    model axis, ``(..., d_in / tp)``.  A kernel-planned projection under
    the model reduction whose column block is exactly that block takes it
    as it is (no gather; its gradient stays the block's); any other
    projection, a dense one included, all-gathers the columns first.
    """
    lead = tuple(x.shape[:-1])
    tokens = math.prod(lead)
    lp = (planned_layer(spec.name) if spec.tensorized and path_index is None
          else None)
    sharded = sharded_route(spec, lp, tokens)
    if x_split is not None and not (sharded is not None and sharded[1].model_reduce):
        from repro_torch.plan.sharded import model_gather

        x, x_split = model_gather(x, -1, x_split), None
    if not spec.tensorized:
        y = torch.einsum("...i,io->...o", x, params["w"])
    else:
        if _CAPTURE is not None:
            _CAPTURE.setdefault(spec.name, []).append(float(torch.sqrt(
                torch.mean(torch.square(x.detach().to(torch.float32))))))
        n_cores = len(spec.out_modes) + len(spec.in_modes)
        if runs_on_kernels(lp):
            # planned kernel execution, forward or backward (a jnp forward
            # with kernel backward ops too): flatten to (tokens, d_in) and
            # route through the plan's CUDA kernels, differentiable; locally
            # on one rank, per token block across ranks
            from repro_torch.plan.executor import planned_tt_linear

            cores = [params[f"core{k}"] for k in range(n_cores)]
            x2d = x.reshape(tokens, x.shape[-1])
            if sharded is None:
                y2d = planned_tt_linear(
                    lp, x2d, cores, spec.in_modes, spec.out_modes, spec.tt_ranks,
                )
            else:
                from repro_torch.plan.sharded import sharded_tt_linear

                rules, decision = sharded
                y2d = sharded_tt_linear(
                    lp, x2d, cores, spec.in_modes, spec.out_modes, spec.tt_ranks,
                    rules=rules, decision=decision, x_block=x_split is not None,
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
            idx = (path_index if path_index is not None
                   else planned_path_index(spec.name))
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


def linear_apply_batched(spec: LinearSpec, params: dict,
                         x: torch.Tensor) -> torch.Tensor:
    """One kernel-planned TT projection of E stacked weights (the MoE's
    experts): ``x (E, T, d_in) -> (E, T, d_out)``, each leaf of ``params``
    stacked on a leading expert axis.

    The port of the reference's ``jax.vmap`` of :func:`linear_apply` over
    the expert axis: one
    :func:`~repro_torch.plan.executor.planned_tt_linear_batched` call for
    every expert, on the route each expert's call would take (locally, or
    :func:`~repro_torch.plan.sharded.sharded_tt_linear` at ``T`` rows,
    whose splits and collectives the experts then share).  Expert ``e``'s
    output is ``linear_apply(spec, params[e], x[e])``'s.  No activation
    RMS is captured, as the reference's capture skips traced inputs.
    """
    lp = planned_layer(spec.name)
    if not (spec.tensorized and runs_on_kernels(lp)):
        raise ValueError(f"{spec.name}: the batched route needs a tensorized "
                         "projection planned on a kernel")
    tokens = x.shape[1]
    cores = [params[f"core{k}"]
             for k in range(len(spec.out_modes) + len(spec.in_modes))]
    sharded = sharded_route(spec, lp, tokens)
    if sharded is None:
        from repro_torch.plan.executor import planned_tt_linear_batched

        y = planned_tt_linear_batched(lp, x, cores, spec.in_modes,
                                      spec.out_modes, spec.tt_ranks)
    else:
        from repro_torch.plan.sharded import sharded_tt_linear

        rules, decision = sharded
        y = sharded_tt_linear(lp, x, cores, spec.in_modes, spec.out_modes,
                              spec.tt_ranks, rules=rules, decision=decision)
    y = y.to(x.dtype)
    if spec.bias:
        y = y + params["b"][:, None, :].to(y.dtype)
    return y


def linear_flops(spec: LinearSpec, tokens: int, path_index: int = 0) -> int:
    """Forward FLOPs for ``tokens`` rows (dense vs TT path)."""
    if not spec.tensorized:
        return 2 * tokens * spec.d_in * spec.d_out
    paths = _topk_paths_cached(
        tokens, spec.in_modes, spec.out_modes, spec.tt_ranks, spec.tt.top_k
    )
    return 2 * paths[min(path_index, len(paths) - 1)].macs
