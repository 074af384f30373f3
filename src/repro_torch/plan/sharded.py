"""Planned TT execution across ranks: token-parallel and row-parallel.

Port of ``src/repro/plan/sharded.py``.  The reference runs each planned
kernel per shard under ``shard_map`` and hands back a global array; here
every rank is a ``torch.distributed`` process that holds the full
activations (:mod:`repro_torch.sharding`), so a planned projection is
split and rebuilt explicitly:

* the flattened token dim is split over the installed rules' token axes
  (DP, plus the SP axis when sequence parallelism is on), batch-major as
  the reference's ``resolve("tokens")`` merges them: each rank runs the
  *same* ``streaming_tt`` / ``tt_gemm`` route on its ``(tokens/n, d_in)``
  rows, the shape the DSE searched under ``--shards n``, and an
  ``all_gather`` over the token axes' group rebuilds ``(tokens, d_out)``;
* under ``ShardingRules.tt_model_reduce`` each rank of a model group also
  takes its ``1/tp`` column block of x and the matching slice of the
  core that carries the leading input mode, and an ``all_reduce(SUM)``
  over the model axis's group adds the partial outputs (the reference's
  in-body ``psum``).  This changes float summation order: outputs are
  equivalent (~1e-6 rel in fp32), not bit-identical.  Pure token-DP *is*
  bit-identical to the single-device route wherever the kernels' rows do
  not depend on the token count, which the CUDA kernels guarantee.

Serving only: the sharded backward (the core gradients' all-reduce, which
the reference's ``shard_map`` transpose adds) is not ported, so the route
refuses to run under autograd (ROADMAP.md, Queue A item 11b).

Collectives go through :func:`_collective`, which counts them
(:data:`COLLECTIVES`).  Gloo runs ``all_gather`` and ``all_reduce`` on
CUDA tensors itself (copying through the host inside the backend), which
is what lets several ranks share one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .executor import planned_tt_linear, shard_execution
from .schema import LayerPlan

#: collectives the sharded route issued since the last :func:`reset_collectives`
COLLECTIVES: dict[str, int] = {"all_gather": 0, "all_reduce": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclasses.dataclass(frozen=True)
class ShardDecision:
    """How one planned projection maps onto the installed mesh."""

    axes: tuple[str, ...]     # mesh axes sharding the flattened token dim
    n_shards: int             # product of those axis sizes (1 = replicated)
    model_reduce: bool = False  # split leading input mode over model axis
    tp: int = 1               # model-axis size when model_reduce

    def describe(self, axis_sizes: dict, model_axis: Optional[str]) -> str:
        parts = ",".join(f"{a}={axis_sizes[a]}" for a in self.axes)
        if self.model_reduce:
            red = f"reduce({model_axis}={self.tp})"
            return f"{parts}+{red}" if parts else red
        return parts


def shard_decision(rules, tokens: int,
                   in_modes: Sequence[int]) -> Optional[ShardDecision]:
    """Route choice for a planned projection under ``rules``, or ``None``.

    ``None`` means the mesh cannot take this problem (no mesh object, or
    the token count does not divide the DP axes and no model reduction
    applies): the caller runs the planned kernel on the whole block on
    every rank (the reference falls back to the plain executor there).
    """
    if rules is None or rules.mesh is None:
        return None
    axes = rules.token_shard_axes(tokens)
    model_reduce, tp = False, 1
    ma = rules.model_axis
    if rules.tt_model_reduce and ma and ma not in axes:
        tp = int(rules.axis_sizes.get(ma, 1))
        if tp > 1 and in_modes and in_modes[0] % tp == 0:
            model_reduce = True
        else:
            tp = 1
    if not axes and not model_reduce:
        return None
    n = math.prod(rules.axis_sizes[a] for a in axes) if axes else 1
    return ShardDecision(tuple(axes), int(n), model_reduce, tp)


def _collective(kind: str, t: torch.Tensor, group) -> torch.Tensor:
    """``all_gather`` (blocks concatenated along dim 0, in group-rank
    order) or ``all_reduce(SUM)`` of ``t`` over ``group``, counted."""
    COLLECTIVES[kind] += 1
    if kind == "all_reduce":
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0)


def sharded_tt_linear(
    lp: LayerPlan,
    x2d: torch.Tensor,
    cores: Sequence[torch.Tensor],
    in_modes: tuple[int, ...],
    out_modes: tuple[int, ...],
    ranks: tuple[int, ...],
    *,
    rules,
    decision: ShardDecision,
) -> torch.Tensor:
    """Planned TT projection over the ranks: per-shard kernel execution.

    ``x2d: (tokens, d_in)`` -> ``(tokens, d_out)`` on every rank.  This
    rank streams its token block through the plan's backend at the
    per-shard shape; cores are replicated, except the leading input core
    under ``model_reduce``, of which each rank of the model group takes
    its slice.
    """
    if torch.is_grad_enabled() and (
            x2d.requires_grad or any(c.requires_grad for c in cores)):
        raise NotImplementedError(
            "the sharded planned route is forward-only: its backward (the "
            "core gradients' all-reduce) is ROADMAP.md, Queue A item 11b; "
            "run under torch.no_grad() or without sharding rules")
    in_modes, out_modes, ranks = tuple(in_modes), tuple(out_modes), tuple(ranks)
    mesh = rules.mesh
    tokens, d_in = int(x2d.shape[0]), int(x2d.shape[1])
    shard_tokens = tokens // decision.n_shards
    t0 = mesh.index(decision.axes) * shard_tokens
    xs = x2d[t0:t0 + shard_tokens]
    cores = list(cores)
    local_in = in_modes
    if decision.model_reduce:
        tp = decision.tp
        m = mesh.coords[rules.model_axis]
        local_in = (in_modes[0] // tp,) + in_modes[1:]
        # x columns are row-major over in_modes, so a contiguous 1/tp
        # column block IS a slice of the leading input mode j1; cores are
        # ordered out_modes then in_modes, so j1's core sits at index
        # len(out_modes), its mode along dim 1 (interior (r, m, r) and
        # final (r, m) cores alike)
        w = d_in // tp
        xs = xs[:, m * w:(m + 1) * w]
        j1 = len(out_modes)
        c = local_in[0]
        cores[j1] = cores[j1][:, m * c:(m + 1) * c].contiguous()
    desc = decision.describe(rules.axis_sizes, rules.model_axis)
    with shard_execution(desc, (shard_tokens, xs.shape[1])):
        y = planned_tt_linear(lp, xs, cores, local_in, out_modes, ranks)
    y = y.contiguous()
    if decision.model_reduce:
        y = _collective("all_reduce", y, mesh.group((rules.model_axis,)))
    if decision.axes:
        y = _collective("all_gather", y, mesh.group(decision.axes))
    return y
