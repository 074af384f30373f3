"""Planned TT execution across ranks: on local rows, token-parallel and
row-parallel.

Port of ``src/repro/plan/sharded.py``.  The reference runs each planned
kernel per shard under ``shard_map`` and hands back a global array; here
every rank is a ``torch.distributed`` process, and what a planned
projection is handed depends on the step's layout
(:mod:`repro_torch.sharding`):

* under ``ShardingRules.batch_split`` the rows a rank holds are already
  its block of the batch (and under ``seq_split`` its block of the
  sequence): those axes leave the token axes, and the rank runs the
  plan's ``streaming_tt`` / ``tt_gemm`` route on its local ``(tokens,
  d_in)`` rows with no collective over them (the shape the DSE searched
  under ``--shards n``).  The records still carry the mesh;
* where the batch stays replicated (it does not divide the batch axes:
  a batch-1 prefill), the flattened token dim is split over the installed
  rules' token axes (DP, plus the SP axis when sequence parallelism is
  on), batch-major as the reference's ``resolve("tokens")`` merges them:
  each rank runs the same route on its ``(tokens/n, d_in)`` rows, and an
  ``all_gather`` over the token axes' group rebuilds ``(tokens, d_out)``;
* under ``ShardingRules.tt_model_reduce`` each rank of a model group also
  takes its ``1/tp`` column block of x and the matching slice of the
  core that carries the leading input mode, and an ``all_reduce(SUM)``
  over the model axis's group adds the partial outputs (the reference's
  in-body ``psum``).  This changes float summation order: outputs are
  equivalent (~1e-6 rel in fp32), not bit-identical.  Pure token-DP *is*
  bit-identical to the single-device route wherever the kernels' rows do
  not depend on the token count, which the CUDA kernels guarantee.

Training.  The ranks that share a block of rows compute the same loss on
it, so each split and each collective is a ``torch.autograd.Function``
whose backward hands every such rank the *whole* gradient of that block
(what the reference's ``shard_map`` transpose gives):

* the token ``all_gather`` of y: the backward takes this rank's row block
  of dy (no sum: dy is the same on every rank);
* the model ``all_reduce`` of y: the backward is the identity;
* the row (and column) block take of x: the backward ``all_gather``s the
  dx blocks over the token group (and over the model group);
* the cores other than j1: the backward ``all_reduce``s their gradients
  over the axes the projection itself split (the token axes, and the
  model axis under the reduce), all of them in one flat buffer; over
  none, no collective;
* core j1's column slice: the backward ``all_reduce``s it over the token
  axes, then ``all_gather``s the slices along dim 1 over the model axis.

The model axis's own splits (:func:`model_block`, :func:`model_gather`,
:func:`model_copy`: a rank's block of the attention, SSM, WKV and
cross-attention heads, d_ff and the vocab) follow the same rule: taking
a block all-gathers its gradient, gathering the blocks takes the rank's
block of the gradient, and a tensor every rank of the group uses whole
but differentiates only in part (K and V under ``q_block``, the SSM's B
and C) sums its gradient once.  A projection handed its column block (``x_block``) returns that
block's dx and gathers nothing over the model axis.

Under ``batch_split`` each block of the batch has its own loss, and the
train step sums every gradient over the batch axes once, after the
backward (``launch/steps.py``): a core gradient summed here over the data
axes too would count ``dp`` times.  Under ``seq_split`` (SP) each rank's
loss is its positions' share too, and the step sums over the sequence's
axis as well; the collectives inside the model are :func:`seq_gather`
(K and V, the encoder-decoder's cross K/V) and :func:`seq_stack` (the
Mamba2 scan's hand-off: every rank's conv tail and SSD end state): each
all-gathered forward, its backward sums the whole gradient over the ranks
and takes the rank's block (a reduce-scatter).  ``model_block``'s
backward all-gathers, so a split routed through it would hand every rank
the whole gradient and the step's sum would count it ``tp`` times.

``torch.distributed.nn.functional``'s collectives are not used: their
backward reduce-scatters (``all_gather``) or all-reduces (``all_reduce``),
which under a replicated loss gives ``n`` times the gradient.  The
kernel's own backward (the executor's autograd Function) re-enters the
rank's :func:`~repro_torch.plan.executor.shard_execution`, so gradient
records carry the mesh and the per-shard shape.

Every collective of the port goes through :func:`collective`, which
counts them (:data:`COLLECTIVES`, forward and backward;
:data:`BWD_COLLECTIVES`, the backward's alone; :data:`COLLECTIVE_BYTES`,
the bytes of each kind: an all-gather's output, an all-reduce's buffer).
``grad_all_reduce`` is the train step's sum of every gradient over the
batch axes.  Over a :class:`~repro_torch.sharding.ShapeGroup` (the dry
run's mesh, tensors on ``meta``) a collective moves nothing and is
counted all the same.  Gloo runs ``all_gather`` and ``all_reduce`` on
CUDA tensors itself (copying through the host inside the backend), which
is what lets several ranks share one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.sharding import ShapeGroup

from .executor import planned_tt_linear, planned_tt_linear_batched, shard_execution
from .schema import LayerPlan

#: collectives sent since the last :func:`reset_collectives`, forward
#: and backward; ``grad_all_reduce`` is the train step's gradient sum
COLLECTIVES: dict[str, int] = {"all_gather": 0, "all_reduce": 0,
                               "grad_all_reduce": 0}
#: the part of :data:`COLLECTIVES` sent by backward passes (the gradient
#: sum counts here: it finishes the backward)
BWD_COLLECTIVES: dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
#: bytes of the collectives of :data:`COLLECTIVES`, by kind
COLLECTIVE_BYTES: dict[str, int] = dict.fromkeys(COLLECTIVES, 0)


def reset_collectives() -> None:
    for counts in (COLLECTIVES, BWD_COLLECTIVES, COLLECTIVE_BYTES):
        for k in counts:
            counts[k] = 0


@dataclasses.dataclass(frozen=True)
class ShardDecision:
    """How one planned projection maps onto the installed mesh."""

    axes: tuple[str, ...]     # mesh axes the route splits the token dim over
    n_shards: int             # product of those axis sizes (1 = replicated)
    model_reduce: bool = False  # split leading input mode over model axis
    tp: int = 1               # model-axis size when model_reduce
    #: batch axes the rows a rank holds are already split over
    #: (``batch_split``): no collective over them
    local: tuple[str, ...] = ()

    def describe(self, axis_sizes: dict, model_axis: Optional[str]) -> str:
        parts = ",".join(f"{a}={axis_sizes[a]}" for a in self.local + self.axes)
        if self.model_reduce:
            red = f"reduce({model_axis}={self.tp})"
            return f"{parts}+{red}" if parts else red
        return parts


def shard_decision(rules, tokens: int,
                   in_modes: Sequence[int]) -> Optional[ShardDecision]:
    """Route choice for a planned projection under ``rules``, or ``None``.

    Under ``batch_split`` the ``tokens`` are a rank's local rows: the batch
    axes are recorded as ``local`` and split nothing more; so is the
    sequence's axis under ``seq_split`` (its rows are the rank's block of
    the positions, and the model reduction, whose axis it is, does not
    apply).  ``None`` means
    the mesh cannot take this problem (no mesh object, or a replicated
    batch whose token count does not divide the DP axes and no model
    reduction applies): the caller runs the planned kernel on the whole
    block on every rank (the reference falls back to the plain executor
    there).  Under autograd that needs no collective: every rank computes
    the whole core gradients itself.
    """
    if rules is None or rules.mesh is None:
        return None
    local = split_axes(rules)
    axes = rules.token_shard_axes(tokens)
    model_reduce, tp = False, 1
    ma = rules.model_axis
    if rules.tt_model_reduce and ma and ma not in axes + local:
        tp = int(rules.axis_sizes.get(ma, 1))
        if tp > 1 and in_modes and in_modes[0] % tp == 0:
            model_reduce = True
        else:
            tp = 1
    if not axes and not model_reduce and not local:
        return None
    n = math.prod(rules.axis_sizes[a] for a in axes) if axes else 1
    return ShardDecision(tuple(axes), int(n), model_reduce, tp, local)


def collective(kind: str, t: torch.Tensor, group, dim: int = 0,
                backward: bool = False) -> torch.Tensor:
    """``all_gather`` (blocks concatenated along ``dim``, in group-rank
    order) or ``all_reduce(SUM)`` (``kind`` ``all_reduce`` or
    ``grad_all_reduce``) of ``t`` over ``group``, counted."""
    COLLECTIVES[kind] += 1
    if backward:
        BWD_COLLECTIVES[kind] += 1
    t = t.contiguous()
    shape_only = isinstance(group, ShapeGroup)
    n = group.size if shape_only else dist.get_world_size(group)
    nbytes = t.numel() * t.element_size()
    if kind != "all_gather":
        COLLECTIVE_BYTES[kind] += nbytes
        if not shape_only:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t
    COLLECTIVE_BYTES[kind] += n * nbytes
    if shape_only:
        return torch.cat([t] * n, dim=dim)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class _TakeBlock(torch.autograd.Function):
    """Block ``index`` of ``n`` along ``dim``; the backward all-reduces the
    block's gradient over ``sum_group`` (when given), then all-gathers the
    blocks over ``group``, so every rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, t, dim: int, index: int, n: int, group: Any,
                sum_group: Any = None):
        ctx.dim, ctx.group, ctx.sum_group = dim, group, sum_group
        size = t.shape[dim] // n
        return t.narrow(dim, index * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_group is not None:
            # a copy: the all-reduce works in place, ``g`` is autograd's
            g = collective("all_reduce", g.clone(), ctx.sum_group,
                            backward=True)
        g = collective("all_gather", g, ctx.group, dim=ctx.dim, backward=True)
        return g, None, None, None, None, None


class _GatherBlocks(torch.autograd.Function):
    """The blocks along ``dim`` of every rank of ``group``, concatenated;
    the backward takes this rank's block of the (replicated) gradient,
    with no sum: every rank's loss reads the whole of it."""

    @staticmethod
    def forward(ctx, t, dim: int, index: int, group: Any):
        ctx.dim, ctx.index, ctx.size = dim, index, t.shape[dim]
        return collective("all_gather", t, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None


class _SumPartials(torch.autograd.Function):
    """The sum of every rank's partial output over ``group``; each rank's
    partial gets the whole (replicated) gradient, so the backward is the
    identity."""

    @staticmethod
    def forward(ctx, t, group: Any):
        ctx.mark_dirty(t)  # the all-reduce sums in place (``t`` contiguous)
        return collective("all_reduce", t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """Cores every rank of ``group`` holds whole, as they are; the backward
    sums their gradients over ``group`` in one flat all-reduce (each rank
    contracted only its own block of the problem)."""

    @staticmethod
    def forward(ctx, group: Any, *cores):
        ctx.group = group
        ctx.like = [torch.empty((0,), dtype=c.dtype, device=c.device)
                    for c in cores]
        ctx.shapes = [c.shape for c in cores]
        return tuple(c.view_as(c) for c in cores)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([
            (g if g is not None else like.new_zeros(s)).reshape(-1)
            for g, like, s in zip(grads, ctx.like, ctx.shapes)])
        flat = collective("all_reduce", flat, ctx.group, backward=True)
        return (None, *(part.reshape(s).clone() for part, s in zip(
            flat.split([math.prod(s) for s in ctx.shapes]), ctx.shapes)))


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
    x_block: bool = False,
) -> torch.Tensor:
    """Planned TT projection over the ranks: per-shard kernel execution.

    ``x2d: (tokens, d_in)`` -> ``(tokens, d_out)`` on every rank, and under
    autograd the whole dx and core gradients of these rows on every rank
    that holds them.  This rank streams its token block (its local rows,
    under ``batch_split``) through the plan's backend at the per-shard
    shape; cores are replicated, except the leading input core under
    ``model_reduce``, of which each rank of the model group takes its
    slice.

    ``x_block``: ``x2d`` is already this rank's column block along the
    model axis, ``(tokens, d_in / tp)``, the leading input mode's slice
    (``decision.model_reduce`` must hold): it is taken as it is, and its
    gradient is this block's alone (nothing gathered over the model axis).

    An ``x2d`` of ``(E, tokens, d_in)`` with every core stacked ``(E,) +
    dims`` is one projection of E experts
    (:func:`~repro_torch.plan.executor.planned_tt_linear_batched`): each
    expert's tokens split as one expert's would, and the experts share
    every split and collective.
    """
    if x_block and not decision.model_reduce:
        raise ValueError("a column block of x needs the model reduction")
    in_modes, out_modes, ranks = tuple(in_modes), tuple(out_modes), tuple(ranks)
    mesh = rules.mesh
    batched = x2d.dim() == 3
    rows, cols = x2d.dim() - 2, x2d.dim() - 1   # the token and d_in dims
    tokens = int(x2d.shape[rows])
    shard_tokens = tokens // decision.n_shards
    token_group = mesh.group(decision.axes) if decision.axes else None
    index = mesh.index(decision.axes)
    xs = x2d
    if decision.axes:
        xs = _TakeBlock.apply(xs, rows, index, decision.n_shards, token_group)
    cores = list(cores)
    local_in = in_modes
    shared = decision.axes
    if decision.model_reduce:
        tp = decision.tp
        ma = rules.model_axis
        m = mesh.coords[ma]
        model_group = mesh.group((ma,))
        shared = decision.axes + (ma,)
        local_in = (in_modes[0] // tp,) + in_modes[1:]
        # x columns are row-major over in_modes, so a contiguous 1/tp
        # column block IS a slice of the leading input mode j1; cores are
        # ordered out_modes then in_modes, so j1's core sits at index
        # len(out_modes), its mode along dim 1 (interior (r, m, r) and
        # final (r, m) cores alike; dim 2 behind the experts' axis)
        if not x_block:
            xs = _TakeBlock.apply(xs, cols, m, tp, model_group)
        j1 = len(out_modes)
        cores[j1] = _TakeBlock.apply(cores[j1], 1 + batched, m, tp, model_group,
                                     token_group)
        rest = [k for k in range(len(cores)) if k != j1]
    else:
        rest = list(range(len(cores)))
    if shared:
        for k, c in zip(rest, _Replicated.apply(mesh.group(shared),
                                                *(cores[k] for k in rest))):
            cores[k] = c
    desc = decision.describe(rules.axis_sizes, rules.model_axis)
    planned = planned_tt_linear_batched if batched else planned_tt_linear
    with shard_execution(desc, (shard_tokens, xs.shape[cols])):
        y = planned(lp, xs, cores, local_in, out_modes, ranks)
    y = y.contiguous()
    if decision.model_reduce:
        y = _SumPartials.apply(y, model_group)
    if decision.axes:
        y = _GatherBlocks.apply(y, rows, index, token_group)
    return y


# ---------------------------------------------------------------------------
# the batch axes, for layers that need more than their block of the batch
# ---------------------------------------------------------------------------

def split_axes(rules) -> tuple[str, ...]:
    """The mesh axes (over 1) whose blocks the activations a rank holds
    are, in mesh order: the batch axes under ``batch_split``, the
    sequence's axis under ``seq_split``."""
    if rules is None or rules.mesh is None:
        return ()
    held = (rules.batch_axes if rules.batch_split else ()) + (
        (rules.seq_axis,) if rules.seq_split and rules.seq_axis else ())
    return tuple(a for a, n in rules.axis_sizes.items() if a in held and n > 1)


def split_group(rules) -> Optional[Any]:
    """The process group of :func:`split_axes` (the ranks whose losses are
    shares of one global loss: the train step sums their gradients), or
    None where a rank holds whole activations."""
    axes = split_axes(rules)
    return rules.mesh.group(axes) if axes else None


def batch_axes_split(rules) -> Optional[tuple[Any, int, int]]:
    """``(group, index, n)`` of the batch axes when ``rules`` split the
    step's batch over them (``batch_split``): their process group, this
    rank's block and the number of blocks; else None."""
    if rules is None or rules.split_dp <= 1:
        return None
    axes = tuple(a for a in rules.batch_axes if rules.axis_sizes.get(a, 1) > 1)
    return rules.mesh.group(axes), rules.mesh.index(axes), rules.split_dp


class _GatherShares(torch.autograd.Function):
    """Every rank's block along ``dim`` over ``group``; the backward sums
    the whole tensor's gradients over the ranks (each rank's loss, a share
    of one global loss, reads the whole of it) and takes this rank's
    block."""

    @staticmethod
    def forward(ctx, t, dim: int, index: int, group: Any):
        ctx.dim, ctx.index, ctx.rows, ctx.group = dim, index, t.shape[dim], group
        return collective("all_gather", t, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = collective("all_reduce", g.clone(), ctx.group, backward=True)
        return g.narrow(ctx.dim, ctx.index * ctx.rows, ctx.rows), None, None, None


class _SumOverRanks(torch.autograd.Function):
    """The sum of every rank's ``t`` over ``group``; the backward sums the
    gradients over the ranks too, so each rank gets the gradient of the
    ranks' summed loss with respect to its own term, and the train step's
    gradient sum counts it once."""

    @staticmethod
    def forward(ctx, t, group: Any):
        ctx.group = group
        return collective("all_reduce", t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return collective("all_reduce", g.clone(), ctx.group, backward=True), None


def gather_batch(t: torch.Tensor, group: Any, index: int) -> torch.Tensor:
    """The whole batch from every rank's block ``t``, differentiable."""
    return _GatherShares.apply(t, 0, index, group)


def seq_axis_split(rules) -> Optional[tuple[Any, int, int]]:
    """``(group, index, tp)`` of the sequence's axis when the installed
    rules hold the rank's block of the sequence (``seq_split``): its
    process group, this rank's block and the number of blocks; else None."""
    if rules is None or not rules.seq_split or rules.mesh is None:
        return None
    a = rules.seq_axis
    n = int(rules.axis_sizes.get(a, 1))
    return (rules.mesh.group((a,)), int(rules.mesh.coords[a]), n) if n > 1 else None


def seq_gather(t: torch.Tensor, dim: int, split) -> torch.Tensor:
    """The whole sequence along ``dim`` from every rank's block ``t``
    (``split``: :func:`seq_axis_split`), all-gathered over the sequence's
    axis; the backward all-reduces the whole gradient and takes the rank's
    block (a reduce-scatter), so each rank ends with the gradient of every
    rank's share with respect to its own positions."""
    group, index, _ = split
    return _GatherShares.apply(t, dim, index, group)


def seq_stack(t: torch.Tensor, split) -> torch.Tensor:
    """Every rank's ``t`` over the sequence's axis (``split``:
    :func:`seq_axis_split`), stacked along a new leading dim in rank order
    (``(tp, *t.shape)``): one all-gather.  The backward all-reduces the
    stack's whole gradient and takes the rank's entry, as
    :func:`seq_gather`'s, so each rank ends with the gradient of every
    rank's share with respect to its own ``t``.  Every rank must read the
    stack into its loss (a slice of it will do), so that every rank runs
    the backward's all-reduce."""
    group, index, _ = split
    return _GatherShares.apply(t.unsqueeze(0), 0, index, group)


def sum_over_ranks(t: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, differentiable."""
    return _SumOverRanks.apply(t, group)


# ---------------------------------------------------------------------------
# the model axis: a rank's block of heads, d_ff and the vocab
# ---------------------------------------------------------------------------

def model_axis_split(rules) -> Optional[tuple[Any, int, int]]:
    """``(group, index, tp)`` of the model axis when ``rules`` have a mesh
    and a model axis over 1: its process group (a
    :class:`~repro_torch.sharding.ShapeGroup` on the dry run's mesh), this
    rank's coordinate on it (the block of a split dim it holds, the same
    coordinate the reduce's column block takes) and its size; else None."""
    if rules is None or rules.mesh is None or rules.tp <= 1:
        return None
    ma = rules.model_axis
    return rules.mesh.group((ma,)), int(rules.mesh.coords[ma]), rules.tp


def model_block(t: torch.Tensor, dim: int, split) -> torch.Tensor:
    """This rank's contiguous block of ``t`` along ``dim`` (``split``:
    :func:`model_axis_split`); the backward all-gathers the blocks'
    gradients over the model axis, so every rank holds the whole one."""
    group, index, tp = split
    return _TakeBlock.apply(t, dim, index, tp, group)


def model_gather(t: torch.Tensor, dim: int, split) -> torch.Tensor:
    """Every rank's block ``t`` along ``dim``, all-gathered over the model
    axis; the backward takes this rank's block, with no sum (the loss is
    the same on every rank of the group)."""
    group, index, _ = split
    return _GatherBlocks.apply(t, dim, index, group)


def model_copy(split, *ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``ts`` as they are, for tensors every rank of the model group uses
    whole but whose gradients each rank computes only in part (K and V
    under a block of the query heads): the backward sums them over the
    model axis, all in one flat all-reduce."""
    return _Replicated.apply(split[0], *ts)
