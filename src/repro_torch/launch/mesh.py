"""The ranks' mesh, the sharding policy and the parameter shardings.

Port of ``src/repro/launch/mesh.py:1-146``.  Where the reference lays a
``jax.sharding.Mesh`` over devices, this lays a :class:`Mesh` over the
ranks of the initialised ``torch.distributed`` process group: rank ``r``
sits at ``numpy.unravel_index(r, shape)`` (the first axis major, as
``jax.make_mesh`` orders devices), and every set of axes that can shard a
dimension gets one process group per setting of the other axes.  With no
process group, or a world of 1, the mesh is ``{"data": 1, "model": 1}``,
the reference's one-device mesh.  Functions, not module constants:
importing this module touches no process group.

``make_rules`` is the per-(arch x shape) sharding policy:
  * batch  -> ("pod", "data") / ("data",)
  * model  -> the TP axis
  * seq    -> sequence parallelism, on when attention heads cannot shard
    the model axis (kv_heads % tp != 0) or at >= 200k context

``param_shardings`` is the reference's FSDP/TP heuristic, one spec per
leaf as a tuple of entries (an axis name or None per dim, ``()`` for a
replicated leaf), the reference's ``PartitionSpec``.  Every rank computes
with whole parameters (activations are replicated); what the specs split
is the AdamW state: :class:`ParamShards` gives each rank its block of
every split leaf and gathers an updated block back whole
(:mod:`repro_torch.optim.adamw`).  The reference's ``cache_shardings``,
``batch_shardings`` and ``replicated`` feed only its XLA dry run
(``launch/dryrun.py``) and are not ported.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.sharding import ShardingRules, SpecEntry
from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes, this rank's place on them, and its process groups."""

    shape: dict                # axis name -> size, in mesh order
    coords: dict               # axis name -> this rank's coordinate
    #: tuple of axes (mesh order, every size > 1) -> the process group of
    #: the ranks that differ from this one only along those axes
    groups: dict = dataclasses.field(default_factory=dict, repr=False)

    def index(self, axes: tuple[str, ...]) -> int:
        """This rank's place along ``axes`` merged, the first axis major:
        its rank within :meth:`group`, and the block of a dim sharded
        over ``axes`` that it holds."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: tuple[str, ...]) -> Any:
        return self.groups[tuple(a for a in self.shape if a in axes)]


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    world, rank = _world()
    if math.prod(shape) != world:
        raise ValueError(
            f"a {dict(zip(axes, shape))} mesh needs {math.prod(shape)} ranks; "
            f"the process group has {world}")
    coords = {a: int(c) for a, c in zip(axes, np.unravel_index(rank, shape))}
    groups = {}
    if world > 1:
        ranks = np.arange(world).reshape(shape)
        live = [i for i, n in enumerate(shape) if n > 1]
        # every rank creates every group, in the same order
        for k in range(1, len(live) + 1):
            for sub in itertools.combinations(live, k):
                rest = [i for i in range(len(shape)) if i not in sub]
                blocks = ranks.transpose(rest + list(sub)).reshape(
                    -1, math.prod(shape[i] for i in sub))
                for members in blocks.tolist():
                    g = dist.new_group(members)
                    if rank in members:
                        groups[tuple(axes[i] for i in sub)] = g
    return Mesh(dict(zip(axes, shape)), coords, groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def small_mesh_shape(n: int, multi_pod: bool = False,
                     ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``make_test_mesh``'s (shape, axes) over ``n`` ranks."""
    if multi_pod and n >= 8:
        pod = 2
        rest = n // pod
        model = _largest_pow2_le(int(math.isqrt(rest)))
        data = rest // model
        return (pod, data, model), ("pod", "data", "model")
    model = _largest_pow2_le(int(math.isqrt(n)))
    data = n // model
    return (data, model), ("data", "model")


def make_test_mesh(devices: Optional[int] = None, multi_pod: bool = False) -> Mesh:
    """Small mesh over every rank of the process group (``devices``, when
    given, must equal the world size)."""
    return _mesh(*small_mesh_shape(devices or _world()[0], multi_pod))


def _largest_pow2_le(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _decode_cache_gib(cfg: ModelConfig, shape: ShapeConfig, dp: int) -> float:
    """Per-device KV-cache GiB if sharded on batch only (heads replicated)."""
    b_local = max(shape.global_batch // max(dp, 1), 1)
    n_attn = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else 1
    if cfg.family == "rwkv":
        return 0.0
    per_layer = 2 * b_local * shape.seq_len * cfg.n_kv_heads * cfg.hd * 2
    return n_attn * per_layer / 2**30


def sp_enabled(cfg: ModelConfig, shape: ShapeConfig, tp: int,
               dp: int = 16) -> bool:
    if cfg.family == "rwkv":
        return False  # attention-free: heads always shard
    if shape.step == "decode":
        # seq-sharding the KV cache makes every decode step gather it:
        # batch + head sharding whenever the cache fits, SP only when not
        if cfg.n_kv_heads % tp == 0:
            return False
        return _decode_cache_gib(cfg, shape, dp) > 12.0
    if cfg.n_kv_heads % tp != 0:
        return True
    return shape.seq_len >= 200_000


def make_rules(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> ShardingRules:
    axis_sizes = dict(mesh.shape)
    batch_axes = tuple(a for a in ("pod", "data") if a in axis_sizes)
    tp = axis_sizes.get("model", 1)
    dp = math.prod(axis_sizes.get(a, 1) for a in batch_axes)
    return ShardingRules(
        axis_sizes=axis_sizes,
        batch_axes=batch_axes,
        model_axis="model" if "model" in axis_sizes else None,
        seq_axis="model" if sp_enabled(cfg, shape, tp, dp) else None,
        mesh=mesh,
    )


# ---------------------------------------------------------------------------
# parameter shardings
# ---------------------------------------------------------------------------

_REPLICATE_BELOW = 65_536  # elements; TT cores & norms replicate


def _param_pspec(shape: tuple[int, ...], axis_sizes: dict) -> tuple[SpecEntry, ...]:
    """The reference's spec of one parameter leaf: the largest dim that
    divides the model axis takes it, the largest other dim that divides
    the data axis takes that (``()``: replicated)."""
    if math.prod(shape) < _REPLICATE_BELOW or len(shape) < 2:
        return ()
    spec: list = [None] * len(shape)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    tp = axis_sizes.get("model", 1)
    if tp > 1:
        for i in order:
            if shape[i] % tp == 0 and shape[i] >= tp:
                spec[i] = "model"
                break
    fsdp = axis_sizes.get("data", 1)
    if fsdp > 1:
        for i in order:
            if spec[i] is None and shape[i] % fsdp == 0 and shape[i] >= fsdp:
                spec[i] = "data"
                break
    return tuple(spec)


def param_shardings(params: Any, mesh: Mesh) -> Any:
    """FSDP/TP heuristic specs for a parameter (or optimizer-state) tree:
    a tree like ``params`` of :func:`_param_pspec` tuples."""
    axis_sizes = dict(mesh.shape)
    return map_tree(lambda p: _param_pspec(tuple(p.shape), axis_sizes), params)


class ParamShards:
    """This rank's block of each parameter leaf that :func:`param_shardings`
    splits, by the leaf's place in :func:`repro_torch.tree.leaves` order.

    A leaf's block is the slice of each split dim at this rank's coordinate
    on that dim's axis; :meth:`gather` rebuilds the whole leaf from every
    rank's block (an ``all_gather`` over the leaf's axes).
    """

    def __init__(self, params: Any, mesh: Mesh):
        self.mesh = mesh
        self.shapes = [tuple(p.shape) for p in leaves(params)]
        self.specs = [_param_pspec(s, dict(mesh.shape)) for s in self.shapes]

    def split(self, i: int) -> bool:
        return any(e is not None for e in self.specs[i])

    def _axes(self, i: int) -> tuple[str, ...]:
        """The leaf's axes in mesh order (its group's rank order)."""
        return tuple(a for a in self.mesh.shape if a in self.specs[i])

    def _index(self, i: int, coords: dict) -> tuple[slice, ...]:
        out = []
        for n, e in zip(self.shapes[i], self.specs[i]):
            size = n // self.mesh.shape[e] if e is not None else n
            c = coords[e] if e is not None else 0
            out.append(slice(c * size, (c + 1) * size))
        return tuple(out)

    def block(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf ``i``'s whole tensor ``t`` (a view)."""
        return t[self._index(i, self.mesh.coords)]

    def block_shape(self, i: int) -> tuple[int, ...]:
        return tuple(s.stop - s.start for s in self._index(i, self.mesh.coords))

    def gather(self, i: int, block: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` whole, from every rank's ``block`` of it."""
        axes = self._axes(i)
        parts = [torch.empty_like(block) for _ in
                 range(math.prod(self.mesh.shape[a] for a in axes))]
        dist.all_gather(parts, block.contiguous(), group=self.mesh.group(axes))
        whole = block.new_empty(self.shapes[i])
        sizes = [self.mesh.shape[a] for a in axes]
        for g, part in enumerate(parts):
            coords = dict(zip(axes, (int(c) for c in np.unravel_index(g, sizes))))
            whole[self._index(i, coords)] = part
        return whole
