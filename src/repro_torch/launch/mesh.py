"""The ranks' mesh and the sharding policy (serving half).

Port of ``src/repro/launch/mesh.py:1-131``.  Where the reference lays a
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
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Optional

import numpy as np
import torch.distributed as dist

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.sharding import ShardingRules


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
