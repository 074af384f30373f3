"""Logical-axis sharding rules (DP / TP / SP over the ranks' mesh).

Port of ``src/repro/sharding.py``.  Models and the planned executor ask
for *logical* axes ("batch", "seq", "model", "tokens", None); the launcher
installs :class:`ShardingRules` mapping those to mesh axes
(:mod:`repro_torch.launch.mesh`).  With no rules installed (unit tests,
one process) nothing is sharded.

Resolution rules, as in the reference:
  * "batch"  -> the data-parallel axes (('pod','data') multi-pod, ('data',))
  * "model"  -> the tensor-parallel axis
  * "seq"    -> the sequence-parallel axis (the model axis when SP is on)
  * "tokens" -> a flattened (batch x seq) dim: the DP axes, then the SP axis
  * a dim is only sharded if its size divides the mesh-axes product.

Execution model.  Every rank (a ``torch.distributed`` process) runs the
same host code on the same requests and holds the full parameters, caches
and activations.  Only a planned TT projection is split, by
:mod:`repro_torch.plan.sharded`: each rank contracts its rows of the
token dim (and, under ``tt_model_reduce``, its column block of the input)
and collectives rebuild the full output.  The reference's GSPMD layout
constraints change layouts, not values, so :func:`shard` checks its axes
and returns its input unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional, Sequence

import torch

#: one entry of :meth:`ShardingRules.partition_spec`: an axis name, a tuple
#: of axis names (a merged dim), or None (replicated) - the reference's
#: ``PartitionSpec`` entries
SpecEntry = Optional[Any]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    axis_sizes: dict          # mesh axis name -> size
    batch_axes: tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"
    seq_axis: Optional[str] = None        # set to model axis for SP
    #: the ranks' mesh (:class:`repro_torch.launch.mesh.Mesh`): coordinates
    #: and one process group per axis set; None routes nothing
    mesh: Optional[Any] = None
    #: opt-in row-parallel TT execution: split the leading input mode (and
    #: its core) over the model axis and all-reduce the partial outputs
    #: (see repro_torch.plan.sharded).  Changes float summation order:
    #: outputs are equivalent, not bit-identical.
    tt_model_reduce: bool = False

    def resolve(self, logical: Optional[str]) -> tuple[str, ...]:
        if logical is None:
            return ()
        if logical == "batch":
            return self.batch_axes
        if logical == "model":
            return (self.model_axis,) if self.model_axis else ()
        if logical == "seq":
            return (self.seq_axis,) if self.seq_axis else ()
        if logical == "tokens":
            # a flattened (batch x seq) dim: DP axes, plus the SP axis when
            # sequence parallelism is on (b-major merge matches the layout)
            seq = (self.seq_axis,) if self.seq_axis else ()
            return self.batch_axes + tuple(a for a in seq if a not in self.batch_axes)
        raise ValueError(f"unknown logical axis {logical!r}")

    def token_shard_axes(self, tokens: int) -> tuple[str, ...]:
        """Mesh axes a flattened ``tokens`` dim can shard over, or ``()``.

        The resolved "tokens" axes, kept only when every axis has size > 1
        and ``tokens`` divides their product (each rank takes an exact
        block of rows).
        """
        axes = tuple(a for a in self.resolve("tokens")
                     if self.axis_sizes.get(a, 1) > 1)
        prod = math.prod(self.axis_sizes[a] for a in axes)
        if not axes or prod <= 1 or tokens % prod != 0:
            return ()
        return axes

    def n_token_shards(self, tokens: int) -> int:
        return math.prod(
            self.axis_sizes[a] for a in self.token_shard_axes(tokens)) or 1

    def partition_spec(self, shape: Sequence[int],
                       logical_axes: Sequence) -> tuple[SpecEntry, ...]:
        """Per-dim entries of the reference's ``PartitionSpec``."""
        used: set[str] = set()
        spec: list[SpecEntry] = []
        for dim, logical in zip(shape, logical_axes):
            axes = self.resolve(logical)
            axes = tuple(a for a in axes if a not in used)
            prod = math.prod(self.axis_sizes.get(a, 1) for a in axes)
            if axes and prod > 1 and dim % prod == 0:
                # "tokens" is semantically a merged (batch x seq) dim, so
                # its entry stays a tuple even with one mesh axis
                spec.append(axes if (len(axes) > 1 or logical == "tokens")
                            else axes[0])
                used.update(axes)
            else:
                spec.append(None)
        return tuple(spec)


_tls = threading.local()


def set_rules(rules: Optional[ShardingRules]) -> None:
    _tls.rules = rules


def get_rules() -> Optional[ShardingRules]:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = get_rules()
    set_rules(rules)
    try:
        yield
    finally:
        set_rules(prev)


def shard(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The reference's sharding constraint: one logical name per dim.

    Checks the names against the rank of ``x`` when rules are installed and
    returns ``x`` unchanged: activations are replicated on every rank.
    """
    if get_rules() is not None and len(logical_axes) != x.dim():
        raise ValueError(f"{len(logical_axes)} axes for rank-{x.dim()} array")
    return x
