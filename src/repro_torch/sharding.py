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
same host code and holds the whole parameters.  Where the batch axes
divide a step's global batch, the launcher hands each rank only its block of
the batch (``launch/mesh.py::batch_shardings``, ``cache_shardings``) and
installs rules with :attr:`ShardingRules.batch_split` set: the inputs,
every activation, the decode caches and recurrent states and the loss
terms are the rank's block, and the rank computes the whole model on it,
as the reference's GSPMD partitioning of a step does.  A planned TT
projection then runs its kernel on the local rows with no collective over
the batch axes (:mod:`repro_torch.plan.sharded`); under
``tt_model_reduce`` it still splits its input columns over the model axis.
Where the batch does not divide, the dim stays replicated, as in the
reference: every rank holds the whole batch, and only a planned TT
projection splits its flattened tokens over the batch axes and gathers
them back.

Along the model axis (a mesh with ``model > 1``) each rank of a model
group holds and computes only its block of the dims the reference tags
``"model"``, where :meth:`ShardingRules.partition_spec` gives them the
axis: the attention heads (:func:`head_layout`: the KV cache's kv-head
block, or a block of the query heads), the MLP's d_ff, the vocab of the
logits (:func:`model_dim`), the SSM and WKV heads and their decode states
(:func:`state_heads`) and the encoder-decoder's cross-attention heads and
cross K/V cache.  The projections that make those dims stay whole on
every rank (the reference's planned routes have no column-parallel
matmul): the rank takes its block of their output, and the blocks are
gathered where a whole dim is needed again.  The experts compute whole
along the model axis, as the reference's ``expert_in`` constraint
``("batch", None, None, None)`` has them.

Under sequence parallelism (SP: the policy's ``seq_axis``, the model axis
when the kv heads do not divide it, or at 200 000 positions and more) a
step of any family but RWKV whose sequence takes the axis
(:func:`splits_sequence`, as ``partition_spec(("batch", "seq", None))``
places it) holds each rank's block of the positions: ``models/lm.py``
takes the rank's block after the embedding and the VLM prefix (the
reference's ``lm.py:251``) and runs the layers under
:attr:`ShardingRules.seq_split`; the encoder-decoder splits its frames
and its tokens each where they take the axis (``models/encdec.py``).
The model axis then belongs to the sequence: the heads, d_ff, the SSM
heads and the vocab stay whole (:func:`model_dim`), a planned projection
runs on the rank's rows, attention gathers K and V over the axis, and
the hybrid's Mamba2 scan hands its conv inputs and its SSD state from
rank to rank (``nn/ssm.py``).  A KV cache holds the rank's block of the
positions where ``_cache_pspec`` gives its ``seq`` entry
(:func:`kv_seq_split`, :attr:`ShardingRules.cache_seq_split`), and so do
the encoder-decoder's cross K/V.  RWKV keeps the sequence whole
(:data:`SP_FAMILIES`).  :func:`shard` checks its axes and returns its
input unchanged: the layer that computes a block takes it.
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
    #: the tensors a step is handed hold only this rank's block of the
    #: batch, split over ``batch_axes`` (set by the launchers for a step whose
    #: global batch divides them: ``launch/mesh.py::batch_layout``)
    batch_split: bool = False
    #: the activations of shape ``(B, S, ...)`` a rank holds are its block
    #: of the sequence over ``seq_axis`` (set by ``models/lm.py`` for the
    #: layers of a step whose sequence takes the axis: :func:`splits_sequence`)
    seq_split: bool = False
    #: the KV caches a rank holds are its block of the cache positions over
    #: ``seq_axis`` (:func:`kv_layout`: where ``_cache_pspec`` gives a KV
    #: cache its ``seq`` entry)
    cache_seq_split: bool = False

    @property
    def dp(self) -> int:
        """The product of the batch axes' sizes."""
        return math.prod(self.axis_sizes.get(a, 1) for a in self.batch_axes)

    @property
    def tp(self) -> int:
        """The model axis's size (1 without one)."""
        return int(self.axis_sizes.get(self.model_axis, 1)) if self.model_axis else 1

    @property
    def split_dp(self) -> int:
        """How many blocks the step's batch is split into: :attr:`dp` under
        :attr:`batch_split`, else 1."""
        return self.dp if self.batch_split else 1

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
        block of rows).  Under :attr:`batch_split` the batch axes, and under
        :attr:`seq_split` the sequence's axis, are already split in the rows
        a rank holds and are not among them.
        """
        done = ((self.batch_axes if self.batch_split else ())
                + ((self.seq_axis,) if self.seq_split and self.seq_axis else ()))
        axes = tuple(a for a in self.resolve("tokens")
                     if self.axis_sizes.get(a, 1) > 1 and a not in done)
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


@dataclasses.dataclass(frozen=True)
class ShapeGroup:
    """The process group of a mesh without ranks (the dry run's): its size
    only.  A collective over it moves nothing and keeps shapes."""

    size: int


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


#: the families whose sequence SP splits: every family the reference's
#: ``sp_enabled`` turns SP on for, all but the attention-free RWKV
SP_FAMILIES = ("dense", "moe", "vlm", "hybrid", "encdec")


def splits_sequence(family: str, batch: int, seq: int) -> bool:
    """Whether the installed rules split the ``seq`` positions of a step of
    ``batch`` rows (the rank's block under ``batch_split``) of a
    :data:`SP_FAMILIES` model (an encoder-decoder's frames or tokens,
    each on its own) over the sequence's axis: SP is on and
    :meth:`ShardingRules.partition_spec` gives the ``"seq"`` dim of
    ``("batch", "seq", None)`` the axis (the global batch decides, as in
    :func:`model_dim`).  False inside a split (:attr:`seq_split`)."""
    rules = get_rules()
    if (family not in SP_FAMILIES or rules is None or rules.mesh is None
            or not rules.seq_axis or rules.seq_split):
        return False
    spec = rules.partition_spec((batch * rules.split_dp, seq, 1),
                                ("batch", "seq", None))
    return spec[1] == rules.seq_axis


def kv_seq_split(rules: Optional[ShardingRules], family: str, n_kv_heads: int,
                 max_seq: int) -> bool:
    """Whether ``rules`` split a KV cache of ``max_seq`` positions over the
    sequence's axis: ``launch/mesh.py::_cache_pspec``'s ``seq`` entry (SP
    on, the kv heads not dividing the model axis, the positions dividing
    it), for a :data:`SP_FAMILIES` model."""
    if (family not in SP_FAMILIES or rules is None or rules.mesh is None
            or not rules.seq_axis):
        return False
    tp = rules.tp
    return tp > 1 and n_kv_heads % tp != 0 and max_seq % tp == 0


def kv_layout(rules: Optional[ShardingRules], family: str, n_kv_heads: int,
              max_seq: int) -> Optional[ShardingRules]:
    """``rules`` with :attr:`~ShardingRules.cache_seq_split` as
    :func:`kv_seq_split` gives it for caches of ``max_seq`` positions: the
    rules under which such caches are made and read."""
    if rules is None:
        return None
    return dataclasses.replace(rules, cache_seq_split=kv_seq_split(
        rules, family, n_kv_heads, max_seq))


def model_dim(shape: Sequence[int], *logical_axes) -> Optional[int]:
    """The dim of a tensor of ``shape`` (the rank's block along the batch
    axes under ``batch_split``) that the installed rules split over the
    model axis, as :meth:`ShardingRules.partition_spec` places the
    reference's logical names, or None.  Only rules with a mesh split.
    Under ``seq_split`` the sequence holds the axis: its ``"seq"`` dim, or
    None."""
    rules = get_rules()
    if rules is None or rules.mesh is None or rules.tp <= 1:
        return None
    if rules.seq_split:
        return logical_axes.index("seq") if "seq" in logical_axes else None
    shape = list(shape)
    if shape and logical_axes[0] in ("batch", "tokens"):
        shape[0] *= rules.split_dp      # the global batch decides, as there
    spec = rules.partition_spec(shape, logical_axes)
    return next((d for d, e in enumerate(spec) if e == rules.model_axis), None)


def ff_split(lead: Sequence[int], d_ff: int) -> bool:
    """Whether the installed rules split the d_ff dim of MLP activations
    ``lead + (d_ff,)`` over the model axis: the reference's ``("batch",
    "seq", "model")`` (``nn/mlp.py``), whole under SP, whose sequence
    takes the axis first."""
    return model_dim((*lead, d_ff), "batch", "seq", "model") == len(lead)


def vocab_split(lead: Sequence[int], vocab: int) -> bool:
    """Whether the installed rules split the vocab of logits ``lead +
    (vocab,)`` over the model axis: the reference's ``("batch", None,
    "model")``, or ``("tokens", "model")`` on the chunked loss's 2-d
    logits."""
    names = ("tokens", "model") if len(lead) == 1 else ("batch", None, "model")
    return model_dim((*lead, vocab), *names) == len(lead)


def head_layout(n_heads: int, n_kv_heads: int) -> str:
    """How a layer's attention heads go over the installed rules' model
    axis: ``"kv_major"`` when the kv heads divide it (each rank its block
    of the kv heads, the KV cache's own split, and the query heads they
    serve), ``"q_block"`` when only the query heads do (each rank its
    block of them, K and V whole), ``"whole"`` otherwise (the reference's
    ``_shard_heads``: ``("batch", None, "model", None)`` on q, k, v), and
    whenever the sequence or the KV cache's positions hold the axis (SP:
    every rank computes every head of its positions)."""
    rules = get_rules()
    if rules is not None and (rules.seq_split or rules.cache_seq_split):
        return "whole"
    if model_dim((1, 1, n_kv_heads, 1), "batch", None, "model", None) == 2:
        return "kv_major"
    if model_dim((1, 1, n_heads, 1), "batch", None, "model", None) == 2:
        return "q_block"
    return "whole"


def state_heads(n_heads: int) -> bool:
    """Whether the installed rules split the heads of an SSM or WKV layer
    over the model axis: the reference's ``("batch", "seq", "model",
    None)`` on the heads (``nn/ssm.py``'s x, ``nn/rwkv.py``'s r, k and v),
    which is also ``_cache_pspec``'s split of their decode states.  Under
    ``seq_split`` the hybrid's sequence has taken the axis first, as
    ``partition_spec`` gives it, and the heads stay whole (False); a
    decode step (one position) leaves the axis to the heads again."""
    return model_dim((1, 1, n_heads, 1), "batch", "seq", "model", None) == 2


def shard(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The reference's sharding constraint: one logical name per dim.

    Checks the names against the rank of ``x`` when rules are installed and
    returns ``x`` unchanged: a tensor a rank holds is already its block of
    the batch under ``batch_split`` (the launcher split the inputs), and the
    model axis is applied where a dim is split, by the layer that computes
    it (:func:`model_dim`, :func:`head_layout`, :func:`state_heads`).
    """
    if get_rules() is not None and len(logical_axes) != x.dim():
        raise ValueError(f"{len(logical_axes)} axes for rank-{x.dim()} array")
    return x
