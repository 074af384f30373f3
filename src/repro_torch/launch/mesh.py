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
with whole parameters; what the specs split is the AdamW state:
:class:`ParamShards` gives each rank its block of every split leaf and
gathers an updated block back whole (:mod:`repro_torch.optim.adamw`).

``batch_shardings``, ``cache_shardings`` and ``replicated`` are the
reference's specs of a step's inputs and decode caches, in the same form.
The launchers (``launch/serve.py``, ``launch/train.py``) apply their
batch-axis entries: where the batch axes divide a step's global batch
(:func:`batch_layout`), :class:`LayoutBlocks` hands each rank its block of
the inputs (and each decode lane block its caches), and the rank computes
the model on it (:mod:`repro_torch.sharding`).  Of the caches' model-axis
entries the KV caches' heads and, under SP, their positions are applied
(:func:`applied_cache_shardings`: a rank holds its block of the kv heads
or of the positions, as its attention computes them), and so are the SSM
and WKV states' heads and the encoder-decoder's cross K/V heads or, under
SP, frames.
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
from repro_torch.sharding import SP_FAMILIES, ShapeGroup, ShardingRules, SpecEntry
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
        """The process group of ``axes``; on a mesh without ranks (no
        groups: the dry run's) a :class:`~repro_torch.sharding.ShapeGroup`."""
        key = tuple(a for a in self.shape if a in axes)
        if not self.groups and math.prod(self.shape.values()) > 1:
            return ShapeGroup(math.prod(self.shape[a] for a in key))
        return self.groups[key]


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


# ---------------------------------------------------------------------------
# input and cache shardings
# ---------------------------------------------------------------------------

def _cache_pspec(path: str, shape: tuple[int, ...], cfg: ModelConfig,
                 rules: ShardingRules) -> tuple[SpecEntry, ...]:
    """The reference's spec of one decode-cache leaf, by leaf name, in its
    stacked form ``shape = (L, B, ...)``.

    KV-style (L, B, S, H, D): batch -> DP; heads -> model when divisible,
    else sequence -> model (SP cache).  State-style: batch -> DP, the
    channel/head dim -> model when divisible.
    """
    ax = rules.axis_sizes
    tp = ax.get("model", 1)
    dp = math.prod(ax.get(a, 1) for a in rules.batch_axes)
    name = path.rsplit("/", 1)[-1].rsplit(".", 1)[-1]

    def batch_spec(b):
        return _entry(rules.batch_axes) if (dp > 1 and b % dp == 0) else None

    if name in ("k", "v", "cross_k", "cross_v") and len(shape) == 5:
        L, b, s, h, d = shape
        bspec = batch_spec(b)
        if tp > 1 and h % tp == 0:
            return (None, bspec, None, "model", None)
        # seq-shard only when the policy enabled SP (cache too big for
        # batch sharding); otherwise replicate heads: collective-free
        if rules.seq_axis and tp > 1 and s % tp == 0:
            return (None, bspec, "model", None, None)
        return (None, bspec, None, None, None)
    if name == "conv" and len(shape) == 4:
        L, b, k, c = shape
        return (None, batch_spec(b), None,
                "model" if (tp > 1 and c % tp == 0) else None)
    if name in ("ssm", "wkv") and len(shape) == 5:
        L, b, h = shape[:3]
        return (None, batch_spec(b),
                "model" if (tp > 1 and h % tp == 0) else None, None, None)
    if name.startswith("shift") and len(shape) == 3:
        L, b, d = shape
        return (None, batch_spec(b),
                "model" if (tp > 1 and d % tp == 0) else None)
    # fallback: batch dim at index 1 if it matches, else replicate
    if len(shape) >= 2:
        return (None, batch_spec(shape[1]), *([None] * (len(shape) - 2)))
    return ()


def _entry(axes: tuple[str, ...]) -> SpecEntry:
    """A spec entry of ``axes``, as ``PartitionSpec`` keeps it: one axis
    by its name, several as a tuple."""
    return axes[0] if len(axes) == 1 else axes


def _map_named(fn, tree, name: str = ""):
    """``fn(name, leaf)`` over a cache or input tree (dicts, lists, named
    tuples of tensors), ``name`` the nearest dict key or field name above
    the leaf (a list index keeps its parent's)."""
    if isinstance(tree, torch.Tensor):
        return fn(name, tree)
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, str(k)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, v, f)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return tree


def cache_shardings(cfg: ModelConfig, caches: Any, rules: ShardingRules) -> Any:
    """Specs of the port's decode caches (per-layer leaves, batch first):
    the reference's :func:`_cache_pspec` of the stacked leaf, less its
    layer entry."""
    return _map_named(lambda name, t: _cache_pspec(
        name, (1,) + tuple(t.shape), cfg, rules)[1:], caches)


def applied_cache_shardings(cfg: ModelConfig, caches: Any,
                            rules: ShardingRules) -> Any:
    """The entries of :func:`cache_shardings` the port applies: the batch
    entries, and the model entry of the heads of a KV cache (the
    ``kv_major`` head layout, ``nn/attention.py``), of the
    encoder-decoder's cross K/V (``models/encdec.py``) and of the SSM and
    WKV states (``nn/ssm.py``, ``nn/rwkv.py``), and the SP ``seq`` entry of
    the KV caches of every :data:`~repro_torch.sharding.SP_FAMILIES` model
    (the hybrid's shared attention and the encoder-decoder's ``self_kv``
    included) and of the encoder-decoder's ``cross_k`` / ``cross_v`` (a
    rank holds its block of the positions or frames: the decode combines
    the ranks' blocks).  Two state leaves whose model entry the port
    departs from are ``None`` here: the SSM's ``conv`` history (the
    reference splits its channels contiguously, a block that mixes the
    rank's x channels with B and C, which every rank convolves whole; a
    rank holds ``win``'s whole output, so the whole history costs no
    collective, and under SP the scan's halo gather hands every rank the
    whole sequence's last inputs) and RWKV's ``shift*`` token shifts (the
    last token of x, which every rank holds whole for the whole
    projections)."""
    heads = {"k": 2, "v": 2, "cross_k": 2, "cross_v": 2, "ssm": 1, "wkv": 1}
    positions = ({"k": 1, "v": 1, "cross_k": 1, "cross_v": 1}
                 if cfg.family in SP_FAMILIES else {})

    def one(name, t):
        spec = _cache_pspec(name, (1,) + tuple(t.shape), cfg, rules)[1:]
        return tuple(None if e == "model" and d not in (heads.get(name),
                                                        positions.get(name)) else e
                     for d, e in enumerate(spec))

    return _map_named(one, caches)


def batch_shardings(batch: Any, rules: ShardingRules) -> Any:
    """Input batches: leading dim -> the DP axes (when divisible), the rest
    replicated."""
    dp = rules.dp

    def one(name, leaf):
        if leaf.dim() >= 1 and dp > 1 and leaf.shape[0] % dp == 0:
            return (_entry(rules.batch_axes), *([None] * (leaf.dim() - 1)))
        return ()

    return _map_named(one, batch)


def replicated(tree: Any, mesh: Mesh) -> Any:
    return _map_named(lambda name, t: (), tree)


def batch_layout(rules: ShardingRules, batch: int) -> ShardingRules:
    """``rules`` for a step of global batch ``batch``: with
    :attr:`~repro_torch.sharding.ShardingRules.batch_split` set when the
    batch axes divide it (each rank then holds its block of the batch),
    as they are when they do not (the batch stays replicated)."""
    dp = rules.dp
    if rules.mesh is None or dp <= 1 or batch % dp:
        return dataclasses.replace(rules, batch_split=False)
    return dataclasses.replace(rules, batch_split=True)


def describe_layout(rules: ShardingRules, batch: int, what: str,
                    cfg: Optional[ModelConfig] = None, seq: int = 1,
                    max_seq: int = 0) -> str:
    """The report's words for a step's layout, e.g. ``batch split over
    data=2: 4 of 8 sequences a rank``, ``replicated: batch 1 does not
    divide data=2`` or ``batch whole: 16 lanes on every rank (data=1)``;
    with ``cfg`` and a model axis over 1, the model split of a step of
    ``seq`` positions (and of KV caches of ``max_seq``) too
    (:func:`describe_model_split`)."""
    axes = " x ".join(f"{a}={rules.axis_sizes[a]}" for a in rules.batch_axes
                      if rules.axis_sizes.get(a, 1) > 1)
    if rules.batch_split:
        out = (f"batch split over {axes}: {batch // rules.dp} of {batch} "
               f"{what} a rank")
    elif not axes:
        out = (f"batch whole: {batch} {what} on every rank ("
               + " x ".join(f"{a}={rules.axis_sizes.get(a, 1)}"
                            for a in rules.batch_axes) + ")")
    else:
        out = f"replicated: batch {batch} does not divide {axes}"
    if cfg is not None and rules.tp > 1:
        out += "; " + describe_model_split(cfg, rules, seq, max_seq)
    return out


def describe_model_split(cfg: ModelConfig, rules: ShardingRules,
                         seq: int = 1, max_seq: int = 0) -> str:
    """What a rank of a model group holds of the sequence, the heads, d_ff
    and the vocab in a step of ``seq`` positions, e.g. ``heads kv_major
    over model=2: 2 of 4 kv heads a rank, d_ff 1024 of 2048 a rank, vocab
    16000 of 32000 a rank``; where SP splits the step's sequence it comes
    first (``sequence 128 of 512 a rank, heads whole over model=4, d_ff
    whole, vocab whole``), and where it splits KV caches of ``max_seq``
    positions they follow the heads (``KV cache positions 8192 of 32768 a
    rank``).  A hybrid's SSM heads come first and it names no d_ff (it has
    no MLP); an RWKV model names its WKV heads in place of the attention's
    and no d_ff (its channel mix stays whole); the encoder-decoder names
    its cross-attention kv heads after the attention's."""
    from repro_torch.models.blocks import rwkv_spec, ssm_spec
    from repro_torch.sharding import (ff_split, head_layout, kv_layout,
                                      splits_sequence, state_heads, use_rules,
                                      vocab_split)

    tp = rules.tp
    where = f"over {rules.model_axis}={tp}"
    states = {"hybrid": ("ssm", ssm_spec), "rwkv": ("wkv", rwkv_spec)}.get(cfg.family)
    with use_rules(rules):
        sp = splits_sequence(cfg.family, 1, seq)
    step = dataclasses.replace(rules, seq_split=sp)
    if max_seq:
        step = kv_layout(step, cfg.family, cfg.n_kv_heads, max_seq)
    with use_rules(step):
        layout = head_layout(cfg.n_heads, cfg.n_kv_heads)
        ff = ff_split((1, seq), cfg.d_ff)
        vocab = vocab_split((1, 1), cfg.vocab)
        n_states = states[1](cfg).n_heads if states else 0
        split_states = states is not None and state_heads(n_states)
    parts = [f"sequence {seq // tp} of {seq} a rank"] if sp else []
    if states is not None:
        parts.append(f"{states[0]} heads {where}: {n_states // tp} of {n_states} "
                     "a rank" if split_states else f"{states[0]} heads whole {where}")
    if cfg.family != "rwkv":                   # RWKV is attention-free
        parts.append({
            "kv_major": f"heads kv_major {where}: {cfg.n_kv_heads // tp} of "
                        f"{cfg.n_kv_heads} kv heads a rank",
            "q_block": f"heads q_block {where}: {cfg.n_heads // tp} of "
                       f"{cfg.n_heads} query heads a rank",
        }.get(layout, f"heads whole {where}"))
    if step.cache_seq_split:
        parts.append(f"KV cache positions {max_seq // tp} of {max_seq} a rank")
    if cfg.family == "encdec":
        parts.append(f"cross kv heads {cfg.n_kv_heads // tp} of {cfg.n_kv_heads} "
                     "a rank" if layout == "kv_major" else
                     f"cross K/V frames 1/{tp} a rank" if step.cache_seq_split
                     else "cross kv heads whole")
    if cfg.family not in ("hybrid", "rwkv"):
        parts.append(f"d_ff {cfg.d_ff // tp} of {cfg.d_ff} a rank" if ff
                     else "d_ff whole")
    parts.append(f"vocab {cfg.vocab // tp} of {cfg.vocab} a rank" if vocab
                 else "vocab whole")
    return ", ".join(parts)


class LayoutBlocks:
    """A rank's block of an input or cache tree along the entries of
    ``specs`` it applies (:func:`batch_shardings`,
    :func:`applied_cache_shardings`: the batch axes, and the model axis),
    and the whole tree back from every rank's block."""

    def __init__(self, specs: Any, rules: ShardingRules):
        self.rules = rules
        self.mesh = rules.mesh
        self.specs = specs

    def _dims(self, spec) -> list[tuple[int, tuple[str, ...]]]:
        out = []
        applied = self.rules.batch_axes + ((self.rules.model_axis,)
                                           if self.rules.model_axis else ())
        for d, e in enumerate(spec):
            axes = e if isinstance(e, tuple) else (e,) if e else ()
            if axes and all(a in applied for a in axes):
                out.append((d, tuple(a for a in self.mesh.shape if a in axes)))
        return out

    def block(self, tree: Any) -> Any:
        """This rank's block of every leaf of ``tree`` (the whole tree)."""
        def one(t, spec):
            for d, axes in self._dims(spec):
                n = math.prod(self.mesh.shape[a] for a in axes)
                size = t.shape[d] // n
                t = t.narrow(d, self.mesh.index(axes) * size, size)
            return t

        return map_tree(one, tree, self.specs)

    def gather(self, tree: Any) -> Any:
        """The whole tree from every rank's block of it (``tree``)."""
        from repro_torch.plan.sharded import collective

        def one(t, spec):
            for d, axes in self._dims(spec):
                t = collective("all_gather", t, self.mesh.group(axes), dim=d)
            return t

        return map_tree(one, tree, self.specs)
