"""Streaming TT contraction (paper 4.2): CUDA kernel + plain version.

Port of ``src/repro/kernels/streaming_tt.py``.  The TPU kernel pinned all
TT cores in VMEM and contracted each token block against the whole core
chain in one grid step.  A Hopper block has 227 KB of shared memory and
the card 132 SMs, so the CUDA version (``csrc/streaming_tt.cu``) splits
the path in two launches:

* :func:`compile_program` turns ``(network, path_steps)`` into a program,
  per token: the token-free steps (core with core), and the token steps,
  each a small GEMM ``C[p, q] = T[p, k] W[k, q]`` whose operands it lays
  out for the step that reads them, so every read in the token phase is
  dense or strided and the permutations happen once, on writes;
* the free phase runs every token-free step in one launch (each block
  recomputes the intermediates in its shared memory and writes its share
  of the token steps' operands), then the stream kernel runs token tiles
  x column slices of the last step, with each step's token-free operand
  staged in shared memory.

The host picks the grid per call (:func:`launch_grid`); no choice of it
changes an output bit, and a long K splits into groups fixed by the step's
shape (:func:`k_groups`), so a row never depends on the other rows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.backward import backward_networks
from repro_torch.core.contraction import execute_path
from repro_torch.core.paths import CandidatePath, find_topk_paths
from repro_torch.core.tensor_network import Node, TensorNetwork

from . import _build, launches
from .tt_gemm import widen


def _stream_node(tn: TensorNetwork) -> Node:
    """The single streamed (kind == "input") node of the network."""
    inputs = [n for n in tn.nodes if n.kind == "input"]
    if len(inputs) != 1:
        raise ValueError(
            "streaming kernel needs exactly one streamed node, found "
            f"{[n.name for n in inputs]}")
    return inputs[0]


def _stream_layout(tn: TensorNetwork):
    """(stream_name, batch_edge, in_modes, out_edges, out_dim).

    The streamed node must carry exactly one free (batch) edge, leading;
    its remaining edges are the flattened inner dim of the 2-d operand.
    ``out_edges`` orders the result batch edge first, then the weight-side
    free edges in node order: the row-major layout of the 2-d output.
    """
    x = _stream_node(tn)
    free = set(tn.free_edges)
    batch_edges = [e for e in x.edges if e in free]
    if len(batch_edges) != 1 or x.edges[0] != batch_edges[0]:
        raise ValueError(
            f"streamed node {x.name}: need a single leading batch edge, "
            f"got edges {x.edges} (free: {batch_edges})")
    batch = batch_edges[0]
    in_modes = tuple(d for e, d in zip(x.edges, x.dims) if e != batch)
    out = [
        (e, d)
        for n in tn.nodes if n.kind != "input"
        for e, d in zip(n.edges, n.dims) if e in free
    ]
    out_edges = (batch,) + tuple(e for e, _ in out)
    out_dim = math.prod((d for _, d in out), start=1)
    return x.name, batch, in_modes, out_edges, out_dim


def _rebatch(tn: TensorNetwork, tokens: int) -> TensorNetwork:
    """Rebind the streamed node's leading batch edge to ``tokens``."""
    x = _stream_node(tn)
    return TensorNetwork([
        Node(n.name, n.edges, (tokens,) + n.dims[1:], n.kind)
        if n.name == x.name else n
        for n in tn.nodes
    ])


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def streaming_tt_linear_plain(
    x: torch.Tensor,
    cores: Sequence[torch.Tensor],
    tn: TensorNetwork,
    path: CandidatePath,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version: ``execute_path`` over all tokens at once.

    Rows are independent, so contracting the whole batch in one pass
    computes the function the block-streamed kernel computes.  Every step
    folds in fp32; the result is cast once to ``out_dtype`` (default:
    x's dtype).
    """
    tokens, n_in = x.shape
    stream_name, _, in_modes, out_edges, out_dim = _stream_layout(tn)
    if math.prod(in_modes) != n_in:
        raise ValueError("x inner dim does not match network input modes")
    full = _rebatch(tn, tokens)
    tensors = {stream_name: x.reshape((tokens,) + in_modes)}
    names = [n.name for n in full.nodes if n.kind != "input"]
    tensors.update(zip(names, cores))
    y = execute_path(full, path, tensors, out_edges=out_edges,
                     preferred_dtype=torch.float32)
    return y.reshape(tokens, out_dim).to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# the program the CUDA kernel runs
# ---------------------------------------------------------------------------

#: shared memory one Hopper block may use
SMEM_LIMIT_BYTES = 232_448
#: the token-free operands of the steps before the last are staged into
#: shared memory while their sum stays under this; past it a step reads its
#: operand from the (L2-resident) workspace
W_STAGE_BYTES = 160 * 1024
#: shared memory of a free-phase block: the cores its ops read and every
#: intermediate; past it the phase runs in one block through the workspace
FREE_SMEM_BYTES = 192 * 1024
#: multiply-adds of the sinks per free-phase block (sets how many blocks)
FREE_BLOCK_MACS = 16_384
#: a reducing step splits K into about K / K_GROUP interleaved groups ...
K_GROUP = 32
#: ... at most this many, and at most this many partial sums per token
MAX_K_GROUPS = 24
MAX_PARTIALS_PER_TOKEN = 512
#: token tiles the host may pick (each a multiple of the kernel's 4-token
#: register tile); none of them changes an output bit
TILES = (16, 8, 4)
_MAX_TOK_STEPS = 16
_MAX_FREE_OPS = 16
_MAX_CORES = 16

Map = tuple[int, int]   # (stride, -1): i * stride; (0, t): tables[t + i]


def _strides(dims: Sequence[int]) -> list[int]:
    out, s = [], 1
    for d in reversed(dims):
        out.append(s)
        s *= d
    return out[::-1]


def _offsets(pairs: Sequence[tuple[int, int]]) -> np.ndarray:
    """Element offsets of a row-major walk over ``(dim, stride)`` axes."""
    off = np.zeros(1, np.int64)
    for d, s in pairs:
        off = (off[:, None] + np.arange(d, dtype=np.int64)[None, :] * s).reshape(-1)
    return off


def _affine(off: np.ndarray) -> Optional[int]:
    """The stride of ``off`` when it is ``i * stride``, else None."""
    stride = int(off[1]) if len(off) > 1 else 0
    if np.array_equal(off, np.arange(len(off), dtype=np.int64) * stride):
        return stride
    return None


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def k_groups(K: int, P: int, Qp: int) -> int:
    """How many groups a step's K splits into: group ``g`` takes ``k = g,
    g + G, g + 2G, ...`` (interleaved, so the threads of one warp read
    neighbouring k).  A function of the step's shape alone, never of the
    token count or the grid, so a row's bits never depend on either: each
    group is one ascending fp32 FMA chain, and the groups fold in
    ascending order."""
    return max(1, min(-(-K // K_GROUP), MAX_K_GROUPS,
                      MAX_PARTIALS_PER_TOKEN // (P * Qp)))


@dataclasses.dataclass(frozen=True)
class FreeOp:
    """A token-free step, run once per call in the free phase:
    ``C[m, n] = sum_k A[ra(m) + ka(k)] * B[kb(k) + cb(n)]``, or, for a copy
    (``b is None``), ``C[m, n] = A[ra(m) + cb(n)]``; ``C[m, n]`` lands at
    ``ws[out + orow(m) + ocol(n)]``: the layout its consumer reads.

    ``a``/``b`` are ``("core", i)`` or ``("ws", offset)``.  A
    ``sink`` feeds a token step; the other ops are intermediates of the
    free phase.  On the card (:class:`FreePlan`) every block computes the
    intermediates whole in its shared memory and a share of the sinks."""

    a: tuple
    b: Optional[tuple]
    M: int
    K: int
    N: int
    ra: Map
    ka: Map
    kb: Map
    cb: Map
    orow: Map
    ocol: Map
    out: int
    sink: bool
    #: a copy walks its destination region (``dst_len`` floats) in order:
    #: ``inv`` maps each destination to ``m * N + n`` (-1: padding, zero)
    inv: Map = (0, -1)
    dst_len: int = 0


@dataclasses.dataclass(frozen=True)
class TokOp:
    """A token-carrying step, per token ``t``:
    ``C_t[p, q] = sum_k T_t[p, k] * W[k, q]``.

    ``T_t[p, k]`` is ``buf[src][t * tok_stride + p * ps + k * ks]`` (the X
    tile for the first step, else the previous step's output, dense
    ``(P, K)``); ``W`` is the dense ``(K, Qp)`` workspace region at ``w``
    (``Qp``: ``Q`` rounded up to 4), staged in shared memory when
    ``stage``.  K splits into ``G`` interleaved groups (:func:`k_groups`).
    ``C_t[p, q]`` lands at ``t * out_stride + orow(p) + ocol(q)`` of buffer
    ``dst``, or of Y when ``dst`` is -1; ``vec_store``: Y takes 4
    consecutive q as one aligned float4."""

    P: int
    K: int
    Q: int
    Qp: int
    G: int
    w: int
    stage: bool
    tok_stride: int
    ps: int
    ks: int
    src: int
    dst: int
    out_stride: int
    orow: Map
    ocol: Map
    vec_store: bool


@dataclasses.dataclass(frozen=True)
class Program:
    """A compiled path, per token: the same object for every token count."""

    n_in: int
    out_dim: int
    core_dims: tuple[tuple[int, ...], ...]
    free_ops: tuple[FreeOp, ...]   # intermediates in path order, then sinks
    free_plan: "FreePlan"
    tok_ops: tuple[TokOp, ...]
    tables: np.ndarray         # int32
    ws_elems: int
    buf_elems: tuple[int, int]  # per token, the intermediates (X aside)
    #: X is not read in place: (P, K, xrow, xk) of the gather into a dense
    #: (P, K) buffer, once per tile; None when X is read through strides
    relayout: Optional[tuple]
    #: per device: the tables, the parameter blocks and the geometry of
    #: each token count seen, kept with the program so the compile cache's
    #: bound covers them
    device_state: dict = dataclasses.field(default_factory=dict,
                                           compare=False, repr=False)

    @property
    def w_fixed(self) -> int:
        """Floats of the staged operands of the steps before the last."""
        return sum(op.K * op.Qp for op in self.tok_ops[:-1] if op.stage)

    def w_smem(self, i: int) -> int:
        """Shared-memory offset (floats) of step ``i``'s staged operand."""
        return sum(op.K * op.Qp for op in self.tok_ops[:i] if op.stage)


@dataclasses.dataclass(frozen=True)
class FreePlan:
    """Where the free phase keeps its operands on the card.

    ``in_smem``: every block stages the cores its ops read (``stage``:
    ``(core, offset, floats)``) and computes every intermediate whole into
    its shared memory (``inter``: workspace offset -> shared offset), then
    its share of the sinks, which alone go to the workspace: no block waits
    on another.  Otherwise one block runs every op through the workspace,
    a block barrier between ops."""

    in_smem: bool
    stage: tuple[tuple[int, int, int], ...]
    inter: tuple[tuple[int, int], ...]
    smem_floats: int
    sink_macs: int

    def blocks(self, n_sm: int) -> int:
        if not self.in_smem:
            return 1
        return max(1, min(n_sm, -(-self.sink_macs // FREE_BLOCK_MACS)))

    def smem_of(self, ref) -> int:
        """Shared-memory offset of an operand, -1 when it stays in place."""
        if not self.in_smem or ref is None:
            return -1
        table = ({c: o for c, o, _ in self.stage} if ref[0] == "core"
                 else dict(self.inter))
        return table.get(ref[1], -1)


def _free_plan(ops: Sequence[FreeOp], core_sizes: Sequence[int]) -> FreePlan:
    used = sorted({r[1] for o in ops for r in (o.a, o.b)
                   if r is not None and r[0] == "core" and o.b is not None})
    off, stage, inter = 0, [], []
    for c in used:
        stage.append((c, off, core_sizes[c]))
        off += _round4(core_sizes[c])
    for o in ops:
        if not o.sink:
            inter.append((o.out, off))
            off += _round4(o.M * o.N)
    sink_macs = sum(o.M * o.N * max(o.K, 1) for o in ops if o.sink)
    if 4 * off <= FREE_SMEM_BYTES:
        return FreePlan(True, tuple(stage), tuple(inter), off, sink_macs)
    return FreePlan(False, (), (), 0, sink_macs)


def compile_program(tn: TensorNetwork, steps) -> Program:
    """Compile ``steps`` over ``tn`` into the kernel's program.

    Replays ``execute_path``'s edge bookkeeping, then lays out every
    intermediate for its consumer: a token-free result feeding a token
    step lands as that step's dense ``(K, Qp)`` operand (a core feeding
    one is copied there), one feeding another token-free step in the
    tensordot layout; each token step writes its result dense in the
    ``(P, K)`` order the next step reads, and the last one into Y.  X and
    Y are the only fixed layouts.  Every offset walk that is affine becomes
    a stride; the rest stay int32 tables, all on writes (and on X when it
    cannot be read through strides).  The batch dim of ``tn`` is ignored.
    """
    steps = tuple(tuple(s) for s in steps)
    tn = _rebatch(tn, 1)
    x = _stream_node(tn)
    _, batch, in_modes, out_edges, out_dim = _stream_layout(tn)
    dims = {e: d for n in tn.nodes for e, d in zip(n.edges, n.dims)}
    cores = [n for n in tn.nodes if n.kind != "input"]
    if len(cores) > _MAX_CORES:
        raise ValueError(f"streaming_tt takes at most {_MAX_CORES} cores")
    core_of = {n.name: i for i, n in enumerate(cores)}

    def size(edges) -> int:
        return math.prod((dims[e] for e in edges), start=1)

    # 1. replay: which steps carry the tokens, and their operands' edges
    work = [(tuple(n.edges), ("tok",) if n.kind == "input"
             else ("core", core_of[n.name])) for n in tn.nodes]
    free, tok = [], []
    for i, j in steps:
        (ea, ra), (eb, rb) = work[i], work[j]
        shared = [e for e in ea if e in eb]
        fa = [e for e in ea if e not in shared]
        fb = [e for e in eb if e not in shared]
        if ("tok",) in (ra, rb):
            et, ew, rw = (ea, eb, rb) if ra == ("tok",) else (eb, ea, ra)
            tok.append(dict(w=rw, shared=shared,
                            p=[e for e in et if e not in shared and e != batch],
                            q=[e for e in ew if e not in shared]))
            res = ("tok",)
        else:
            # a token-free result read by this step is laid out in the
            # order it is read: A as (m, k), B as (k, n), k and n innermost
            if ra[0] == "free":
                free[ra[1]]["order"] = fa + shared
            if rb[0] == "free":
                free[rb[1]]["order"] = shared + fb
            free.append(dict(a=ra, b=rb, shared=shared, fa=fa, fb=fb))
            res = ("free", len(free) - 1)
        work = [w for s, w in enumerate(work) if s not in (i, j)]
        work.append((tuple(fa + fb), res))
    if len(work) != 1 or work[0][1] != ("tok",):
        raise ValueError("path does not end in the token-carrying result")
    if set(work[0][0]) != set(out_edges):
        raise ValueError(f"path result edges {work[0][0]} != {out_edges}")
    if len(tok) > _MAX_TOK_STEPS:
        raise ValueError(f"path has {len(tok)} token-carrying steps; the "
                         f"kernel takes at most {_MAX_TOK_STEPS}")

    # 2. orders: X's for the first step's reads, Y's for the last step's
    #    writes, the previous result's elsewhere
    xs = dict(zip(x.edges[1:], _strides(x.dims[1:])))
    ys = dict(zip(out_edges[1:], _strides([dims[e] for e in out_edges[1:]])))
    for s, t in enumerate(tok):
        if s == 0:
            t["p"] = sorted(t["p"], key=lambda e: -xs[e])
            t["k"] = sorted(t["shared"], key=lambda e: -xs[e])
        else:
            order = tok[s - 1]["p"] + tok[s - 1]["q"]
            t["p"] = [e for e in order if e in t["p"]]
            t["k"] = [e for e in order if e in t["shared"]]
        if s == len(tok) - 1:
            t["p"] = sorted(t["p"], key=lambda e: -ys[e])
            t["q"] = sorted(t["q"], key=lambda e: -ys[e])
        t["P"], t["K"], t["Q"] = size(t["p"]), size(t["k"]), size(t["q"])
        t["Qp"] = _round4(t["Q"])
        # W dense (K, Qp): k edges row-major over rows of Qp, q edges inside
        t["wstr"] = {**{e: st * t["Qp"] for e, st in zip(
            t["k"], _strides([dims[e] for e in t["k"]]))},
            **dict(zip(t["q"], _strides([dims[e] for e in t["q"]])))}

    # 3. the workspace: each token step's W, then every other free result
    tables: list[np.ndarray] = []
    n_tab = 0
    ws = 0

    def table(off: np.ndarray) -> Map:
        nonlocal n_tab
        stride = _affine(off)
        if stride is not None:
            return (stride, -1)
        tables.append(off)
        n_tab += len(off)
        return (0, n_tab - len(off))

    def walk(edges, strides) -> Map:
        return table(_offsets([(dims[e], strides[e]) for e in edges]))

    def alloc(n: int) -> int:
        nonlocal ws
        ws += _round4(n)
        return ws - _round4(n)

    for t in tok:
        t["w_off"] = alloc(t["K"] * t["Qp"])
        if t["w"][0] == "free":
            free[t["w"][1]]["to"] = t
    for f in free:
        if "to" in f:
            f["out"], f["str"] = f["to"]["w_off"], f["to"]["wstr"]
        else:
            ec = f["order"]
            f["len"] = size(ec)
            f["out"] = alloc(size(ec))
            f["str"] = dict(zip(ec, _strides([dims[e] for e in ec])))

    # 4. the free phase: the token-free steps, then the copies of cores
    #    that token steps read
    ops = []
    for f in free:
        def operand(ref):
            if ref[0] == "core":
                n = cores[ref[1]]
                return ref, dict(zip(n.edges, _strides(n.dims)))
            g = free[ref[1]]
            return ("ws", g["out"]), g["str"]

        (ra, sa), (rb, sb) = operand(f["a"]), operand(f["b"])
        ops.append(FreeOp(
            ra, rb, size(f["fa"]), size(f["shared"]), size(f["fb"]),
            walk(f["fa"], sa), walk(f["shared"], sa), walk(f["shared"], sb),
            walk(f["fb"], sb), walk(f["fa"], f["str"]), walk(f["fb"], f["str"]),
            f["out"], "to" in f))
    for t in tok:
        if t["w"][0] == "core":
            n = cores[t["w"][1]]
            cs = dict(zip(n.edges, _strides(n.dims)))
            # the copy walks its destinations in order: inv maps each back
            rel = (_offsets([(dims[e], t["wstr"][e]) for e in t["k"]])[:, None]
                   + _offsets([(dims[e], t["wstr"][e]) for e in t["q"]])[None, :])
            inv = np.full(t["K"] * t["Qp"], -1, np.int64)
            inv[rel.reshape(-1)] = np.arange(t["K"] * t["Q"])
            ops.append(FreeOp(t["w"], None, t["K"], 1, t["Q"],
                              walk(t["k"], cs), (0, -1), (0, -1),
                              walk(t["q"], cs), walk(t["k"], t["wstr"]),
                              walk(t["q"], t["wstr"]), t["w_off"], True,
                              table(inv), len(inv)))
    # producers precede their readers in path order: a stable sort keeps it
    ops.sort(key=lambda o: o.sink)
    if len(ops) > _MAX_FREE_OPS:
        raise ValueError(f"path has {len(ops)} token-free ops; the kernel "
                         f"takes at most {_MAX_FREE_OPS}")
    free_plan = _free_plan(ops, [math.prod(n.dims) for n in cores])

    # 5. the token steps: read the previous buffer (or X) through strides,
    #    write the next step's dense (P, K) buffer (or Y) through maps
    n_in = math.prod(in_modes)
    buf = [0, 0]
    relayout = None
    tok_ops = []
    staged = 0
    for s, t in enumerate(tok):
        last = s == len(tok) - 1
        P, K, Q, Qp = t["P"], t["K"], t["Q"], t["Qp"]
        if s == 0:
            xrow = _offsets([(dims[e], xs[e]) for e in t["p"]])
            xk = _offsets([(dims[e], xs[e]) for e in t["k"]])
            sr, sk = _affine(xrow), _affine(xk)
            if sr is not None and sk is not None:
                read = (n_in, sr, sk)
            else:
                relayout = (P, K, table(xrow), table(xk))
                read = (P * K, K, 1)
            src = 0
        else:
            read = (P * K, K, 1)
            src = tok_ops[-1].dst
        if last:
            dst, out_stride, ostr = -1, out_dim, ys
        else:
            nxt = tok[s + 1]
            order = nxt["p"] + nxt["k"]
            ostr = dict(zip(order, _strides([dims[e] for e in order])))
            dst, out_stride = 1 - src, size(order)
            buf[dst] = max(buf[dst], out_stride)
        orow, ocol = walk(t["p"], ostr), walk(t["q"], ostr)
        rows = _offsets([(dims[e], ostr[e]) for e in t["p"]])
        vec = (last and ocol == (1, -1) and Q % 4 == 0 and out_dim % 4 == 0
               and bool((rows % 4 == 0).all()))
        stage = last or staged + 4 * K * Qp <= W_STAGE_BYTES
        if not last and stage:
            staged += 4 * K * Qp
        tok_ops.append(TokOp(P, K, Q, Qp, k_groups(K, P, Qp), t["w_off"], stage, *read,
                             src, dst, out_stride, orow, ocol, vec))
    all_tables = (np.concatenate(tables) if tables else np.zeros(1, np.int64))
    if all_tables.max(initial=0) >= 2**31 or ws >= 2**31:
        raise ValueError("offset table overflows int32")
    return Program(n_in, out_dim, tuple(n.dims for n in cores), tuple(ops),
                   free_plan, tuple(tok_ops),
                   all_tables.astype(np.int32), ws, (buf[0], buf[1]), relayout)


# ---------------------------------------------------------------------------
# the launch geometry (per call; no choice here changes an output bit)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Grid:
    """One launch: ``blocks x slices`` blocks.  Block ``(bx, sy)`` runs
    token tiles ``bx, bx + blocks, ...`` of ``tile`` tokens each, and the
    last step's columns (4-float vectors) of slice ``sy``; every step
    before the last runs whole in each slice."""

    tile: int
    n_tiles: int
    slices: int
    blocks: int
    #: the first step reads X in place (a tile of X does not fit beside
    #: the staged operands) instead of from a staged tile
    x_global: bool
    #: shared-memory offsets (floats): the last step's staged slice, the
    #: two token buffers, the partial sums; and the total in bytes
    w_last: int
    buf0: int
    buf1: int
    part: int
    smem_bytes: int


def _layout(prog: Program, tile: int, slices: int,
            x_global: bool = False) -> tuple[int, ...]:
    last = prog.tok_ops[-1]
    width = 4 * -(-(last.Qp // 4) // slices)
    b0, b1 = prog.buf_elems
    if not x_global:   # the staged X tile (raw in buffer 1 when relaid out)
        b0 = max(b0, prog.n_in)
        if prog.relayout is not None:
            b1 = max(b1, prog.n_in)
    w_last = prog.w_fixed
    buf0 = _round4(w_last + last.K * width)
    buf1 = _round4(buf0 + tile * b0)
    part = _round4(buf1 + tile * b1)
    per_token = max([op.G * op.P * op.Qp for op in prog.tok_ops[:-1] if op.G > 1]
                    + [last.G * last.P * width if last.G > 1 else 0])
    return w_last, buf0, buf1, part, 4 * (part + tile * per_token)


def launch_grid(prog: Program, tokens: int, n_sm: int = 132, *,
                tile: Optional[int] = None, slices: Optional[int] = None,
                blocks: Optional[int] = None,
                x_global: Optional[bool] = None) -> Grid:
    """The kernel's grid for ``tokens`` on a card of ``n_sm`` SMs.

    The tile is the largest of :data:`TILES` that the token count needs
    and shared memory holds with the fewest slices (X staged if any tile
    holds it, else read in place); then the last step's columns split into
    more slices until the grid reaches every SM (a slice keeps >= 32
    columns); a block loops over tiles when there are more tiles than the
    card holds blocks.  The arguments force a choice (the tests use that:
    no choice changes a bit).  Raises ``ValueError`` when no 4-token tile
    fits a block's shared memory."""
    qv = prog.tok_ops[-1].Qp // 4

    def fits(t: int, s: int, xg: bool) -> bool:
        return _layout(prog, t, s, xg)[-1] <= SMEM_LIMIT_BYTES

    modes = ([x_global] if x_global is not None
             else [False] if prog.relayout is not None else [False, True])
    if tile is None:
        want = 4 if tokens <= 4 else 8 if tokens <= 64 else 16
        cands = [(t, xg) for xg in modes for t in TILES if t <= want]
        pick = (next(((t, xg) for t, xg in cands if fits(t, 1, xg)), None)
                or next(((t, xg) for t, xg in cands if fits(t, qv, xg)), None))
        if pick is None:
            raise ValueError(
                f"streaming_tt: a {TILES[-1]}-token tile along this path needs "
                f"{_layout(prog, TILES[-1], qv, modes[-1])[-1]} B of shared "
                f"memory, over the {SMEM_LIMIT_BYTES} B a Hopper block can "
                "use; plan this layer on tt_gemm instead")
        tile, x_global = pick
    elif x_global is None:
        x_global = not any(fits(tile, s, False) for s in range(1, qv + 1)) \
            and prog.relayout is None
    n_tiles = -(-tokens // tile)
    if slices is None:
        slices = next((s for s in range(1, qv + 1) if fits(tile, s, x_global)), qv)
        slices = max(slices, min(-(-n_sm // n_tiles), max(1, qv // 8)))
    w_last, buf0, buf1, part, smem = _layout(prog, tile, slices, x_global)
    if blocks is None:
        per_sm = max(1, min(8, 233_472 // (smem + 1024)))
        blocks = min(n_tiles, max(1, per_sm * n_sm // slices))
    if (tile % 4 or not 1 <= slices <= qv or not 1 <= blocks <= n_tiles
            or (x_global and prog.relayout is not None)):
        raise ValueError(f"streaming_tt: bad grid tile {tile}, slices {slices}, "
                         f"blocks {blocks}, X in place {x_global} ({n_tiles} "
                         f"tiles, {qv} column vectors)")
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"streaming_tt: tile {tile} x {slices} slices needs "
                         f"{smem} B of shared memory")
    return Grid(tile, n_tiles, slices, blocks, bool(x_global), w_last, buf0,
                buf1, part, smem)


def run_program_plain(prog: Program, x: torch.Tensor,
                      cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Execute a program with torch gathers, tile by tile.

    The CPU mirror of ``csrc/streaming_tt.cu`` with the same program: the
    free phase writes the workspace through its output maps, each tile
    stages X (rows past the last token zero), every step reads its operands
    dense or through strides, sums each k-group and folds the groups in
    order, and writes the next buffer (or Y) through its maps.  The tests
    hold it against :func:`streaming_tt_linear_plain`, so the compiler is
    checked where no card is present.
    """
    tab = torch.from_numpy(prog.tables.astype(np.int64))
    flat = [c.reshape(-1).to(torch.float32) for c in cores]
    ws = torch.zeros(max(prog.ws_elems, 1), dtype=torch.float32)

    def idx(m: Map, n: int) -> torch.Tensor:
        stride, off = m
        return tab[off:off + n] if off >= 0 else torch.arange(n) * stride

    def base(ref) -> torch.Tensor:
        return flat[ref[1]] if ref[0] == "core" else ws[ref[1]:]

    for op in prog.free_ops:
        a = base(op.a)
        if op.b is None:
            c = a[idx(op.ra, op.M)[:, None] + idx(op.cb, op.N)[None, :]]
        else:
            c = (a[idx(op.ra, op.M)[:, None] + idx(op.ka, op.K)[None, :]]
                 @ base(op.b)[idx(op.kb, op.K)[:, None] + idx(op.cb, op.N)[None, :]])
        ws[op.out + idx(op.orow, op.M)[:, None] + idx(op.ocol, op.N)[None, :]] = c

    tokens = x.shape[0]
    tile = launch_grid(prog, max(tokens, 1)).tile
    y = torch.zeros(tokens * prog.out_dim, dtype=torch.float32)
    tt = torch.arange(tile)
    for t0 in range(0, tokens, tile):
        valid = min(tile, tokens - t0)
        raw = torch.zeros(tile * prog.n_in)
        raw[:valid * prog.n_in] = x[t0:t0 + valid].reshape(-1).float()
        bufs = [raw, None]
        if prog.relayout is not None:
            P, K, xrow, xk = prog.relayout
            bufs[0] = raw[(tt[:, None, None] * prog.n_in + idx(xrow, P)[None, :, None]
                           + idx(xk, K)[None, None, :]).reshape(-1)]
        for op in prog.tok_ops:
            a = bufs[op.src][tt[:, None, None] * op.tok_stride
                             + torch.arange(op.P)[None, :, None] * op.ps
                             + torch.arange(op.K)[None, None, :] * op.ks]
            w = ws[op.w:op.w + op.K * op.Qp].reshape(op.K, op.Qp)[:, :op.Q]
            acc = None
            for g in range(op.G):
                part = a[:, :, g::op.G] @ w[g::op.G]
                acc = part if acc is None else acc + part
            off = idx(op.orow, op.P)[:, None] + idx(op.ocol, op.Q)[None, :]
            if op.dst >= 0:
                nxt = torch.zeros(tile * prog.buf_elems[op.dst])
                nxt[(tt[:, None, None] * op.out_stride + off[None]).reshape(-1)] = \
                    acc.reshape(-1)
                bufs[op.dst] = nxt
            else:
                rows = (t0 + tt[:valid])[:, None, None] * prog.out_dim + off[None]
                y[rows.reshape(-1)] = acc[:valid].reshape(-1)
    return y.reshape(tokens, prog.out_dim).to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA wrapper
# ---------------------------------------------------------------------------

class _Map(ctypes.Structure):
    _fields_ = [("table", ctypes.c_void_p), ("stride", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _FreeOp(ctypes.Structure):
    _fields_ = [("ra", _Map), ("ka", _Map), ("kb", _Map), ("cb", _Map),
                ("orow", _Map), ("ocol", _Map), ("inv", _Map),
                ("a_core", ctypes.c_int), ("a_off", ctypes.c_int),
                ("b_core", ctypes.c_int), ("b_off", ctypes.c_int),
                ("a_sh", ctypes.c_int), ("b_sh", ctypes.c_int),
                ("out_sh", ctypes.c_int), ("out_off", ctypes.c_int),
                ("M", ctypes.c_int), ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("dst_len", ctypes.c_int)]


class _FreeParams(ctypes.Structure):
    _fields_ = [("cores", ctypes.c_void_p * _MAX_CORES), ("ws", ctypes.c_void_p),
                ("ws_stride", ctypes.c_longlong),
                ("core_stride", ctypes.c_longlong * _MAX_CORES),
                ("n_ops", ctypes.c_int), ("n_inter", ctypes.c_int),
                ("n_stage", ctypes.c_int), ("smem_floats", ctypes.c_int),
                ("blocks", ctypes.c_int), ("pad", ctypes.c_int),
                ("stage_core", ctypes.c_int * _MAX_CORES),
                ("stage_off", ctypes.c_int * _MAX_CORES),
                ("stage_len", ctypes.c_int * _MAX_CORES),
                ("ops", _FreeOp * _MAX_FREE_OPS)]


class _TokOp(ctypes.Structure):
    _fields_ = [("orow", _Map), ("ocol", _Map),
                ("P", ctypes.c_int), ("K", ctypes.c_int), ("Q", ctypes.c_int),
                ("Qp", ctypes.c_int), ("G", ctypes.c_int),
                ("w_off", ctypes.c_int), ("w_smem", ctypes.c_int),
                ("tok_stride", ctypes.c_int), ("ps", ctypes.c_int),
                ("ks", ctypes.c_int), ("src", ctypes.c_int), ("dst", ctypes.c_int),
                ("out_stride", ctypes.c_int), ("vec_store", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _StreamParams(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("y", ctypes.c_void_p),
                ("ws", ctypes.c_void_p), ("x_stride", ctypes.c_longlong),
                ("y_stride", ctypes.c_longlong), ("ws_stride", ctypes.c_longlong),
                ("xrow", _Map), ("xk", _Map),
                ("tokens", ctypes.c_int), ("n_in", ctypes.c_int),
                ("out_dim", ctypes.c_int), ("tile", ctypes.c_int),
                ("n_tiles", ctypes.c_int), ("slices", ctypes.c_int),
                ("x_global", ctypes.c_int), ("buf_off", ctypes.c_int * 2), ("part_off", ctypes.c_int),
                ("w_last_off", ctypes.c_int), ("relayout", ctypes.c_int),
                ("x_P", ctypes.c_int), ("x_K", ctypes.c_int),
                ("n_steps", ctypes.c_int),
                ("steps", _TokOp * _MAX_TOK_STEPS)]


#: the launch geometry as the C side reads it (``streaming_tt_launch``)
_Geometry = ctypes.c_int * 10


@dataclasses.dataclass
class _DeviceState:
    tables: torch.Tensor
    free: _FreeParams
    stream: _StreamParams
    n_sm: int
    grids: dict      # tokens -> (Grid, _Geometry)


def _device_state(prog: Program, dev: torch.device) -> _DeviceState:
    """The program's tables on ``dev`` and its parameter blocks, filled once
    with everything but the per-call pointers and geometry."""
    st = prog.device_state.get(dev.index)
    if st is not None:
        return st
    tab = torch.from_numpy(prog.tables).to(dev)

    def m(mp: Map) -> _Map:
        stride, off = mp
        return _Map(tab.data_ptr() + 4 * off if off >= 0 else None, stride, 0)

    def ref(r) -> tuple[int, int]:
        return (-1, 0) if r is None else (r[1], 0) if r[0] == "core" else (-1, r[1])

    fp = _FreeParams()
    plan = prog.free_plan
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    fp.n_ops = len(prog.free_ops)
    fp.n_inter = sum(1 for o in prog.free_ops if not o.sink)
    fp.n_stage, fp.smem_floats = len(plan.stage), plan.smem_floats
    fp.blocks = plan.blocks(n_sm)
    for i, (core, off, n) in enumerate(plan.stage):
        fp.stage_core[i], fp.stage_off[i], fp.stage_len[i] = core, off, n
    for i, o in enumerate(prog.free_ops):
        out_sh = -1 if o.sink else plan.smem_of(("ws", o.out))
        fp.ops[i] = _FreeOp(m(o.ra), m(o.ka), m(o.kb), m(o.cb), m(o.orow),
                            m(o.ocol), m(o.inv), *ref(o.a), *ref(o.b),
                            plan.smem_of(o.a) if o.b is not None else -1,
                            plan.smem_of(o.b), out_sh, o.out, o.M,
                            0 if o.b is None else o.K, o.N, o.dst_len)
    sp = _StreamParams()
    sp.n_in, sp.out_dim, sp.n_steps = prog.n_in, prog.out_dim, len(prog.tok_ops)
    if prog.relayout is not None:
        sp.relayout = 1
        sp.x_P, sp.x_K = prog.relayout[0], prog.relayout[1]
        sp.xrow, sp.xk = m(prog.relayout[2]), m(prog.relayout[3])
    for i, op in enumerate(prog.tok_ops):
        sp.steps[i] = _TokOp(
            m(op.orow), m(op.ocol), op.P, op.K, op.Q, op.Qp, op.G,
            op.w, prog.w_smem(i) if op.stage else -1, op.tok_stride, op.ps,
            op.ks, op.src, op.dst, op.out_stride, int(op.vec_store), 0)
    st = _DeviceState(tab, fp, sp, n_sm, {})
    prog.device_state[dev.index] = st
    return st


def _geometry(g: Grid) -> ctypes.Array:
    return _Geometry(g.tile, g.n_tiles, g.slices, g.buf0, g.buf1, g.part,
                     g.w_last, g.blocks, g.smem_bytes, int(g.x_global))


@functools.lru_cache(maxsize=256)
def _compiled(signature, steps) -> Program:
    nodes = [Node(name, edges, dims, kind) for name, edges, dims, kind in signature]
    return compile_program(TensorNetwork(nodes), steps)


#: (id(network), steps) -> (network, program): the callers build each
#: network once per shape, so most calls skip the signature
_BY_ID: dict = {}


def program_for(tn: TensorNetwork, path: CandidatePath) -> Program:
    """The cached :class:`Program` of a network and path.  The streamed
    node's batch dim is not part of the key: every token count (and every
    plan block) of one geometry shares one program."""
    key = (id(tn), path.steps)
    hit = _BY_ID.get(key)
    if hit is not None and hit[0] is tn:
        return hit[1]
    sig = tuple((n.name, n.edges, n.dims, n.kind) for n in _rebatch(tn, 1).nodes)
    prog = _compiled(sig, tuple(tuple(s) for s in path.steps))
    if len(_BY_ID) >= 4096:
        _BY_ID.clear()
    _BY_ID[key] = (tn, prog)
    return prog


def _check_operands(x: torch.Tensor, cores: Sequence[torch.Tensor]) -> None:
    dev = x.device
    for t in (x, *cores):
        if t.device != dev or dev.type != "cuda":
            raise ValueError("streaming_tt: x and every core must sit on one "
                             "CUDA device (or all on the CPU)")
        if not t.is_contiguous():
            raise ValueError("streaming_tt: x and the cores must be contiguous")


def _run(prog: Program, x: torch.Tensor, cores: Sequence[torch.Tensor],
         grid: Optional[Grid], counter: str) -> torch.Tensor:
    """One launch sequence on checked fp32 CUDA operands: ``x (tokens,
    N_in)`` and the cores, or E experts: ``x (E, tokens, N_in)``, core
    ``i`` of shape ``(E,) + core_dims[i]``; returns the fp32 ``(tokens,
    out_dim)`` / ``(E, tokens, out_dim)``.  Each expert runs the grid an
    unbatched call at ``tokens`` takes (or ``grid``), so its rows are that
    call's bits."""
    dev = x.device
    lead = tuple(x.shape[:-2])
    experts, tokens = math.prod(lead), x.shape[-2]
    if len(cores) != len(prog.core_dims) or any(
            tuple(c.shape) != lead + d for c, d in zip(cores, prog.core_dims)):
        raise ValueError("streaming_tt: core shapes do not match the network")
    if x.shape[-1] != prog.n_in:
        raise ValueError("x inner dim does not match network input modes")
    y = torch.empty(lead + (tokens, prog.out_dim), dtype=torch.float32, device=dev)
    if tokens == 0 or experts == 0:
        return y
    ws_stride = _round4(max(prog.ws_elems, 1))
    if max(experts * tokens * prog.n_in, experts * tokens * prog.out_dim,
           experts * ws_stride) >= 2**31:
        raise ValueError("streaming_tt: activation too large for 32-bit offsets")
    if experts > 65535:
        raise ValueError(f"streaming_tt: {experts} experts, over the grid's "
                         "65535")
    st = _device_state(prog, dev)
    if grid is None:
        geo = st.grids.get(tokens)
        if geo is None:
            if len(st.grids) >= 1024:
                st.grids.clear()
            geo = st.grids[tokens] = _geometry(launch_grid(prog, tokens, st.n_sm))
    else:
        geo = _geometry(grid)
    ws = torch.empty(experts * ws_stride, dtype=torch.float32, device=dev)
    lib = _lib()
    n = len(cores)
    rc = lib.streaming_tt_launch(
        ctypes.addressof(st.free), ctypes.addressof(st.stream),
        (ctypes.c_void_p * n)(*[c.data_ptr() for c in cores]),
        (ctypes.c_longlong * n)(*[math.prod(d) for d in prog.core_dims]),
        n, experts, x.data_ptr(), y.data_ptr(), ws.data_ptr(), ws_stride, tokens,
        geo, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(
            f"streaming_tt launch failed: "
            f"{lib.streaming_tt_error_string(rc).decode()} (experts {experts}, "
            f"tokens {tokens}, grid {list(geo)})")
    launches.COUNTS[counter] += 1
    return y


def streaming_tt_linear(
    x: torch.Tensor,
    cores: Sequence[torch.Tensor],
    tn: TensorNetwork,
    path: CandidatePath,
    *,
    block_tokens: int = 256,
    grid: Optional[Grid] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Apply a streaming TT contraction to ``x: (tokens, N_in)``.

    ``tn``/``path`` describe one block of ``block_tokens`` tokens (the
    plan's block); any token count is accepted, and the kernel picks its
    own tiles (:func:`launch_grid`; ``grid`` forces one, for the tests).
    x and the cores are float32 or bfloat16; the kernel folds in fp32 (bf16
    operands are widened before the launch) and the result is cast once to
    ``out_dtype`` (default: x's dtype).  CPU tensors take
    :func:`streaming_tt_linear_plain`; CUDA tensors launch the kernel (at
    most two launches, one count) or raise.
    """
    if x.device.type == "cpu" and all(c.device.type == "cpu" for c in cores):
        return streaming_tt_linear_plain(x, cores, tn, path,
                                         out_dtype=out_dtype)
    _check_operands(x, cores)
    out_dtype = out_dtype or x.dtype
    x, *cores = widen("streaming_tt", x, *cores)
    if x.dim() != 2:
        raise ValueError("streaming_tt: x must be a (tokens, N_in) tensor")
    return _run(program_for(tn, path), x, cores, grid, "streaming_tt").to(out_dtype)


def streaming_tt_linear_batched_plain(
    x: torch.Tensor,
    cores: Sequence[torch.Tensor],
    tn: TensorNetwork,
    path: CandidatePath,
) -> torch.Tensor:
    """Plain version of :func:`streaming_tt_linear_batched`: the plain K1
    of each expert, stacked."""
    return torch.stack([
        streaming_tt_linear_plain(x[e], [c[e] for c in cores], tn, path)
        for e in range(x.shape[0])])


def streaming_tt_linear_batched(
    x: torch.Tensor,
    cores: Sequence[torch.Tensor],
    tn: TensorNetwork,
    path: CandidatePath,
) -> torch.Tensor:
    """:func:`streaming_tt_linear` of E experts in one launch sequence (the
    reference's ``jax.vmap`` of K1 over the stacked expert axis): ``x (E,
    tokens, N_in)``, each core stacked ``(E,) + core dims``; returns ``(E,
    tokens, out_dim)``.  Every expert runs the program and grid an
    unbatched call at ``tokens`` runs, so expert ``e``'s rows equal
    ``streaming_tt_linear(x[e], [c[e] for c in cores], ...)`` bit for bit.
    bf16 operands are widened once for all experts, and the fp32 result
    is cast once to x's dtype.  CPU tensors take
    :func:`streaming_tt_linear_batched_plain`; CUDA tensors launch the
    kernel (one count) or raise."""
    if x.device.type == "cpu" and all(c.device.type == "cpu" for c in cores):
        return streaming_tt_linear_batched_plain(x, cores, tn, path)
    _check_operands(x, cores)
    if x.dim() != 3:
        raise ValueError("streaming_tt: x must be an (experts, tokens, N_in) "
                         "tensor")
    dtype = x.dtype
    x, *cores = widen("streaming_tt", x, *cores)
    return _run(program_for(tn, path), x, cores, None,
                "streaming_tt_batched").to(dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("streaming_tt")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.streaming_tt_launch.argtypes = [p, p, p, p, i, i, p, p, p,
                                            ctypes.c_longlong, i, p, p]
        lib.streaming_tt_launch.restype = i
        lib.streaming_tt_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.streaming_tt_limits.restype = None
        lib.streaming_tt_error_string.argtypes = [i]
        lib.streaming_tt_error_string.restype = ctypes.c_char_p
        got = (ctypes.c_int * 5)()
        lib.streaming_tt_limits(got)
        want = (_MAX_TOK_STEPS, _MAX_FREE_OPS, _MAX_CORES,
                ctypes.sizeof(_FreeParams), ctypes.sizeof(_StreamParams))
        if tuple(got) != want:
            raise RuntimeError(f"csrc/streaming_tt.cu limits and struct sizes "
                               f"{tuple(got)} differ from the wrapper's {want}")
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# differentiable wrapper: backward along the searched gradient networks
# ---------------------------------------------------------------------------

def _path_for(net: TensorNetwork, steps) -> CandidatePath:
    """The pinned backward steps over ``net``, else its MAC-optimal path."""
    if steps is None:
        return find_topk_paths(net, k=1)[0]
    steps = tuple(tuple(s) for s in steps)
    gemms = tuple(net.gemm_sequence(steps))
    return CandidatePath(steps, sum(g.macs for g in gemms), gemms)


class StreamingTTLinearVJP(torch.autograd.Function):
    """:func:`streaming_tt_linear` under autograd (port of the reference's
    ``streaming_tt_linear_vjp``).

    The backward pass contracts the layer's gradient networks
    (:mod:`repro_torch.core.backward`) instead of transposing the kernel:

      * ``dL/dx`` streams ``dY`` through the same kernel over the dx
        network (the cores unchanged, ``dY`` the streamed node);
      * each ``dL/dG_k`` reduces over the tokens, so it streams two
        operands and cannot use the single-stream kernel: its network is
        contracted over the whole batch with every step on ``tt_gemm``.

    ``bwd_steps`` maps ``"dx"`` / core names to pinned backward steps;
    missing entries take the MAC-optimal path of that gradient's network.
    """

    @staticmethod
    def forward(ctx, x, tn, path, bwd_steps, block_tokens, out_dtype, *cores):
        ctx.save_for_backward(x, *cores)
        ctx.meta = (tn, bwd_steps, block_tokens)
        return streaming_tt_linear(x, list(cores), tn, path,
                                   block_tokens=block_tokens,
                                   out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        from .ops import GradRoute, gemm_contract, tt_linear_backward

        x, *cores = ctx.saved_tensors
        tn, bwd_steps, block_tokens = ctx.meta
        routes = {
            wrt: GradRoute(bwd_steps.get("dx"), "streaming_tt",
                           block_tokens=block_tokens)
            if wrt == "dx" else
            GradRoute(bwd_steps.get(wrt), "tt_gemm", gemm_contract())
            for wrt, _ in backward_networks(tn)
        }
        dx, dcores = tt_linear_backward(tn, x, g, cores, routes)
        return (dx, None, None, None, None, None, *dcores)


def streaming_tt_linear_vjp(
    x: torch.Tensor,
    cores: Sequence[torch.Tensor],
    tn: TensorNetwork,
    path: CandidatePath,
    *,
    bwd_steps: Optional[Mapping[str, Sequence[tuple[int, int]]]] = None,
    block_tokens: int = 256,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """:func:`streaming_tt_linear` with the gradient-network backward pass
    of :class:`StreamingTTLinearVJP`.  ``tn``/``path`` describe one block
    of ``block_tokens`` tokens, as for the forward."""
    return StreamingTTLinearVJP.apply(x, tn, path, dict(bwd_steps or {}),
                                      block_tokens, out_dtype, *cores)
