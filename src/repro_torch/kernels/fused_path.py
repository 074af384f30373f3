"""Fused path segment (K5): CUDA kernel + plain version.

Port of ``src/repro/kernels/fused_path.py``.  A fused segment is a chain
of >= 2 contraction-path steps (each step after the first consumes the
previous result, and exactly one operand of each step carries the batch
edge) executed in one call: the batch-free operands (the token-free core
merges) are packed once into dense buffers in their GEMM role, the
batch-carrying operand streams in token blocks, one CUDA block each, and
each interior intermediate stays on chip in fp32 (``csrc/fused_path.cu``).

The contract (``fused_path.py:14-28`` of the reference): each chained
step replays the per-step ``tt_gemm`` GEMM exactly, with ``block_k``
clamped against the step's *full* dims and every output summing its
k-blocks in ascending order in fp32.  The CUDA kernel shares its tile loop
with ``csrc/tt_gemm.cu`` (``csrc/gemm_tile.cuh``), so on the card fused ==
the per-step CUDA route bit for bit; the plain version is a chain of
:func:`~repro_torch.kernels.tt_gemm.tt_gemm_plain` calls with the same
blocks, bit-identical to the per-step plain route.

Host side: :func:`_compile_segment` is the reference's symbolic replay,
copied; :func:`compile_program` turns it into the offset tables, packs,
tiles and grid the kernel runs (as ``streaming_tt.compile_program`` does
for K1), and :func:`run_program_plain` executes the same program with
torch gathers on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch

from . import _build, launches
from .tt_gemm import tt_gemm_plain

#: default batch (streamed-token) edge label
BATCH_EDGE = "b"

#: shared memory one Hopper block may use
SMEM_LIMIT_BYTES = 232_448
#: largest token block of the kernel; smaller blocks fill more SMs
MAX_KERNEL_BLOCK_TOKENS = 64
#: a token block is not cut below this to fill the SMs
MIN_KERNEL_BLOCK_TOKENS = 8
_MAX_STEPS = 8
_THREADS = 256
_TILE_ROWS = 4          # rows of a thread's register tile (gemm_tile.cuh)
_MAX_TILE = 64          # tile_n of one pass
_MAX_TILE_OUTPUTS = _THREADS * 4 * _TILE_ROWS
#: floats of staging tiles a round may use (~96 KB: two blocks an SM)
_STAGE_FLOATS = 24_576

Src = tuple[str, int]  # ("in", kernel-input position) | ("mid", op index)


def _compile_segment(entries, steps, batch_edge):
    """Symbolic replay of ``steps`` over the work-list ``entries``.

    ``entries`` is the live ``execute_path`` work list as ``(edges,
    shape)`` pairs; ``steps`` are current-index pairs forming a chain.
    Returns ``(input_positions, ops, mids)``:

      * ``input_positions``: work-list indices of the entries the segment
        reads, in first-use order;
      * ``ops``: per step ``(a_src, b_src, ax_a, ax_b, (m, k, n))`` with
        sources in ``("in", pos)`` / ``("mid", t)`` space and the *full*
        flattened GEMM dims of the step (the dims the per-step route
        clamps its blocks against);
      * ``mids``: per step ``(edges, dims)`` of its result.

    A verbatim copy of the reference's bookkeeping (its output is compared
    with the reference's exactly).
    """
    sym: list[tuple[tuple[str, ...], tuple[int, ...], Src]] = []
    for pos, (edges, shape) in enumerate(entries):
        sym.append((tuple(edges), tuple(shape), ("in", pos)))

    input_positions: list[int] = []
    in_slot: dict[int, int] = {}
    ops: list[tuple] = []
    mids: list[tuple[tuple[str, ...], tuple[int, ...]]] = []

    def as_kernel_src(src: Src) -> Src:
        kind, idx = src
        if kind == "mid":
            return src
        if idx not in in_slot:
            in_slot[idx] = len(input_positions)
            input_positions.append(idx)
        return ("in", in_slot[idx])

    for t, (i, j) in enumerate(steps):
        (ea, da, sa), (eb, db, sb) = sym[i], sym[j]
        if t > 0 and ("mid", t - 1) not in (sa, sb):
            raise ValueError(
                f"segment step {t} does not consume the previous result "
                "(not a chain)")
        if sa[0] == "mid" and sb[0] == "mid":
            raise ValueError(f"segment step {t} joins two interior results")
        n_batch = (batch_edge in ea) + (batch_edge in eb)
        if n_batch != 1:
            raise ValueError(
                f"segment step {t}: need exactly one batch-carrying "
                f"operand, found {n_batch}")
        shared = [e for e in ea if e in eb]
        ax_a = tuple(ea.index(e) for e in shared)
        ax_b = tuple(eb.index(e) for e in shared)
        ec = tuple(e for e in ea if e not in shared) + tuple(
            e for e in eb if e not in shared)
        dc = tuple(d for e, d in zip(ea, da) if e not in shared) + tuple(
            d for e, d in zip(eb, db) if e not in shared)
        m_full = math.prod(d for e, d in zip(ea, da) if e not in shared)
        n_full = math.prod(d for e, d in zip(eb, db) if e not in shared)
        k_full = math.prod(da[ax] for ax in ax_a)
        ops.append((as_kernel_src(sa), as_kernel_src(sb), ax_a, ax_b,
                    (m_full, k_full, n_full)))
        mids.append((ec, dc))
        sym = [s for k, s in enumerate(sym) if k not in (i, j)]
        sym.append((ec, dc, ("mid", t)))
    return input_positions, ops, mids


def _clamp_block(block: int, dim: int) -> int:
    # local copy of ops.clamp_block (ops imports this module)
    p = 1
    while p < dim:
        p *= 2
    return max(8, min(block, p))


def _stream_slot(work, input_positions, batch_edge) -> int:
    slots = [slot for slot, p in enumerate(input_positions)
             if batch_edge in work[p][0]]
    if len(slots) != 1:
        raise ValueError(
            f"segment needs one batch-carrying input, found {len(slots)}")
    return slots[0]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def fused_segment_contract_plain(
    work: Sequence[tuple[tuple[str, ...], torch.Tensor]],
    steps: Sequence[tuple[int, int]],
    *,
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
    batch_edge: str = BATCH_EDGE,
) -> tuple[tuple[str, ...], torch.Tensor]:
    """Plain PyTorch version: the chain as :func:`tt_gemm_plain` calls.

    Each step permutes its operands to ``(M, K) @ (K, N)`` exactly as
    ``ops.gemm_contract`` does and clamps its blocks against the step's
    full dims, so the result equals the per-step plain route bit for bit.
    Returns ``(result_edges, result)`` in the tensordot layout of the last
    step.
    """
    if len(steps) < 2:
        raise ValueError("fused segments need at least two steps")
    entries = [(edges, tuple(t.shape)) for edges, t in work]
    input_positions, ops, mids = _compile_segment(entries, steps, batch_edge)
    _stream_slot(work, input_positions, batch_edge)
    ins = [work[p][1] for p in input_positions]
    vals: list[torch.Tensor] = []
    for (a_src, b_src, ax_a, ax_b, (m, k, n)), (_, dc) in zip(ops, mids):
        ta = ins[a_src[1]] if a_src[0] == "in" else vals[a_src[1]]
        tb = ins[b_src[1]] if b_src[0] == "in" else vals[b_src[1]]
        a_free = [i for i in range(ta.dim()) if i not in ax_a]
        b_free = [i for i in range(tb.dim()) if i not in ax_b]
        a2 = ta.permute(a_free + list(ax_a)).reshape(m, k).contiguous()
        b2 = tb.permute(list(ax_b) + b_free).reshape(k, n).contiguous()
        c2 = tt_gemm_plain(a2, b2, block_m=_clamp_block(block_m, m),
                           block_k=_clamp_block(block_k, k),
                           block_n=_clamp_block(block_n, n))
        vals.append(c2.reshape(dc))
    return mids[-1][0], vals[-1]


# ---------------------------------------------------------------------------
# the offset tables the CUDA kernel runs
# ---------------------------------------------------------------------------

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


@dataclasses.dataclass(frozen=True)
class Operand:
    """The token-side operand of a chained GEMM, ``element(r, c) =
    base[row[r] + col[c]]``.  ``src`` is ``("in", slot)`` (the streamed
    input, in device memory) or ``("mid", t)`` (interior buffer t);
    ``tables`` maps ``row``/``col`` (and ``row_tok``/``col_tok`` for the
    streamed input) to offsets into the program's int32 table array.
    ``vec``: the streamed input's rows start 16-byte aligned, its columns
    are contiguous and its tokens lie on the rows, so the kernel stages it
    with 16-byte copies."""

    src: tuple
    tables: dict
    tok_stride: int
    vec: bool = False


@dataclasses.dataclass(frozen=True)
class Pack:
    """One batch-free operand, packed once per call into the dense
    row-major ``(rows x cols)`` view of its GEMM role at ``offset`` floats
    of the packed buffer: ``packed[offset + r * cols + c] = in[slot][row[r]
    + col[c]]`` (``row``/``col`` offsets into the table array)."""

    slot: int
    rows: int
    cols: int
    row: int
    col: int
    offset: int


@dataclasses.dataclass(frozen=True)
class ChainStep:
    t: Operand                 # the token-side operand
    w_is_a: bool               # the packed batch-free operand is A, else B
    w_offset: int              # floats into the packed buffer
    M: int
    K: int
    N: int
    bk: int
    kc: int                    # k staged per round, a multiple of bk
    tile_m: int
    tile_n: int
    tr: int                    # rows of a thread's register tile
    out_mid: int               # -1: the result goes to Y
    out_tables: dict           # last step: c_row, c_col, c_row_tok | c_col_tok
    #: last step: Y's columns are the block's tokens, contiguous, its rows
    #: 16-byte aligned: float4 stores
    y_vec: bool = False


@dataclasses.dataclass(frozen=True)
class Program:
    """A compiled segment for one work-list geometry and token block."""

    block_tokens: int
    tokens: int
    out_edges: tuple[str, ...]
    out_dims: tuple[int, ...]
    y_tok_stride: int
    input_positions: tuple[int, ...]   # work-list entries the chain reads
    steps: tuple[ChainStep, ...]
    tables: np.ndarray         # int32
    mid_elems: tuple[int, ...]         # each rounded up to 4 floats
    tile_elems: int
    packs: tuple[Pack, ...]
    packed_elems: int
    #: per device the program ran on: its int32 tables there and the
    #: launch parameters built on them (:func:`_launch_params`), kept with
    #: the program so the compile cache's bound covers them
    device_state: dict = dataclasses.field(default_factory=dict,
                                           compare=False, repr=False)

    @property
    def mid_offsets(self) -> tuple[int, ...]:
        return tuple(int(x) for x in np.cumsum((0,) + self.mid_elems[:-1]))

    @property
    def smem_bytes(self) -> int:
        return 4 * (sum(self.mid_elems) + self.tile_elems)

    @property
    def n_token_blocks(self) -> int:
        return -(-self.tokens // self.block_tokens)

    @property
    def packed_bytes(self) -> int:
        return 4 * self.packed_elems


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _step_tile(m: int, n: int) -> tuple[int, int, int]:
    """(tile_m, tile_n, rows a thread) of a step whose block computes an
    (m x n) output: 4-column groups of threads, each thread up to
    ``gemm_tile.cuh``'s 4 rows, 256 threads."""
    tile_n = max(4, min(_next_pow2(n), _MAX_TILE))
    ty_max = _THREADS // (tile_n // 4)
    rows = min(_next_pow2(m), _TILE_ROWS * ty_max)
    return rows, tile_n, -(-rows // ty_max)


def compile_program(entries, steps, *, block_k: int, block_tokens: int,
                    batch_edge: str = BATCH_EDGE) -> Program:
    """Compile the chain ``steps`` over the work list ``entries``
    (``(edges, dims)`` at the call's full token count) for one kernel token
    block.

    Per step the GEMM view follows ``ops.gemm_contract``: rows walk A's
    free edges, the shared index walks the shared edges in A's order,
    columns walk B's free edges.  Each step reads one token-side operand
    (the streamed input at the first step, the previous interior result
    after it) and one batch-free input, which is packed once per call into
    the dense view of its role.  Offsets of the streamed input and of Y use
    their full-token strides with the token index local to the block (the
    kernel adds ``t0 * tok_stride``); interior results live in shared
    memory in the token-blocked tensordot layout of their step.
    """
    steps = tuple(tuple(s) for s in steps)
    entries = [(tuple(e), tuple(d)) for e, d in entries]
    if not 2 <= len(steps) <= _MAX_STEPS:
        raise ValueError(f"fused segments take 2..{_MAX_STEPS} steps, "
                         f"got {len(steps)}")
    input_positions, ops, mids = _compile_segment(entries, steps, batch_edge)
    ins = [entries[p] for p in input_positions]
    slot = _stream_slot(entries, input_positions, batch_edge)
    tokens = ins[slot][1][ins[slot][0].index(batch_edge)]
    bt = block_tokens

    def blocked(edges, dims):
        return tuple(bt if e == batch_edge else d for e, d in zip(edges, dims))

    tables: list[np.ndarray] = []
    n_tab = 0

    def add(arr: np.ndarray) -> int:
        nonlocal n_tab
        tables.append(arr)
        n_tab += len(arr)
        return n_tab - len(arr)

    def walk(edges, dim, stride) -> tuple[np.ndarray, np.ndarray | None]:
        """Offsets over ``edges`` and, when the batch edge is among them,
        each entry's token index in the block."""
        off = _offsets([(dim[e], stride[e]) for e in edges])
        if batch_edge not in edges:
            return off, None
        return off, _offsets([(dim[e], 1 if e == batch_edge else 0)
                              for e in edges])

    def layout(src):
        """(edges, block dims, strides, tok_stride) of an operand."""
        if src[0] == "mid":
            ec, dc = mids[src[1]]
            bd = blocked(ec, dc)
            return ec, bd, dict(zip(ec, _strides(bd))), 0
        e, d = ins[src[1]]
        st = dict(zip(e, _strides(d)))
        return e, blocked(e, d), st, st.get(batch_edge, 0)

    chain: list[ChainStep] = []
    packs: list[Pack] = []
    packed = 0
    tile_elems = 0
    for t, (a_src, b_src, ax_a, ax_b, (m_full, k_full, n_full)) in enumerate(ops):
        ea, da, sa, tsa = layout(a_src)
        eb, db, sb, tsb = layout(b_src)
        shared = [ea[ax] for ax in ax_a]
        dim = {**dict(zip(ea, da)), **dict(zip(eb, db))}
        a_free = [e for e in ea if e not in shared]
        b_free = [e for e in eb if e not in shared]
        row_a, tok_ra = walk(a_free, dim, sa)
        k_a, _ = walk(shared, dim, sa)
        k_b, _ = walk(shared, dim, sb)
        col_b, tok_cb = walk(b_free, dim, sb)
        m, k, n = len(row_a), len(k_a), len(col_b)
        w_is_a = batch_edge not in ea
        if w_is_a == (batch_edge not in eb):
            raise ValueError(f"segment step {t}: need one batch-free operand")
        # the batch-free input, packed in the dense view of its role
        w_src = a_src if w_is_a else b_src
        rows, cols = (m, k) if w_is_a else (k, n)
        w_row, w_col = (row_a, k_a) if w_is_a else (k_b, col_b)
        packs.append(Pack(w_src[1], rows, cols, add(w_row), add(w_col), packed))
        w_offset = packed
        packed += _round4(rows * cols)
        # the token-side operand keeps its tables
        t_src = b_src if w_is_a else a_src
        t_row, t_col = (k_b, col_b) if w_is_a else (row_a, k_a)
        tt = {"row": add(t_row), "col": add(t_col)}
        streamed = t_src == ("in", slot)
        if streamed and not w_is_a:
            tt["row_tok"] = add(tok_ra)
        elif streamed:
            tt["col_tok"] = add(tok_cb)
        tok_stride = (tsb if w_is_a else tsa) if streamed else 0
        t_cols = n if w_is_a else k
        vec = (streamed and not w_is_a and t_cols % 4 == 0
               and tok_stride % 4 == 0 and bool((t_row % 4 == 0).all())
               and np.array_equal(t_col, np.arange(t_cols)))
        bk = _clamp_block(block_k, k_full)
        tile_m, tile_n, tr = _step_tile(m, n)
        kc_max = (_STAGE_FLOATS - 4 * tile_m) // (tile_m + tile_n)
        kc = bk * max(1, min(kc_max // bk, -(-k // bk)))
        tile_elems = max(tile_elems, tile_m * (kc + 4) + kc * tile_n)
        out_tables: dict = {}
        y_vec = False
        out_mid = t
        if t == len(ops) - 1:
            out_mid = -1
            ec, dc = mids[t]
            sy = dict(zip(ec, _strides(dc)))
            c_row, tok_r = walk(a_free, dim, sy)
            c_col, tok_c = walk(b_free, dim, sy)
            out_tables = {"c_row": add(c_row), "c_col": add(c_col)}
            if tok_r is not None:
                out_tables["c_row_tok"] = add(tok_r)
            else:
                out_tables["c_col_tok"] = add(tok_c)
            y_tok = sy[batch_edge]
            y_vec = (tok_r is None and np.array_equal(c_col, np.arange(n))
                     and bool((c_row % 4 == 0).all())
                     and y_tok * bt % 4 == 0)
        chain.append(ChainStep(
            Operand(t_src, tt, tok_stride, vec), w_is_a, w_offset,
            m, k, n, bk, kc, tile_m, tile_n, tr, out_mid, out_tables, y_vec))
    out_edges, out_dims = mids[-1]
    all_tables = np.concatenate(tables)
    if (all_tables.max(initial=0) >= 2**31 or math.prod(out_dims) >= 2**31
            or packed >= 2**31):
        raise ValueError("fused_path: offsets overflow int32")
    mid_elems = tuple(_round4(math.prod(blocked(*mids[t])))
                      for t in range(len(ops) - 1))
    return Program(
        bt, tokens, out_edges, out_dims,
        dict(zip(out_edges, _strides(out_dims)))[batch_edge],
        tuple(input_positions), tuple(chain), all_tables.astype(np.int32),
        mid_elems, tile_elems, tuple(packs), packed)


def choose_block_tokens(entries, steps, *, block_k: int, plan_block: int,
                        n_sm: int = 132,
                        batch_edge: str = BATCH_EDGE) -> int:
    """The kernel's token block: a power of two no larger than the plan's
    block, :data:`MAX_KERNEL_BLOCK_TOKENS` or the call's tokens, halved
    (down to :data:`MIN_KERNEL_BLOCK_TOKENS`) while the call would give
    fewer token blocks than ``n_sm``, and halved further while its shared
    memory exceeds what a block has.

    Raises ``ValueError`` when a single token does not fit.
    """
    entries = [(tuple(e), tuple(d)) for e, d in entries]
    stream = next(d[e.index(batch_edge)] for e, d in entries if batch_edge in e)
    bt = 1
    while bt * 2 <= min(max(plan_block, 1), MAX_KERNEL_BLOCK_TOKENS) \
            and bt < stream:
        bt *= 2
    while bt > MIN_KERNEL_BLOCK_TOKENS and -(-stream // bt) < n_sm:
        bt //= 2
    while True:
        smem = compile_program(entries, steps, block_k=block_k,
                               block_tokens=bt,
                               batch_edge=batch_edge).smem_bytes
        if smem <= SMEM_LIMIT_BYTES:
            return bt
        if bt == 1:
            raise ValueError(
                f"fused_path: one token of this segment needs {smem} B of "
                f"shared memory, over the {SMEM_LIMIT_BYTES} B a Hopper "
                "block can use")
        bt //= 2


def segment_smem_bytes(
    work: Sequence[tuple[tuple[str, ...], torch.Tensor]],
    steps: Sequence[tuple[int, int]],
    *,
    block_tokens: int,
    block_k: int = 128,
    batch_edge: str = BATCH_EDGE,
) -> int:
    """Shared memory one block of the kernel uses at ``block_tokens``:
    the fp32 interior intermediates plus the staging tiles of the largest
    round (the counterpart of the reference's ``segment_vmem_bytes``)."""
    entries = [(edges, tuple(t.shape)) for edges, t in work]
    return compile_program(entries, steps, block_k=block_k,
                           block_tokens=block_tokens,
                           batch_edge=batch_edge).smem_bytes


def run_program_plain(prog: Program,
                      inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Execute a compiled program with torch gathers, block by block.

    The CPU mirror of what ``csrc/fused_path.cu`` does with the same
    tables and grid: the pack of each batch-free operand into its dense
    view, then per token block the masked loads of the streamed input, the
    interior buffers, and the scatter of the last step into Y.  The tests
    hold it against :func:`fused_segment_contract_plain`, so the table
    compiler is checked where no card is present.
    """
    tab = torch.from_numpy(prog.tables.astype(np.int64))
    flat = [t.reshape(-1).to(torch.float32) for t in inputs]
    bt = prog.block_tokens
    y = torch.zeros(math.prod(prog.out_dims), dtype=torch.float32)

    def vec(off: int, n: int) -> torch.Tensor:
        return tab[off:off + n]

    packed = torch.full((prog.packed_elems,), float("nan"))
    for pk in prog.packs:
        idx = vec(pk.row, pk.rows)[:, None] + vec(pk.col, pk.cols)[None, :]
        packed[pk.offset:pk.offset + pk.rows * pk.cols] = \
            flat[pk.slot][idx].reshape(-1)

    def token_side(op: Operand, rows: int, cols: int, mids, t0, valid):
        t = op.tables
        if op.src[0] == "mid":
            base, shift = mids[op.src[1]], 0
        else:
            base, shift = flat[op.src[1]], t0 * op.tok_stride
        idx = vec(t["row"], rows)[:, None] + vec(t["col"], cols)[None, :] + shift
        ok = torch.ones(rows, cols, dtype=torch.bool)
        if "row_tok" in t:
            ok &= (vec(t["row_tok"], rows) < valid)[:, None]
        if "col_tok" in t:
            ok &= (vec(t["col_tok"], cols) < valid)[None, :]
        return torch.where(ok, base[idx.clamp(0, base.numel() - 1)], 0.0)

    for t0 in range(0, prog.tokens, bt):
        valid = min(bt, prog.tokens - t0)
        mids: list[torch.Tensor] = []
        for st in prog.steps:
            w = packed[st.w_offset:st.w_offset + (
                st.M * st.K if st.w_is_a else st.K * st.N)]
            if st.w_is_a:
                a = w.reshape(st.M, st.K)
                b = token_side(st.t, st.K, st.N, mids, t0, valid)
            else:
                a = token_side(st.t, st.M, st.K, mids, t0, valid)
                b = w.reshape(st.K, st.N)
            c = a @ b
            if st.out_mid >= 0:
                mids.append(c.reshape(-1))
                continue
            ot = st.out_tables
            off = (vec(ot["c_row"], st.M)[:, None] + vec(ot["c_col"], st.N)[None, :]
                   + t0 * prog.y_tok_stride)
            tok = (vec(ot["c_row_tok"], st.M)[:, None].expand_as(c)
                   if "c_row_tok" in ot else
                   vec(ot["c_col_tok"], st.N)[None, :].expand_as(c))
            keep = tok < valid
            y[off[keep]] = c[keep]
    return y.reshape(prog.out_dims)


# ---------------------------------------------------------------------------
# the CUDA wrapper
# ---------------------------------------------------------------------------

class _Operand(ctypes.Structure):
    _fields_ = [("base", ctypes.c_void_p), ("mid", ctypes.c_int),
                ("row", ctypes.c_void_p), ("col", ctypes.c_void_p),
                ("row_tok", ctypes.c_void_p), ("col_tok", ctypes.c_void_p),
                ("tok_stride", ctypes.c_longlong), ("vec", ctypes.c_int)]


class _ChainStep(ctypes.Structure):
    _fields_ = [("t", _Operand), ("w_is_a", ctypes.c_int),
                ("w_offset", ctypes.c_int),
                ("M", ctypes.c_int), ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("bk", ctypes.c_int), ("kc", ctypes.c_int),
                ("tile_m", ctypes.c_int), ("tile_n", ctypes.c_int),
                ("tr", ctypes.c_int), ("out_mid", ctypes.c_int),
                ("y_vec", ctypes.c_int),
                ("c_row", ctypes.c_void_p), ("c_col", ctypes.c_void_p),
                ("c_row_tok", ctypes.c_void_p), ("c_col_tok", ctypes.c_void_p)]


class _FusedParams(ctypes.Structure):
    _fields_ = [("y", ctypes.c_void_p), ("packed", ctypes.c_void_p),
                ("tokens", ctypes.c_longlong),
                ("y_tok_stride", ctypes.c_longlong),
                ("block_tokens", ctypes.c_int), ("n_steps", ctypes.c_int),
                ("tile_offset", ctypes.c_int),
                ("mid_offset", ctypes.c_int * _MAX_STEPS),
                ("steps", _ChainStep * _MAX_STEPS)]


class _PackOp(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("row", ctypes.c_void_p),
                ("col", ctypes.c_void_p), ("rows", ctypes.c_int),
                ("cols", ctypes.c_int), ("offset", ctypes.c_int)]


class _PackParams(ctypes.Structure):
    _fields_ = [("packed", ctypes.c_void_p), ("n_ops", ctypes.c_int),
                ("ops", _PackOp * _MAX_STEPS)]


@functools.lru_cache(maxsize=256)
def _compiled(entries, steps, block_k: int, plan_block: int, n_sm: int,
              batch_edge: str) -> Program:
    bt = choose_block_tokens(entries, steps, block_k=block_k,
                             plan_block=plan_block, n_sm=n_sm,
                             batch_edge=batch_edge)
    return compile_program(entries, steps, block_k=block_k, block_tokens=bt,
                           batch_edge=batch_edge)


def program_for(work, steps, *, block_k: int, block_tokens: int,
                n_sm: int = 132, batch_edge: str = BATCH_EDGE) -> Program:
    """The cached :class:`Program` of a segment call."""
    entries = tuple((tuple(e), tuple(t.shape)) for e, t in work)
    return _compiled(entries, tuple(tuple(s) for s in steps), block_k,
                     block_tokens, n_sm, batch_edge)


def fused_segment_contract(
    work: Sequence[tuple[tuple[str, ...], torch.Tensor]],
    steps: Sequence[tuple[int, int]],
    *,
    block_tokens: int = 256,
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
    batch_edge: str = BATCH_EDGE,
) -> tuple[tuple[str, ...], torch.Tensor]:
    """Execute the chain ``steps`` over the live work list ``work`` in one
    call: the pack of the batch-free operands, then the chain (two CUDA
    launches, one count in ``launches.COUNTS``).

    Returns ``(result_edges, result)``: the entry the per-step route would
    append, with the batch axis wherever the last step leaves it.
    ``block_tokens`` is the plan's token block; the kernel picks its own
    block no larger than it (:func:`choose_block_tokens`).  CPU tensors
    take :func:`fused_segment_contract_plain`; CUDA tensors launch the
    kernel or raise.  ``block_m``/``block_n`` change no value (only
    ``block_k`` does) and pass to the plain version.
    """
    if len(steps) < 2:
        raise ValueError("fused segments need at least two steps")
    tensors = [t for _, t in work]
    if all(t.device.type == "cpu" for t in tensors):
        return fused_segment_contract_plain(
            work, steps, block_m=block_m, block_k=block_k, block_n=block_n,
            batch_edge=batch_edge)
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("fused_path: every work-list tensor must sit on one "
                         "CUDA device (or all on the CPU)")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    prog = program_for(work, steps, block_k=block_k, block_tokens=block_tokens,
                       n_sm=n_sm, batch_edge=batch_edge)
    return _run(work, prog)


def _launch_params(prog: Program, dev: torch.device):
    """(device tables, pack params, chain params) of ``prog`` on ``dev``:
    the tables copied once, the parameter structs filled with everything
    but the per-call pointers."""
    tab = torch.from_numpy(prog.tables).to(dev)

    def tptr(tables: dict, name: str):
        return tab.data_ptr() + 4 * tables[name] if name in tables else None

    pack = _PackParams()
    pack.n_ops = len(prog.packs)
    for i, pk in enumerate(prog.packs):
        pack.ops[i] = _PackOp(None, tab.data_ptr() + 4 * pk.row,
                              tab.data_ptr() + 4 * pk.col, pk.rows, pk.cols,
                              pk.offset)
    params = _FusedParams()
    params.tokens, params.y_tok_stride = prog.tokens, prog.y_tok_stride
    params.block_tokens = prog.block_tokens
    params.n_steps = len(prog.steps)
    params.tile_offset = sum(prog.mid_elems)
    for i, off in enumerate(prog.mid_offsets):
        params.mid_offset[i] = off
    for i, st in enumerate(prog.steps):
        t, ot = st.t.tables, st.out_tables
        is_mid = st.t.src[0] == "mid"
        params.steps[i] = _ChainStep(
            _Operand(None, st.t.src[1] if is_mid else -1, tptr(t, "row"),
                     tptr(t, "col"), tptr(t, "row_tok"), tptr(t, "col_tok"),
                     st.t.tok_stride, 0),
            int(st.w_is_a), st.w_offset, st.M, st.K, st.N, st.bk, st.kc,
            st.tile_m, st.tile_n, st.tr, st.out_mid, int(st.y_vec), tptr(ot, "c_row"), tptr(ot, "c_col"),
            tptr(ot, "c_row_tok"), tptr(ot, "c_col_tok"))
    return tab, pack, params


def _run(work, prog: Program) -> tuple[tuple[str, ...], torch.Tensor]:
    """One call of ``prog`` on the CUDA work list: the pack, then the
    chain.  Tests pass programs of other token blocks here to show the
    result does not depend on them."""
    dev = work[0][1].device
    ins = [work[p][1] for p in prog.input_positions]
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError("fused_path kernel takes float32 operands")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("fused_path: operands must be contiguous")
    if any(st.bk % 4 for st in prog.steps):
        raise ValueError("fused_path kernel: each step's clamped block_k must "
                         "be a multiple of 4, got "
                         f"{[st.bk for st in prog.steps]}")
    y = torch.empty(prog.out_dims, dtype=torch.float32, device=dev)
    if prog.tokens == 0:
        return prog.out_edges, y
    packed = torch.empty(prog.packed_elems, dtype=torch.float32, device=dev)
    state = prog.device_state.get(dev.index)
    if state is None:
        state = prog.device_state[dev.index] = _launch_params(prog, dev)
    _, pack, params = state
    # only the operand, output and scratch pointers change between calls;
    # the launch copies the structs, so one caller at a time may reuse them
    pack.packed = params.packed = packed.data_ptr()
    params.y = y.data_ptr()
    for i, pk in enumerate(prog.packs):
        pack.ops[i].src = ins[pk.slot].data_ptr()
    for i, st in enumerate(prog.steps):
        if st.t.src[0] == "in":
            base = ins[st.t.src[1]].data_ptr()
            params.steps[i].t.base = base
            params.steps[i].t.vec = int(st.t.vec and base % 16 == 0)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_path_launch(ctypes.byref(pack), ctypes.byref(params),
                               prog.n_token_blocks, prog.smem_bytes, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_path launch failed: {lib.fused_path_error_string(rc).decode()}"
            f" (tokens {prog.tokens}, block {prog.block_tokens}, smem "
            f"{prog.smem_bytes} B)")
    launches.COUNTS["fused_path"] += 1
    return prog.out_edges, y


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_path")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_path_launch.argtypes = [p, p, i, i, p]
        lib.fused_path_launch.restype = i
        lib.fused_path_max_steps.restype = i
        lib.fused_path_max_tile.restype = i
        lib.fused_path_error_string.argtypes = [i]
        lib.fused_path_error_string.restype = ctypes.c_char_p
        if (lib.fused_path_max_steps() != _MAX_STEPS
                or lib.fused_path_max_tile() != _MAX_TILE_OUTPUTS):
            raise RuntimeError("csrc/fused_path.cu step or tile capacity "
                               "differs from the wrapper's")
        lib._typed = True
    return lib
