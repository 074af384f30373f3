"""Streaming TT contraction (paper 4.2): CUDA kernel + plain version.

Port of ``src/repro/kernels/streaming_tt.py``.  The TPU kernel pinned all
TT cores in VMEM and contracted each token block against the whole core
chain in one grid step.  A Hopper block has 227 KB of shared memory, less
than the plans' 8 MiB VMEM blocks need, so the CUDA version
(``csrc/streaming_tt.cu``) splits the path:

* :func:`compile_program` turns ``(network, path_steps)`` into a step
  table: one GEMM per pairwise contraction, its operands addressed through
  int32 offset tables, each step marked token-free or token-carrying;
* the token-free steps (core with core) run once per call into a device
  workspace, then one launch streams the tokens through the
  token-carrying steps, with the token operand in shared memory.

The kernel picks its own token block (see :func:`choose_block_tokens`):
token rows are independent, so the block size never changes an output.
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

#: shared memory the kernel aims to stay under (leaves room for two
#: blocks per SM); one token that does not fit here may still use up to
#: :data:`SMEM_LIMIT_BYTES`
SMEM_TARGET_BYTES = 96 * 1024
SMEM_LIMIT_BYTES = 232_448
#: largest token block of the kernel; smaller blocks spread a short
#: prompt over more SMs
MAX_KERNEL_BLOCK_TOKENS = 32
_MAX_TOK_STEPS = 16


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
) -> torch.Tensor:
    """Plain PyTorch version: ``execute_path`` over all tokens at once.

    Rows are independent, so contracting the whole batch in one pass
    computes the function the block-streamed kernel computes.
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
    return y.reshape(tokens, out_dim).to(x.dtype)


# ---------------------------------------------------------------------------
# the step table the CUDA kernel runs
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
class GemmStep:
    """One pairwise contraction as ``C[M,N] = A[M,K] @ B[K,N]``.

    ``a``/``b`` name the operands: ``("core", i)``, ``("ws", offset)`` (a
    token-free intermediate in the workspace) or ``("tok",)`` (the
    token-carrying tensor).  ``tables`` maps ``row_a``, ``k_a``, ``k_b``,
    ``col_b`` (and ``c_row``/``c_col`` for the step that writes Y) to
    element offsets into the program's int32 table array.
    """

    a: tuple
    b: tuple
    M: int
    K: int
    N: int
    tables: dict
    out: tuple                 # ("ws", offset) | ("buf", i) | ("y",)
    src: int = -1              # buffer of the token operand


@dataclasses.dataclass(frozen=True)
class Program:
    """A compiled path for one network geometry at one kernel token block."""

    block_tokens: int
    n_in: int
    out_dim: int
    free_steps: tuple[GemmStep, ...]
    tok_steps: tuple[GemmStep, ...]
    tables: np.ndarray         # int32
    ws_elems: int
    buf_elems: tuple[int, int]  # per block
    #: the int32 tables copied to each device the program ran on, kept
    #: with the program so the compile cache's bound covers them
    device_tables: dict = dataclasses.field(default_factory=dict,
                                            compare=False, repr=False)

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.buf_elems[0] + self.buf_elems[1])


def compile_program(tn: TensorNetwork, steps, block_tokens: int) -> Program:
    """Compile ``steps`` over ``tn`` (rebatched to ``block_tokens``).

    Replays ``execute_path``'s edge bookkeeping and records, per step, the
    offset tables of its GEMM view: rows walk A's free edges, the shared
    index walks the shared edges in A's order, columns walk B's free
    edges, and the result is the contiguous ``(M, N)`` tensordot layout.
    The last step instead scatters into Y's ``(tokens, out_dim)`` layout.
    """
    steps = tuple(tuple(s) for s in steps)
    tn = _rebatch(tn, block_tokens)
    _, _, in_modes, out_edges, out_dim = _stream_layout(tn)
    core_names = [n.name for n in tn.nodes if n.kind != "input"]
    work = [(n.edges, n.dims,
             ("tok",) if n.kind == "input" else ("core", core_names.index(n.name)))
            for n in tn.nodes]
    tables: list[np.ndarray] = []
    n_tab = 0

    def add(arr: np.ndarray) -> int:
        nonlocal n_tab
        tables.append(arr)
        n_tab += len(arr)
        return n_tab - len(arr)

    free_steps, tok_steps = [], []
    ws = 0
    cur = 0
    buf = [block_tokens * math.prod(in_modes), 0]
    for idx, (i, j) in enumerate(steps):
        (ea, da, ra), (eb, db, rb) = work[i], work[j]
        shared = [e for e in ea if e in eb]
        sa = dict(zip(ea, _strides(da)))
        sb = dict(zip(eb, _strides(db)))
        dim = {**dict(zip(ea, da)), **dict(zip(eb, db))}
        a_free = [e for e in ea if e not in shared]
        b_free = [e for e in eb if e not in shared]
        row_a = _offsets([(dim[e], sa[e]) for e in a_free])
        k_a = _offsets([(dim[e], sa[e]) for e in shared])
        k_b = _offsets([(dim[e], sb[e]) for e in shared])
        col_b = _offsets([(dim[e], sb[e]) for e in b_free])
        tab = {"row_a": add(row_a), "k_a": add(k_a), "k_b": add(k_b),
               "col_b": add(col_b)}
        m, k, n = len(row_a), len(k_a), len(col_b)
        ec = tuple(a_free + b_free)
        dc = tuple(dim[e] for e in ec)
        if ra == ("tok",) or rb == ("tok",):
            if idx == len(steps) - 1:
                sy = dict(zip(out_edges, _strides(
                    [block_tokens] + [dim[e] for e in out_edges[1:]])))
                if set(ec) != set(out_edges):
                    raise ValueError(f"path result edges {ec} != {out_edges}")
                tab["c_row"] = add(_offsets([(dim[e], sy[e]) for e in a_free]))
                tab["c_col"] = add(_offsets([(dim[e], sy[e]) for e in b_free]))
                out = ("y",)
            else:
                dst = 1 - cur
                buf[dst] = max(buf[dst], m * n)
                out = ("buf", dst)
            tok_steps.append(GemmStep(ra, rb, m, k, n, tab, out, src=cur))
            if out[0] == "buf":
                cur = out[1]
            rc = ("tok",)
        else:
            free_steps.append(GemmStep(ra, rb, m, k, n, tab, ("ws", ws)))
            rc = ("ws", ws)
            ws += m * n
        work = [w for s, w in enumerate(work) if s not in (i, j)]
        work.append((ec, dc, rc))
    if len(work) != 1 or not tok_steps or tok_steps[-1].out != ("y",):
        raise ValueError("path does not end in the token-carrying result")
    if len(tok_steps) > _MAX_TOK_STEPS:
        raise ValueError(f"path has {len(tok_steps)} token-carrying steps; the "
                         f"kernel takes at most {_MAX_TOK_STEPS}")
    all_tables = np.concatenate(tables)
    if all_tables.max(initial=0) >= 2**31:
        raise ValueError("offset table overflows int32")
    return Program(block_tokens, math.prod(in_modes), out_dim,
                   tuple(free_steps), tuple(tok_steps),
                   all_tables.astype(np.int32), ws, (buf[0], buf[1]))


def choose_block_tokens(tn: TensorNetwork, steps, plan_block: int) -> int:
    """The kernel's token block: a power of two <= ``plan_block`` and
    :data:`MAX_KERNEL_BLOCK_TOKENS` whose ping-pong buffers fit
    :data:`SMEM_TARGET_BYTES` (or one token under the hard limit).

    Raises ``ValueError`` when a single token's working set exceeds the
    shared memory a block can have.
    """
    per_token = compile_program(tn, steps, 1).smem_bytes
    if per_token > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"streaming_tt: one token's working set along this path is "
            f"{per_token} B, over the {SMEM_LIMIT_BYTES} B of shared memory "
            "a Hopper block can use; plan this layer on tt_gemm instead")
    bt = 1
    cap = max(1, min(plan_block, MAX_KERNEL_BLOCK_TOKENS))
    while bt * 2 <= cap and per_token * bt * 2 <= SMEM_TARGET_BYTES:
        bt *= 2
    return bt


def run_program_plain(prog: Program, x: torch.Tensor,
                      cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Execute a step table with torch gathers, block by block.

    The CPU mirror of what ``csrc/streaming_tt.cu`` does with the same
    tables (workspace, ping-pong buffers, scatter into Y); the tests hold
    it against :func:`streaming_tt_linear_plain` so the table compiler is
    checked where no card is present.
    """
    tab = torch.from_numpy(prog.tables.astype(np.int64))
    cores = [c.reshape(-1).to(torch.float32) for c in cores]
    ws = torch.zeros(max(prog.ws_elems, 1), dtype=torch.float32)

    def gemm(a, b, st: GemmStep) -> torch.Tensor:
        t = st.tables
        row_a = tab[t["row_a"]:t["row_a"] + st.M]
        k_a = tab[t["k_a"]:t["k_a"] + st.K]
        k_b = tab[t["k_b"]:t["k_b"] + st.K]
        col_b = tab[t["col_b"]:t["col_b"] + st.N]
        return a[row_a[:, None] + k_a[None, :]] @ b[k_b[:, None] + col_b[None, :]]

    def operand(ref, tok):
        if ref[0] == "core":
            return cores[ref[1]]
        if ref[0] == "ws":
            return ws[ref[1]:]
        return tok

    for st in prog.free_steps:
        c = gemm(operand(st.a, None), operand(st.b, None), st)
        ws[st.out[1]:st.out[1] + st.M * st.N] = c.reshape(-1)
    tokens = x.shape[0]
    bt = prog.block_tokens
    y = torch.zeros(tokens * prog.out_dim, dtype=torch.float32)
    for t0 in range(0, tokens, bt):
        valid = min(bt, tokens - t0)
        bufs = [torch.zeros(bt * prog.n_in), None]
        bufs[0][:valid * prog.n_in] = x[t0:t0 + valid].reshape(-1).float()
        for st in prog.tok_steps:
            tok = bufs[st.src]
            c = gemm(operand(st.a, tok), operand(st.b, tok), st)
            if st.out[0] == "buf":
                bufs[st.out[1]] = c.reshape(-1)
                continue
            t = st.tables
            off = (tab[t["c_row"]:t["c_row"] + st.M][:, None]
                   + tab[t["c_col"]:t["c_col"] + st.N][None, :]).reshape(-1)
            keep = off < valid * prog.out_dim
            y[t0 * prog.out_dim + off[keep]] = c.reshape(-1)[keep]
    return y.reshape(tokens, prog.out_dim).to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA wrapper
# ---------------------------------------------------------------------------

class _GemmTables(ctypes.Structure):
    _fields_ = [("row_a", ctypes.c_void_p), ("k_a", ctypes.c_void_p),
                ("k_b", ctypes.c_void_p), ("col_b", ctypes.c_void_p),
                ("M", ctypes.c_int), ("K", ctypes.c_int), ("N", ctypes.c_int)]


class _FreeStep(ctypes.Structure):
    _fields_ = [("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("c", ctypes.c_void_p), ("t", _GemmTables)]


class _TokStep(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("c_row", ctypes.c_void_p),
                ("c_col", ctypes.c_void_p), ("t", _GemmTables),
                ("token_is_a", ctypes.c_int), ("src", ctypes.c_int),
                ("dst", ctypes.c_int)]


class _StreamParams(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("y", ctypes.c_void_p),
                ("tokens", ctypes.c_longlong), ("n_in", ctypes.c_int),
                ("out_dim", ctypes.c_int), ("block_tokens", ctypes.c_int),
                ("buf0_elems", ctypes.c_int), ("n_steps", ctypes.c_int),
                ("steps", _TokStep * _MAX_TOK_STEPS)]


@functools.lru_cache(maxsize=256)
def _compiled(signature, steps, plan_block: int) -> Program:
    nodes = [Node(name, edges, dims, kind) for name, edges, dims, kind in signature]
    tn = TensorNetwork(nodes)
    bt = choose_block_tokens(tn, steps, plan_block)
    return compile_program(tn, steps, bt)


def program_for(tn: TensorNetwork, path: CandidatePath,
                plan_block: int) -> Program:
    """The cached :class:`Program` for a network, path and plan block."""
    sig = tuple((n.name, n.edges, n.dims, n.kind) for n in tn.nodes)
    return _compiled(sig, tuple(tuple(s) for s in path.steps), plan_block)


def streaming_tt_linear(
    x: torch.Tensor,
    cores: Sequence[torch.Tensor],
    tn: TensorNetwork,
    path: CandidatePath,
    *,
    block_tokens: int = 256,
) -> torch.Tensor:
    """Apply a streaming TT contraction to ``x: (tokens, N_in)``.

    ``tn``/``path`` describe one block of ``block_tokens`` tokens (the
    plan's block); any token count is accepted (the last block is masked,
    not padded).  CPU tensors take :func:`streaming_tt_linear_plain`; CUDA
    tensors launch the kernel or raise.
    """
    if x.device.type == "cpu" and all(c.device.type == "cpu" for c in cores):
        return streaming_tt_linear_plain(x, cores, tn, path)
    if x.device.type != "cuda" or any(c.device != x.device for c in cores):
        raise ValueError("streaming_tt: x and every core must sit on one "
                         "CUDA device (or all on the CPU)")
    if x.dtype != torch.float32 or any(c.dtype != torch.float32 for c in cores):
        raise TypeError("streaming_tt kernel takes float32 x and cores")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("streaming_tt: x must be a contiguous (tokens, N_in) tensor")
    if not all(c.is_contiguous() for c in cores):
        raise ValueError("streaming_tt: cores must be contiguous")
    core_nodes = [n for n in tn.nodes if n.kind != "input"]
    if len(cores) != len(core_nodes) or any(
            tuple(c.shape) != n.dims for c, n in zip(cores, core_nodes)):
        raise ValueError("streaming_tt: core shapes do not match the network")
    prog = program_for(tn, path, block_tokens)
    tokens = x.shape[0]
    if x.shape[1] != prog.n_in:
        raise ValueError("x inner dim does not match network input modes")
    y = torch.empty((tokens, prog.out_dim), dtype=torch.float32, device=x.device)
    if tokens == 0:
        return y
    if max(tokens * prog.n_in, tokens * prog.out_dim) >= 2**31:
        raise ValueError("streaming_tt: activation too large for 32-bit offsets")

    tab = prog.device_tables.get(x.device.index)
    if tab is None:
        tab = torch.from_numpy(prog.tables).to(x.device)
        prog.device_tables[x.device.index] = tab
    ws = torch.empty(max(prog.ws_elems, 1), dtype=torch.float32, device=x.device)

    def tptr(off: int) -> int:
        return tab.data_ptr() + 4 * off

    def optr(ref) -> int:
        if ref[0] == "core":
            return cores[ref[1]].data_ptr()
        return ws.data_ptr() + 4 * ref[1]

    def tables(st: GemmStep) -> _GemmTables:
        t = st.tables
        return _GemmTables(tptr(t["row_a"]), tptr(t["k_a"]), tptr(t["k_b"]),
                           tptr(t["col_b"]), st.M, st.K, st.N)

    free = (_FreeStep * max(len(prog.free_steps), 1))()
    for i, st in enumerate(prog.free_steps):
        free[i] = _FreeStep(optr(st.a), optr(st.b), optr(st.out), tables(st))
    params = _StreamParams()
    params.x, params.y, params.tokens = x.data_ptr(), y.data_ptr(), tokens
    params.n_in, params.out_dim = prog.n_in, prog.out_dim
    params.block_tokens = prog.block_tokens
    params.buf0_elems = prog.buf_elems[0]
    params.n_steps = len(prog.tok_steps)
    for i, st in enumerate(prog.tok_steps):
        token_is_a = st.a == ("tok",)
        w = st.b if token_is_a else st.a
        y_step = st.out == ("y",)
        params.steps[i] = _TokStep(
            optr(w),
            tptr(st.tables["c_row"]) if y_step else None,
            tptr(st.tables["c_col"]) if y_step else None,
            tables(st), int(token_is_a), st.src,
            -1 if y_step else st.out[1])
    n_blocks = -(-tokens // prog.block_tokens)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.streaming_tt_launch(free, len(prog.free_steps),
                                 ctypes.byref(params), n_blocks,
                                 prog.smem_bytes, stream)
    if rc != 0:
        raise RuntimeError(
            f"streaming_tt launch failed: "
            f"{lib.streaming_tt_error_string(rc).decode()} (tokens {tokens}, "
            f"block {prog.block_tokens}, smem {prog.smem_bytes} B)")
    launches.COUNTS["streaming_tt"] += 1
    return y


def _lib() -> ctypes.CDLL:
    lib = _build.load("streaming_tt")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.streaming_tt_launch.argtypes = [p, i, p, i, i, p]
        lib.streaming_tt_launch.restype = i
        lib.streaming_tt_max_steps.restype = i
        lib.streaming_tt_error_string.argtypes = [i]
        lib.streaming_tt_error_string.restype = ctypes.c_char_p
        if lib.streaming_tt_max_steps() != _MAX_TOK_STEPS:
            raise RuntimeError("csrc/streaming_tt.cu step capacity differs "
                               "from the wrapper's")
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
    def forward(ctx, x, tn, path, bwd_steps, block_tokens, *cores):
        ctx.save_for_backward(x, *cores)
        ctx.meta = (tn, bwd_steps, block_tokens)
        return streaming_tt_linear(x, list(cores), tn, path,
                                   block_tokens=block_tokens)

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
        return (dx, None, None, None, None, *dcores)


def streaming_tt_linear_vjp(
    x: torch.Tensor,
    cores: Sequence[torch.Tensor],
    tn: TensorNetwork,
    path: CandidatePath,
    *,
    bwd_steps: Optional[Mapping[str, Sequence[tuple[int, int]]]] = None,
    block_tokens: int = 256,
) -> torch.Tensor:
    """:func:`streaming_tt_linear` with the gradient-network backward pass
    of :class:`StreamingTTLinearVJP`.  ``tn``/``path`` describe one block
    of ``block_tokens`` tokens, as for the forward."""
    return StreamingTTLinearVJP.apply(x, tn, path, dict(bwd_steps or {}),
                                      block_tokens, *cores)
