"""Dataflow-configurable GEMM (OS / WS / IS): CUDA kernel + plain version.

Port of ``src/repro/kernels/tt_gemm.py``.  The Pallas kernel picked its
dataflow through the grid order; the CUDA kernel (``csrc/tt_gemm.cu``)
picks which operand tile stays resident in shared memory:

  OS  one block per output tile, k loop inside, fp32 accumulator in
      registers, C written once;
  WS  a grid of (n-band x m-range x k-group) blocks chosen for the card by
      :func:`ws_grid`; in each block the k-block's B tile stays resident
      while the A tiles of the m-range stream past it.  Split over K, every
      k-block's partial goes to a workspace and a second launch folds them
      in ascending order; unsplit, partial C folds in registers or
      round-trips through C once per k-fold;
  IS  one block per m-band, A tile resident while B streams, same fp32
      partial-sum contract as WS.

Each output element sums its k-blocks in ascending order in fp32 (the
workspace keeps each k-block's partial apart, so a split changes no bit;
no atomics), so the three dataflows agree bit for bit at one ``block_k``
and a row never depends on M, on the WS grid or on the other rows of the
call.  Ragged dims are masked in the kernel instead of zero-padded.

What bounds WS at the train plans' weight gradients (M,K,N = 2048,2048,16
and 768|2048 x 2048|768 x 16, ``block_n`` 16) is the bytes of A, not FMAs
(0.0051 ms against 0.002 ms at 2048,2048,16), and before the split the
grid: one block per n-band meant one block for the whole product.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Iterator, Literal

import torch

from . import _build, launches

DataflowName = Literal["IS", "OS", "WS"]
DATAFLOWS = ("OS", "WS", "IS")

_CODE = {"OS": 0, "IS": 2}   # tt_gemm_launch's codes; WS has its own launcher
_COUNTER = {"OS": "tt_gemm_os", "WS": "tt_gemm_ws", "IS": "tt_gemm_is"}
_THREADS = 256
_MAX_PER_THREAD = 64
#: dynamic shared memory one Hopper block may use
SMEM_LIMIT_BYTES = 232_448
#: the WS kernel's register tile: up to this many rows x 4 columns a thread
WS_TILE_ROWS = 4
#: the WS grid's m-tiles are not cut below this many rows
WS_MIN_TILE_ROWS = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_blocks(dataflow: str, block_m: int, block_k: int,
                  block_n: int) -> None:
    if dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r}")
    for name, v in (("block_m", block_m), ("block_k", block_k),
                    ("block_n", block_n)):
        if not isinstance(v, int) or v < 1:
            raise ValueError(f"{name} must be a positive int, got {v!r}")


@dataclasses.dataclass(frozen=True)
class WSGrid:
    """How one WS launch covers ``(M, K, N)``: blocks over (n-band x
    m-range x k-group), each thread a register tile of ``rows_per_thread``
    rows (strided by ``row_groups``) x 4 columns.  The kernel decodes a
    block index exactly as :meth:`block_work` does."""

    m: int
    k: int
    n: int
    block_k: int
    block_n: int
    rows_per_thread: int
    row_groups: int
    mtiles_per_range: int
    kblocks_per_group: int

    @property
    def tile_m(self) -> int:
        """Rows of one staged A tile (the kernel's m-tile)."""
        return self.rows_per_thread * self.row_groups

    @property
    def n_kblocks(self) -> int:
        return _cdiv(self.k, self.block_k)

    @property
    def n_nbands(self) -> int:
        return _cdiv(self.n, self.block_n)

    @property
    def n_mtiles(self) -> int:
        return _cdiv(self.m, self.tile_m)

    @property
    def n_mranges(self) -> int:
        return _cdiv(self.n_mtiles, self.mtiles_per_range)

    @property
    def n_kgroups(self) -> int:
        return _cdiv(self.n_kblocks, self.kblocks_per_group)

    @property
    def blocks(self) -> int:
        return self.n_nbands * self.n_mranges * self.n_kgroups

    @property
    def split(self) -> bool:
        """K split over k-groups: partials go to the workspace and a
        second launch folds them."""
        return self.n_kgroups > 1

    @property
    def workspace_elems(self) -> int:
        """fp32 values of the partial-sum workspace (``n_kb x M x N``)."""
        return self.n_kblocks * self.m * self.n if self.split else 0

    @property
    def smem_bytes(self) -> int:
        lda = _cdiv(self.block_k, 4) * 4 + 4
        ldb = 4 * _cdiv(self.block_n, 4)
        return 4 * (self.tile_m * lda + self.block_k * ldb)

    def block_work(self, b: int) -> tuple[range, range, range]:
        """(rows, k-blocks, columns) block ``b`` computes."""
        nb = b % self.n_nbands
        mr = (b // self.n_nbands) % self.n_mranges
        kg = b // (self.n_nbands * self.n_mranges)
        rows = range(mr * self.mtiles_per_range * self.tile_m,
                     min(self.m, (mr + 1) * self.mtiles_per_range * self.tile_m))
        kbs = range(kg * self.kblocks_per_group,
                    min(self.n_kblocks, (kg + 1) * self.kblocks_per_group))
        cols = range(nb * self.block_n, min(self.n, (nb + 1) * self.block_n))
        return rows, kbs, cols

    def blocks_work(self) -> Iterator[tuple[range, range, range]]:
        return (self.block_work(b) for b in range(self.blocks))


@functools.lru_cache(maxsize=1024)
def ws_grid(m: int, k: int, n: int, *, block_m: int, block_k: int,
            block_n: int, n_sm: int = 132) -> WSGrid:
    """The WS kernel's grid for one call, aiming at ``2 * n_sm`` blocks.

    1. The m-tile: up to ``min(block_m, M)`` rows, as ``row_groups``
       threads per 4-column group (256 threads over ``ceil(block_n / 4)``
       groups) times up to :data:`WS_TILE_ROWS` rows each, cut to fit
       shared memory.
    2. While ``n-bands x m-tiles x k-blocks`` stays under the aim, the
       m-tile shrinks to ``ceil(M / wanted)`` rows (not below
       :data:`WS_MIN_TILE_ROWS`), so that M alone could fill the grid.
    3. When the n-bands x m-tiles reach the aim, neighbouring m-tiles
       merge into m-ranges (B stays resident across more of A);
       otherwise K splits into k-groups of ``n_kb // needed`` k-blocks.

    At the train plans' weight gradients on 132 SMs (block_k 128,
    block_n 16): 2048,2048,16 -> 18 m-ranges of 120 rows x 16 k-groups =
    288 blocks; 768,2048,16 -> 17 of 46 rows x 16 = 272; 2048,768,16 ->
    44 of 47 rows x 6 = 264.  At the serve shape 37,2048,16 (block_m 64):
    10 m-ranges of 4 rows x 16 k-groups = 160.
    ``block_k`` alone fixes the bits; the grid changes none.
    """
    _check_blocks("WS", block_m, block_k, block_n)
    n_tx = _cdiv(block_n, 4)
    if n_tx > _THREADS:
        raise ValueError(f"tt_gemm WS: block_n {block_n} over {4 * _THREADS}")
    ty_max = _THREADS // n_tx
    lda = _cdiv(block_k, 4) * 4 + 4
    b_floats = block_k * 4 * n_tx
    max_rows = (SMEM_LIMIT_BYTES // 4 - b_floats) // lda
    if max_rows < 1:
        raise ValueError(
            f"tt_gemm WS: block_k {block_k} x block_n {block_n} needs more "
            f"than the {SMEM_LIMIT_BYTES} B of shared memory a block has")

    def tile(rows: int) -> tuple[int, int]:
        rows = max(1, min(rows, WS_TILE_ROWS * ty_max, max_rows))
        tr = _cdiv(rows, ty_max)
        return tr, rows // tr

    m1, k1 = max(m, 1), max(k, 1)
    n_nb, n_kb = _cdiv(max(n, 1), block_n), _cdiv(k1, block_k)
    aim = 2 * n_sm
    tr, ty = tile(min(block_m, m1))
    if n_nb * _cdiv(m1, tr * ty) * n_kb < aim:
        wanted = _cdiv(aim, n_nb * n_kb)
        tr, ty = tile(max(min(tr * ty, WS_MIN_TILE_ROWS), _cdiv(m1, wanted)))
    n_mt = _cdiv(m1, tr * ty)
    mtiles, kblocks = 1, n_kb
    if n_nb * n_mt >= aim:
        mtiles = n_nb * n_mt // aim
    else:
        kblocks = max(1, n_kb // _cdiv(aim, n_nb * n_mt))
    return WSGrid(m, k, n, block_k, block_n, tr, ty, mtiles, kblocks)


def run_ws_grid_plain(a: torch.Tensor, b: torch.Tensor,
                      grid: WSGrid) -> torch.Tensor:
    """The CPU mirror of a WS launch over ``grid``: every block writes the
    partials of its (rows, k-blocks, columns) into the ``n_kb x M x N``
    workspace, then the fold sums them in ascending k-block order.  Each
    k-block's partial is the plain version's (one product over all rows),
    so the mirror checks the grid's cover and the fold, not the FMAs."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    bk = grid.block_k
    parts = [a32[:, k0:k0 + bk] @ b32[k0:k0 + bk] for k0 in range(0, grid.k, bk)]
    work = torch.full((grid.n_kblocks, grid.m, grid.n), float("nan"))
    for rows, kbs, cols in grid.blocks_work():
        for kb in kbs:
            work[kb, rows.start:rows.stop, cols.start:cols.stop] = \
                parts[kb][rows.start:rows.stop, cols.start:cols.stop]
    c = work[0]
    for kb in range(1, grid.n_kblocks):
        c = c + work[kb]
    return c


def tt_gemm_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    dataflow: DataflowName = "OS",
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """Plain PyTorch version: the kernel's fp32 k-fold accumulation.

    ``C = p_0 + p_1 + ...`` with ``p_i`` the product over the i-th k-block,
    the grouping every dataflow of the kernel uses.  ``block_m``/``block_n``
    do not change the result; they are checked so both versions take the
    same arguments.
    """
    _check_blocks(dataflow, block_m, block_k, block_n)
    m, k = a.shape
    k2, _ = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    c = None
    for k0 in range(0, k, block_k):
        p = a32[:, k0:k0 + block_k] @ b32[k0:k0 + block_k]
        c = p if c is None else c + p
    return c.to(a.dtype)


def tt_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    dataflow: DataflowName = "OS",
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """``a @ b`` through the dataflow kernel (fp32, row-major operands).

    CPU tensors take :func:`tt_gemm_plain`; CUDA tensors launch the kernel
    or raise.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tt_gemm_plain(a, b, dataflow=dataflow, block_m=block_m,
                             block_k=block_k, block_n=block_n)
    _check_blocks(dataflow, block_m, block_k, block_n)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"tt_gemm: operands on {a.device} and {b.device}; need both on "
            "one CUDA device (or both on the CPU)")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"tt_gemm kernel takes float32, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tt_gemm: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("tt_gemm: operands must be contiguous")
    if block_m * block_n > _THREADS * _MAX_PER_THREAD:
        raise ValueError(
            f"tt_gemm: tile {block_m}x{block_n} exceeds "
            f"{_THREADS * _MAX_PER_THREAD} outputs per block")
    smem = 4 * (block_m * block_k + block_k * block_n)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"tt_gemm: tiles ({block_m}, {block_k}, {block_n}) need {smem} B "
            f"of shared memory, over the {SMEM_LIMIT_BYTES} B a block has")
    m, k = a.shape
    n = b.shape[1]
    if dataflow == "WS":
        return _ws_gemm(a, b, ws_grid(m, k, n, block_m=block_m, block_k=block_k,
                                      block_n=block_n, n_sm=_n_sm(a.device)))
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return c
    if max(m * k, k * n, m * n) >= 2**31:
        raise ValueError("tt_gemm: operand too large for 32-bit dims")
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.tt_gemm_launch(_CODE[dataflow], a.data_ptr(), b.data_ptr(),
                            c.data_ptr(), m, k, n, block_m, block_k, block_n,
                            stream)
    if rc != 0:
        raise RuntimeError(
            f"tt_gemm {dataflow} launch failed: "
            f"{lib.tt_gemm_error_string(rc).decode()} (M={m} K={k} N={n}, "
            f"blocks {block_m}x{block_k}x{block_n})")
    launches.COUNTS[_COUNTER[dataflow]] += 1
    return c


@functools.lru_cache(maxsize=None)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ws_gemm(a: torch.Tensor, b: torch.Tensor, grid: WSGrid) -> torch.Tensor:
    """One WS call on checked CUDA operands over ``grid``: the kernel and,
    when K is split, the fold (two CUDA launches, one count).  Tests pass
    their own grid here to show the result does not depend on it."""
    m, k = a.shape
    n = b.shape[1]
    if (grid.m, grid.k, grid.n) != (m, k, n):
        raise ValueError(f"tt_gemm WS: grid for {(grid.m, grid.k, grid.n)}, "
                         f"operands {(m, k, n)}")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return c
    if k == 0:
        return c.zero_()
    if max(m * k, k * n, grid.n_kblocks * m * n) >= 2**31:
        raise ValueError("tt_gemm: operand too large for 32-bit dims")
    if grid.smem_bytes > SMEM_LIMIT_BYTES:
        raise ValueError(f"tt_gemm WS: grid needs {grid.smem_bytes} B of "
                         "shared memory")
    work = (torch.empty(grid.workspace_elems, dtype=torch.float32,
                        device=a.device) if grid.split else None)
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.tt_gemm_ws_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if work is None else work.data_ptr(), m, k, n, grid.block_k,
        grid.block_n, grid.rows_per_thread, grid.row_groups,
        grid.mtiles_per_range, grid.kblocks_per_group, stream)
    if rc != 0:
        raise RuntimeError(
            f"tt_gemm WS launch failed: {lib.tt_gemm_error_string(rc).decode()}"
            f" (M={m} K={k} N={n}, {grid})")
    launches.COUNTS[_COUNTER["WS"]] += 1
    return c


def _lib() -> ctypes.CDLL:
    lib = _build.load("tt_gemm")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tt_gemm_launch.argtypes = [i, p, p, p, i, i, i, i, i, i, p]
        lib.tt_gemm_launch.restype = i
        lib.tt_gemm_ws_launch.argtypes = [p, p, p, p] + [i] * 9 + [p]
        lib.tt_gemm_ws_launch.restype = i
        lib.tt_gemm_error_string.argtypes = [i]
        lib.tt_gemm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# differentiable wrapper: the backward GEMMs run the same dataflow kernel
# ---------------------------------------------------------------------------

class TTGemmVJP(torch.autograd.Function):
    """``tt_gemm`` under autograd (port of the reference's ``tt_gemm_vjp``).

    The VJP of ``C = A @ B`` is two GEMMs, ``dA = dC @ B^T`` and
    ``dB = A^T @ dC``, issued through the same dataflow kernel with the
    block shapes permuted to follow the transposed operands, as the
    reference permutes them (``src/repro/kernels/tt_gemm.py:233-241``).
    """

    @staticmethod
    def forward(ctx, a, b, dataflow, block_m, block_k, block_n):
        ctx.save_for_backward(a, b)
        ctx.blocks = (dataflow, block_m, block_k, block_n)
        return tt_gemm(a, b, dataflow=dataflow, block_m=block_m,
                       block_k=block_k, block_n=block_n)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        dataflow, block_m, block_k, block_n = ctx.blocks
        g = g.contiguous()
        # dA (m, k) = g (m, n) @ B^T (n, k): the K axis is n -> block_n
        da = tt_gemm(g, b.t().contiguous(), dataflow=dataflow,
                     block_m=block_m, block_k=block_n, block_n=block_k)
        # dB (k, n) = A^T (k, m) @ g (m, n): the M axis is k -> block_k
        db = tt_gemm(a.t().contiguous(), g, dataflow=dataflow,
                     block_m=block_k, block_k=block_m, block_n=block_n)
        return da.to(a.dtype), db.to(b.dtype), None, None, None, None


def tt_gemm_vjp(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    dataflow: DataflowName = "OS",
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """:func:`tt_gemm` with a backward pass through the same kernel."""
    return TTGemmVJP.apply(a, b, dataflow, block_m, block_k, block_n)
