"""Dataflow-configurable GEMM (OS / WS / IS): CUDA kernel + plain version.

Port of ``src/repro/kernels/tt_gemm.py``.  The Pallas kernel picked its
dataflow through the grid order; the CUDA kernels (``csrc/tt_gemm.cu``)
keep what the dataflow names resident while the rest streams, over a grid
the host picks for the card:

  OS  (m-tile x n-tile) blocks chosen by :func:`os_grid`; each block's
      output tile stays in registers while A's and B's k-block tiles stream
      past it (``cp.async``), and every output is stored once;
  WS  (n-band x m-range x k-group) blocks chosen by :func:`ws_grid`; in
      each block the k-block's B tile stays resident while the A tiles of
      the m-range stream past it.  Split over K, every k-block's partial
      goes to a workspace and a second launch folds them in ascending
      order; unsplit, partial C folds in registers or round-trips through
      C once per k-fold;
  IS  (m-band x n-group) blocks chosen by :func:`is_grid`; each block
      stages its band of A once (across all of K where it fits shared
      memory) and keeps it while the B tiles of its n-tiles stream past
      it, each n-tile folded in registers.  A band too deep for shared
      memory stages per k-block, and a group of several n-tiles then folds
      its partials through C, the reference's ``o = o + part``.

At every decode shape of the plans IS runs OS's schedule under its own
name: the calls give fewer tiles than SMs, so :func:`is_grid` gives each
block one n-tile, and every tile fits shared memory, so both stage a
block's rows of A and its B rows across all of K in one pass
(:attr:`BandGrid.one_pass`).  IS's band reuse and its fold through C take
effect only past that.

Operands are float32 or bfloat16.  The kernels load fp32: the wrapper
widens bf16 operands with one ``.to(torch.float32)`` before the launch,
which is exact (every bf16 value, and every bf16 x bf16 product, is an
fp32 value), and casts the fp32 result once to ``out_dtype`` (default:
A's dtype), as the reference folds in fp32 and casts once.

Each output element sums its k-blocks in ascending order in fp32 (the
workspace keeps each k-block's partial apart, so a split changes no bit;
no atomics), so the three dataflows agree bit for bit at one ``block_k``
and a row never depends on M, on a grid or on the other rows of the
call.  Ragged dims are masked in the kernel instead of zero-padded.

What bounds the calls the plans make is not bytes or FMAs.  The decode
GEMMs (OS and IS, 4 tokens) move 1-45 KB each (~0.013 us at 3.35 TB/s):
the launch, the round trips to memory and the FMA chains set their time,
so the grids fill the card with small tiles and a block puts every copy
of a short K in flight before one wait.  WS at the train plans' weight
gradients (M,K,N = 2048,2048,16) is bound by the bytes of A (0.0051 ms
against 0.002 ms of FMAs), and before the split by its grid: one block per
n-band meant one block for the whole product.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import ClassVar, Iterator, Literal

import torch

from . import _build, launches

DataflowName = Literal["IS", "OS", "WS"]
DATAFLOWS = ("OS", "WS", "IS")

_CODE = {"OS": 0, "IS": 2}   # tt_gemm_launch's codes; WS has its own launcher
_COUNTER = {"OS": "tt_gemm_os", "WS": "tt_gemm_ws", "IS": "tt_gemm_is"}
_THREADS = 256
#: dynamic shared memory one Hopper block may use
SMEM_LIMIT_BYTES = 232_448
#: the register tile of every dataflow: up to this many rows x 4 columns
#: a thread
WS_TILE_ROWS = 4
#: the WS grid's m-tiles are not cut below this many rows
WS_MIN_TILE_ROWS = 4
#: an OS tile or IS band is not cut below this many rows
BAND_MIN_ROWS = 4
#: the widest n-tile of an OS or IS block (a grid choice: no bit depends
#: on it)
BAND_MAX_TILE_N = 128
#: an OS or IS n-tile is halved, down to BAND_MIN_TILE_N columns, while the
#: card is not full and a block would stage more than this many floats of
#: B; on an H100 a block's staging, not its FMAs, sets a decode GEMM's time
BAND_B_FLOATS = 512
BAND_MIN_TILE_N = 8
#: operand dtypes the kernels take (bf16 is widened to fp32 before launch)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def widen(name: str, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """fp32 copies of bf16 operands (fp32 ones pass through), for a kernel
    that loads fp32; any other dtype raises ``TypeError``."""
    bad = [t.dtype for t in tensors if t.dtype not in KERNEL_DTYPES]
    if bad:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 operands, "
                        f"got {bad}")
    return [t.to(torch.float32) for t in tensors]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _kpad(cols: int) -> int:
    """``cols`` rounded up to a multiple of 4 (``csrc/gemm_tile.cuh``:
    kpad): the depth a k-block stages at, zero-filled past ``block_k``."""
    return _cdiv(cols, 4) * 4


def _pad_ld(cols: int) -> int:
    """Row stride of a staged A tile ``cols`` wide (``csrc/tt_gemm.cu``:
    pad_ld): rounded up to 4, plus 4."""
    return _kpad(cols) + 4


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
        lda = _pad_ld(self.block_k)
        ldb = 4 * _cdiv(self.block_n, 4)
        return 4 * (self.tile_m * lda + _kpad(self.block_k) * ldb)

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
    lda = _pad_ld(block_k)
    b_floats = _kpad(block_k) * 4 * n_tx
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


@dataclasses.dataclass(frozen=True)
class BandGrid:
    """How one OS or IS launch covers ``(M, K, N)``: blocks over (m-band x
    n-group), each a band of :attr:`tile_m` rows and a group of up to
    ``ntiles_per_group`` n-tiles of ``tile_n`` columns, each thread a
    register tile of ``rows_per_thread`` rows (strided by ``row_groups``)
    x 4 columns.  ``a_whole`` stages the band of A across all of K once;
    ``one_pass`` stages every tile of a block before one wait (each n-tile
    then folds in registers over one loop across K), else the block's
    (n-tile, k-block) tiles stream through a two-stage ring.  Both need a
    ``block_k`` that is a multiple of 4.  The kernel's block
    (``blockIdx.x``, ``blockIdx.y``) = (m-band, n-group) does what
    ``block_steps(m-band * n_ngroups + n-group)`` lists, in that order."""

    m: int
    k: int
    n: int
    block_k: int
    tile_n: int
    rows_per_thread: int
    row_groups: int
    ntiles_per_group: int
    a_whole: bool
    one_pass: bool

    dataflow: ClassVar[str] = ""

    def __post_init__(self):
        if (self.a_whole or self.one_pass) and self.block_k % 4:
            raise ValueError(f"tt_gemm {self.dataflow}: a whole band of A or "
                             "one pass needs block_k a multiple of 4")
        if self.one_pass and not (self.a_whole or self.ntiles_per_group == 1):
            raise ValueError(f"tt_gemm {self.dataflow}: one pass folds in "
                             "registers: a whole band of A or one n-tile a "
                             "block")

    @property
    def tile_m(self) -> int:
        """Rows of one band (the block's rows)."""
        return self.rows_per_thread * self.row_groups

    @property
    def n_kblocks(self) -> int:
        return _cdiv(self.k, self.block_k)

    @property
    def n_ntiles(self) -> int:
        return _cdiv(self.n, self.tile_n)

    @property
    def n_mbands(self) -> int:
        return _cdiv(self.m, self.tile_m)

    @property
    def n_ngroups(self) -> int:
        return _cdiv(self.n_ntiles, self.ntiles_per_group)

    @property
    def blocks(self) -> int:
        return self.n_mbands * self.n_ngroups

    @property
    def smem_bytes(self) -> int:
        ldb = 4 * _cdiv(self.tile_n, 4)
        depth = self.n_kblocks * self.block_k
        if self.a_whole or self.one_pass:
            a = self.tile_m * _pad_ld(depth)
        else:
            a = 2 * self.tile_m * _pad_ld(self.block_k)
        if self.one_pass:
            b = self.ntiles_per_group * depth * ldb
        else:
            b = 2 * _kpad(self.block_k) * ldb
        return 4 * (a + b)

    def block_steps(self, b: int) -> list[tuple[range, range, int, bool]]:
        """(rows, columns, k-block, through C) of each tile block ``b``
        computes, in the kernel's order: n-tile by n-tile, each n-tile's
        k-blocks ascending and folded in registers, when the A band is
        whole or the group has one n-tile; else k-block by k-block, each
        partial folded through C."""
        mb, ng = divmod(b, self.n_ngroups)
        rows = range(mb * self.tile_m, min(self.m, (mb + 1) * self.tile_m))
        j0 = ng * self.ntiles_per_group
        n_j = min(self.ntiles_per_group, self.n_ntiles - j0)
        via_c = not self.a_whole and n_j > 1
        kbs = range(self.n_kblocks)
        order = ([(j, kb) for kb in kbs for j in range(n_j)] if via_c
                 else [(j, kb) for j in range(n_j) for kb in kbs])
        return [(rows, range((j0 + j) * self.tile_n,
                             min(self.n, (j0 + j + 1) * self.tile_n)), kb, via_c)
                for j, kb in order]


@dataclasses.dataclass(frozen=True)
class OSGrid(BandGrid):
    """An OS launch: one n-tile a block, A and B both streamed per
    k-block, the output tile resident in registers."""

    dataflow: ClassVar[str] = "OS"

    def __post_init__(self):
        super().__post_init__()
        if self.ntiles_per_group != 1 or self.a_whole:
            raise ValueError("an OS block owns one output tile and streams A")


@dataclasses.dataclass(frozen=True)
class ISGrid(BandGrid):
    """An IS launch: the A band resident while B streams."""

    dataflow: ClassVar[str] = "IS"


def _band_grid(cls, m: int, k: int, n: int, block_m: int, block_k: int,
               block_n: int, n_sm: int) -> BandGrid:
    _check_blocks(cls.dataflow, block_m, block_k, block_n)
    m1, k1, n1 = max(m, 1), max(k, 1), max(n, 1)
    tile_n = min(block_n, BAND_MAX_TILE_N, 4 * _cdiv(n1, 4))
    ldb = 4 * _cdiv(tile_n, 4)
    ty_max = _THREADS // (ldb // 4)
    max_rows = ((SMEM_LIMIT_BYTES // 4 - 2 * _kpad(block_k) * ldb)
                // (2 * _pad_ld(block_k)))
    if max_rows < 1:
        raise ValueError(
            f"tt_gemm {cls.dataflow}: block_k {block_k} is too deep for two "
            f"staged tiles in the {SMEM_LIMIT_BYTES} B of shared memory a "
            "block has")

    def tile(rows: int) -> tuple[int, int]:
        rows = max(1, min(rows, WS_TILE_ROWS * ty_max, max_rows))
        tr = _cdiv(rows, ty_max)
        return tr, rows // tr

    n_nt, n_kb = _cdiv(n1, tile_n), _cdiv(k1, block_k)
    tr, ty = tile(min(block_m, m1))
    if _cdiv(m1, tr * ty) * n_nt < n_sm:
        wanted = _cdiv(n_sm, n_nt)
        tr, ty = tile(max(min(tr * ty, BAND_MIN_ROWS), m1 // wanted))
    tm = tr * ty
    # then narrower n-tiles, while the card is not full and a block would
    # stage more than BAND_B_FLOATS of B (its K rows x tile_n columns)
    while (_cdiv(m1, tm) * _cdiv(n1, tile_n) < n_sm and tile_n > BAND_MIN_TILE_N
           and n_kb * block_k * tile_n > BAND_B_FLOATS):
        tile_n = max(BAND_MIN_TILE_N, 4 * _cdiv(tile_n, 8))
    ldb = 4 * _cdiv(tile_n, 4)
    n_nt = _cdiv(n1, tile_n)
    group, a_whole = 1, False
    if cls is ISGrid:
        group = max(1, min(n_nt, _cdiv(m1, tm) * n_nt // n_sm))
        a_whole = block_k % 4 == 0 and 4 * (
            tm * _pad_ld(n_kb * block_k) + 2 * block_k * ldb) <= SMEM_LIMIT_BYTES
    if block_k % 4 == 0 and (a_whole or group == 1):
        one = cls(m, k, n, block_k, tile_n, tr, ty, group, a_whole, True)
        if one.smem_bytes <= SMEM_LIMIT_BYTES:
            return one
    return cls(m, k, n, block_k, tile_n, tr, ty, group, a_whole, False)


@functools.lru_cache(maxsize=1024)
def os_grid(m: int, k: int, n: int, *, block_m: int, block_k: int,
            block_n: int, n_sm: int = 132) -> OSGrid:
    """The OS kernel's grid for one call, aiming at ``n_sm`` blocks.

    1. The output tile: ``min(block_n, BAND_MAX_TILE_N, N)`` columns (to a
       multiple of 4) by up to ``min(block_m, M)`` rows, as ``row_groups``
       threads per 4-column group (256 threads over the groups) times up
       to :data:`WS_TILE_ROWS` rows each, cut to fit two staged k-blocks
       in shared memory.
    2. While ``m-tiles x n-tiles`` stays under ``n_sm``, the tile shrinks
       to ``M // wanted`` rows (not below :data:`BAND_MIN_ROWS`), so that
       M alone could fill the card; then, while it still does not and a
       block would stage more than :data:`BAND_B_FLOATS` of B, the
       n-tile halves (not below :data:`BAND_MIN_TILE_N` columns).
    3. ``one_pass`` where a block's rows of A and B across all of K fit
       shared memory (and ``block_k`` is a multiple of 4); else the
       k-blocks stream through a two-stage ring.

    At the decode shapes on 132 SMs: 64,128,16 (blocks 64,128,16) -> 32
    tiles of 4 rows x 8 columns, 1 k-block; 16,192,4 (16,64,8) -> 4 tiles
    of 4 x 4, its 3 k-blocks in one pass; 128,8,8 (32,8,8) -> 32 tiles.
    ``block_k`` alone fixes the bits; the grid changes none.
    """
    return _band_grid(OSGrid, m, k, n, block_m, block_k, block_n, n_sm)


@functools.lru_cache(maxsize=1024)
def is_grid(m: int, k: int, n: int, *, block_m: int, block_k: int,
            block_n: int, n_sm: int = 132) -> ISGrid:
    """The IS kernel's grid for one call: the band as :func:`os_grid` cuts
    its tile (aiming at ``n_sm`` m-bands x n-tiles), then n-groups of
    ``m-bands x n-tiles // n_sm`` n-tiles where there are more tiles than
    SMs.  The band of A is staged whole (all of K) where it and two B
    tiles fit shared memory, else one k-block at a time; ``one_pass`` as
    :func:`os_grid` sets it, for a group of one n-tile or a whole band.

    At the decode shapes on 132 SMs: 32,16,256 (blocks 32,16,128) -> 8
    bands of 4 rows x 8 n-tiles of 32 = 64 blocks; 16,192,4 (16,16,8) -> 4
    bands, each with its 12 k-blocks in one pass; 16,64,48 (16,16,64) -> 4
    bands x 6 n-tiles of 8.  Every decode shape gives fewer tiles than
    SMs, so each group is one n-tile: the launch runs OS's schedule.
    """
    return _band_grid(ISGrid, m, k, n, block_m, block_k, block_n, n_sm)


def run_band_grid_plain(a: torch.Tensor, b: torch.Tensor,
                        grid: BandGrid) -> torch.Tensor:
    """The CPU mirror of an OS or IS launch over ``grid``: every block
    folds the k-block partials of its tiles into C in the kernel's order
    (first k-block stored, later ones added).  Each partial is the plain
    version's (one product over all rows), so the mirror checks the
    grid's cover and the fold order, not the FMAs."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    bk = grid.block_k
    parts = [a32[:, k0:k0 + bk] @ b32[k0:k0 + bk] for k0 in range(0, grid.k, bk)]
    c = torch.full((grid.m, grid.n), float("nan"))
    for blk in range(grid.blocks):
        for rows, cols, kb, _ in grid.block_steps(blk):
            r, q = slice(rows.start, rows.stop), slice(cols.start, cols.stop)
            c[r, q] = parts[kb][r, q] if kb == 0 else c[r, q] + parts[kb][r, q]
    return c


def tt_gemm_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    dataflow: DataflowName = "OS",
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: the kernel's fp32 k-fold accumulation.

    ``C = p_0 + p_1 + ...`` with ``p_i`` the product over the i-th k-block,
    the grouping every dataflow of the kernel uses.  ``block_m``/``block_n``
    do not change the result; they are checked so both versions take the
    same arguments.  The fp32 result is cast once to ``out_dtype``
    (default: A's dtype).
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
    return c.to(out_dtype or a.dtype)


def tt_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    dataflow: DataflowName = "OS",
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``a @ b`` through the dataflow kernel (fp32 or bf16 row-major
    operands, fp32 fold, one cast to ``out_dtype``, default A's dtype).

    CPU tensors take :func:`tt_gemm_plain`; CUDA tensors launch the kernel
    or raise.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tt_gemm_plain(a, b, dataflow=dataflow, block_m=block_m,
                             block_k=block_k, block_n=block_n,
                             out_dtype=out_dtype)
    _check_blocks(dataflow, block_m, block_k, block_n)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"tt_gemm: operands on {a.device} and {b.device}; need both on "
            "one CUDA device (or both on the CPU)")
    out_dtype = out_dtype or a.dtype
    a32, b32 = widen("tt_gemm", a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tt_gemm: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("tt_gemm: operands must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    blocks = dict(block_m=block_m, block_k=block_k, block_n=block_n,
                  n_sm=_n_sm(a.device))
    if dataflow == "WS":
        c = _ws_gemm(a32, b32, ws_grid(m, k, n, **blocks))
    else:
        grid = os_grid if dataflow == "OS" else is_grid
        c = _band_gemm(a32, b32, grid(m, k, n, **blocks))
    return c.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _band_gemm(a: torch.Tensor, b: torch.Tensor, grid: BandGrid) -> torch.Tensor:
    """One OS or IS call on checked CUDA operands over ``grid`` (one CUDA
    launch, one count).  Tests pass their own grid here to show the result
    does not depend on it."""
    m, k = a.shape
    n = b.shape[1]
    if (grid.m, grid.k, grid.n) != (m, k, n):
        raise ValueError(f"tt_gemm {grid.dataflow}: grid for "
                         f"{(grid.m, grid.k, grid.n)}, operands {(m, k, n)}")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return c
    if k == 0:
        return c.zero_()
    if max(m * k, k * n, m * n) >= 2**31:
        raise ValueError("tt_gemm: operand too large for 32-bit dims")
    if grid.smem_bytes > SMEM_LIMIT_BYTES:
        raise ValueError(f"tt_gemm {grid.dataflow}: grid needs "
                         f"{grid.smem_bytes} B of shared memory")
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.tt_gemm_launch(
        _CODE[grid.dataflow], a.data_ptr(), b.data_ptr(), c.data_ptr(), m, k,
        n, grid.block_k, grid.tile_n, grid.rows_per_thread, grid.row_groups,
        grid.ntiles_per_group, int(grid.a_whole), int(grid.one_pass), stream)
    if rc != 0:
        raise RuntimeError(
            f"tt_gemm {grid.dataflow} launch failed: "
            f"{lib.tt_gemm_error_string(rc).decode()} (M={m} K={k} N={n}, "
            f"{grid})")
    launches.COUNTS[_COUNTER[grid.dataflow]] += 1
    return c


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
        lib.tt_gemm_launch.argtypes = [i, p, p, p] + [i] * 10 + [p]
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
    def forward(ctx, a, b, dataflow, block_m, block_k, block_n, out_dtype):
        ctx.save_for_backward(a, b)
        ctx.blocks = (dataflow, block_m, block_k, block_n)
        return tt_gemm(a, b, dataflow=dataflow, block_m=block_m,
                       block_k=block_k, block_n=block_n, out_dtype=out_dtype)

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
        return da.to(a.dtype), db.to(b.dtype), None, None, None, None, None


def tt_gemm_vjp(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    dataflow: DataflowName = "OS",
    block_m: int = 128,
    block_k: int = 128,
    block_n: int = 128,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """:func:`tt_gemm` with a backward pass through the same kernel."""
    return TTGemmVJP.apply(a, b, dataflow, block_m, block_k, block_n,
                           out_dtype)
