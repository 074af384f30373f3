"""Dataflow-configurable GEMM (OS / WS / IS): CUDA kernel + plain version.

Port of ``src/repro/kernels/tt_gemm.py``.  The Pallas kernel picked its
dataflow through the grid order; the CUDA kernel (``csrc/tt_gemm.cu``)
picks which operand tile stays resident in shared memory:

  OS  one block per output tile, k loop inside, fp32 accumulator in
      registers, C written once;
  WS  one block per n-band, B tile resident while A streams, partial C
      read-add-written in fp32 device memory once per k-fold;
  IS  one block per m-band, A tile resident while B streams, same fp32
      partial-sum contract as WS.

Each output element sums its k-blocks in ascending order in fp32, with no
atomics and no split-K, so the three dataflows agree bit for bit at one
``block_k`` and a row never depends on M or on the other rows of the call.
Ragged dims are masked in the kernel instead of zero-padded.
"""

from __future__ import annotations

import ctypes
from typing import Literal

import torch

from . import _build, launches

DataflowName = Literal["IS", "OS", "WS"]
DATAFLOWS = ("OS", "WS", "IS")

_CODE = {"OS": 0, "WS": 1, "IS": 2}
_COUNTER = {"OS": "tt_gemm_os", "WS": "tt_gemm_ws", "IS": "tt_gemm_is"}
_THREADS = 256
_MAX_PER_THREAD = 64
#: dynamic shared memory one Hopper block may use
SMEM_LIMIT_BYTES = 232_448


def _check_blocks(dataflow: str, block_m: int, block_k: int,
                  block_n: int) -> None:
    if dataflow not in _CODE:
        raise ValueError(f"unknown dataflow {dataflow!r}")
    for name, v in (("block_m", block_m), ("block_k", block_k),
                    ("block_n", block_n)):
        if not isinstance(v, int) or v < 1:
            raise ValueError(f"{name} must be a positive int, got {v!r}")


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


def _lib() -> ctypes.CDLL:
    lib = _build.load("tt_gemm")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tt_gemm_launch.argtypes = [i, p, p, p, i, i, i, i, i, i, p]
        lib.tt_gemm_launch.restype = i
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
