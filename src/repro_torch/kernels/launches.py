"""Launch counts of the CUDA kernels.

Each kernel wrapper adds one to its count where it launches its kernel on
a CUDA tensor, and nowhere else (the plain CPU versions do not count), so a
run can show that a path really went through the kernels.
"""

from __future__ import annotations

#: kernel name -> launches since the last :func:`reset`
COUNTS: dict[str, int] = {
    "streaming_tt": 0,
    "tt_gemm_os": 0,
    "tt_gemm_ws": 0,
    "tt_gemm_is": 0,
}


def reset() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def snapshot() -> dict[str, int]:
    return dict(COUNTS)
