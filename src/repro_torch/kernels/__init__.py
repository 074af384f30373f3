"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``streaming_tt`` (K1) and ``tt_gemm`` (K2-K4, one wrapper with the OS, WS
and IS dataflows) replace the Pallas kernels of ``src/repro/kernels/``.
The CUDA sources live in ``csrc/`` and build on first use
(:mod:`._build`); ``launches.COUNTS`` counts each kernel's launches.
"""

from . import launches, ops, ref

__all__ = ["launches", "ops", "ref"]
