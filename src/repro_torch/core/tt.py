"""Tensor-train decomposition (TT-SVD, Oseledets 2011) and helpers.

Framework-neutral copy of ``src/repro/core/tt.py`` (the port never imports
the JAX package).

Used to (a) factorize pretrained dense weights into TT cores for the
paper's compression experiments (Table 1) and (b) report reconstruction
error / compression ratios.  Runs in numpy — decomposition is an offline,
host-side operation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class TTMatrix:
    """TT representation of a matrix W in R^{M x N} (paper eq. 2).

    ``cores[k]`` has shape (r_k, mode_k, r_{k+1}), where the first
    ``len(out_modes)`` cores carry output modes m_k and the rest carry
    input modes n_k.  Boundary ranks are 1.
    """

    cores: list[np.ndarray]
    out_modes: tuple[int, ...]
    in_modes: tuple[int, ...]

    @property
    def ranks(self) -> tuple[int, ...]:
        return tuple(c.shape[0] for c in self.cores) + (self.cores[-1].shape[2],)

    @property
    def n_params(self) -> int:
        return sum(c.size for c in self.cores)

    @property
    def dense_params(self) -> int:
        return math.prod(self.out_modes) * math.prod(self.in_modes)

    @property
    def compression_ratio(self) -> float:
        return self.dense_params / self.n_params

    def to_matrix(self) -> np.ndarray:
        """Reconstruct the dense (M, N) matrix."""
        full = self.cores[0]  # (1, m1, r1)
        for c in self.cores[1:]:
            full = np.tensordot(full, c, axes=([full.ndim - 1], [0]))
        full = full.reshape(self.out_modes + self.in_modes)
        m = math.prod(self.out_modes)
        n = math.prod(self.in_modes)
        return full.reshape(m, n)


def tt_svd(
    w: np.ndarray,
    out_modes: Sequence[int],
    in_modes: Sequence[int],
    max_rank: int,
    rel_eps: float = 0.0,
) -> TTMatrix:
    """TT-SVD of a matrix with mode order (m_1..m_d, n_1..n_e).

    Sequential truncated SVDs; each unfolding is truncated to
    ``max_rank`` and, if ``rel_eps`` > 0, to the rank capturing
    (1 - rel_eps^2 / (d-1)) of the Frobenius mass (Oseledets' bound).
    """
    out_modes = tuple(out_modes)
    in_modes = tuple(in_modes)
    m, n = w.shape
    if math.prod(out_modes) != m or math.prod(in_modes) != n:
        raise ValueError("mode products must match matrix dims")
    modes = out_modes + in_modes
    d = len(modes)
    tensor = w.reshape(modes)
    delta = (rel_eps / math.sqrt(max(d - 1, 1))) * np.linalg.norm(w) if rel_eps else 0.0

    cores: list[np.ndarray] = []
    rank = 1
    rest = tensor.reshape(rank * modes[0], -1)
    for k in range(d - 1):
        u, s, vt = np.linalg.svd(rest, full_matrices=False)
        if delta > 0:
            tail = np.sqrt(np.cumsum(s[::-1] ** 2))[::-1]
            keep = int(np.searchsorted(-tail, -delta) )
            keep = max(keep, 1)
        else:
            keep = len(s)
        r_new = min(max_rank, keep, len(s))
        cores.append(u[:, :r_new].reshape(rank, modes[k], r_new))
        rest = (np.diag(s[:r_new]) @ vt[:r_new]).reshape(r_new * modes[k + 1], -1)
        rank = r_new
    cores.append(rest.reshape(rank, modes[-1], 1))
    return TTMatrix(cores, out_modes, in_modes)


def tt_rand(
    rng: np.random.Generator,
    out_modes: Sequence[int],
    in_modes: Sequence[int],
    rank: int,
    stddev: float | None = None,
) -> TTMatrix:
    """Random TT cores whose contraction has approximately unit-variance
    columns scaled like a Glorot-initialised dense matrix.

    Each interior rank is min(rank, full_rank_at_cut).  Cores are i.i.d.
    normal with per-core variance chosen so the reconstructed matrix has
    stddev ~= sqrt(2 / (fan_in + fan_out)) (or the supplied ``stddev``).
    """
    out_modes = tuple(out_modes)
    in_modes = tuple(in_modes)
    modes = out_modes + in_modes
    d = len(modes)
    ranks = [1]
    left = 1
    right = math.prod(modes)
    for k in range(d - 1):
        left *= modes[k]
        right //= modes[k]
        ranks.append(min(rank, left, right))
    ranks.append(1)
    m = math.prod(out_modes)
    n = math.prod(in_modes)
    target = stddev if stddev is not None else math.sqrt(2.0 / (m + n))
    # product of d independent gaussians: var multiplies; contraction over
    # ranks sums r_k terms -> scale each core by (target^2 / prod r)^(1/2d)
    prod_ranks = math.prod(ranks[1:-1]) or 1
    per_core_std = (target**2 / prod_ranks) ** (1.0 / (2 * d))
    cores = [
        rng.normal(0.0, per_core_std, size=(ranks[k], modes[k], ranks[k + 1]))
        for k in range(d)
    ]
    return TTMatrix(cores, out_modes, in_modes)


def reconstruction_error(tt: TTMatrix, w: np.ndarray) -> float:
    """Relative Frobenius reconstruction error."""
    return float(np.linalg.norm(tt.to_matrix() - w) / np.linalg.norm(w))


def quantize_int8(x: np.ndarray) -> tuple[np.ndarray, float]:
    """Symmetric per-tensor INT8 quantization: returns (q, scale)."""
    scale = float(np.max(np.abs(x))) / 127.0 if x.size else 1.0
    scale = scale or 1.0
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize(q: np.ndarray, scale: float) -> np.ndarray:
    return q.astype(np.float32) * scale
