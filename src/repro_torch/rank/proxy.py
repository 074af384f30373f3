"""Accuracy proxy for rank candidates: TT-SVD reconstruction error.

Copy of ``src/repro/rank/proxy.py`` (NumPy), except the calibration
forward, which runs the port's model (PyTorch) instead of the reference's.

Scoring a rank candidate by actually fine-tuning the model is far too
expensive inside a DSE loop; the standard proxy (e.g. the paper's Table
1 compression study) is the relative Frobenius error of the TT-SVD of
the layer's weight matrix — a deterministic, training-free stand-in
that orders candidates the same way post-compression accuracy does for
moderate compression levels.

The repo has no pretrained checkpoints, so each family is scored
against a deterministic *synthetic reference weight* with a realistic
spectrum: an orthogonal low-rank core with power-law decaying singular
values plus a small isotropic noise floor, seeded from the family name
and shape.  The proxy is then exactly the quantity a checkpointed run
would compute — swap :func:`reference_weight` for a loader and nothing
downstream changes.

Model-level aggregation weights each family by its dense parameter
count times its instance count — optionally rescaled by a measured
activation RMS (``activation_calibration``), so families whose inputs
run hot count for more.
"""

from __future__ import annotations

import functools
import hashlib
import math
from typing import Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.tt import reconstruction_error, tt_svd

from .space import FamilyFactorization, RankCandidate

#: rank of the reference weight's structured core
REFERENCE_COMPONENTS = 64

#: power-law decay exponent of the reference singular values
SPECTRUM_DECAY = 1.2

#: relative Frobenius mass of the isotropic noise floor (keeps every
#: truncation error strictly positive — no free-lunch candidates)
NOISE_FLOOR = 1e-3


def _seed(name: str, d_out: int, d_in: int) -> int:
    h = hashlib.sha1(f"{name}:{d_out}x{d_in}".encode()).digest()
    return int.from_bytes(h[:8], "big")


@functools.lru_cache(maxsize=16)
def reference_weight(name: str, d_out: int, d_in: int) -> np.ndarray:
    """Deterministic synthetic (d_out, d_in) reference weight.

    ``U diag(s) V^T + noise`` with orthonormal U/V, ``s_i ~ i^-1.2``
    over min(64, dims) components, and an isotropic noise floor at 1e-3
    of the structured Frobenius mass.  Same (name, shape) -> bit-equal
    array in every process, so proxies are reproducible across runs.
    """
    rng = np.random.default_rng(_seed(name, d_out, d_in))
    q = min(REFERENCE_COMPONENTS, d_out, d_in)
    u, _ = np.linalg.qr(
        rng.standard_normal((d_out, q)).astype(np.float32))
    v, _ = np.linalg.qr(
        rng.standard_normal((d_in, q)).astype(np.float32))
    s = np.arange(1, q + 1, dtype=np.float32) ** np.float32(-SPECTRUM_DECAY)
    w = (u * s) @ v.T
    g = rng.standard_normal((d_out, d_in)).astype(np.float32)
    g *= NOISE_FLOOR * np.linalg.norm(s) / np.linalg.norm(g)
    w += g
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=4096)
def reconstruction_proxy(
    name: str,
    d_out: int,
    d_in: int,
    out_modes: tuple[int, ...],
    in_modes: tuple[int, ...],
    rank: int,
) -> float:
    """Relative Frobenius error of the TT-SVD of the family's reference
    weight under (out_modes, in_modes) at ``rank``.  The TT-SVD clips
    each cut to its full-rank bound, so the realized interior ranks
    equal :func:`repro_torch.rank.space.clip_ranks` of the same grid point."""
    w = reference_weight(name, d_out, d_in)
    tt = tt_svd(w, out_modes, in_modes, max_rank=rank)
    return reconstruction_error(tt, w)


def family_proxy(f: FamilyFactorization) -> float:
    return reconstruction_proxy(f.name, f.d_out, f.d_in,
                                f.out_modes, f.in_modes, max(f.ranks))


def candidate_proxy(
    candidate: RankCandidate,
    weights: Optional[Mapping[str, float]] = None,
) -> float:
    """Model-level accuracy proxy: dense-parameter (x instance
    [x activation-RMS]) weighted mean of the per-family errors."""
    total_w = 0.0
    total = 0.0
    for f in candidate.families:
        w = float(f.dense_params) * f.instances
        if weights is not None:
            w *= float(weights.get(f.name, 1.0))
        total_w += w
        total += w * family_proxy(f)
    return total / total_w if total_w > 0 else 0.0


def activation_calibration(
    cfg,
    *,
    batch: int = 2,
    seq: int = 16,
    seed: int = 0,
    generator=None,
    device="cuda",
) -> dict[str, float]:
    """Per-family input-RMS weights from one calibration forward.

    Runs a random-token prefill of ``cfg`` on ``device`` (``cuda`` unless
    the caller asks for the CPU) through ``ModelAPI.prefill``, with
    whatever plan is installed, and returns ``{family name: mean input
    RMS}`` for use as :func:`candidate_proxy` weights.  Weights and tokens
    come from ``generator`` (a ``torch.Generator``), else from ``seed``,
    drawn on the CPU, so one seed gives the same inputs on every device.
    Programmatic/test use only — the CLI's proxy stays unweighted so
    reports are model-free deterministic.  The reference's eager switches
    (``scan_layers=False, remat="none"``) are kept: the port's layers run
    eagerly either way.
    """
    import dataclasses as _dc

    import torch

    from repro_torch.models import api
    from repro_torch.nn import capture_activation_rms

    eager_cfg = _dc.replace(cfg, scan_layers=False, remat="none")
    m = api(eager_cfg, device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    params = m.init_params(generator)
    tokens = torch.randint(0, eager_cfg.vocab, (batch, seq),
                           generator=generator).to(device)
    with torch.no_grad(), capture_activation_rms() as rms:
        m.prefill(params, {"tokens": tokens}, seq)
    return dict(rms)


def frontier_points(
    evals: Sequence[tuple[float, float]],
) -> list[int]:
    """Indices of the (latency, proxy) Pareto front (both minimised)."""
    from repro_torch.core.dse import pareto_front

    return pareto_front(list(evals))
