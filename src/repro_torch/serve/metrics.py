"""Serving metrics: throughput + per-request latency percentiles.

Framework-neutral copy of ``src/repro/serve/metrics.py`` (the port never
imports the JAX package).
"""

from __future__ import annotations

import math
from typing import Sequence

from .scheduler import ServeResult


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = max(0, math.ceil(q / 100.0 * len(s)) - 1)
    return float(s[k])


def summarize(result: ServeResult) -> dict:
    """Flatten a :class:`ServeResult` into the BENCH/CI metric row.

    ``gen_tok_s`` counts generated tokens only (decode-weighted — the
    sustained-load number the throughput objective optimizes);
    ``latency_*`` is ready-to-done per request, ``ttft_*`` ready-to-
    first-token, both in milliseconds.
    """
    comps = result.completions
    gen = sum(len(c.tokens) for c in comps)
    total = sum(c.prompt_len + len(c.tokens) for c in comps)
    lat_ms = [(c.t_done - c.t_ready) * 1e3 for c in comps]
    ttft_ms = [(c.t_first - c.t_ready) * 1e3 for c in comps]
    wall = result.wall_s
    return {
        "n_requests": len(comps),
        "steps": result.steps,
        "n_slots": result.n_slots,
        "wall_s": wall,
        "generated_tokens": gen,
        "total_tokens": total,
        "gen_tok_s": gen / wall if wall > 0 else 0.0,
        "total_tok_s": total / wall if wall > 0 else 0.0,
        "mean_occupancy": result.occupancy,
        "ttft_p50_ms": percentile(ttft_ms, 50),
        "ttft_p95_ms": percentile(ttft_ms, 95),
        "latency_p50_ms": percentile(lat_ms, 50),
        "latency_p95_ms": percentile(lat_ms, 95),
    }
