"""Learned cost-correction: per (shape-bucket, dataflow) measured ratios.

Port of ``src/repro/tune/correction.py`` (no JAX), copied.

PR 5's calibration compressed every measurement into one geometric-mean
measured/analytic ratio per dataflow.  That is the right first-order
term, but the disagreement between the analytic cost model and the
machine is *shape-dependent* too: small GEMMs pay fixed launch/dispatch
overheads the closed-form model under-weights, huge GEMMs approach the
roofline the model idealizes.  This module fits the second-order term
from the persistent tuning cache — free training data every
``repro_torch.tune`` run accumulates:

- :func:`shape_bucket` quantizes a GEMM's MAC volume ``M*K*N`` onto a
  coarse log2 grid (bucket = ``floor(log2(MKN) / 2)`` — one bucket per
  4x volume step, wide enough that a handful of measured shapes lands
  multiple samples per bucket);
- :func:`fit_cost_correction` walks the cache's GEMM entries (filtered
  to one device/interpret mode so machines never mix) and takes the
  geometric mean of measured/analytic ratios per (bucket, dataflow), at
  the compiler's heuristic-blocks operating point;
- :class:`CostCorrection` answers ``scale(M, K, N, dataflow)`` with a
  fallback chain: exact bucket (when it holds >= ``min_samples``
  measurements) -> the per-dataflow geomean (PR 5's flat model) -> 1.0.

``dse.apply_calibration`` accepts the fitted model anywhere it accepted
the flat per-dataflow mapping, including the architecture co-search —
the correction is a property of the cost model vs the machine, so the
same scales rescale every candidate's analytic table.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

from repro_torch.core.simulator import ALL_DATAFLOWS, Dataflow
from repro_torch.hw import HardwareConfig

from .cache import TuningCache, variant_key

#: log2 width of one shape bucket: volumes within a 2**2 = 4x band share
#: a bucket, so a model's handful of distinct GEMM shapes still lands
#: multiple samples per bucket instead of one singleton each
SHAPE_BUCKET_LOG2_WIDTH = 2

#: minimum measurements a bucket needs before its own geomean is trusted
#: over the per-dataflow fallback (a single sample is indistinguishable
#: from noise)
MIN_BUCKET_SAMPLES = 2


def shape_bucket(M: int, K: int, N: int) -> int:
    """Quantize a GEMM's MAC volume onto the coarse log2 grid."""
    volume = int(M) * int(K) * int(N)
    if volume <= 0:
        raise ValueError(f"GEMM volume must be positive, got {volume}")
    return int(math.floor(math.log2(volume) / SHAPE_BUCKET_LOG2_WIDTH))


def _df_value(dataflow) -> str:
    return dataflow.value if isinstance(dataflow, Dataflow) else str(dataflow)


@dataclasses.dataclass(frozen=True)
class CostCorrection:
    """Fitted measured/analytic rescale model (see module docstring).

    ``bucket_scales`` maps ``(shape_bucket, dataflow value)`` to the
    bucket's geomean ratio — only buckets with >= ``min_samples``
    measurements are present.  ``dataflow_scales`` is the flat fallback
    (PR 5's calibration, fit from the same entries).
    """

    bucket_scales: Mapping[tuple[int, str], float]
    dataflow_scales: Mapping[str, float]
    bucket_samples: Mapping[tuple[int, str], int]
    device_kind: str = ""
    interpret: Optional[bool] = None
    n_ratios: int = 0
    min_samples: int = MIN_BUCKET_SAMPLES

    def scale(self, M: int, K: int, N: int, dataflow) -> float:
        """Rescale factor for one GEMM: bucket -> dataflow geomean -> 1."""
        d = _df_value(dataflow)
        s = self.bucket_scales.get((shape_bucket(M, K, N), d))
        if s is not None:
            return s
        return self.dataflow_scales.get(d, 1.0)

    def describe(self) -> dict:
        """JSON-friendly summary for the DSE report's ``tune`` section."""
        return {
            "model": "shape-bucket-geomean",
            "bucket_log2_width": SHAPE_BUCKET_LOG2_WIDTH,
            "min_samples": self.min_samples,
            "n_ratios": self.n_ratios,
            "n_buckets": len(self.bucket_scales),
            "device_kind": self.device_kind,
            "interpret": self.interpret,
            "dataflow_scales": {d: self.dataflow_scales[d]
                                for d in sorted(self.dataflow_scales)},
            "bucket_scales": {
                f"b{b}:{d}": self.bucket_scales[(b, d)]
                for (b, d) in sorted(self.bucket_scales)
            },
        }


def fit_cost_correction(
    cache: TuningCache,
    hw: HardwareConfig,
    *,
    device_kind: Optional[str] = None,
    interpret: Optional[bool] = None,
    shapes: Optional[Sequence[tuple[int, int, int]]] = None,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
    min_samples: int = MIN_BUCKET_SAMPLES,
) -> CostCorrection:
    """Fit a :class:`CostCorrection` from the persistent tuning cache.

    Walks every GEMM entry matching ``device_kind`` / ``interpret``
    (both default to "any"), reads the measurement at the compiler's
    heuristic-blocks operating point — the tiling the analytic argmin
    would deploy, so ratios compare like with like; sweep-only variants
    are ignored — and accumulates log ratios against the closed-form
    prediction for ``hw``.  ``shapes`` optionally restricts the fit to a
    fixed shape set: ``repro_torch.dse --tune`` passes its calibration work
    items so a warm cache holding extra sweep entries (e.g. from a prior
    ``tilings="measured"`` compile) still fits the identical model —
    bit-identical re-emission is CI-asserted.
    """
    from .autotune import analytic_gemm_seconds, heuristic_blocks

    shape_set = ({(int(M), int(K), int(N)) for (M, K, N) in shapes}
                 if shapes is not None else None)
    df_values = {_df_value(d) for d in dataflows}
    bucket_logs: dict[tuple[int, str], list[float]] = {}
    df_logs: dict[str, list[float]] = {}
    for key in sorted(cache.entries):
        e = cache.entries[key]
        if e.kind != "gemm":
            continue
        if device_kind is not None and e.device_kind != device_kind:
            continue
        if interpret is not None and e.interpret != interpret:
            continue
        d = str(e.problem.get("dataflow", ""))
        if d not in df_values:
            continue
        M, K, N = (int(e.problem["M"]), int(e.problem["K"]),
                   int(e.problem["N"]))
        if shape_set is not None and (M, K, N) not in shape_set:
            continue
        measured = e.measured_s.get(variant_key(heuristic_blocks(M, K, N)))
        if measured is None or measured <= 0:
            continue
        analytic = analytic_gemm_seconds(M, K, N, d, hw)
        if analytic <= 0:
            continue
        lr = math.log(measured / analytic)
        bucket_logs.setdefault((shape_bucket(M, K, N), d), []).append(lr)
        df_logs.setdefault(d, []).append(lr)

    bucket_scales = {bd: math.exp(sum(ls) / len(ls))
                     for bd, ls in bucket_logs.items()
                     if len(ls) >= min_samples}
    dataflow_scales = {d: math.exp(sum(ls) / len(ls))
                       for d, ls in df_logs.items()}
    return CostCorrection(
        bucket_scales=bucket_scales,
        dataflow_scales=dataflow_scales,
        bucket_samples={bd: len(ls) for bd, ls in bucket_logs.items()},
        device_kind=device_kind or "",
        interpret=interpret,
        n_ratios=sum(len(ls) for ls in df_logs.values()),
        min_samples=min_samples,
    )
