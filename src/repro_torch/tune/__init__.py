"""Empirical autotuning: close the loop from analytic DSE to measured time.

Port of ``src/repro/tune/`` (PyTorch, no JAX).  The analytic cost model
ranks configurations; this subsystem *measures* them — real CUDA kernel
variants (K1-K5), on the card serving traffic, by CUDA-graph replay —
and feeds the measurements back into the two consumers:

- **plan compilation**: ``compile_plan(..., tilings="measured",
  tuner=...)`` replaces the heuristic per-layer tilings with the
  measured argmin per unique (GEMM shape, dataflow) / streaming problem;
- **the DSE itself**: ``global_search(..., calibration=...)`` rescales
  the analytic table per dataflow by measured/analytic ratios, so the
  argmin can genuinely change when measurements disagree with the model.

Measurements live in a persistent, canonical-JSON cache keyed by
(problem, backend, device kind, interpret flag) — a warm cache replays
with zero measurements, making tuned plans reproducible bit-for-bit.

CLI: ``python -m repro_torch.tune`` (warm the cache), ``python -m
repro_torch.dse --tune {off,cache,measure}`` (calibrated search + measured
plan tilings); both measure on the card unless ``--device cpu`` is given.
"""

from .autotune import (
    TUNE_MODES,
    Autotuner,
    analytic_gemm_seconds,
    gemm_work_items,
    heuristic_blocks,
    measured_calibration,
)
from .cache import (
    CACHE_FORMAT,
    CACHE_VERSION,
    DEFAULT_CACHE_PATH,
    KERNEL_MODULES,
    TuningCache,
    TuningEntry,
    entry_fingerprint,
    entry_shards,
    kernel_fingerprint,
    kernel_source_paths,
    merge_caches,
    parse_variant,
    variant_key,
)
from .correction import (
    MIN_BUCKET_SAMPLES,
    SHAPE_BUCKET_LOG2_WIDTH,
    CostCorrection,
    fit_cost_correction,
    shape_bucket,
)
from .measure import (
    default_interpret,
    device_kind,
    measure_callable,
    measure_fused,
    measure_gemm,
    measure_per_step,
    measure_streaming,
)
from .variants import (
    GEMM_BLOCK_CAPS,
    STREAM_BLOCK_CAPS,
    block_candidates,
    dominant_gemm,
    fused_token_variants,
    gemm_variants,
    network_signature,
    streaming_variants,
)

__all__ = [
    "TUNE_MODES", "Autotuner", "analytic_gemm_seconds", "gemm_work_items",
    "heuristic_blocks", "measured_calibration",
    "CACHE_FORMAT", "CACHE_VERSION", "DEFAULT_CACHE_PATH", "KERNEL_MODULES",
    "TuningCache", "TuningEntry", "entry_fingerprint", "entry_shards",
    "kernel_fingerprint", "kernel_source_paths", "merge_caches", "parse_variant", "variant_key",
    "MIN_BUCKET_SAMPLES", "SHAPE_BUCKET_LOG2_WIDTH", "CostCorrection",
    "fit_cost_correction", "shape_bucket",
    "default_interpret", "device_kind", "measure_callable", "measure_fused",
    "measure_gemm", "measure_per_step", "measure_streaming",
    "GEMM_BLOCK_CAPS", "STREAM_BLOCK_CAPS", "block_candidates",
    "dominant_gemm", "fused_token_variants", "gemm_variants",
    "network_signature", "streaming_variants",
]
