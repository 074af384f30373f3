"""The autotuner: measured variant sweeps + the DSE calibration table.

Port of ``src/repro/tune/autotune.py`` (no JAX), copied; the tuner also
names the torch device its measurements run on (``cuda`` unless the
caller asks for the CPU) and derives ``device_kind`` and ``interpret``
from it.

:class:`Autotuner` is the handle everything else consumes:

- ``plan/compiler.compile_plan(..., tilings="measured", tuner=...)`` asks
  it for the best measured ``(block_m, block_k, block_n)`` per unique
  (dominant GEMM, dataflow) and the best measured ``block_tokens`` per
  unique streaming-layer problem;
- ``repro_torch.dse --tune`` asks it for per-dataflow measured seconds of the
  model's dominant GEMM shapes, from which :func:`measured_calibration`
  builds the per-dataflow rescale table ``dse.global_search`` applies;
- ``python -m repro_torch.tune`` drives it directly to warm the cache.

Two modes: ``"cache"`` measures only what the persistent cache misses
(the normal mode — a warm cache replays with **zero** measurements, so
re-emitting a plan is deterministic and bit-identical), ``"measure"``
re-measures every requested variant and overwrites the cached numbers.
``n_measured`` / ``n_cache_hits`` make "the second run measured nothing"
an assertable property.

Deduplication mirrors ``core/cost_table``: repeated transformer blocks
share one cache entry per unique (GEMM shape, dataflow) and per unique
(layer network, token count), so the measurement count scales with the
number of *distinct* problems, not with model depth.
"""

from __future__ import annotations

import hashlib
import math
from typing import Optional, Sequence

import torch

from repro_torch.core.simulator import ALL_DATAFLOWS, Dataflow, gemm_cost_model
from repro_torch.hw import HardwareConfig
from repro_torch.plan.compiler import (
    VMEM_BUDGET_BYTES,
    default_blocks,
    rebatch,
)
from repro_torch.core.tensor_network import TensorNetwork

from . import measure as _measure
from .cache import TuningCache, TuningEntry, kernel_fingerprint, variant_key
from .variants import (
    GEMM_BLOCK_CAPS,
    STREAM_BLOCK_CAPS,
    dominant_gemm,
    fused_token_variants,
    gemm_variants,
    network_signature,
    streaming_variants,
)

TUNE_MODES = ("cache", "measure")

#: the compiler's default (fixed-target) tiling for one GEMM shape —
#: literally ``plan/compiler.default_blocks``, so the calibration's
#: operating point is the tiling the analytic argmin would deploy
heuristic_blocks = default_blocks


class Autotuner:
    """Measured-variant sweeps over a persistent :class:`TuningCache`."""

    def __init__(
        self,
        cache: Optional[TuningCache] = None,
        mode: str = "cache",
        *,
        cache_path: Optional[str] = None,
        device_kind: Optional[str] = None,
        interpret: Optional[bool] = None,
        warmup: int = _measure.WARMUP,
        repeats: int = _measure.REPEATS,
        measure_gemm_fn=None,
        measure_streaming_fn=None,
        measure_fused_fn=None,
        measure_per_step_fn=None,
        kernel_fp: Optional[str] = None,
        shards: int = 1,
        device=None,
    ) -> None:
        if mode not in TUNE_MODES:
            raise ValueError(f"unknown tune mode {mode!r}; have {TUNE_MODES}")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.cache = cache if cache is not None else TuningCache()
        self.mode = mode
        self.cache_path = cache_path
        # the torch device the measurements run on (the card unless the
        # caller asks for the CPU); injected measure functions get it too
        self.device = torch.device("cuda" if device is None else device)
        self.device_kind = (device_kind if device_kind is not None
                            else _measure.device_kind(self.device))
        self.interpret = (interpret if interpret is not None
                          else _measure.default_interpret(self.device))
        # staleness guard (ROADMAP gap d): keys carry the kernel-source
        # hash, so entries measured through edited kernels stop matching
        self.kernel_fp = (kernel_fp if kernel_fp is not None
                          else kernel_fingerprint())
        # sharded search measures per-shard problems whose shapes depend
        # on the mesh width — a 4-shard entry must never answer a
        # single-device lookup, so the shard count is part of every key
        self.shards = int(shards)
        self.warmup = warmup
        self.repeats = repeats
        # injection points for tests (no real kernels, no real clocks)
        self._measure_gemm = measure_gemm_fn or _measure.measure_gemm
        self._measure_streaming = (measure_streaming_fn
                                   or _measure.measure_streaming)
        self._measure_fused = measure_fused_fn or _measure.measure_fused
        self._measure_per_step = (measure_per_step_fn
                                  or _measure.measure_per_step)
        self.n_measured = 0
        self.n_cache_hits = 0
        self._measured_this_run: set[str] = set()

    def save(self, path: Optional[str] = None) -> None:
        """Persist the cache (to ``path`` or the constructor's path)."""
        target = path or self.cache_path
        if target is None:
            raise ValueError("no cache path to save to")
        self.cache.save(target)

    # -- keys --------------------------------------------------------------
    def _suffix(self) -> str:
        interp = "interp" if self.interpret else "native"
        return f"{self.device_kind}:{interp}:s{self.shards}:k{self.kernel_fp}"

    def gemm_key(self, M: int, K: int, N: int, dataflow: str) -> str:
        return f"gemm:{M}x{K}x{N}:{dataflow}:{self._suffix()}"

    def streaming_key(self, tn: TensorNetwork, steps, tokens: int) -> str:
        sig = network_signature(rebatch(tn, 1), steps)
        digest = hashlib.sha1(sig.encode()).hexdigest()[:16]
        return f"stream:{digest}:t{tokens}:{self._suffix()}"

    def fused_key(self, tn: TensorNetwork, steps, segments,
                  tokens: int) -> str:
        sig = network_signature(rebatch(tn, 1), steps)
        seg = "_".join(f"{s}-{e}" for s, e in segments)
        digest = hashlib.sha1(f"{sig}|{seg}".encode()).hexdigest()[:16]
        return f"fused:{digest}:t{tokens}:{self._suffix()}"

    # -- GEMM sweeps -------------------------------------------------------
    def _gemm_entry(self, M: int, K: int, N: int,
                    dataflow: str) -> TuningEntry:
        return self.cache.ensure(
            self.gemm_key(M, K, N, dataflow),
            kind="gemm", backend="tt_gemm",
            device_kind=self.device_kind, interpret=self.interpret,
            problem={"M": int(M), "K": int(K), "N": int(N),
                     "dataflow": str(dataflow)},
        )

    def _measure_into(self, entry: TuningEntry, vk: str, measure) -> float:
        run_key = f"{entry.key}#{vk}"
        fresh = run_key in self._measured_this_run
        if vk in entry.measured_s and (self.mode == "cache" or fresh):
            # "measure" re-measures stale cache entries, but at most once
            # per process — calibration and the family sweeps share points
            self.n_cache_hits += 1
            return entry.measured_s[vk]
        s = float(measure())
        entry.measured_s[vk] = s
        self._measured_this_run.add(run_key)
        self.n_measured += 1
        return s

    # -- cache-only lookups (no measuring) ---------------------------------
    def cached_gemm_blocks(
        self, M: int, K: int, N: int, dataflow: str
    ) -> Optional[tuple[int, ...]]:
        """Best *already-measured* blocks for one GEMM problem, or None.

        Never measures: the plan compiler uses this for backward-op
        tilings (train plans reuse forward measurements when the cache
        holds them, analytic heuristic otherwise — ROADMAP gap b).
        """
        entry = self.cache.get(self.gemm_key(M, K, N, dataflow))
        return entry.best_blocks if entry is not None else None

    def cached_streaming_tokens(
        self, tn: TensorNetwork, steps, tokens: int
    ) -> Optional[int]:
        """Best already-measured ``block_tokens`` for one streaming
        problem, or None (cache-only — see :meth:`cached_gemm_blocks`)."""
        entry = self.cache.get(self.streaming_key(tn, steps, tokens))
        blocks = entry.best_blocks if entry is not None else None
        return blocks[0] if blocks else None

    def gemm_seconds(self, M: int, K: int, N: int, dataflow: str,
                     blocks: tuple[int, int, int]) -> float:
        """Measured seconds of one (shape, dataflow, tiling) variant."""
        entry = self._gemm_entry(M, K, N, dataflow)
        return self._measure_into(
            entry, variant_key(blocks),
            lambda: self._measure_gemm(
                M, K, N, dataflow, blocks, interpret=self.interpret,
                warmup=self.warmup, repeats=self.repeats, device=self.device))

    def tune_gemm(
        self,
        M: int, K: int, N: int,
        dataflow: str,
        *,
        include: Sequence[tuple[int, int, int]] = (),
        caps: Sequence[int] = GEMM_BLOCK_CAPS,
    ) -> tuple[int, int, int]:
        """Best measured ``(block_m, block_k, block_n)`` for one GEMM.

        Sweeps the feasible variant space (plus ``include`` — pass the
        compiler's heuristic tiling so the result can never lose to it),
        measuring cache misses; returns the argmin over the swept set,
        ties to the numerically smallest variant.
        """
        variants = gemm_variants(M, K, N, caps=caps, include=include)
        entry = self._gemm_entry(M, K, N, dataflow)
        measured = {
            v: self._measure_into(
                entry, variant_key(v),
                lambda v=v: self._measure_gemm(
                    M, K, N, dataflow, v, interpret=self.interpret,
                    warmup=self.warmup, repeats=self.repeats,
                    device=self.device))
            for v in variants
        }
        return min(measured, key=lambda v: (measured[v], v))

    # -- streaming sweeps --------------------------------------------------
    def tune_streaming(
        self,
        tn: TensorNetwork,
        steps,
        tokens: int,
        *,
        include: Sequence[int] = (),
        budget_bytes: int = VMEM_BUDGET_BYTES,
        caps: Sequence[int] = STREAM_BLOCK_CAPS,
    ) -> Optional[int]:
        """Best measured ``block_tokens`` for one streaming-layer problem.

        ``tn`` is the full-batch layer network; each variant rebatches it
        to the candidate block and times the padded streaming call over
        ``tokens`` rows.  Returns ``None`` when the network does not fit
        the single-streamed-operand kernel layout (the caller keeps the
        heuristic tiling).
        """
        variants = streaming_variants(tn, steps, tokens, caps=caps,
                                      budget_bytes=budget_bytes,
                                      include=include)
        if not variants:
            return None
        key = self.streaming_key(tn, steps, tokens)
        entry = self.cache.ensure(
            key, kind="streaming", backend="streaming_tt",
            device_kind=self.device_kind, interpret=self.interpret,
            problem={"signature": network_signature(rebatch(tn, 1), steps),
                     "tokens": int(tokens)},
        )
        measured: dict[int, float] = {}
        for bt in variants:
            tn_block = rebatch(tn, bt)
            try:
                s = self._measure_into(
                    entry, variant_key((bt,)),
                    lambda: self._measure_streaming(
                        tn_block, steps, tokens, bt,
                        interpret=self.interpret, device=self.device,
                        warmup=self.warmup, repeats=self.repeats))
            except ValueError:
                # network layout unsupported by the streaming kernel
                # (e.g. trailing conv patch edge) — nothing to tune
                return None
            measured[bt] = s
        return min(measured, key=lambda bt: (measured[bt], bt))

    # -- fused-segment sweeps ----------------------------------------------
    def tune_fused(
        self,
        tn: TensorNetwork,
        steps,
        segments,
        tokens: int,
        *,
        include: Sequence[int] = (),
        budget_bytes: int = VMEM_BUDGET_BYTES,
        caps: Sequence[int] = STREAM_BLOCK_CAPS,
        block_k: int = 128,
    ) -> Optional[dict]:
        """Measured fused vs per-step seconds for one segmented layer.

        Sweeps the feasible ``block_tokens`` ladder of the fused chain
        runs (``variants.fused_token_variants`` — only blocks that
        reproduce exactly the priced segmentation), measures the
        spill-always per-step route once as the baseline, and returns
        ``{"block_tokens", "fused_s", "per_step_s"}`` (``None`` when no
        variant reproduces the segmentation).  Both routes land in the
        persistent cache, so ``--tune cache`` replays without measuring.
        """
        tn = rebatch(tn, tokens)
        steps = tuple(tuple(s) for s in steps)
        segments = tuple((int(s), int(e)) for s, e in segments)
        variants = fused_token_variants(
            tn, steps, segments, tokens, caps=caps,
            budget_bytes=budget_bytes, include=include)
        if not variants:
            return None
        sig = network_signature(rebatch(tn, 1), steps)
        entry = self.cache.ensure(
            self.fused_key(tn, steps, segments, tokens),
            kind="fused", backend="tt_gemm",
            device_kind=self.device_kind, interpret=self.interpret,
            problem={"signature": sig, "tokens": int(tokens),
                     "segments": [list(s) for s in segments]},
        )
        measured = {
            bt: self._measure_into(
                entry, variant_key((bt,)),
                lambda bt=bt: self._measure_fused(
                    tn, steps, segments, bt, block_k=block_k,
                    interpret=self.interpret, device=self.device,
                    warmup=self.warmup, repeats=self.repeats))
            for bt in variants
        }
        best = min(measured, key=lambda bt: (measured[bt], bt))
        base_entry = self.cache.ensure(
            f"fusedbase:{self.fused_key(tn, steps, segments, tokens)[6:]}",
            kind="fused_base", backend="tt_gemm",
            device_kind=self.device_kind, interpret=self.interpret,
            problem={"signature": sig, "tokens": int(tokens)},
        )
        per_step_s = self._measure_into(
            base_entry, variant_key((tokens,)),
            lambda: self._measure_per_step(
                tn, steps, interpret=self.interpret, device=self.device,
                warmup=self.warmup, repeats=self.repeats))
        return {"block_tokens": int(best), "fused_s": measured[best],
                "per_step_s": per_step_s}


# ---------------------------------------------------------------------------
# model-level work items + the DSE calibration table
# ---------------------------------------------------------------------------

def gemm_work_items(
    layer_paths: Sequence[Sequence],
    max_shapes: Optional[int] = None,
) -> list[tuple[int, int, int]]:
    """Unique dominant-GEMM shapes of a model's candidate paths.

    One work item per unique shape (the measurement dedup), ordered by
    the shape's own MAC volume descending (the heaviest GEMMs carry the
    calibration signal), optionally truncated to ``max_shapes``.
    """
    shapes = {dominant_gemm(p) for paths in layer_paths for p in paths}
    order = sorted(shapes, key=lambda s: (-(s[0] * s[1] * s[2]), s))
    return order[:max_shapes] if max_shapes is not None else order


def analytic_gemm_seconds(
    M: int, K: int, N: int, dataflow, hw: HardwareConfig
) -> float:
    """The closed-form model's prediction for one monolithic GEMM."""
    df = dataflow if isinstance(dataflow, Dataflow) else Dataflow(dataflow)
    cycles, _, _ = gemm_cost_model(M, K, N, df, hw.pe_rows, hw.pe_cols, hw)
    return float(cycles) / hw.freq_hz


def measured_calibration(
    shapes: Sequence[tuple[int, int, int]],
    tuner: Autotuner,
    hw: HardwareConfig,
    dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
) -> dict[str, float]:
    """Per-dataflow measured/analytic scale factors over ``shapes``.

    Each shape is measured once per dataflow at the compiler's heuristic
    tiling (the operating point the analytic argmin would deploy), and
    the per-dataflow scale is the geometric mean of measured/analytic
    ratios — robust to the absolute-magnitude gap between the modeled
    accelerator and the measuring host, sensitive exactly to the
    *relative* per-dataflow disagreement that can flip an argmin.
    """
    if not shapes:
        raise ValueError("measured_calibration needs at least one shape")
    scales: dict[str, float] = {}
    for d in dataflows:
        logs = []
        for (M, K, N) in shapes:
            measured = tuner.gemm_seconds(
                M, K, N, d.value, heuristic_blocks(M, K, N))
            analytic = analytic_gemm_seconds(M, K, N, d, hw)
            if measured > 0 and analytic > 0:
                logs.append(math.log(measured / analytic))
        scales[d.value] = math.exp(sum(logs) / len(logs)) if logs else 1.0
    return scales
