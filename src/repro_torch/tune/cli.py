"""``python -m repro_torch.tune`` — warm the measured-latency tuning cache.

Port of ``src/repro/tune/cli.py`` (no JAX), with the reference's flags,
report and ``merge``, plus ``--device``: the measurements run on the card
(``cuda``, the default; the run fails when no card is present) unless
``--device cpu`` asks for the plain versions on the CPU.

Runs the full measure -> calibrate -> re-search loop for one arch:

    PYTHONPATH=src python -m repro_torch.tune --arch tt-lm-100m --smoke \
        --cache results/tuning_cache.json              # on the card
    PYTHONPATH=src python -m repro_torch.tune --arch tt-lm-100m --smoke \
        --device cpu --max-shapes 2                    # plain versions

1. enumerate the model's DSE problems and candidate paths (the same
   pipeline as ``python -m repro_torch.dse``);
2. measure the unique dominant GEMM shapes under every dataflow at the
   heuristic tiling — the per-dataflow calibration signal;
3. re-run the global argmin with the measured calibration applied, so
   the families tuned next are the ones a calibrated ``--tune cache``
   search will actually deploy;
4. sweep kernel-tiling variants per deployed family (GEMM blocks for
   ``tt_gemm`` layers, ``block_tokens`` for streaming layers) and
   persist every measurement to the cache.

A subsequent ``python -m repro_torch.dse --tune cache --emit-plan`` replays
the warmed cache without re-measuring; ``--max-shapes`` bounds the work
for smoke/CI runs (unmeasured problems are then measured on first miss
by the consuming search).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import torch

from repro_torch.dse_cli import dse_problems, model_layer_paths
from repro_torch.hw import get_target

from .autotune import (
    TUNE_MODES,
    Autotuner,
    gemm_work_items,
    measured_calibration,
)
from .cache import (
    DEFAULT_CACHE_PATH,
    TuningCache,
    kernel_fingerprint,
    merge_caches,
    variant_key,
)


def run_tune(
    arch: str,
    hw: str = "fpga_vu9p",
    top_k: int = 4,
    tokens: Optional[int] = None,
    smoke: bool = False,
    cache_path: str = DEFAULT_CACHE_PATH,
    mode: str = "cache",
    max_shapes: Optional[int] = None,
    warmup: Optional[int] = None,
    repeats: Optional[int] = None,
    tuner: Optional[Autotuner] = None,
    shards: int = 1,
    device="cuda",
) -> dict:
    """Measure, calibrate, re-search, sweep; returns the JSON report.

    ``tuner`` may inject a pre-built :class:`Autotuner` (tests stub the
    measurement functions through it); by default one is built over the
    persistent cache at ``cache_path``, measuring on ``device``.
    """
    from repro_torch.core.dse import global_search
    from repro_torch.plan.compiler import (
        base_name,
        batch_dim,
        choose_backend,
        choose_tiling,
    )

    if mode not in TUNE_MODES:
        raise ValueError(f"unknown tune mode {mode!r}; have {TUNE_MODES}")
    hw_cfg = get_target(hw)
    named, tokens = dse_problems(arch, tokens, smoke)
    if shards > 1:
        # warm the cache for a sharded search: measure the per-shard
        # problems a `repro_torch.dse --shards N` run will look up
        from repro_torch.core.cost_table import shard_streamed_tokens

        tokens = shard_streamed_tokens(tokens, shards)
        named, tokens = dse_problems(arch, tokens, smoke)
    layer_paths = model_layer_paths(named, top_k)
    if tuner is None:
        kw = {}
        if warmup is not None:
            kw["warmup"] = warmup
        if repeats is not None:
            kw["repeats"] = repeats
        tuner = Autotuner(TuningCache.load_or_empty(cache_path), mode,
                          cache_path=cache_path, shards=shards,
                          device=device, **kw)

    t0 = time.perf_counter()
    shapes = gemm_work_items(layer_paths, max_shapes=max_shapes)
    calibration = measured_calibration(shapes, tuner, hw_cfg)
    res = global_search(layer_paths, hw_cfg, calibration=calibration)

    families = []
    seen: set[str] = set()
    for (inst_name, tn), choice in zip(named, res.choices):
        name = base_name(inst_name)
        if name in seen:
            continue
        seen.add(name)
        if max_shapes is not None and len(families) >= max_shapes:
            break
        t = tokens or batch_dim(tn)
        tiling = choose_tiling(choice, t, None)
        backend = choose_backend(tn, choice, tiling, None)
        row = {
            "name": name,
            "backend": backend,
            "dataflow": choice.dataflow.value,
            "heuristic": tiling.to_json(),
        }
        if backend == "tt_gemm":
            g = max(choice.path.gemms, key=lambda g: g.macs)
            best = tuner.tune_gemm(
                g.M, g.K, g.N, choice.dataflow.value,
                include=[(tiling.block_m, tiling.block_k, tiling.block_n)])
            entry = tuner.cache.get(
                tuner.gemm_key(g.M, g.K, g.N, choice.dataflow.value))
            row["measured"] = {"block_m": best[0], "block_k": best[1],
                               "block_n": best[2]}
            row["speedup_vs_heuristic"] = _speedup(
                entry, (tiling.block_m, tiling.block_k, tiling.block_n))
        elif backend == "streaming_tt":
            bt = tuner.tune_streaming(tn, choice.path.steps, t,
                                      include=[tiling.block_tokens])
            if bt is not None:
                entry = tuner.cache.get(
                    tuner.streaming_key(tn, choice.path.steps, t))
                row["measured"] = {"block_tokens": bt}
                row["speedup_vs_heuristic"] = _speedup(
                    entry, (tiling.block_tokens,))
        families.append(row)

    if tuner.cache_path is not None:
        tuner.save()
    return {
        "arch": arch,
        "hw": hw,
        "mode": mode,
        "cache": tuner.cache_path,
        "device_kind": tuner.device_kind,
        "interpret": tuner.interpret,
        "tokens": tokens,
        "shards": tuner.shards,
        "top_k": top_k,
        "n_shapes": len(shapes),
        "n_families": len(families),
        "n_measured": tuner.n_measured,
        "n_cache_hits": tuner.n_cache_hits,
        "n_cache_entries": len(tuner.cache),
        "tune_seconds": time.perf_counter() - t0,
        "calibration": calibration,
        "families": families,
    }


def _speedup(entry, heuristic_variant: tuple[int, ...]) -> Optional[float]:
    """best-vs-heuristic measured ratio for one cache entry (>= 1.0)."""
    if entry is None:
        return None
    h = entry.measured_s.get(variant_key(heuristic_variant))
    b = entry.best_seconds
    if h is None or b is None or b <= 0:
        return None
    return h / b


def _build_merge_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.tune merge",
        description="Union tuning caches from several hosts into one "
                    "(last-writer-wins on identical keys; entries measured "
                    "through edited kernel sources are dropped).",
    )
    p.add_argument("caches", nargs="+", metavar="CACHE.json",
                   help="cache files to merge, oldest first (later files "
                        "win on colliding measurements)")
    p.add_argument("-o", "--out", required=True, metavar="PATH",
                   help="merged cache destination")
    p.add_argument("--fingerprint", default=None, metavar="HASH",
                   help="accept entries with this kernel-source hash "
                        "(default: the current working tree's)")
    p.add_argument("--shards", type=int, default=None, metavar="N",
                   help="accept only entries measured for an N-way mesh "
                        "(per-shard problem shapes differ per mesh width; "
                        "default: keep every width)")
    return p


def run_merge(argv: Sequence[str]) -> int:
    args = _build_merge_parser().parse_args(argv)
    try:
        caches = [TuningCache.load(p) for p in args.caches]
    except (OSError, ValueError) as e:
        print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    fp = args.fingerprint or kernel_fingerprint()
    merged, dropped, dropped_shards = merge_caches(
        caches, fingerprint=fp, shards=args.shards)
    merged.save(args.out)
    total_in = sum(len(c) for c in caches)
    shard_note = (f", {dropped_shards} dropped (shard-shape mismatch vs "
                  f"s{args.shards})" if args.shards is not None else "")
    print(f"merged {len(args.caches)} caches ({total_in} entries) -> "
          f"{args.out}: {len(merged)} entries kept, {dropped} dropped "
          f"(fingerprint mismatch vs k{fp}){shard_note}", file=sys.stderr)
    return 0


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Empirical kernel autotuner: measure CUDA kernel variant "
                    "latencies, warm the persistent tuning cache, and "
                    "report the measured calibration table.",
    )
    p.add_argument("--arch", required=True,
                   help="named config (see repro.dse --list-archs)")
    p.add_argument("--hw", default="fpga_vu9p",
                   help="cost-model target the calibration compares against")
    p.add_argument("--top-k", type=int, default=4, metavar="K")
    p.add_argument("--tokens", type=int, default=None)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--cache", default=DEFAULT_CACHE_PATH, metavar="PATH",
                   help=f"tuning-cache file (default {DEFAULT_CACHE_PATH})")
    p.add_argument("--mode", default="cache", choices=TUNE_MODES,
                   help="cache: measure only cache misses (default); "
                        "measure: re-measure and overwrite")
    p.add_argument("--shards", type=int, default=1, metavar="N",
                   help="measure per-shard problems for an N-way mesh "
                        "(matches repro.dse --shards N lookups; default 1)")
    p.add_argument("--max-shapes", type=int, default=None, metavar="N",
                   help="bound the calibration shapes and tuned families "
                        "(smoke/CI runs)")
    p.add_argument("--repeats", type=int, default=None, metavar="R",
                   help="timed repetitions per variant (median kept)")
    p.add_argument("--warmup", type=int, default=None, metavar="W",
                   help="untimed warmup calls per variant (absorbs the "
                        "kernel build and program compilation; raise on "
                        "noisy hosts)")
    p.add_argument("--device", default="cuda",
                   help="torch device the measurements run on (default "
                        "cuda; cpu times the plain versions of the kernels)")
    p.add_argument("--out", default="-", metavar="PATH",
                   help="report destination ('-' = stdout, default)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "merge":
        return run_merge(list(argv[1:]))
    args = _build_parser().parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(pass --device cpu to time the plain versions)",
              file=sys.stderr)
        return 2
    try:
        report = run_tune(
            arch=args.arch,
            hw=args.hw,
            top_k=args.top_k,
            tokens=args.tokens,
            smoke=args.smoke,
            cache_path=args.cache,
            mode=args.mode,
            max_shapes=args.max_shapes,
            warmup=args.warmup,
            repeats=args.repeats,
            shards=args.shards,
            device=args.device,
        )
    except (KeyError, ValueError) as e:
        msg = e.args[0] if e.args else e
        print(f"error: {msg}", file=sys.stderr)
        return 2
    text = json.dumps(report, indent=2)
    if args.out == "-":
        print(text)
    else:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    print(f"tuned {report['n_families']} families / "
          f"{report['n_shapes']} shapes: {report['n_measured']} measured, "
          f"{report['n_cache_hits']} cache hits -> {args.cache}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
