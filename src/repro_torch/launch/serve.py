"""Serving driver: request scheduler + phase-specialized execution plans.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --plan src/repro_torch/plans/tt-lm-100m.json --strict-plan \\
      --schedule continuous --batch 4 --n-requests 8 --prompt-len 32 --gen 16

Port of ``src/repro/launch/serve.py`` with the same flags.  ``--device``
defaults to ``cuda`` and the run fails when no card is present
(``--device cpu`` runs the plain versions).  ``--plan-backend`` forces one
kernel backend for every planned layer.

Across ranks: under ``torchrun --nproc-per-node N`` (``WORLD_SIZE > 1``),
or in a process whose ``torch.distributed`` group is already up, every
rank serves the same requests under the sharding rules of
``make_test_mesh()`` (:mod:`repro_torch.launch.mesh`), and each planned
TT projection splits its tokens over the ranks
(:mod:`repro_torch.plan.sharded`).  A rank's card is
``cuda:{local_rank % device_count}``; the backend is ``nccl`` when every
rank has a card of its own and ``gloo`` when ranks share one (NCCL refuses
two ranks on one card) or run on the CPU.  Rank 0 prints the report; every
rank checks that all ranks generated the same tokens (exit 5 if not).
``run(..., tt_model_reduce=True)`` turns on the row-parallel reduction,
a library switch as in the reference (no flag).

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu \
        --smoke --plan-prefill P --plan-decode D --strict-plan

``--strict-plan`` exits 3 when a plan was given but no projection executed
under it, and 4 when a layer planned for a kernel backend ran on the
plain executor instead.  Across ranks, a projection whose tokens do not
divide over the mesh runs its planned kernel on every rank, unsharded (a
record without a mesh), and is not demoted.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import os
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.kernels import launches
from repro_torch.launch.mesh import make_rules, make_test_mesh
from repro_torch.models import api
from repro_torch.models.config import ShapeConfig
from repro_torch.plan import (
    BACKENDS,
    execution_log,
    execution_log_dropped,
    load_plan,
    reset_execution_log,
)
from repro_torch.serve import (
    Scheduler,
    ServeEngine,
    ServePolicy,
    ServeResult,
    load_trace,
    summarize,
    synthetic_trace,
)
from repro_torch.sharding import use_rules

EXIT_UNPLANNED = 3   # --strict-plan: plan given, zero planned executions
EXIT_DEMOTED = 4     # --strict-plan: planned kernel layers ran the plain executor
EXIT_RANKS_DISAGREE = 5  # ranks generated different tokens


@dataclasses.dataclass
class ServeRun:
    """What :func:`run` returns: the exit code and, when serving happened,
    the scheduler's result, its summary and the kernel launch counts of
    the process so far."""

    code: int
    result: Optional[ServeResult] = None
    summary: Optional[dict] = None
    launches: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place among the serving ranks."""

    rank: int
    world: int
    backend: str            # "" on one rank
    shared_card: bool       # several ranks on one card
    owned: bool             # :func:`_join_ranks` started the process group


def _join_ranks(device_type: str) -> Ranks:
    """Join the process group (torchrun's ``env://``), or adopt the one the
    caller started; one rank without either."""
    owned = not dist.is_initialized()
    world = (int(os.environ.get("WORLD_SIZE", "1")) if owned
             else dist.get_world_size())
    if world <= 1:
        return Ranks(0, 1, "", False, False)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    shared = device_type == "cuda" and local_world > torch.cuda.device_count()
    if owned:
        dist.init_process_group(
            "nccl" if device_type == "cuda" and not shared else "gloo",
            init_method="env://")
    return Ranks(dist.get_rank(), world, str(dist.get_backend()), shared, owned)


def _tokens_agree(ranks: Ranks, result: ServeResult, device) -> bool:
    """Whether every rank generated the same tokens (a digest all-gathered)."""
    text = repr(sorted(result.tokens_by_rid().items())).encode()
    digest = int.from_bytes(hashlib.sha256(text).digest()[:7], "little")
    dev = device if ranks.backend == "nccl" else "cpu"
    mine = torch.tensor([digest], dtype=torch.int64, device=dev)
    every = [torch.empty_like(mine) for _ in range(ranks.world)]
    dist.all_gather(every, mine)
    return all(int(t) == digest for t in every)


def _load_and_describe(path: str, label: str):
    plan = load_plan(path)
    print(f"installed {label}: arch={plan.arch} hw={plan.hw} "
          f"strategy={plan.strategy} ({len(plan.layers)} layer plans)"
          + (f" [phase {plan.phase}]" if plan.phase else ""))
    print(f"plan tilings: {plan.tilings}"
          + (" (autotuned — repro_torch.tune)" if plan.tilings == "measured"
             else ""))
    if plan.hardware is not None:
        h = plan.hardware
        print(f"plan hardware: {h.name} ({h.pe_rows}x{h.pe_cols} PEs, "
              f"sram {h.sram_input_bytes // 1024}+"
              f"{h.sram_output_bytes // 1024} KiB, "
              f"bw {h.dram_words_per_cycle:g} words/cycle)")
    return plan


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="tt-lm-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--schedule", default="oneshot",
                    choices=("oneshot", "continuous"),
                    help="oneshot: each request decodes alone (default); "
                         "continuous: admit into free decode lanes each step")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slot width (fixed decode batch; default 4)")
    ap.add_argument("--n-requests", type=int, default=None,
                    help="synthetic-trace request count (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="mean inter-arrival gap in decode steps "
                         "(0 = every request arrives at t=0)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="request-trace JSON instead of the synthetic trace")
    ap.add_argument("--prompt-bucket", type=int, default=8,
                    help="round prompt lengths up to a multiple (default 8)")
    ap.add_argument("--max-admissions", type=int, default=None,
                    help="admission-policy cap per step (default: fill "
                         "every free lane)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="trace and sampling seed")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="install one execution plan for both phases")
    ap.add_argument("--plan-prefill", default=None, metavar="PATH",
                    help="prefill-phase plan of a pair")
    ap.add_argument("--plan-decode", default=None, metavar="PATH",
                    help="decode-phase plan of a pair")
    ap.add_argument("--plan-backend", default=None, choices=BACKENDS,
                    help="force one kernel backend for every planned layer")
    ap.add_argument("--strict-plan", action="store_true",
                    help="exit non-zero if a plan was given but no projection "
                         "executed under it (UNPLANNED run, exit 3), or if a "
                         "layer planned for a kernel backend ran on the plain "
                         "executor (DEMOTED run, exit 4)")
    return ap


def run(argv=None, *, tt_model_reduce: bool = False) -> ServeRun:
    """Parse ``argv``, serve, print the report; see :class:`ServeRun`.

    ``tt_model_reduce`` turns on the rules' row-parallel reduction over the
    model axis (several ranks only)."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.plan and (args.plan_prefill or args.plan_decode):
        ap.error("--plan is mutually exclusive with "
                 "--plan-prefill/--plan-decode")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(pass --device cpu to run the plain versions)", file=sys.stderr)
        return ServeRun(2)
    ranks = _join_ranks(device.type)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", ranks.rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if device.type == "cuda" and ranks.world > 1:
        torch.cuda.set_device(device)  # NCCL talks on the current device
    try:
        with open(os.devnull, "w") as sink:
            # rank 0 prints the report; errors reach stderr from every rank
            with (contextlib.redirect_stdout(sink) if ranks.rank
                  else contextlib.nullcontext()):
                return _serve(args, ap, device, ranks, tt_model_reduce)
    finally:
        if ranks.owned:
            dist.destroy_process_group()


def _serve(args, ap, device, ranks: Ranks, tt_model_reduce: bool) -> ServeRun:
    cfg = get_config(args.arch, tt=not args.dense, smoke=args.smoke)
    if cfg.family == "encdec":
        print("error: the serve scheduler is causal-LM only; encdec runs "
              "its own scalar-position decoder (serve it through the "
              "prefill/decode steps: examples/serve_decode_torch.py)",
              file=sys.stderr)
        return ServeRun(2)
    any_plan = bool(args.plan or args.plan_prefill or args.plan_decode)
    if args.plan:
        prefill_plan = decode_plan = _load_and_describe(args.plan, "plan")
    else:
        prefill_plan = (_load_and_describe(args.plan_prefill, "prefill plan")
                        if args.plan_prefill else None)
        decode_plan = (_load_and_describe(args.plan_decode, "decode plan")
                       if args.plan_decode else None)
    if args.plan_backend is not None and not any_plan:
        ap.error("--plan-backend needs a plan")

    if args.trace:
        requests = load_trace(args.trace, cfg.vocab, seed=args.seed)
    else:
        n = args.n_requests if args.n_requests is not None else args.batch
        requests = synthetic_trace(
            n, cfg.vocab, prompt_len=args.prompt_len, gen=args.gen,
            arrival_rate=args.arrival_rate, seed=args.seed)
    bucket = args.prompt_bucket
    max_seq = max(
        max(-(-len(r.prompt) // bucket) * bucket,
            len(r.prompt) + r.max_new_tokens - 1)
        for r in requests) if requests else bucket

    shape = ShapeConfig("cli", max_seq, args.batch, "decode")
    rules = make_rules(cfg, shape, make_test_mesh())
    if tt_model_reduce:
        rules = dataclasses.replace(rules, tt_model_reduce=True)

    reset_execution_log()
    t0 = time.perf_counter()
    with use_rules(rules):
        # install a plan before init: v4 plans embed searched
        # factorizations, which set the TT parameter shapes themselves
        init_plan = prefill_plan if prefill_plan is not None else decode_plan
        m = (api(cfg, plan=init_plan, device=device) if init_plan is not None
             else api(cfg, device=device))
        params = m.init_params(0)  # random weights, as the reference's PRNGKey(0)
        try:
            engine = ServeEngine(
                cfg, params, n_slots=args.batch, max_seq=max_seq,
                prompt_bucket=bucket, prefill_plan=prefill_plan,
                decode_plan=decode_plan, arch=args.arch,
                plan_backend=args.plan_backend)
        except ValueError as e:
            print(f"error: plan/model mismatch: {e}", file=sys.stderr)
            return ServeRun(2)
        sched = Scheduler(
            engine,
            ServePolicy(schedule=args.schedule,
                        max_admissions_per_step=args.max_admissions),
            temperature=args.temperature, seed=args.seed)
        result = sched.run(requests)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    total_s = time.perf_counter() - t0
    counts = launches.snapshot()
    if ranks.world > 1 and not _tokens_agree(ranks, result, device):
        print(f"error: rank {ranks.rank}: the {ranks.world} ranks generated "
              "different tokens", file=sys.stderr)
        return ServeRun(EXIT_RANKS_DISAGREE, result, summarize(result), counts)

    s = summarize(result)
    print(f"schedule {args.schedule}: {s['n_requests']} requests over "
          f"{s['steps']} steps, {result.n_slots} decode slots, "
          f"occupancy {s['mean_occupancy']:.2f}, device {device}")
    print(f"throughput: {s['gen_tok_s']:.1f} gen tok/s, "
          f"{s['total_tok_s']:.1f} total tok/s "
          f"({s['generated_tokens']} generated / {s['total_tokens']} total "
          f"tokens, serve {s['wall_s']*1e3:.1f} ms, "
          f"end-to-end {total_s*1e3:.1f} ms)")
    print(f"latency: ttft p50/p95 {s['ttft_p50_ms']:.1f}/"
          f"{s['ttft_p95_ms']:.1f} ms, request p50/p95 "
          f"{s['latency_p50_ms']:.1f}/{s['latency_p95_ms']:.1f} ms")
    if result.completions:
        c0 = result.completions[0]
        print(f"generated token ids (rid {c0.rid}): {list(c0.tokens)[:16]}")
    print("kernel launches in this process: "
          + " ".join(f"{k}={v}" for k, v in counts.items()))
    out = ServeRun(0, result, s, counts)

    if any_plan:
        log = execution_log()
        by_stream: dict[str, dict[str, int]] = {}
        for r in log:
            st = by_stream.setdefault(r["stream"] or "?", {})
            st[r["backend"]] = st.get(r["backend"], 0) + 1
        n_pre = sum(by_stream.get("prefill", {}).values())
        n_dec = sum(by_stream.get("decode", {}).values())
        print(f"planned executions (one record per call): {len(log)} — "
              f"prefill stream: {n_pre}, decode stream: {n_dec}")
        for stream in ("prefill", "decode"):
            if stream in by_stream:
                print(f"  {stream} backends "
                      f"{dict(sorted(by_stream[stream].items()))}")
        tilings = sorted({
            (r["tiling"]["block_m"], r["tiling"]["block_k"],
             r["tiling"]["block_n"], r["tiling"]["block_tokens"])
            for r in log})
        if tilings:
            print("kernel tilings (block_m,k,n,tokens): "
                  + " ".join(str(t) for t in tilings))
        dropped = execution_log_dropped()
        if dropped:
            print(f"NOTE: the execution log ring dropped {dropped} oldest "
                  f"records (cap {len(log)}); the counts above cover the "
                  "newest records only")
        meshes = sorted({r.get("mesh", "") for r in log} - {""})
        if meshes:
            shapes = sorted({tuple(r["shard_shape"]) for r in log
                             if r.get("shard_shape")})
            where = ("on the CPU" if device.type == "cpu" else
                     f"{ranks.world} ranks share one card" if ranks.shared_card
                     else "one card per rank")
            print(f"sharded execution: mesh {' '.join(meshes)}, "
                  f"per-shard (tokens, d_in) "
                  + " ".join(str(s) for s in shapes)
                  + f" ({ranks.world} ranks, backend {ranks.backend}, {where})")
        # a layer planned for a kernel backend that recorded backend "jnp"
        # was demoted; --strict-plan makes it fatal
        backends_by_stream = {
            s: ({lp.name: lp.backend for lp in p.layers}
                if p is not None else {})
            for s, p in (("prefill", prefill_plan), ("decode", decode_plan))
        }
        demoted = [
            r for r in log
            if r["backend"] == "jnp"
            and backends_by_stream.get(
                r["stream"], {}).get(r["name"], "jnp") != "jnp"
        ]
        if demoted:
            names = sorted({r["name"] for r in demoted})
            print(f"WARNING: {len(demoted)} planned-kernel executions were "
                  f"DEMOTED to the plain executor ({len(names)} layers: "
                  f"{names[:4]}{'...' if len(names) > 4 else ''})",
                  file=sys.stderr)
            if args.strict_plan:
                out.code = EXIT_DEMOTED
                return out
        if not log:
            print(
                "WARNING: a plan was given but the run executed no planned "
                "projection — the run was entirely UNPLANNED (layer names "
                "did not line up; was the plan emitted for a different arch "
                "or tt/--dense setting?)",
                file=sys.stderr,
            )
            if args.strict_plan:
                out.code = EXIT_UNPLANNED
    return out


def main(argv=None) -> int:
    return run(argv).code


if __name__ == "__main__":
    raise SystemExit(main())
