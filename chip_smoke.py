#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of tt-lm-100m serving on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order; any failure exits non-zero and prints no result line:

1. card: ``nvidia-smi`` name and power limit.
2. build: ``nvcc`` builds ``src/repro_torch/csrc/*.cu``, one process per
   source, all started together.
3. kernels: every CUDA kernel of the serving path (K1 ``streaming_tt``,
   K2-K4 ``tt_gemm`` OS/WS/IS) against its plain PyTorch version at the
   shapes the main path gives it, plus ragged token counts.  Per kernel:
   max abs error, kernel ms, plain ms, ``library_ms`` (one PyTorch call
   that computes the same function; used nowhere in the port) and the
   bound (bytes over 3.35 TB/s or fp32 FLOPs over 67 TFLOP/s, the
   larger).
4. serve: full-width tt-lm-100m with random weights from a seed, through
   ``python -m repro_torch.launch.serve``'s code path: the full plan with
   ``--strict-plan`` (continuous, then oneshot: the tokens must match), the
   plan pair, and the pair with ``--plan-backend tt_gemm`` (the dataflow
   kernels).  Launch counts are zeroed just before and read just after.
5. per call: launches of one prefill and one decode step per plan
   setting; a decode step's wall time and the card's busy share
   (``torch.profiler``).
6. check: prefill logits through the kernels agree with the plain
   executor on the card; tt-lm-smoke on the card agrees with the CPU.

TF32 is off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are False): the model is fp32.
The last two lines before the final one are the kernels JSON and the
card's ``name, power.limit``; the last line is the ``{"ok": true, ...}``
JSON.  Nothing of JAX or of the JAX package is imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
PLANS = os.path.join(SRC, "repro_torch", "plans")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores

SERVE = ["--batch", "4", "--n-requests", "8", "--prompt-len", "32",
         "--gen", "16", "--strict-plan"]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int = 50, warmup: int = 5) -> tuple[float, float]:
    """(ms per call on the card, ms per call the host spends enqueueing).

    CUDA events around ``reps`` back-to-back calls give the first; the
    host clock around the same loop, before the final synchronize, the
    second.  When the two are close, the host, not the card, sets the pace.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def main_path_layers():
    """(plan name, layer plan, network) of every TT projection the serving
    runs execute: the full plan, the pair, and the pair on tt_gemm.  The
    tied LM head has a plan entry but runs through the embedding cores, so
    no ``head`` entry executes."""
    from repro_torch.configs import get_config
    from repro_torch.dse_cli import model_dse_layers
    from repro_torch.plan import load_plan

    families = {n.split("[")[0]: tn for n, tn in
                model_dse_layers(get_config("tt-lm-100m"), tokens=8)}
    out = []
    for name in ("tt-lm-100m.json", "tt-lm-100m.pair.prefill.json",
                 "tt-lm-100m.pair.decode.json"):
        for lp in load_plan(os.path.join(PLANS, name)).layers:
            if lp.name != "head":
                out.append((name, lp, families[lp.name]))
    return out


def check_streaming(device, layers) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ops, streaming_tt
    from repro_torch.plan.executor import as_candidate_path

    seen, err, timing = set(), 0.0, {}
    gen = torch.Generator().manual_seed(1)
    for plan_name, lp, tn in layers:
        if lp.backend != "streaming_tt":
            continue
        for tokens in (1, 4, 32, 37):
            key = (lp.name, lp.path_steps, tokens)
            if key in seen:
                continue
            seen.add(key)
            bt = ops.clamp_block(lp.tiling.block_tokens, tokens)
            tn_b = streaming_tt._rebatch(tn, bt)
            path = as_candidate_path(tn_b, lp.path_steps)
            cores = [(torch.randn(n.dims, generator=gen) * 0.2).to(device)
                     for n in tn.nodes if n.kind != "input"]
            n_in = int(np.prod(tn.nodes[-1].dims[1:]))
            x = torch.randn(tokens, n_in, generator=gen).to(device)

            def kernel():
                return streaming_tt.streaming_tt_linear(x, cores, tn_b, path,
                                                        block_tokens=bt)

            def plain():
                return streaming_tt.streaming_tt_linear_plain(x, cores, tn_b, path)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = 1e-4 * max(1.0, want.abs().max().item())
            if not torch.isfinite(got).all() or e > tol:
                raise AssertionError(
                    f"streaming_tt {plan_name}:{lp.name} tokens {tokens}: "
                    f"max abs err {e} > {tol}")
            err = max(err, e)
            if lp.name != "mlp.wg" or tokens not in (4, 32) or tokens in timing:
                continue
            # one PyTorch call for the same function: einsum over X and cores
            eq = _einsum_equation(tn)
            x3 = x.reshape((tokens,) + tn.nodes[-1].dims[1:])

            def library():
                return torch.einsum(eq, x3, *cores[::-1])

            assert (library().reshape(tokens, -1) - want).abs().max().item() <= tol
            prog = streaming_tt.program_for(tn_b, path, bt)
            full = streaming_tt._rebatch(tn, tokens)
            macs = sum(g.macs for g in full.gemm_sequence(lp.path_steps))
            nbytes = 4 * (x.numel() + sum(c.numel() for c in cores)
                          + tokens * prog.out_dim)
            b_ms, b_by = bound(nbytes, 2 * macs)
            ms, host_ms = timed(kernel)
            timing[tokens] = dict(
                at=f"{lp.name} ({plan_name}), tokens {tokens}, kernel token "
                   f"block {prog.block_tokens}, {len(prog.free_steps)} token-free "
                   f"+ {len(prog.tok_steps)} token steps",
                ms=ms, host_ms=host_ms, plain_ms=timed(plain)[0],
                library_ms=timed(library)[0], bound_ms=b_ms, bound_by=b_by)
    log(f"  streaming_tt: {len(seen)} (layer, path, tokens) cases, "
        f"max abs err {err:.3e}")
    t4 = timing[4]
    log(f"  streaming_tt at {t4['at']}: kernel {_fmt(t4['ms'])} ms (host "
        f"{_fmt(t4['host_ms'])} ms), plain {_fmt(t4['plain_ms'])} ms, library "
        f"{_fmt(t4['library_ms'])} ms, bound {_fmt(t4['bound_ms'])} ms "
        f"({t4['bound_by']})")
    return dict(name="streaming_tt", max_abs_err=err, **timing[32])


def _einsum_equation(tn) -> str:
    """One einsum over X and the cores (input side first), output (b, i...)."""
    letters = {}
    for n in tn.nodes:
        for e in n.edges:
            letters.setdefault(e, chr(ord("a") + len(letters)))
    x = tn.nodes[-1]
    cores = [n for n in tn.nodes if n.kind != "input"][::-1]
    outs = [x.edges[0]] + sorted((e for n in cores for e in n.edges
                                  if e.startswith("i")), key=lambda e: int(e[1:]))
    terms = ["".join(letters[e] for e in n.edges) for n in [x] + cores]
    return ",".join(terms) + "->" + "".join(letters[e] for e in outs)


def check_tt_gemm(device, layers) -> list[dict]:
    import torch

    from repro_torch.kernels import ops, tt_gemm

    shapes = {"OS": set(), "WS": set(), "IS": set()}
    for plan_name, lp, tn in layers:
        tokens = (4,) if "decode" in plan_name else (32, 37, 1)
        for t in tokens:
            full = tn.__class__([
                n.__class__(n.name, n.edges, (t,) + n.dims[1:], n.kind)
                if n.kind == "input" else n for n in tn.nodes])
            for g in full.gemm_sequence(lp.path_steps):
                shapes[lp.dataflow].add((g.M, g.K, g.N, lp.tiling.block_m,
                                         lp.tiling.block_k, lp.tiling.block_n))
    out = []
    gen = torch.Generator().manual_seed(2)
    for df, cases in shapes.items():
        err, best = 0.0, None
        for (m, k, n, bm, bk, bn) in sorted(cases):
            a = torch.randn(m, k, generator=gen).to(device)
            b = torch.randn(k, n, generator=gen).to(device)
            blocks = dict(block_m=ops.clamp_block(bm, m), block_k=ops.clamp_block(bk, k),
                          block_n=ops.clamp_block(bn, n))
            got = tt_gemm.tt_gemm(a, b, dataflow=df, **blocks)
            want = tt_gemm.tt_gemm_plain(a, b, dataflow=df, **blocks)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = 1e-5 * max(1.0, want.abs().max().item())
            if not torch.isfinite(got).all() or e > tol:
                raise AssertionError(f"tt_gemm {df} {(m, k, n)} {blocks}: "
                                     f"max abs err {e} > {tol}")
            row = tt_gemm.tt_gemm(a[:1].contiguous(), b, dataflow=df, **blocks)
            if not torch.equal(row[0], got[0]):
                raise AssertionError(f"tt_gemm {df}: row 0 depends on M")
            err = max(err, e)
            if best is None or m * k * n > best[0][0] * best[0][1] * best[0][2]:
                best = ((m, k, n), a, b, blocks)
        (m, k, n), a, b, blocks = best
        b_ms, b_by = bound(4 * (m * k + k * n + m * n), 2 * m * k * n)
        ms, host_ms = timed(lambda: tt_gemm.tt_gemm(a, b, dataflow=df, **blocks))
        rec = dict(
            name=f"tt_gemm_{df.lower()}", max_abs_err=err,
            at=f"M,K,N={m},{k},{n} blocks {blocks['block_m']},{blocks['block_k']},"
               f"{blocks['block_n']}",
            ms=ms, host_ms=host_ms,
            plain_ms=timed(lambda: tt_gemm.tt_gemm_plain(a, b, dataflow=df,
                                                         **blocks))[0],
            library_ms=timed(lambda: torch.matmul(a, b))[0],
            bound_ms=b_ms, bound_by=b_by)
        log(f"  tt_gemm {df}: {len(cases)} main-path shapes, max abs err {err:.3e}")
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 4 and 5: serving and the output check
# ---------------------------------------------------------------------------

def serve_runs() -> tuple[dict, list[str]]:
    from repro_torch.kernels import launches
    from repro_torch.launch.serve import run

    full = os.path.join(PLANS, "tt-lm-100m.json")
    pair = ["--plan-prefill", os.path.join(PLANS, "tt-lm-100m.pair.prefill.json"),
            "--plan-decode", os.path.join(PLANS, "tt-lm-100m.pair.decode.json")]
    runs = [
        ("full plan, continuous", ["--plan", full, "--schedule", "continuous"]),
        ("full plan, oneshot", ["--plan", full, "--schedule", "oneshot"]),
        ("plan pair, continuous", pair + ["--schedule", "continuous"]),
        ("plan pair on tt_gemm, continuous",
         pair + ["--schedule", "continuous", "--plan-backend", "tt_gemm"]),
    ]
    notes, tokens = [], {}
    launches.reset()
    for label, argv in runs:
        before = launches.snapshot()
        log(f"--- serve: {label}")
        out = run(argv + SERVE)
        if out.code != 0:
            raise AssertionError(f"serve ({label}) exited {out.code}")
        delta = {k: out.launches[k] - before[k] for k in before}
        s = out.summary
        notes.append(f"{label}: {s['gen_tok_s']:.1f} gen tok/s, "
                     f"{s['total_tok_s']:.1f} total tok/s, ttft p50 "
                     f"{s['ttft_p50_ms']:.1f} ms, wall {s['wall_s']*1e3:.1f} ms, "
                     f"launches {delta}")
        tokens[label] = out.result.tokens_by_rid()
        for rid, toks in tokens[label].items():
            if len(toks) != 16 or not all(0 <= t < 32_000 for t in toks):
                raise AssertionError(f"{label}: request {rid} tokens {toks}")
    counts = launches.snapshot()
    if tokens["full plan, continuous"] != tokens["full plan, oneshot"]:
        raise AssertionError("continuous and oneshot serving disagree")
    notes.append("continuous == oneshot per request: yes")
    return counts, notes


def launches_per_call(device) -> list[str]:
    """Kernel launches of one prefill (32-token prompt) and one decode step
    (4 lanes) under each plan setting the serve phase used."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.models import api
    from repro_torch.plan import load_plan
    from repro_torch.serve import ServeEngine

    cfg = get_config("tt-lm-100m")
    full = load_plan(os.path.join(PLANS, "tt-lm-100m.json"))
    pre = load_plan(os.path.join(PLANS, "tt-lm-100m.pair.prefill.json"))
    dec = load_plan(os.path.join(PLANS, "tt-lm-100m.pair.decode.json"))
    params = api(cfg, device=device).init_params(0)
    notes = []
    for label, p, d, backend in (("full plan", full, full, None),
                                 ("plan pair", pre, dec, None),
                                 ("plan pair on tt_gemm", pre, dec, "tt_gemm")):
        eng = ServeEngine(cfg, params, n_slots=4, max_seq=48, prompt_bucket=8,
                          prefill_plan=p, decode_plan=d, arch="tt-lm-100m",
                          plan_backend=backend)
        launches.reset()
        _, small = eng.prefill_request(list(range(1, 33)))
        per_prefill = {k: v for k, v in launches.snapshot().items() if v}
        caches = eng.admit(eng.fresh_caches(), small, 0)
        launches.reset()
        eng.decode(np.array([5, 0, 0, 0]), np.array([32, 0, 0, 0]), caches)
        per_decode = {k: v for k, v in launches.snapshot().items() if v}
        notes.append(f"{label}: launches per prefill {per_prefill}, "
                     f"per decode step {per_decode}")
    return notes


def decode_profile(device) -> list[str]:
    """Where a full-width decode step (full plan, 4 busy lanes) spends its
    time: host wall per step, the card's busy time per step from
    ``torch.profiler``, and the kernels that take the most of it.  A
    measurement only: when the profiler records no device time the lines
    say "not measured" and the run goes on."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.plan import load_plan
    from repro_torch.serve import ServeEngine

    cfg = get_config("tt-lm-100m")
    plan = load_plan(os.path.join(PLANS, "tt-lm-100m.json"))
    eng = ServeEngine(cfg, api(cfg, device=device).init_params(0), n_slots=4,
                      max_seq=64, prompt_bucket=8, prefill_plan=plan,
                      decode_plan=plan, arch="tt-lm-100m")
    caches = eng.fresh_caches()
    for lane in range(4):
        _, small = eng.prefill_request(list(range(1 + lane, 33 + lane)))
        caches = eng.admit(caches, small, lane)
    tok, pos = np.array([7, 8, 9, 10]), np.array([32, 32, 32, 32])

    def steps(n):
        nonlocal caches
        for i in range(n):
            _, caches = eng.decode(tok, pos + i, caches)

    steps(3)
    torch.cuda.synchronize()
    n = 5
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps(n)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        avgs = prof.key_averages()
    except Exception as e:  # the profiler is optional instrumentation here
        return [f"decode step profile: not measured ({type(e).__name__}: {e})"]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    busy = sum(dev_us(e) for e in avgs) / 1e3 / n
    if busy <= 0:
        return [f"decode step (full plan, 4 lanes): {wall:.2f} ms wall; card "
                "busy time not measured (the profiler saw no device time)"]
    top = sorted(avgs, key=dev_us, reverse=True)[:6]
    return [f"decode step (full plan, 4 lanes, torch.profiler over {n} steps): "
            f"{wall:.2f} ms wall, card busy {busy:.2f} ms "
            f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%",
            "  top device time per step: " + "; ".join(
                f"{e.key[:48]} {dev_us(e) / 1e3 / n:.3f} ms x{e.count // n}"
                for e in top)]


def output_check(device) -> list[str]:
    """Kernel path vs the plain executor, on the card, at full width; and
    tt-lm-smoke on the card vs the CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.plan import load_plan

    notes = []
    cfg = get_config("tt-lm-100m")
    plan = load_plan(os.path.join(PLANS, "tt-lm-100m.json"))
    toks = torch.randint(0, cfg.vocab, (1, 32),
                         generator=torch.Generator().manual_seed(5)).to(device)
    m = api(cfg, plan=plan, device=device)
    params = m.init_params(0)
    planned, _ = m.prefill_full(params, {"tokens": toks}, 48)
    plain, _ = api(cfg, plan=None, device=device).prefill_full(
        params, {"tokens": toks}, 48)
    torch.cuda.synchronize()
    if planned.shape != (1, 32, cfg.vocab) or not torch.isfinite(planned).all():
        raise AssertionError(f"bad logits {tuple(planned.shape)}")
    e = (planned - plain).abs().max().item()
    scale = plain.abs().max().item()
    if e > 1e-4 * max(scale, 1e-3) + 1e-6:
        raise AssertionError(f"planned vs plain logits differ by {e} (scale {scale})")
    notes.append(f"full-width prefill logits, kernels vs plain executor on the "
                 f"card: max abs diff {e:.3e} (max |logit| {scale:.3e})")

    smoke = get_config("tt-lm-100m", smoke=True)
    splan = load_plan(os.path.join(PLANS, "tt-lm-smoke.json"))
    sm_cpu = api(smoke, plan=splan, device="cpu")
    p_cpu = sm_cpu.init_params(0)
    st = toks[:, :12].cpu() % smoke.vocab
    want, _ = sm_cpu.prefill_full(p_cpu, {"tokens": st}, 16)
    sm_gpu = api(smoke, plan=splan, device=device)
    got, _ = sm_gpu.prefill_full(sm_gpu.init_params(0), {"tokens": st.to(device)}, 16)
    e2 = (got.cpu() - want).abs().max().item()
    if e2 > 1e-4:
        raise AssertionError(f"tt-lm-smoke card vs CPU logits differ by {e2}")
    notes.append(f"tt-lm-smoke prefill logits, card vs CPU: max abs diff {e2:.3e}")
    return notes


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("error: run chip_smoke.py from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    t_start = time.perf_counter()
    try:
        card = card_line()
        log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        per_src = _build.build_all()
        log(f"build: {time.perf_counter() - t0:.1f} s wall "
            f"({', '.join(f'{k} {v:.1f} s' for k, v in per_src.items())})")
        for name in _build.SOURCES:
            ptxas = [ln.strip() for ln in
                     (_build.BUILD_DIR / f"{name}.log").read_text().splitlines()
                     if "registers" in ln or "spill" in ln]
            log(f"  ptxas {name}: " + " | ".join(ptxas))

        log("--- kernels against their plain versions")
        layers = main_path_layers()
        kernels = [check_streaming(device, layers)] + check_tt_gemm(device, layers)
        for k in kernels:
            log(f"  {k['name']} at {k['at']}: kernel {_fmt(k['ms'])} ms (host "
                f"{_fmt(k['host_ms'])} ms), plain {_fmt(k['plain_ms'])} ms, "
                f"library {_fmt(k['library_ms'])} ms, bound "
                f"{_fmt(k['bound_ms'])} ms ({k['bound_by']})")

        counts, notes = serve_runs()
        for n in notes:
            log(f"  {n}")
        log(f"main-path launches: {counts}")
        for name in ("streaming_tt", "tt_gemm_os", "tt_gemm_ws", "tt_gemm_is"):
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the main path")

        for n in (launches_per_call(device) + decode_profile(device)
                  + output_check(device)):
            log(f"  {n}")

        bad = sorted(k for k in sys.modules
                     if k in ("jax", "repro") or k.startswith(("jax.", "repro.")))
        if bad:
            raise AssertionError(f"the JAX package was imported: {bad[:5]}")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    sources = {"streaming_tt": ("src/repro_torch/csrc/streaming_tt.cu",
                                "src/repro/kernels/streaming_tt.py:149"),
               "tt_gemm_os": ("src/repro_torch/csrc/tt_gemm.cu",
                              "src/repro/kernels/tt_gemm.py:178"),
               "tt_gemm_ws": ("src/repro_torch/csrc/tt_gemm.cu",
                              "src/repro/kernels/tt_gemm.py:178"),
               "tt_gemm_is": ("src/repro_torch/csrc/tt_gemm.cu",
                              "src/repro/kernels/tt_gemm.py:178")}
    report = {"kernels": [
        {"name": k["name"], "route": "cuda", "source": sources[k["name"]][0],
         "replaces": sources[k["name"]][1], "launches": counts[k["name"]],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"], "at": k["at"]}
        for k in kernels]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _fmt(ms: float) -> str:
    return f"{ms:.4f}"


if __name__ == "__main__":
    sys.exit(main())
