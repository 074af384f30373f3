#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of tt-lm-100m serving and training on one
NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order; any failure exits non-zero and prints no result line:

1. card: ``nvidia-smi`` name and power limit.
2. build: ``nvcc`` builds ``src/repro_torch/csrc/*.cu``, one process per
   source, all started together.
3. kernels: every CUDA kernel of the serving and training paths (K1
   ``streaming_tt``, K2-K4 ``tt_gemm`` OS/WS/IS, K5 ``fused_path``) against
   its plain PyTorch version at the shapes the main paths give it, plus
   ragged token counts; K1 also at the train step's 2048 tokens, forward
   and through every dx network; K5 also bit for bit against the per-step
   CUDA ``tt_gemm`` route.  Per kernel: max abs error, kernel ms, plain ms,
   ``library_ms`` (PyTorch calls that compute the same function; used
   nowhere in the port) and the bound (bytes over 3.35 TB/s or fp32 FLOPs
   over 67 TFLOP/s, the larger).  Every OS and IS shape of a decode step
   is timed by CUDA-graph replay beside one ``torch.matmul``, with the sum
   weighted by its launches per decode step.
4. serve: full-width tt-lm-100m with random weights from a seed, through
   ``python -m repro_torch.launch.serve``'s code path: the full plan with
   ``--strict-plan`` (continuous, then oneshot: the tokens must match), the
   plan pair, and the pair with ``--plan-backend tt_gemm`` (the dataflow
   kernels).  Launch counts are zeroed just before and read just after.
5. per call: launches of one prefill and one decode step per plan
   setting; a decode step's wall time, the card's busy share and the
   device time of the setting's kernels (``torch.profiler``), under the
   full plan (K1) and under the pair on ``tt_gemm`` (K2 + K4).
6. check: prefill logits through the kernels agree with the plain
   executor on the card; tt-lm-smoke on the card agrees with the CPU.
7. train: full-width tt-lm-100m through ``python -m
   repro_torch.launch.train``'s code path, batch 8 x seq 256, 3 AdamW steps
   under each committed train plan (``tt-lm-100m.train.json``: K1 forward
   and dx, tt_gemm weight gradients; ``tt-lm-100m.train.tt_gemm.json``: K5
   fused segments forward, tt_gemm backward).  Launch counts are zeroed
   just before and read just after; per plan the losses, step ms, tokens/s,
   launches per step and the execution log's backends, and one profiled
   step (``torch.profiler``).
8. train check: the first step's loss and gradient norm through the
   kernels against the same step on the plain executor (``--plan-backend
   jnp``) on the card, rel 1e-4; a one-step tt-lm-smoke train on the card
   against the CPU.

TF32 is off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are False): the model is fp32.

The last two lines before the final one are the kernels JSON and the
card's ``name, power.limit``; the last line is the ``{"ok": true, ...}``
JSON.  The kernels JSON gives each kernel's launches per main path,
``{"serve": n, "train": m}``, each path's counts zeroed just before it
and read just after; the run fails unless every kernel of
:data:`SERVE_KERNELS` launched on the serve path and every kernel of
:data:`TRAIN_KERNELS` on the train path.  Nothing of JAX or of the JAX
package is imported.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
PLANS = os.path.join(SRC, "repro_torch", "plans")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores

SERVE = ["--batch", "4", "--n-requests", "8", "--prompt-len", "32",
         "--gen", "16", "--strict-plan"]

#: kernels each main path must launch: serving runs K1 under the auto plan
#: and K2-K4 under ``--plan-backend tt_gemm``; training runs K1 forward and
#: dx, K3 WS weight gradients and K5 fused segments
SERVE_KERNELS = ("streaming_tt", "tt_gemm_os", "tt_gemm_ws", "tt_gemm_is")
TRAIN_KERNELS = ("streaming_tt", "tt_gemm_ws", "fused_path")
#: the CUDA functions of each kernel: a profile sums them, since one
#: wrapper call may launch two
KERNEL_FUNCTIONS = {"K1 streaming_tt": ("tt_free_kernel", "tt_stream_kernel"),
                    "K2 tt_gemm_os": ("os_kernel",),
                    "K3 tt_gemm_ws": ("ws_kernel", "ws_fold_kernel"),
                    "K4 tt_gemm_is": ("is_kernel",),
                    "K5 fused_path": ("pack_kernel", "fused_kernel")}
#: the kernels each profile sums: a train step, and a decode step under
#: each (label, prefill plan, decode plan, --plan-backend) setting
TRAIN_PROFILE = ("K1 streaming_tt", "K3 tt_gemm_ws", "K5 fused_path")
DECODE_SETTINGS = (
    ("full plan", "tt-lm-100m.json", "tt-lm-100m.json", None,
     ("K1 streaming_tt",)),
    ("plan pair on tt_gemm", "tt-lm-100m.pair.prefill.json",
     "tt-lm-100m.pair.decode.json", "tt_gemm", ("K2 tt_gemm_os", "K4 tt_gemm_is")))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(text: str) -> list[str]:
    """``function: registers, spill stores / loads`` for each entry function
    of an ``nvcc -Xptxas -v`` log (mangled names cut to the kernel's)."""
    out, name, spill = [], None, ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
            name, spill = None, ""
    return out


def _kernel_name(mangled: str) -> str:
    """The last name of a mangled (nested) name, with its template
    arguments left mangled: ``tt_stream_kernel``, ``os_kernelILi1ELb1EE``."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if mangled[i:i + 1] == "I":
        depth, k = 0, i
        while k < len(mangled):
            depth += {"I": 1, "L": 1, "E": -1}.get(mangled[k], 0)
            k += 1
            if depth == 0:
                break
        name += mangled[i:k]
    return name


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


def graph_ms(fn, reps: int = 20) -> float | None:
    """ms per call on the card with the host's enqueue taken out: ``reps``
    calls captured in one CUDA graph, the graph replayed 5 times between
    CUDA events.  Where ``timed`` reports the host's pace (small kernels
    behind Python wrappers), this is the device's.  None when the calls
    cannot be captured (a measurement only; the run goes on); a failure
    of the calls themselves, in the warm-up before the capture, raises."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (5 * reps)
    except Exception as e:  # capture is optional instrumentation here
        log(f"  (graph timing not measured: {type(e).__name__}: {e})")
        torch.cuda.synchronize()
        return None


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
    """K1 at every streaming layer of the serving plans (1, 4, 32 and 37
    tokens) and at every dx network of ``tt-lm-100m.train.json`` (37 and
    2048 tokens) against its plain version within 1e-4 of the output's
    scale.  Timed beside one ``torch.einsum`` (library) and the bound:
    mlp.wg at 4, 32 and 2048 tokens, and mlp.wd's dx network at 2048 (the
    train step's shapes).  The kernels line carries the 32-token row."""
    import torch

    from repro_torch.kernels import ops, streaming_tt
    from repro_torch.plan.executor import as_candidate_path

    cases = []
    for plan_name, lp, tn in layers:
        if lp.backend == "streaming_tt":
            timed_layer = lp.name == "mlp.wg" and plan_name == "tt-lm-100m.json"
            cases += [(f"{lp.name} ({plan_name})", lp.path_steps, tn, t,
                       lp.tiling.block_tokens, timed_layer and t in (4, 32))
                      for t in (1, 4, 32, 37)]
    for name, steps, tn in dx_networks():
        cases += [(f"{name} dx ({TRAIN_PLANS[0]})", steps, tn, t, 256,
                   name == "mlp.wd" and t == 2048) for t in (37, 2048)]
    mlp_wg = next(c for c in cases if c[0].startswith("mlp.wg (tt-lm-100m.json)"))
    cases.append(mlp_wg[:3] + (2048, mlp_wg[4], True))
    seen, err, timing = set(), 0.0, {}
    gen = torch.Generator().manual_seed(1)
    for label, steps, tn, tokens, plan_block, timed_case in cases:
        key = (label.split(" (")[0], steps, tokens)
        if key in seen:
            continue
        seen.add(key)
        bt = ops.clamp_block(plan_block, tokens)
        tn_b = streaming_tt._rebatch(tn, bt)
        path = as_candidate_path(tn_b, steps)
        cores = [(torch.randn(n.dims, generator=gen) * 0.2).to(device)
                 for n in tn.nodes if n.kind != "input"]
        n_in = math.prod(streaming_tt._stream_node(tn).dims[1:])
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
            raise AssertionError(f"streaming_tt {label} tokens {tokens}: "
                                 f"max abs err {e} > {tol}")
        err = max(err, e)
        if not timed_case:
            continue
        library = _einsum_call(tn, x, cores)
        assert (library() - want).abs().max().item() <= tol
        prog = streaming_tt.program_for(tn_b, path)
        grid = streaming_tt.launch_grid(
            prog, tokens, torch.cuda.get_device_properties(device).multi_processor_count)
        full = streaming_tt._rebatch(tn, tokens)
        macs = sum(g.macs for g in full.gemm_sequence(steps))
        nbytes = 4 * (x.numel() + sum(c.numel() for c in cores) + got.numel())
        b_ms, b_by = bound(nbytes, 2 * macs)
        ms, host_ms = timed(kernel)
        timing[label.split(" (")[0], tokens] = dict(
            at=f"{label}, tokens {tokens}: {len(prog.free_ops)} token-free ops in "
               f"one launch, then {len(prog.tok_ops)} token steps over tiles of "
               f"{grid.tile} x {grid.slices} column slices ({grid.blocks} x "
               f"{grid.slices} blocks, {grid.smem_bytes} B shared memory)",
            ms=ms, host_ms=host_ms, graph_ms=graph_ms(kernel),
            plain_ms=timed(plain)[0], library_ms=timed(library)[0],
            library_graph_ms=graph_ms(library), bound_ms=b_ms, bound_by=b_by)
    log(f"  streaming_tt: {len(seen)} (layer, path, tokens) cases, "
        f"max abs err {err:.3e}")
    for t in timing.values():
        log(f"  streaming_tt at {t['at']}: kernel {_fmt(t['ms'])} (host "
            f"{_fmt(t['host_ms'])}, graph {_fmt(t['graph_ms'])}), plain "
            f"{_fmt(t['plain_ms'])}, library {_fmt(t['library_ms'])} (graph "
            f"{_fmt(t['library_graph_ms'])}), bound {_fmt(t['bound_ms'])} "
            f"({t['bound_by']})")
    return dict(name="streaming_tt", max_abs_err=err, **timing["mlp.wg", 32])


def dx_networks():
    """(layer, planned dx steps, grad-input network) of every layer whose dx
    streams through K1 under ``tt-lm-100m.train.json``, as
    ``ops.tt_linear_backward`` builds them."""
    from repro_torch.configs import get_config
    from repro_torch.core.backward import grad_input_network
    from repro_torch.dse_cli import model_dse_layers
    from repro_torch.kernels import streaming_tt
    from repro_torch.plan import load_plan

    families = {n.split("[")[0]: tn for n, tn in
                model_dse_layers(get_config("tt-lm-100m"), tokens=8)}
    out = []
    for lp in load_plan(os.path.join(PLANS, TRAIN_PLANS[0])).layers:
        op = next((o for o in lp.backward if o.wrt == "dx"), None)
        if op is None or op.backend != "streaming_tt" or lp.name == "head":
            continue
        net = grad_input_network(families[lp.name])
        out.append((lp.name, streaming_tt._path_for(net, op.path_steps).steps, net))
    return out


def _einsum_call(tn, x, cores):
    """One ``torch.einsum`` over X and the cores (the streamed node first,
    the cores from the last node back), in the plain version's output
    layout ``(tokens, out_dim)``."""
    import torch

    from repro_torch.kernels import streaming_tt

    letters = {}
    for n in tn.nodes:
        for e in n.edges:
            letters.setdefault(e, chr(ord("a") + len(letters)))
    stream = streaming_tt._stream_node(tn)
    core_nodes = [n for n in tn.nodes if n.kind != "input"]
    out_edges = streaming_tt._stream_layout(tn)[3]
    eq = (",".join("".join(letters[e] for e in n.edges)
                   for n in [stream] + core_nodes[::-1])
          + "->" + "".join(letters[e] for e in out_edges))
    x3 = x.reshape((x.shape[0],) + stream.dims[1:])
    ops_ = [x3] + list(cores)[::-1]
    return lambda: torch.einsum(eq, *ops_).reshape(x.shape[0], -1)


def check_tt_gemm(device, layers) -> list[dict]:
    """Every tt_gemm shape of the serving paths (decode at 4 lanes, prefill
    at 32, 37 and 1 tokens), with the plan's blocks clamped as the executor
    clamps them, against the plain version within 1e-5 of the output's
    scale, and row 0 bit for bit against a one-row call.  Every OS and IS
    shape (all of them decode shapes) is timed by CUDA-graph replay beside
    one ``torch.matmul``, and weighted by its launches per decode step (4
    lanes: its count in the decode plan x the model's layers), so a small
    shape that got slower shows beside the largest one.  One record per
    dataflow at its largest shape for the kernels line."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, tt_gemm

    n_layers = get_config("tt-lm-100m").n_layers
    shapes = {"OS": set(), "WS": set(), "IS": set()}
    per_step: dict = {}
    for plan_name, lp, tn in layers:
        tokens = (4,) if "decode" in plan_name else (32, 37, 1)
        for t in tokens:
            full = tn.__class__([
                n.__class__(n.name, n.edges, (t,) + n.dims[1:], n.kind)
                if n.kind == "input" else n for n in tn.nodes])
            for g in full.gemm_sequence(lp.path_steps):
                key = (g.M, g.K, g.N, ops.clamp_block(lp.tiling.block_m, g.M),
                       ops.clamp_block(lp.tiling.block_k, g.K),
                       ops.clamp_block(lp.tiling.block_n, g.N))
                shapes[lp.dataflow].add(key)
                if "decode" in plan_name:
                    per_step[lp.dataflow, key] = (
                        per_step.get((lp.dataflow, key), 0) + n_layers)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    grids = {"OS": tt_gemm.os_grid, "IS": tt_gemm.is_grid}
    out = []
    gen = torch.Generator().manual_seed(2)
    for df, cases in shapes.items():
        err, best, rows = 0.0, None, []
        for key in sorted(cases):
            m, k, n, bm, bk, bn = key
            a = torch.randn(m, k, generator=gen).to(device)
            b = torch.randn(k, n, generator=gen).to(device)
            blocks = dict(block_m=bm, block_k=bk, block_n=bn)
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
            if df == "WS":
                continue
            rows.append(((m, k, n), tuple(blocks.values()),
                         grids[df](m, k, n, n_sm=n_sm, **blocks).blocks,
                         per_step.get((df, key), 0),
                         graph_ms(lambda: tt_gemm.tt_gemm(a, b, dataflow=df, **blocks)),
                         graph_ms(lambda: torch.matmul(a, b))))
        (m, k, n), a, b, blocks = best
        b_ms, b_by = bound(4 * (m * k + k * n + m * n), 2 * m * k * n)
        ms, host_ms = timed(lambda: tt_gemm.tt_gemm(a, b, dataflow=df, **blocks))
        rec = dict(
            name=f"tt_gemm_{df.lower()}", max_abs_err=err,
            at=f"M,K,N={m},{k},{n} blocks {blocks['block_m']},{blocks['block_k']},"
               f"{blocks['block_n']}",
            ms=ms, host_ms=host_ms,
            graph_ms=graph_ms(lambda: tt_gemm.tt_gemm(a, b, dataflow=df, **blocks)),
            plain_ms=timed(lambda: tt_gemm.tt_gemm_plain(a, b, dataflow=df,
                                                         **blocks))[0],
            library_ms=timed(lambda: torch.matmul(a, b))[0],
            library_graph_ms=graph_ms(lambda: torch.matmul(a, b)),
            bound_ms=b_ms, bound_by=b_by)
        log(f"  tt_gemm {df}: {len(cases)} main-path shapes, max abs err {err:.3e}")
        for mkn, blk, n_blocks, count, k_ms, lib_ms in rows:
            log(f"    {df} M,K,N={mkn} blocks {blk}: {n_blocks} CUDA blocks, "
                f"kernel graph {_fmt(k_ms)}, torch.matmul graph {_fmt(lib_ms)}, "
                f"x{count} per decode step")
        if rows and all(r[4] is not None and r[5] is not None for r in rows):
            log(f"  tt_gemm {df} per decode step (4 lanes, "
                f"{sum(r[3] for r in rows)} launches, graph ms x launches): "
                f"kernel {sum(r[3] * r[4] for r in rows):.4f} ms, torch.matmul "
                f"{sum(r[3] * r[5] for r in rows):.4f} ms")
        out.append(rec)
    return out


def _replay(work, i, j, contract):
    (ea, ta), (eb, tb) = work[i], work[j]
    shared = [x for x in ea if x in eb]
    val = contract(ta, tb, ([ea.index(x) for x in shared],
                            [eb.index(x) for x in shared]))
    ec = tuple(x for x in ea if x not in shared) + tuple(
        x for x in eb if x not in shared)
    return [w for k, w in enumerate(work) if k not in (i, j)] + [(ec, val)]


def check_fused(device) -> dict:
    """K5 at the full-width segments of attn.wq, mlp.wg and mlp.wd under
    ``tt-lm-100m.train.tt_gemm.json`` (path steps [4, 6): X (tokens x
    d_in) @ (d_in x 16), then (d_out x 16) @ (16 x tokens)), at the train
    step's 2048 tokens and at 37: against the plain version, and bit for
    bit against the per-step CUDA tt_gemm route with the plan's dataflow
    and blocks."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dse_cli import model_dse_layers
    from repro_torch.kernels import fused_path, ops
    from repro_torch.plan import load_plan

    plan = load_plan(os.path.join(PLANS, "tt-lm-100m.train.tt_gemm.json"))
    gen = torch.Generator().manual_seed(3)
    err, timing = 0.0, {}
    for name in ("attn.wq", "mlp.wg", "mlp.wd"):
        lp = plan.layer(name)
        (s0, e0) = next(g for g in lp.segments if g[1] - g[0] >= 2)
        blocks = dict(block_m=lp.tiling.block_m, block_k=lp.tiling.block_k,
                      block_n=lp.tiling.block_n)
        for tokens in (2048, 37):
            tn = dict((n.split("[")[0], t) for n, t in model_dse_layers(
                get_config("tt-lm-100m"), tokens=tokens))[name]
            work = [(n.edges, (torch.randn(n.dims, generator=gen) * 0.3).to(device))
                    for n in tn.nodes]
            contract = ops.gemm_contract(dataflow=lp.dataflow, **blocks)
            for (i, j) in lp.path_steps[:s0]:
                work = _replay(work, i, j, contract)
            chain = lp.path_steps[s0:e0]

            def kernel():
                return fused_path.fused_segment_contract(
                    work, chain, block_tokens=lp.tiling.block_tokens, **blocks)

            def plain():
                return fused_path.fused_segment_contract_plain(work, chain, **blocks)

            (ec, got), (_, want) = kernel(), plain()
            w = list(work)
            for (i, j) in chain:
                w = _replay(w, i, j, contract)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = 1e-5 * max(1.0, want.abs().max().item())
            if not torch.isfinite(got).all() or e > tol:
                raise AssertionError(f"fused_path {name} tokens {tokens}: max abs "
                                     f"err {e} > {tol}")
            if w[-1][0] != ec or not torch.equal(w[-1][1], got):
                raise AssertionError(f"fused_path {name} tokens {tokens}: not bit-"
                                     "identical to the per-step tt_gemm route")
            err = max(err, e)
            if tokens != 2048:
                continue
            # library: the same two steps as two torch.matmul calls; the
            # batch-free operands' permutes are weight layout, made outside
            # (inputs in first-use order: X, the input-side merge (r, j..),
            # the output-side merge (i.., r, i..))
            pos, _, _ = fused_path._compile_segment(
                [(e_, tuple(t_.shape)) for e_, t_ in work], chain, "b")
            (_, x_t), (_, w_in), (w_out_e, w_out_t) = (work[p] for p in pos)
            r_ax = [k for k, e_ in enumerate(w_out_e) if e_.startswith("r")]
            w_out2 = w_out_t.permute([k for k in range(w_out_t.dim()) if k not in r_ax]
                                     + r_ax).reshape(-1, w_in.shape[0]).contiguous()
            x2 = x_t.reshape(tokens, -1)
            w_in2 = w_in.reshape(w_in.shape[0], -1)

            def library():
                return torch.matmul(w_out2, torch.matmul(x2, w_in2.t()).t())

            le = (library().reshape(got.shape) - want).abs().max().item()
            if le > 1e-4 * max(1.0, want.abs().max().item()):
                raise AssertionError(f"fused_path library check off by {le}")
            d_in, d_out, r = x2.shape[1], w_out2.shape[0], w_in.shape[0]
            nbytes = 4 * (x2.numel() + w_in.numel() + w_out_t.numel() + got.numel())
            b_ms, b_by = bound(nbytes, 2 * tokens * r * (d_in + d_out))
            n_sm = torch.cuda.get_device_properties(device).multi_processor_count
            prog = fused_path.program_for(work, chain, block_k=blocks["block_k"],
                                          block_tokens=lp.tiling.block_tokens,
                                          n_sm=n_sm)
            ms, host_ms = timed(kernel)
            timing[name] = dict(
                at=f"{name} segment {[s0, e0]}, tokens {tokens}: ({tokens} x {d_in})"
                   f" @ ({d_in} x {r}) then ({d_out} x {r}) @ ({r} x {tokens}); "
                   f"kernel token block {prog.block_tokens}, "
                   f"{prog.n_token_blocks} blocks, {prog.smem_bytes} B shared "
                   f"memory, {prog.packed_bytes} B of packed batch-free operands",
                ms=ms, host_ms=host_ms, graph_ms=graph_ms(kernel),
                plain_ms=timed(plain)[0], library_ms=timed(library)[0],
                library_graph_ms=graph_ms(library), bound_ms=b_ms, bound_by=b_by)
    for name, t in timing.items():
        log(f"  fused_path at {t['at']}: kernel {_fmt(t['ms'])} (host "
            f"{_fmt(t['host_ms'])}, graph {_fmt(t['graph_ms'])}), plain "
            f"{_fmt(t['plain_ms'])}, library {_fmt(t['library_ms'])} "
            f"(graph {_fmt(t['library_graph_ms'])}), bound "
            f"{_fmt(t['bound_ms'])} ({t['bound_by']})")
    log(f"  fused_path: 3 layers x (2048, 37) tokens, max abs err {err:.3e}, "
        "bit-identical to the per-step CUDA tt_gemm route: yes")
    return dict(name="fused_path", max_abs_err=err, **timing["mlp.wg"])


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


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)


def device_time(avgs) -> tuple[float, float, list]:
    """(ms the card was busy, ms of every event's device time summed, the
    device events by time).  Only events that ran on the card (kernels,
    copies) count as busy time: a host-side op (an aten op, an autograd
    Function) also carries the device time of the kernels it launched,
    so summing every event counts those kernels twice."""
    from torch.autograd import DeviceType

    on_card = [e for e in avgs if e.device_type == DeviceType.CUDA]
    return (sum(_dev_us(e) for e in on_card) / 1e3,
            sum(_dev_us(e) for e in avgs) / 1e3,
            sorted(on_card, key=_dev_us, reverse=True))


def kernel_split(top, busy: float, n: int, kernels) -> list[str]:
    """Device ms per step of each kernel in ``kernels`` (its CUDA
    functions of :data:`KERNEL_FUNCTIONS` summed) over ``n`` profiled
    steps whose card was busy ``busy`` ms a step, and their sum."""
    lines, grand = [], 0.0
    for kernel in kernels:
        names = KERNEL_FUNCTIONS[kernel]
        parts = {fn: [e for e in top if re.search(rf"\b{fn}\b", e.key)]
                 for fn in names}
        ms = {fn: sum(_dev_us(e) for e in es) / 1e3 / n for fn, es in parts.items()}
        total = sum(ms.values())
        grand += total
        lines.append(
            f"  {kernel}: {total:.3f} ms a step ({100 * total / busy:.1f}% of busy)"
            " = " + " + ".join(
                f"{fn} {ms[fn]:.3f} ms x{sum(e.count for e in parts[fn]) // n}"
                f" ({100 * ms[fn] / total if total else 0:.1f}%)" for fn in names))
    if len(kernels) > 1:
        lines.append(f"  {' + '.join(k.split()[0] for k in kernels)}: {grand:.3f} "
                     f"ms a step ({100 * grand / busy:.1f}% of busy)")
    return lines


def decode_profile(device) -> list[str]:
    """Where a full-width decode step (4 busy lanes) spends its time under
    each plan setting: host wall per step, the card's busy time per step
    from ``torch.profiler``, the kernels that take the most of it, and the
    device time of the setting's own kernels.  A measurement only: when
    the profiler records no device time the lines say "not measured" and
    the run goes on."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.plan import load_plan
    from repro_torch.serve import ServeEngine

    cfg = get_config("tt-lm-100m")
    params = api(cfg, device=device).init_params(0)
    notes = []
    for label, pre, dec, backend, kernels in DECODE_SETTINGS:
        eng = ServeEngine(cfg, params, n_slots=4, max_seq=64, prompt_bucket=8,
                          prefill_plan=load_plan(os.path.join(PLANS, pre)),
                          decode_plan=load_plan(os.path.join(PLANS, dec)),
                          arch="tt-lm-100m", plan_backend=backend)
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
            notes.append(f"decode step profile ({label}): not measured "
                         f"({type(e).__name__}: {e})")
            continue

        busy, every, top = device_time(avgs)
        busy, every = busy / n, every / n
        if busy <= 0:
            notes.append(f"decode step ({label}, 4 lanes): {wall:.2f} ms wall; card "
                         "busy time not measured (the profiler saw no device time)")
            continue
        notes += [f"decode step ({label}, 4 lanes, torch.profiler over {n} steps): "
                  f"{wall:.2f} ms wall, card busy {busy:.2f} ms "
                  f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}% "
                  f"(device events only; every event's device time summed: "
                  f"{every:.2f} ms)",
                  "  top device time per step: " + "; ".join(
                      f"{e.key[:48]} {_dev_us(e) / 1e3 / n:.3f} ms x{e.count // n}"
                      for e in top[:6])]
        notes += kernel_split(top, busy, n, kernels)
    return notes


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


# ---------------------------------------------------------------------------
# phase 7 and 8: training and the train check
# ---------------------------------------------------------------------------

TRAIN = ["--batch", "8", "--seq", "256", "--log-every", "1"]
TRAIN_PLANS = ("tt-lm-100m.train.json", "tt-lm-100m.train.tt_gemm.json")


def train_runs(ckpt_root: str) -> tuple[dict, dict, list[str]]:
    """Three full-width train steps under each committed train plan.
    Returns (launch counts of the whole phase, step-0 metrics per plan,
    report lines)."""
    from repro_torch.kernels import launches
    from repro_torch.launch.train import run

    notes, first = [], {}
    launches.reset()
    for name in TRAIN_PLANS:
        log(f"--- train: {name}")
        out = run(["--plan", os.path.join(PLANS, name), "--steps", "3",
                   "--ckpt-dir", os.path.join(ckpt_root, name)] + TRAIN)
        if out.code != 0 or len(out.losses) != 3:
            raise AssertionError(f"train ({name}) exited {out.code}")
        if not all(math.isfinite(x) for x in out.losses + out.grad_norms):
            raise AssertionError(f"train ({name}): non-finite loss {out.losses}")
        steady = out.step_s[1:]
        ms = 1e3 * sum(steady) / len(steady)
        per_step = {k: v for k, v in out.launches[-1].items() if v}
        notes.append(
            f"{name}: losses {[round(x, 6) for x in out.losses]}, grad norms "
            f"{[round(x, 6) for x in out.grad_norms]}; step ms first "
            f"{1e3 * out.step_s[0]:.1f}, then {[round(1e3 * t, 1) for t in steady]}"
            f" (mean {ms:.1f}); {8 * 256 / ms * 1e3:.1f} train tokens/s; "
            f"launches per step {per_step}; fwd backends {out.fwd_backends}, "
            f"bwd backends {out.bwd_backends}, fused chain runs {out.fused_runs}")
        first[name] = (out.losses[0], out.grad_norms[0])
    return launches.snapshot(), first, notes


def train_check(device, first: dict, ckpt_root: str) -> list[str]:
    """Step 0 through the kernels against the plain executor on the card;
    a one-step tt-lm-smoke train on the card against the CPU."""
    from repro_torch.launch.train import run

    notes = []
    plain = run(["--plan", os.path.join(PLANS, TRAIN_PLANS[0]), "--plan-backend",
                 "jnp", "--steps", "1", "--ckpt-dir",
                 os.path.join(ckpt_root, "jnp")] + TRAIN)
    if plain.code != 0:
        raise AssertionError(f"plain-executor train exited {plain.code}")
    want = (plain.losses[0], plain.grad_norms[0])
    for name, got in first.items():
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        if max(rel) > 1e-4:
            raise AssertionError(f"{name}: step-0 loss/grad norm {got} vs plain "
                                 f"executor {want} (rel {rel})")
        notes.append(f"{name}: step-0 loss {got[0]:.7f}, grad norm {got[1]:.7f}; "
                     f"plain executor on the card {want[0]:.7f}, {want[1]:.7f} "
                     f"(rel {rel[0]:.1e}, {rel[1]:.1e})")
    smoke = ["--smoke", "--plan", os.path.join(PLANS, "tt-lm-smoke.train.tt_gemm.json"),
             "--steps", "1", "--batch", "2", "--seq", "16"]
    res = {dev: run(smoke + ["--device", dev, "--ckpt-dir",
                             os.path.join(ckpt_root, f"smoke-{dev}")])
           for dev in ("cpu", str(device))}
    got, want = res[str(device)], res["cpu"]
    rel = max(abs(got.losses[0] - want.losses[0]) / abs(want.losses[0]),
              abs(got.grad_norms[0] - want.grad_norms[0]) / abs(want.grad_norms[0]))
    if got.code or want.code or rel > 1e-4:
        raise AssertionError(f"tt-lm-smoke train step, card vs CPU: rel {rel}")
    notes.append(f"tt-lm-smoke one train step, card vs CPU: loss "
                 f"{got.losses[0]:.7f} vs {want.losses[0]:.7f}, grad norm "
                 f"{got.grad_norms[0]:.7f} vs {want.grad_norms[0]:.7f} (rel {rel:.1e})")
    return notes


def weight_grad_gemms(device) -> list[str]:
    """The tt_gemm GEMMs of one full-width backward pass under
    ``tt-lm-100m.train.json`` (weight gradients at 2048 tokens, the plan's
    dataflow and blocks), grouped by shape.  Each distinct shape must equal
    the OS kernel bit for bit, and the plain version within rtol 1e-5 and
    atol 1e-5 x max(1, the output's largest magnitude) as the CUDA tests
    hold it (K runs to 2048).  Each is timed once on the kernel and
    weighted by its count per step, which says which GEMMs the step's
    tt_gemm time goes to, beside its plain version, one ``torch.matmul``
    (library) and the bound."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.backward import backward_networks
    from repro_torch.dse_cli import _block_specs
    from repro_torch.kernels import ops, tt_gemm
    from repro_torch.plan import load_plan

    cfg = get_config("tt-lm-100m")
    plan = load_plan(os.path.join(PLANS, TRAIN_PLANS[0]))
    specs = {sp.name: (sp, n) for sp, n, _ in _block_specs(cfg)}
    shapes: dict = {}
    for lp in plan.layers:
        if lp.name == "head":
            continue   # tied to the embedding: never executes
        spec, count = specs[lp.name]
        nets = dict(backward_networks(spec.network(2048)))
        for op in lp.backward:
            if op.backend != "tt_gemm":
                continue
            for g in nets[op.wrt].gemm_sequence(op.path_steps):
                key = (lp.dataflow, g.M, g.K, g.N,
                       ops.clamp_block(op.tiling.block_m, g.M),
                       ops.clamp_block(op.tiling.block_k, g.K),
                       ops.clamp_block(op.tiling.block_n, g.N))
                shapes[key] = shapes.get(key, 0) + count
    gen = torch.Generator().manual_seed(4)
    rows = []
    for (df, m, k, n, bm, bk, bn), count in shapes.items():
        a = torch.randn(m, k, generator=gen).to(device)
        b = torch.randn(k, n, generator=gen).to(device)
        blocks = dict(block_m=bm, block_k=bk, block_n=bn)
        got = tt_gemm.tt_gemm(a, b, dataflow=df, **blocks)
        if not torch.equal(got, tt_gemm.tt_gemm(a, b, dataflow="OS", **blocks)):
            raise AssertionError(f"tt_gemm {df} M,K,N={(m, k, n)} blocks "
                                 f"{(bm, bk, bn)}: not bit-identical to OS")
        want = tt_gemm.tt_gemm_plain(a, b, dataflow=df, **blocks)
        err = (got - want).abs()
        tol = 1e-5 * want.abs() + 1e-5 * max(1.0, want.abs().max().item())
        if not torch.isfinite(got).all() or bool((err > tol).any()):
            raise AssertionError(f"tt_gemm {df} M,K,N={(m, k, n)}: max abs err "
                                 f"{err.max().item()} against the plain version")

        def kernel():
            return tt_gemm.tt_gemm(a, b, dataflow=df, **blocks)

        ms, _ = timed(kernel, reps=20, warmup=3)
        dev_ms = graph_ms(kernel)
        plain = timed(lambda: tt_gemm.tt_gemm_plain(a, b, dataflow=df, **blocks),
                      reps=5, warmup=1)[0]
        lib = timed(lambda: torch.matmul(a, b), reps=20, warmup=3)[0]
        lib_dev = graph_ms(lambda: torch.matmul(a, b))
        b_ms, b_by = bound(4 * (m * k + k * n + m * n), 2 * m * k * n)
        grid = (tt_gemm.ws_grid(m, k, n, n_sm=torch.cuda.get_device_properties(
            device).multi_processor_count, **blocks).blocks if df == "WS" else None)
        rows.append((ms * count, ms, count, df, (m, k, n), (bm, bk, bn), plain,
                     lib, b_ms, b_by, grid, dev_ms, lib_dev, err.max().item()))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    return [f"weight-gradient tt_gemm GEMMs per train step ({TRAIN_PLANS[0]}): "
            f"{sum(r[2] for r in rows)} launches of {len(rows)} shapes, "
            f"{total:.2f} ms timed one shape at a time; every shape "
            "bit-identical to OS and within tolerance of the plain version: "
            "yes"] + [
        f"  {df} M,K,N={mkn} blocks {blk}: kernel {_fmt(ms)} x{count} = "
        f"{tot:.2f} ms ({grid} blocks; graph {_fmt(dev_ms)}), plain "
        f"{_fmt(plain)}, library {_fmt(lib)} (graph {_fmt(lib_dev)}), "
        f"bound {b_ms:.5f} ms ({b_by}); max abs err vs plain {e:.3e}"
        for tot, ms, count, df, mkn, blk, plain, lib, b_ms, b_by, grid, dev_ms,
        lib_dev, e in rows]


def train_profile(device) -> list[str]:
    """Where one full-width train step goes, per train plan: host wall,
    the card's busy time (``torch.profiler``) and the kernels that take
    the most of it.  A measurement only: without device time the lines
    say "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.nn import install_plan
    from repro_torch.optim import adamw_init
    from repro_torch.plan import load_plan
    from repro_torch.tree import leaves

    cfg = get_config("tt-lm-100m")
    notes = []
    for name in TRAIN_PLANS:
        install_plan(load_plan(os.path.join(PLANS, name)))
        params = api(cfg, device=device).init_params(0)
        for p in leaves(params):
            p.requires_grad_(True)
        opt = adamw_init(params)
        step = make_train_step(cfg)
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in make_pipeline(cfg.vocab, 256, 8).batch(0).items()}
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt, _ = step(params, opt, batch)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            avgs = prof.key_averages()
        except Exception as e:  # the profiler is optional instrumentation here
            notes.append(f"{name} train step profile: not measured "
                         f"({type(e).__name__}: {e})")
            continue

        busy, _, top = device_time(avgs)
        if busy <= 0:
            notes.append(f"{name} train step: {wall:.1f} ms wall (profiled); card "
                         "busy time not measured (no device time recorded)")
            continue
        notes.append(f"{name} train step (torch.profiler, 1 step): {wall:.1f} ms "
                     f"wall, card busy {busy:.1f} ms ({100 * busy / wall:.1f}%), "
                     f"idle {100 * (1 - busy / wall):.1f}%")
        notes.append("  top device time: " + "; ".join(
            f"{e.key[:40]} {_dev_us(e) / 1e3:.2f} ms x{e.count}" for e in top[:8]))
        notes += kernel_split(top, busy, 1, TRAIN_PROFILE)
    install_plan(None)
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
            log(f"  ptxas {name}: " + " | ".join(
                ptxas_summary((_build.BUILD_DIR / f"{name}.log").read_text())))

        log("--- kernels against their plain versions")
        layers = main_path_layers()
        kernels = ([check_streaming(device, layers)] + check_tt_gemm(device, layers)
                   + [check_fused(device)])
        for k in kernels:
            log(f"  {k['name']} at {k['at']}: kernel {_fmt(k['ms'])} (host "
                f"{_fmt(k['host_ms'])}, graph {_fmt(k['graph_ms'])}), "
                f"plain {_fmt(k['plain_ms'])}, "
                f"library {_fmt(k['library_ms'])} (graph "
                f"{_fmt(k.get('library_graph_ms'))}), bound "
                f"{_fmt(k['bound_ms'])} ({k['bound_by']})")

        serve_counts, notes = serve_runs()
        for n in notes:
            log(f"  {n}")
        log(f"serve-path launches: {serve_counts}")
        for name in SERVE_KERNELS:
            if serve_counts[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     "serve path")

        for n in (launches_per_call(device) + decode_profile(device)
                  + output_check(device)):
            log(f"  {n}")

        with tempfile.TemporaryDirectory() as ckpt_root:
            train_counts, first, notes = train_runs(ckpt_root)
            for n in notes:
                log(f"  {n}")
            log(f"train-path launches: {train_counts}")
            for name in TRAIN_KERNELS:
                if train_counts[name] <= 0:
                    raise AssertionError(f"kernel {name} never launched on the "
                                         "train path")
            for n in (train_check(device, first, ckpt_root) + train_profile(device)
                      + weight_grad_gemms(device)):
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
                              "src/repro/kernels/tt_gemm.py:178"),
               "fused_path": ("src/repro_torch/csrc/fused_path.cu",
                              "src/repro/kernels/fused_path.py:286")}
    report = {"kernels": [
        {"name": k["name"], "route": "cuda", "source": sources[k["name"]][0],
         "replaces": sources[k["name"]][1],
         "launches": {"serve": serve_counts[k["name"]],
                      "train": train_counts[k["name"]]},
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "graph_ms": k["graph_ms"],
         "plain_ms": k["plain_ms"],
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


def _fmt(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4g} ms"


if __name__ == "__main__":
    sys.exit(main())
