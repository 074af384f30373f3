"""Training driver: data pipeline -> train step -> fault-tolerant loop.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --plan src/repro_torch/plans/tt-lm-100m.train.json --steps 3

Port of ``src/repro/launch/train.py`` with the same flags minus the mesh,
plus ``--device`` (default ``cuda``; the run fails when no card is
present, ``--device cpu`` runs the plain versions of the kernels) and
``--seed`` (weights from a ``torch.Generator``, data from the reference's
pipeline).  The loop composes deterministic resumable data, AdamW with a
warmup-cosine schedule, async atomic checkpoints, straggler monitoring and
preemption-safe shutdown; ``--grad-compress`` round-trips the gradients
through int8 error feedback before AdamW.  Every causal family trains
(dense, moe, hybrid, rwkv, vlm).

With ``--plan`` every TT projection contracts along the planned paths
through the planned CUDA kernels, forward and backward, and the run ends
with the reference's two acceptance lines: the forward and backward
backends of the execution log, and the fused chain runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.kernels import launches
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.models.lm import count_params
from repro_torch.nn import install_plan
from repro_torch.optim import adamw_init, compress_init, linear_warmup_cosine
from repro_torch.plan import (
    BACKENDS,
    check_plan_for_config,
    execution_log,
    load_plan,
    reset_execution_log,
)
from repro_torch.runtime import FaultTolerantLoop, StragglerMonitor
from repro_torch.tree import leaves


@dataclasses.dataclass
class TrainRun:
    """What :func:`run` returns: the exit code, the parameter count and,
    per step run, the loss, the global gradient norm (before clipping),
    the wall seconds of the train step (forward, backward, update; the
    synthetic batch is made before the clock starts) and the kernel
    launches (a rematerialised forward counts again)."""

    code: int
    losses: list = dataclasses.field(default_factory=list)
    grad_norms: list = dataclasses.field(default_factory=list)
    step_s: list = dataclasses.field(default_factory=list)
    launches: list = dataclasses.field(default_factory=list)
    fwd_backends: list = dataclasses.field(default_factory=list)
    bwd_backends: list = dataclasses.field(default_factory=list)
    fused_runs: int = 0
    done: int = 0
    n_params: int = 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="tt-lm-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0,
                    help="weight and data seed")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt "
                         "under the system temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="install a DSE execution plan (ideally --mode "
                         "train): projections contract along the planned "
                         "paths through the planned CUDA kernels, forward "
                         "and backward")
    ap.add_argument("--plan-backend", default=None, choices=BACKENDS,
                    help="force one kernel backend for every plan layer "
                         "(jnp = the plain executor)")
    return ap


def _trainable(state: dict) -> dict:
    for p in leaves(state["params"]):
        p.requires_grad_(True)
    return state


def run(argv=None) -> TrainRun:
    """Parse ``argv``, train, print the report; see :class:`TrainRun`."""
    ap = parser()
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(pass --device cpu to run the plain versions)", file=sys.stderr)
        return TrainRun(2)
    if args.plan_backend is not None and not args.plan:
        ap.error("--plan-backend needs --plan")

    cfg = get_config(args.arch, tt=not args.dense, smoke=args.smoke)
    install_plan(None)
    if args.plan:
        plan = load_plan(args.plan)
        problems = check_plan_for_config(plan, args.arch, cfg)
        if problems:
            print("error: plan/model mismatch: " + "; ".join(problems),
                  file=sys.stderr)
            return TrainRun(2)
        install_plan(plan, force_backend=args.plan_backend)
        backends = sorted({lp.backend for lp in plan.layers})
        forced = (f", backends forced to {args.plan_backend}"
                  if args.plan_backend else "")
        print(f"installed plan {args.plan} (backends {backends}{forced})")
    reset_execution_log()

    m = api(cfg, device=device)
    params = m.init_params(torch.Generator().manual_seed(args.seed))
    out = TrainRun(0, n_params=count_params(params))
    print(f"{cfg.name}: {out.n_params} parameters ({cfg.family}, {cfg.dtype}, "
          f"remat {cfg.remat}, loss_chunk {cfg.loss_chunk})")
    opt = adamw_init(params)
    if args.grad_compress:
        opt = (opt, compress_init(params))
    state = _trainable({"params": params, "opt": opt})
    pipe = make_pipeline(cfg.vocab, args.seq, args.batch, seed=args.seed)
    lr = linear_warmup_cosine(args.lr, args.warmup, args.steps)
    step_fn = make_train_step(cfg, lr=lr, grad_compress=args.grad_compress)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt")
    mgr = CheckpointManager(ckpt_dir, keep=3)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        start, state = mgr.restore(state)
        state = _trainable(state)
        print(f"resumed from step {start}")

    monitor = StragglerMonitor()
    t_start = time.time()

    def one_step(state, step):
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in pipe.batch(step).items()}
        before = launches.snapshot()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])      # waits for the step to finish
        gn = float(metrics["grad_norm"])
        out.step_s.append(time.perf_counter() - t0)
        after = launches.snapshot()
        out.launches.append({k: after[k] - before[k] for k in after})
        out.losses.append(loss)
        out.grad_norms.append(gn)
        if step % args.log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  gnorm {gn:.3f}  "
                  f"({time.time() - t_start:.1f}s)", flush=True)
        return {"params": params, "opt": opt}

    loop = FaultTolerantLoop(one_step, mgr, checkpoint_every=args.ckpt_every,
                             straggler=monitor, on_restore=_trainable)
    state, done = loop.run(state, start, args.steps - start)
    mgr.save(done, state)
    out.done = done
    if args.plan:
        log = execution_log()
        out.fwd_backends = sorted({r["backend"] for r in log
                                   if r["phase"] == "fwd"})
        out.bwd_backends = sorted({r["backend"] for r in log
                                   if r["phase"] == "bwd"})
        print(f"planned execution under grad: fwd backends "
              f"{out.fwd_backends}, bwd backends {out.bwd_backends}")
        out.fused_runs = sum(1 for r in log if r.get("segment")
                             and r["segment"][1] - r["segment"][0] >= 2)
        if out.fused_runs:
            print(f"fused segments under grad: {out.fused_runs} chain runs "
                  "(on-chip intermediates)")
    if out.step_s:
        steady = out.step_s[1:] or out.step_s
        ms = 1e3 * sum(steady) / len(steady)
        print(f"train step: {ms:.1f} ms mean over {len(steady)} step(s) "
              f"after the first, {args.batch * args.seq / ms * 1e3:.1f} "
              f"tokens/s, device {device}")
    print(f"finished at step {done}; stragglers flagged: {monitor.flagged}")
    return out


def main(argv=None) -> int:
    return run(argv).code


if __name__ == "__main__":
    raise SystemExit(main())
