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
(dense, moe, hybrid, rwkv, vlm); an encoder-decoder arch exits 2, since
the pipeline makes no encoder frames.

With ``--plan`` every TT projection contracts along the planned paths
through the planned CUDA kernels, forward and backward, and the run ends
with the reference's two acceptance lines: the forward and backward
backends of the execution log, and the fused chain runs.

Across ranks: under ``torchrun --nproc-per-node N`` (``WORLD_SIZE > 1``),
or in a process whose ``torch.distributed`` group is already up, every
rank makes the same global batches from ``--seed`` under the sharding
rules of ``make_test_mesh()`` (:mod:`repro_torch.launch.mesh`).  Where the
batch axes divide ``--batch``, each rank takes its block of every batch
(``batch_shardings``) and computes the model on it, as the reference's
partitioned step does (``src/repro/launch/train.py:63-65,87``); on a model
axis over 1 each rank of a model group computes its block of the heads,
d_ff and the vocab (:mod:`repro_torch.sharding`), the loss is the same on
every rank of it, and no gradient is summed over it after the backward:
its loss is its share of the global mean, and the step sums every
gradient over the batch axes before the clip (``launch/steps.py``).
Where the policy turns SP on (an arch but RWKV whose kv heads do not
divide the model axis, or a run of 200 000 positions or more) each rank
of a model group takes its block of the positions instead (the layout
line names it, e.g. ``sequence 128 of 512 a rank``), its loss is its
share of them, and the step sums the gradients over the model axis too.
Where they do not, the batch stays replicated and each planned TT projection
splits its tokens over the ranks, forward and backward
(:mod:`repro_torch.plan.sharded`).  The report names the layout.  Each
rank keeps the AdamW moments of its block of every leaf
``param_shardings`` splits.  Ranks join as in ``launch.serve``
(:func:`repro_torch.launch.ranks.join_ranks`).  Rank 0 writes the
checkpoints (:class:`repro_torch.checkpoint.RankCheckpointManager`) and
prints the report, with the reference's ``sharded planned execution: mesh
...`` line; every rank checks that all ranks reached the same losses and
parameters (exit 5 if not).  ``run(..., tt_model_reduce=True)`` turns on
the row-parallel reduction, a library switch as in the reference (no
flag).

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
        --smoke --plan src/repro_torch/plans/tt-lm-smoke.train.json --steps 2
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager, RankCheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.kernels import launches
from repro_torch.launch.mesh import (
    LayoutBlocks,
    ParamShards,
    batch_layout,
    batch_shardings,
    describe_layout,
    make_rules,
    make_test_mesh,
)
from repro_torch.launch.ranks import Ranks, join_ranks, ranks_agree
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.models.config import ShapeConfig
from repro_torch.models.lm import count_params
from repro_torch.nn import install_plan, kept_plan
from repro_torch.optim import (
    AdamWState,
    adamw_init,
    compress_init,
    linear_warmup_cosine,
)
from repro_torch.plan import (
    BACKENDS,
    check_plan_for_config,
    execution_log,
    load_plan,
    reset_execution_log,
)
from repro_torch.plan.sharded import (
    BWD_COLLECTIVES,
    COLLECTIVES,
    reset_collectives,
)
from repro_torch.runtime import FaultTolerantLoop, StragglerMonitor
from repro_torch.sharding import use_rules
from repro_torch.tree import leaves, map_indexed

EXIT_RANKS_DISAGREE = 5  # ranks reached different losses or parameters


@dataclasses.dataclass
class TrainRun:
    """What :func:`run` returns: the exit code, the parameter count and,
    per step run, the loss, the global gradient norm (before clipping),
    the wall seconds of the train step (forward, backward, update; the
    synthetic batch is made before the clock starts), the kernel launches
    (a rematerialised forward counts again) and the sharded route's
    collectives (``{"fwd": {...}, "bwd": {...}}``, zero on one rank)."""

    code: int
    losses: list = dataclasses.field(default_factory=list)
    grad_norms: list = dataclasses.field(default_factory=list)
    step_s: list = dataclasses.field(default_factory=list)
    launches: list = dataclasses.field(default_factory=list)
    collectives: list = dataclasses.field(default_factory=list)
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


def _map_moments(state: dict, fn) -> dict:
    """``state`` with ``fn(i, leaf)`` over the AdamW moments' leaves (``i``
    the leaf's place in the parameters' order)."""
    opt = state["opt"]
    adam = opt if isinstance(opt, AdamWState) else opt[0]
    adam = adam._replace(m=map_indexed(fn, adam.m), v=map_indexed(fn, adam.v))
    return {**state, "opt": adam if isinstance(opt, AdamWState)
            else (adam, *opt[1:])}


def _rank_checkpoints(ckpt_dir: str, ranks: Ranks,
                      shards: ParamShards) -> RankCheckpointManager:
    """Rank 0 writes the state with every moment gathered whole (the
    reference's layout); every rank restores and keeps its block."""
    def whole(state):
        return _map_moments(state, lambda i, t: shards.gather(i, t)
                            if shards.split(i) else t)

    def whole_like(state):
        return _map_moments(state, lambda i, t: t.new_empty(shards.shapes[i])
                            if shards.split(i) else t)

    def local(state):
        return _map_moments(state, lambda i, t: shards.block(i, t).clone()
                            if shards.split(i) else t)

    return RankCheckpointManager(ckpt_dir, keep=3, rank=ranks.rank, whole=whole,
                                 whole_like=whole_like, local=local,
                                 barrier=dist.barrier)


def _state_digest(losses: list, params) -> bytes:
    """The losses and every parameter's bytes: what the ranks must agree on."""
    parts = [repr(losses).encode()]
    parts += [p.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
              for p in leaves(params)]
    return b"".join(parts)


def run(argv=None, *, tt_model_reduce: bool = False) -> TrainRun:
    """Parse ``argv``, train, print the report; see :class:`TrainRun`.

    ``tt_model_reduce`` turns on the rules' row-parallel reduction over the
    model axis (several ranks only)."""
    ap = parser()
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(pass --device cpu to run the plain versions)", file=sys.stderr)
        return TrainRun(2)
    if args.plan_backend is not None and not args.plan:
        ap.error("--plan-backend needs --plan")
    ranks = join_ranks(device.type)
    device = ranks.device(device)
    try:
        with open(os.devnull, "w") as sink:
            # rank 0 prints the report; errors reach stderr from every rank
            with (contextlib.redirect_stdout(sink) if ranks.rank
                  else contextlib.nullcontext()), kept_plan():
                # the plan the run installs is the run's alone
                return _train(args, device, ranks, tt_model_reduce)
    finally:
        if ranks.owned:
            dist.destroy_process_group()


def _train(args, device, ranks: Ranks, tt_model_reduce: bool) -> TrainRun:
    cfg = get_config(args.arch, tt=not args.dense, smoke=args.smoke)
    if cfg.family == "encdec":
        # the reference's train CLI feeds the same pipeline to an encdec arch
        # and fails at its first step (KeyError: 'frontend')
        print("error: the data pipeline yields tokens and labels only; an "
              "encoder-decoder arch also needs encoder frames "
              "(batch['frontend']): train it through api().train_loss and "
              "launch.steps.make_train_step", file=sys.stderr)
        return TrainRun(2)
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
    reset_collectives()
    rules = make_rules(cfg, ShapeConfig("cli", args.seq, args.batch, "train"),
                       make_test_mesh())
    if tt_model_reduce:
        rules = dataclasses.replace(rules, tt_model_reduce=True)
    rules = batch_layout(rules, args.batch)
    if ranks.world > 1:
        print("layout: " + describe_layout(rules, args.batch, "sequences", cfg,
                                           args.seq))
    with use_rules(rules):
        return _loop(args, cfg, device, ranks, rules)


def _loop(args, cfg, device, ranks: Ranks, rules) -> TrainRun:
    m = api(cfg, device=device)
    params = m.init_params(torch.Generator().manual_seed(args.seed))
    out = TrainRun(0, n_params=count_params(params))
    print(f"{cfg.name}: {out.n_params} parameters ({cfg.family}, {cfg.dtype}, "
          f"remat {cfg.remat}, loss_chunk {cfg.loss_chunk})")
    shards = ParamShards(params, rules.mesh) if ranks.world > 1 else None
    opt = adamw_init(params, shards)
    if args.grad_compress:
        opt = (opt, compress_init(params))
    state = _trainable({"params": params, "opt": opt})
    pipe = make_pipeline(cfg.vocab, args.seq, args.batch, seed=args.seed)
    lr = linear_warmup_cosine(args.lr, args.warmup, args.steps)
    step_fn = make_train_step(cfg, lr=lr, grad_compress=args.grad_compress,
                              shards=shards)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt")
    mgr = (CheckpointManager(ckpt_dir, keep=3) if shards is None
           else _rank_checkpoints(ckpt_dir, ranks, shards))
    start = 0
    if args.resume and mgr.latest_step() is not None:
        start, state = mgr.restore(state)
        state = _trainable(state)
        print(f"resumed from step {start}")

    monitor = StragglerMonitor()
    t_start = time.time()

    def one_step(state, step):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in pipe.batch(step).items()}
        if rules.batch_split:
            batch = LayoutBlocks(batch_shardings(batch, rules), rules).block(batch)
        batch = {k: v.to(device) for k, v in batch.items()}
        before = launches.snapshot()
        coll = dict(COLLECTIVES), dict(BWD_COLLECTIVES)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])      # waits for the step to finish
        gn = float(metrics["grad_norm"])
        out.step_s.append(time.perf_counter() - t0)
        after = launches.snapshot()
        out.launches.append({k: after[k] - before[k] for k in after})
        bwd = {k: BWD_COLLECTIVES[k] - coll[1][k] for k in BWD_COLLECTIVES}
        out.collectives.append({
            "fwd": {k: COLLECTIVES[k] - coll[0][k] - bwd[k] for k in COLLECTIVES},
            "bwd": bwd})
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
    if ranks.world > 1 and not ranks_agree(
            ranks, _state_digest(out.losses, state["params"]), device):
        print(f"error: rank {ranks.rank}: the {ranks.world} ranks reached "
              "different losses or parameters", file=sys.stderr)
        out.code = EXIT_RANKS_DISAGREE
        return out
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
        meshes = sorted({r["mesh"] for r in log} - {""})
        if meshes:
            shapes = sorted({tuple(r["shard_shape"]) for r in log
                             if r["shard_shape"]})
            where = ("on the CPU" if device.type == "cpu" else
                     f"{ranks.world} ranks share one card" if ranks.shared_card
                     else "one card per rank")
            print(f"sharded planned execution: mesh {' '.join(meshes)}, "
                  "per-shard (tokens, d_in) "
                  + " ".join(str(s) for s in shapes)
                  + f" ({ranks.world} ranks, backend {ranks.backend}, {where})")
    if out.step_s:
        steady = out.step_s[1:] or out.step_s
        ms = 1e3 * sum(steady) / len(steady)
        print(f"train step: {ms:.1f} ms mean over {len(steady)} step(s) "
              f"after the first, {args.batch * args.seq / ms * 1e3:.1f} "
              f"tokens/s, device {device}")
        if ranks.world > 1:
            c = out.collectives[-1]
            print(f"collectives a step (the last): forward {c['fwd']}, "
                  f"backward {c['bwd']}")
    print(f"finished at step {done}; stragglers flagged: {monitor.flagged}")
    return out


def main(argv=None) -> int:
    return run(argv).code


if __name__ == "__main__":
    raise SystemExit(main())
