#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of tt-lm-100m serving and training, and of
full-width qwen2-moe-a2.7b, zamba2-1.2b, rwkv6-7b and seamless-m4t-medium
serving and training, on one NVIDIA card, on one process and on ranks
that share it (chatglm3-6b with its sequence split over them); run the
dry run of one cell of
every architecture, hold one dry-run cell against the card, and run the
examples.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order; any failure exits non-zero and prints no result line:

1. card: ``nvidia-smi`` name and power limit.
2. build: ``nvcc`` builds ``src/repro_torch/csrc/*.cu``, one process per
   source, all started together.
2a. dryrun: (a) the dry run's CLI (``python -m repro_torch.launch.dryrun
   --arch A --shape S``) for one shape of every arch
   (:data:`DRYRUN_CELLS`: every step kind and the long-context skip) at
   full width on the single-pod production mesh (16 x 16), shapes only on
   ``meta``, with cost, one process per cell, :data:`DRYRUN_WORKERS` at a time
   (:data:`DRYRUN_TIMEOUT_S`): every cell ``ok``, or ``skipped`` with the
   reference's reason; the roofline table over the cells (H100 peaks).
   (b) meanwhile, in this process: full-width tt-lm-100m's train step
   (seq 256 x batch 8, no plan) traced on ``meta`` against the same step
   on the card under ``FlopCounterMode``: the FLOPs equal, the predicted
   peak within 0.5-2x of ``torch.cuda.max_memory_allocated``.  (c)
   started with (a): ``examples/quickstart_torch.py`` and
   ``train_tt_lm_torch.py --steps 40`` on the card and the host-only
   ``dse_explore_torch.py``, each a process with a time limit
   (:data:`EXAMPLE_TIMEOUT_S`): each exits 0, and the quickstart's planned
   layer launches a kernel (its last line, the launch counts of its
   process).
2b. dse: the port's DSE (``python -m repro_torch.dse`` through
   ``dse_cli.main``, in process, no JAX) emits every committed plan of
   ``src/repro_torch/plans/`` with the argv of :data:`EMIT` into a
   scratch directory; each must equal the committed file byte for byte.
   Every later phase loads the emitted plans, so the main path runs the
   port's own DSE -> compiler -> install -> kernels.  Each plan's emit
   seconds on the host CPU are printed beside the card.  The full-width
   rank search (``tt-lm-100m.rank.json``: ``--rank-search budget --search
   guided``, 15 decompositions) is recorded on the way for phase 3b.
2c. tune: the autotuner (``python -m repro_torch.tune`` and
   ``repro_torch.dse --tune``, in process, the cache in the scratch
   directory) times K1-K5 by CUDA-graph replay: 47 measurements on a cold
   cache, a ``--tune cache`` plan A (replayed: 0 measurements, the same
   bytes), a ``--plan-backend tt_gemm --tune measure`` plan B (75) and the
   fused sweep (21 K5 variants against 4 per-step routes, 100 in all).
   Full-width tt-lm-100m is then served under A and B (continuous ==
   oneshot, every kernel their layers name launched, the banner says
   autotuned, logits against the plain executor), each beside the
   analytic plan of its backend (:func:`tune_phase`).
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
   weighted by its launches per decode step.  In bf16 (operands widened
   to fp32 by the wrappers, one cast of the result): K1 at mlp.wg with 32
   tokens, K2-K4 at 64,128,16, 37,2048,16 and 32,16,256 and K5 at the
   mlp.wg segment against their plain versions at 8e-2 (the reference's
   bf16 tolerance), and WS == OS == IS bit for bit at each GEMM shape.
   The experts' batched launches (:func:`check_batched`): batched K1 at
   qwen2-moe-a2.7b's ``moe.eu`` / ``moe.ed`` over 60 experts at a served
   step's 4 slots and the train step's 172 (forward and dx) and batched
   K3 at every weight-gradient GEMM of those layers, each against its
   batched plain version, bit for bit against the 60 unbatched launches,
   timed beside them, one batched library call and the bound; then one
   full-width MoE layer's forward and backward under
   ``torch.cuda.set_sync_debug_mode("error")`` (:func:`moe_sync_check`).
3b. rank space: every candidate of the full-width rank search compiles to
   the plan it would emit; K1 runs each layer's path at 4, 32 and 2048
   tokens and K2-K4 each path's GEMMs at 4 and 32 tokens (WS == OS == IS
   bit for bit) against the plain versions.  A layer K1 refuses is listed
   (and fails the run on the chosen candidate).  K1 (mlp.wg) and every
   GEMM of the chosen candidate are timed beside ``torch.einsum`` /
   ``torch.matmul`` and the bound.
4. serve: full-width tt-lm-100m with random weights from a seed, through
   ``python -m repro_torch.launch.serve``'s code path: the full plan with
   ``--strict-plan`` (continuous, then oneshot: the tokens must match), the
   plan pair, the pair with ``--plan-backend tt_gemm`` (the dataflow
   kernels), and the rank-searched plan (continuous, oneshot: the tokens
   must match; continuous with ``--plan-backend tt_gemm``).  Launch counts
   are zeroed just before and read just after, and read again around the
   rank plan's runs, which must launch K1 and each of its layers' dataflow
   kernels.
4a. shards (after the serve phase): full-width tt-lm-100m served by 2
   ranks (``data=2``) and by 4 ranks (``data=2 x model=2`` with
   ``tt_model_reduce``), processes of this script (``--shard-rank``)
   that share ``cuda:0`` over ``gloo``, each spawn with a time limit,
   through ``launch.serve.run`` under the ``--shards 2`` plan pair with
   its own backends (K1) and forced to tt_gemm (K2, K3, K4), 8 requests
   (prompt 32, gen 16, 4 slots, continuous), under the batch layout: a
   data rank holds and decodes 2 of the 4 lanes, the batch-1 prefill is
   replicated.  2 ranks: the tokens of the single-device oneshot run and
   its fp32 prefill logits bit for bit; the fp32 logits of a decode step
   of all 4 lanes (gathered) within 1e-4 x max |logit| on 2 and 4 ranks
   (whether bit for bit is printed); 4 ranks: prefill logits within
   1e-4 x max |logit| (the all-reduce and the repeated-KV attention
   reorder sums; tokens are reported).  A decode step on 2 ranks under
   the pair's own backends sends the logits' gather alone.  On 4 ranks
   each rank of a model group holds 2 of the 4 kv heads (its KV-cache
   bytes exactly half the 2-rank run's), half of d_ff and half of the
   vocab; a decode step's collectives equal :func:`step_collectives`
   (PERF.md's formula) and rank 0's layout line names the split.  Every rank's
   records sit at their mesh and per-shard shapes (the local rows), no
   kernel layer runs on the plain executor, every rank launches K1
   (auto) and K2, K3, K4 (tt_gemm); wall seconds and gen tok/s per run
   ("N ranks sharing one card, not a scaling figure"), per-shard shapes
   and the gloo collectives per prefill and decode step are printed.
4a'. shard train (after the shard phase): full-width tt-lm-100m (fp32,
   seed 0, batch 8 x seq 256) trained by ranks sharing ``cuda:0`` over
   ``gloo`` (processes of this script, ``--shard-train-rank``, each spawn
   with a time limit) through ``launch.train.run``, 3 AdamW steps, each
   data rank on its 4 of the 8 sequences, the gradients summed over
   ``data``: (a) ``tt-lm-100m.shards2.train.json`` on 2 ranks
   (``data=2``); (b) the same plan on 4 (``data=2 x model=2``,
   ``tt_model_reduce``); (c) ``tt-lm-100m.shards2.train.tt_gemm.json`` on
   2 (K5 on a mesh); (d) in (a)'s spawn, one ``remat="full"`` step.  The
   oracle is the single device in this process under the same plan and
   seed: the step-0 loss and grad norm within rel 1e-4 and every leaf
   within the per-leaf bound of 4c; on 2 ranks the losses of steps 1-2
   within rel 1e-4 and, under (a), a step's collectives the loss's
   all-reduce and the gradients' alone; on 4 ranks (the model axis
   splitting heads, d_ff and the vocab) a step's collectives equal
   :func:`step_collectives` and the layout line names the split.  A
   rank's peak ``max_memory_allocated`` over its train run is at most
   0.65x the single device's, and on 4 ranks below the 2-rank run's.  Every record of a kernel layer (forward, the remat
   recompute, backward) sits at its mesh and per-shard shape, no kernel
   layer runs on the plain executor, every step launches K1 forward and
   dx and K3 (K3 and K5 under tt_gemm); collectives a step, step ms a
   rank and peak memory are printed.
4b. families (after the shard-train phase): full-width, full-depth
   qwen2-moe-a2.7b, zamba2-1.2b and rwkv6-7b (seed-0 weights, bf16 as
   configured) served through ``python -m repro_torch.launch.serve``'s code
   path under their plan pairs (emitted in the dse phase) with
   ``--strict-plan``, continuous then oneshot (the tokens must match);
   fp32 prefill logits through the kernels against the plain executor on
   the card (1e-4 x max |logit|; rwkv6-7b at 4 of its 32 layers, see
   :data:`FAMILY_CHECK_LAYERS`) and in bf16 (reported); launches of one
   prefill (K1, and K3 for zamba2 and rwkv6, required) and one decode step
   (K1 required; qwen2-moe's K1 launches, the experts' batched ones
   included, equal to :func:`moe_launches`' count from its plans, or the
   run fails); a profiled decode step and the peak device memory per
   arch; K1 and K3 at every new main-path shape against their plain
   versions, timed beside one ``torch.einsum`` / ``torch.matmul`` and the
   bound.
4c. families train (after the families phase): full-width, full-depth
   qwen2-moe-a2.7b, zamba2-1.2b and rwkv6-7b (seed-0 weights, bf16,
   ``remat="full"``, ``loss_chunk=256``) through ``python -m
   repro_torch.launch.train``'s code path under their train plans
   (emitted in the dse phase), batch 4 x seq 512: AdamW steps
   (:data:`FAMILY_TRAIN_RUNS`: 3 each), zamba2 also under
   ``zamba2-1.2b.train.tt_gemm.json`` (K5 fused segments) and for 2 steps
   with ``--grad-compress`` (its checkpoint must restore).  Every loss and
   gradient norm finite, every step launches K1 forward and dx and K3
   (the tt_gemm run: K3 and K5; qwen2-moe's K1 and batched K3 launches a
   step those :func:`moe_launches` counts from its plan), or the run
   fails.  Step 0 in fp32
   through the kernels against the plain executor on the card: the loss
   and the gradient norm at rel 1e-4, every gradient leaf at ``||g -
   g_plain|| / ||g_plain||`` <= 1e-4 or 10x the plain executor's own
   fp32-vs-float64 gap of that leaf (rwkv6-7b at 4 layers, 4, 8, 16 and
   32 layers reported); per arch the step
   ms, train tokens/s, launches per step (the remat recompute
   included), peak device memory and one profiled step (busy share, top
   device ops).
4d. encdec (after the families-train phase): full-width, full-depth
   seamless-m4t-medium (12 + 12 layers, seed-0 weights, bf16) served
   through ``launch.steps.make_prefill_step`` / ``make_decode_step`` (the
   reference's serving form for the family) under its plan pair: batch 4
   x 512 seeded random frames, a 32-token prompt, 16 greedy tokens;
   prefill ms, decode ms a step, gen tok/s and launches per prefill and
   per decode step (K1 required in both); fp32 prefill and decode-step
   logits against the plain executor (1e-4 x max |logit|); a profiled
   decode step and the peak memory.  Then 3 AdamW steps of
   ``make_train_step`` under its train plan (batch 4 x seq 512 with 512
   frames, remat full, loss_chunk 256): K1 forward and dx and K3 every
   step, the per-leaf step-0 check of 4c, a profiled step.  K1 at
   ``enc_mlp.wu`` (2048 frames) and ``xattn.wq`` (4 tokens) and K3 at
   every weight-gradient GEMM of ``enc_mlp.wu`` are timed as in 4b.
4e. states (after the encdec phase): full-width zamba2-1.2b (12 of its
   38 layers: two groups of 6), rwkv6-7b (4 of 32) and
   seamless-m4t-medium (12 + 12), fp32, seed-0 weights, on 4 ranks
   (``data=2 x model=2``, ``tt_model_reduce``; processes of this script,
   ``--states-rank``, one spawn for the three archs) sharing ``cuda:0``
   over ``gloo``, under the committed family plans, each rank of a model
   group computing its block of the SSM, WKV or cross-attention heads and
   the vocab: four lanes (prompt 32) served greedily for 8 tokens (zamba2
   and rwkv6 through a ``ServeEngine``, seamless through the step
   builders, 64 seeded frames) and step 0 at batch 4 x seq 128, against
   the single device in this process: the tokens equal, fp32 prefill and
   first decode step's logits within 1e-4 x max |logit|, a rank's
   ``ssm`` / ``wkv`` / ``cross_k`` + ``cross_v`` bytes exactly 0.25x one
   device's, a decode step's and step 0's collectives equal to
   :func:`step_collectives`, step 0's loss and grad norm within rel 1e-4
   and every leaf within 4c's bound, K1 in every prefill, decode step and
   step 0 on every rank, K3 in zamba2's and rwkv6's prefill and every
   step 0; peak memory a rank and the phase's seconds are printed.
4f. sp (after the states phase): full-width chatglm3-6b (8 of its 28
   layers, fp32, seed-0 weights, remat full) on 4 ranks (``data=1 x
   model=4``; processes of this script, ``--sp-rank``) sharing ``cuda:0``
   over ``gloo`` under the committed chatglm3-6b plans, where
   ``make_rules`` turns SP on (its 2 kv heads do not divide the axis):
   step 0 at batch 4 x seq 512 (128 positions a rank), the fp32 prefill
   logits of every position of that batch, and 16 lanes served over
   caches of 32 768 positions (prompt 32, 8 greedy steps; the rules of
   the 28-layer config's decode cell split the caches' positions),
   against the single device in this process: the step-0 loss and grad
   norm within rel 1e-4 and every leaf within 4c's bound, the logits
   within 1e-4 x max |logit|, the tokens equal, a rank's KV-cache bytes
   exactly 0.25x one device's, the collectives of the batch's prefill, a
   served prefill, a decode step and step 0 equal to
   :func:`step_collectives`, K1 forward and dx and K3 in step 0 and K1 in
   every prefill and decode step on every rank.  In the same spawn,
   full-width zamba2-1.2b (12 of its 38 layers: two groups of 6) and
   seamless-m4t-medium (12 + 12), fp32, remat full, under the rules
   ``make_rules`` gives at a train shape of 262 144 positions (SP on from
   200 000: their kv heads divide the axis), applied at batch 4 x seq 512
   (512 frames), the Mamba2 scan handing its conv inputs and SSD state
   from rank to rank and the decoder gathering the ranks' cross K/V:
   step 0, the batch's prefill logits and four lanes served (prompt 32,
   8 greedy steps, 64 frames) against the single device, a rank's cache
   bytes of the split leaves exactly 0.25x one device's and the rest
   whole, the collectives equal to :func:`step_collectives`, K1 forward
   and dx and K3 in step 0, K1 in every prefill and decode step, K3 in
   zamba2's prefill; peak memory a rank and the phase's seconds are
   printed.
5. per call: launches of one prefill and one decode step per plan
   setting; a decode step's wall time, the card's busy share and the
   device time of the setting's kernels (``torch.profiler``), under the
   full plan (K1), under the pair on ``tt_gemm`` (K2 + K4) and under the
   rank plan (K1 on two-core networks).
6. check: prefill logits through the kernels agree with the plain
   executor on the card, under the full plan and under the rank plan;
   tt-lm-smoke on the card agrees with the CPU; the rank search's
   calibration forward (``activation_calibration``, 32 tokens through K1
   under the rank plan) on the card agrees with the CPU.
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
``{"serve": n, "serve_rank_plan": r, "train": m, "tune": u,
"serve_tuned": v, "serve_families": f, "train_families": t,
"serve_encdec": e, "train_encdec": d, "serve_sharded": h,
"train_sharded": g, "states_sharded": w, "sp_sharded": p, "examples": x}``
(the experts' batched kernels, ``streaming_tt_batched`` and
``tt_gemm_ws_batched``, launch on the families' paths; ``r`` is the
part of ``n`` from the
rank plan's runs; ``x`` the quickstart's launches in its own process; ``h`` the shard phase's serve runs, summed over every rank of both
spawns; ``g`` the shard-train phase's train runs, summed over every rank
of its three spawns; ``u`` the tune phase's measurements, ``v`` its
serving under the measured plans, ``f`` the families' serve runs, ``t``
the families' train runs, ``e`` and ``d`` the encdec phase's counted
generation and train steps, ``w`` the states phase's first prefill,
first decode step and step 0 of each arch, summed over its 4 ranks,
``p`` the SP phase's step 0, first served prefill and first decode step
of each arch, summed over its 4 ranks),
each path's counts zeroed just before it
and read just after, its times at the rank plan's shapes
(``rank_plan``), at the family shapes (``families``, K1 and K3) and at
the encdec shapes (``encdec``, K1 and K3) and the K1 refusals over the
rank space; the
run fails unless every kernel of :data:`SERVE_KERNELS` launched on the serve path, every kernel of
:data:`TRAIN_KERNELS` on the train path and every kernel of
:data:`TUNE_KERNELS` on the tune path.  Nothing of JAX or of the JAX
package is imported.
"""

from __future__ import annotations

import ast
import collections
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
COMMITTED_PLANS = os.path.join(SRC, "repro_torch", "plans")
#: where the phases after the dse phase read their plans: ``main`` points
#: it at the dse phase's emissions once they match the committed files
PLANS = COMMITTED_PLANS

#: ``python -m repro_torch.dse`` argv of every committed plan (the same
#: table as ``tests/test_torch_plan.py::EMIT``; a test holds them equal).
#: A ``.pair.`` entry is one half of ``--emit-plan-pair``
EMIT = {
    "tt-lm-100m.json": ["--arch", "tt-lm-100m"],
    "tt-lm-100m.pair.prefill.json": ["--arch", "tt-lm-100m", "--serve-slots", "4"],
    "tt-lm-100m.pair.decode.json": ["--arch", "tt-lm-100m", "--serve-slots", "4"],
    "tt-lm-100m.shards2.pair.prefill.json": ["--arch", "tt-lm-100m", "--serve-slots",
                                             "4", "--shards", "2"],
    "tt-lm-100m.shards2.pair.decode.json": ["--arch", "tt-lm-100m", "--serve-slots",
                                            "4", "--shards", "2"],
    "tt-lm-smoke.json": ["--arch", "tt-lm-100m", "--smoke"],
    "tt-lm-smoke.tt_gemm.json": ["--arch", "tt-lm-100m", "--smoke",
                                 "--plan-backend", "tt_gemm"],
    "tt-lm-100m.train.json": ["--arch", "tt-lm-100m", "--mode", "train",
                              "--tokens", "2048"],
    "tt-lm-100m.train.tt_gemm.json": ["--arch", "tt-lm-100m", "--mode", "train",
                                      "--tokens", "2048", "--plan-backend",
                                      "tt_gemm"],
    "tt-lm-100m.shards2.train.json": ["--arch", "tt-lm-100m", "--mode", "train",
                                      "--tokens", "2048", "--shards", "2"],
    "tt-lm-100m.shards2.train.tt_gemm.json": ["--arch", "tt-lm-100m", "--mode",
                                              "train", "--tokens", "2048",
                                              "--shards", "2", "--plan-backend",
                                              "tt_gemm"],
    "tt-lm-smoke.train.json": ["--arch", "tt-lm-100m", "--smoke", "--mode",
                               "train", "--top-k", "2", "--tokens", "32"],
    "tt-lm-smoke.train.tt_gemm.json": ["--arch", "tt-lm-100m", "--smoke",
                                       "--mode", "train", "--top-k", "2",
                                       "--tokens", "32", "--plan-backend",
                                       "tt_gemm"],
    "tt-lm-100m.rank.json": ["--arch", "tt-lm-100m", "--rank-search", "budget",
                             "--search", "guided"],
    "tt-lm-smoke.rank.json": ["--arch", "tt-lm-100m", "--smoke", "--top-k", "2",
                              "--tokens", "64", "--rank-search", "budget",
                              "--search", "guided"],
    "qwen2-moe-a2.7b.pair.prefill.json": ["--arch", "qwen2-moe-a2.7b",
                                          "--serve-slots", "4"],
    "qwen2-moe-a2.7b.pair.decode.json": ["--arch", "qwen2-moe-a2.7b",
                                         "--serve-slots", "4"],
    "zamba2-1.2b.pair.prefill.json": ["--arch", "zamba2-1.2b", "--serve-slots", "4"],
    "zamba2-1.2b.pair.decode.json": ["--arch", "zamba2-1.2b", "--serve-slots", "4"],
    "rwkv6-7b.pair.prefill.json": ["--arch", "rwkv6-7b", "--serve-slots", "4"],
    "rwkv6-7b.pair.decode.json": ["--arch", "rwkv6-7b", "--serve-slots", "4"],
    "qwen2-moe-a2.7b.train.json": ["--arch", "qwen2-moe-a2.7b", "--mode", "train",
                                   "--tokens", "2048"],
    "zamba2-1.2b.train.json": ["--arch", "zamba2-1.2b", "--mode", "train",
                               "--tokens", "2048"],
    "zamba2-1.2b.train.tt_gemm.json": ["--arch", "zamba2-1.2b", "--mode", "train",
                                       "--tokens", "2048", "--plan-backend",
                                       "tt_gemm"],
    "rwkv6-7b.train.json": ["--arch", "rwkv6-7b", "--mode", "train",
                            "--tokens", "2048"],
    "seamless-m4t-medium.pair.prefill.json": ["--arch", "seamless-m4t-medium",
                                              "--serve-slots", "4"],
    "seamless-m4t-medium.pair.decode.json": ["--arch", "seamless-m4t-medium",
                                             "--serve-slots", "4"],
    "seamless-m4t-medium.train.json": ["--arch", "seamless-m4t-medium", "--mode",
                                       "train", "--tokens", "2048"],
    "chatglm3-6b.pair.prefill.json": ["--arch", "chatglm3-6b", "--serve-slots", "16"],
    "chatglm3-6b.pair.decode.json": ["--arch", "chatglm3-6b", "--serve-slots", "16"],
    "chatglm3-6b.train.json": ["--arch", "chatglm3-6b", "--mode", "train",
                               "--tokens", "2048"],
}
#: the reference's bf16 tolerance (``tests/test_kernels.py:47``)
BF16_TOL = 8e-2

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores

SERVE = ["--batch", "4", "--n-requests", "8", "--prompt-len", "32",
         "--gen", "16", "--strict-plan"]

#: kernels each main path must launch: serving runs K1 under the auto plan
#: and K2-K4 under ``--plan-backend tt_gemm``; training runs K1 forward and
#: dx, K3 WS weight gradients and K5 fused segments
SERVE_KERNELS = ("streaming_tt", "tt_gemm_os", "tt_gemm_ws", "tt_gemm_is")
#: the rank-searched plan (``--rank-search budget --search guided``): its
#: runs must launch K1 (auto backends) and the dataflow kernel of each of
#: its layers (``--plan-backend tt_gemm``)
RANK_PLAN = "tt-lm-100m.rank.json"
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
     "tt-lm-100m.pair.decode.json", "tt_gemm", ("K2 tt_gemm_os", "K4 tt_gemm_is")),
    ("rank plan", "tt-lm-100m.rank.json", "tt-lm-100m.rank.json", None,
     ("K1 streaming_tt",)))


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
# phase 2b: the port's DSE emits the plans
# ---------------------------------------------------------------------------

def dse_phase(out_dir: str) -> tuple[dict[str, float], dict]:
    """Emit every plan of :data:`EMIT` into ``out_dir`` with the port's DSE
    (``dse_cli.main``, in process) and hold each against the committed file
    byte for byte.  Returns the emit seconds on the host CPU per call (one
    call writes both halves of a pair) and, per rank-searched plan, the
    rank search's result as the CLI ran it (every candidate's layers and
    DSE choices, recorded on the way through ``repro_torch.rank``)."""
    import contextlib
    import io

    import repro_torch.rank as rank_pkg
    from repro_torch import dse_cli

    secs, searches, real, label = {}, {}, rank_pkg.rank_search, ""

    def recording(*args, **kw):
        searches[label] = res = real(*args, **kw)
        return res

    rank_pkg.rank_search = recording
    try:
        for name, argv in EMIT.items():
            if ".pair." in name:
                prefix = name.split(".pair.")[0] + ".pair"
                label = prefix + ".{prefill,decode}.json"
                argv = argv + ["--emit-plan-pair", os.path.join(out_dir, prefix)]
            else:
                label = name
                argv = argv + ["--emit-plan", os.path.join(out_dir, name)]
            if label in secs:
                continue
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = dse_cli.main(argv + ["--out", os.devnull])
            secs[label] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"python -m repro_torch.dse {argv}: exit {rc}")
    finally:
        rank_pkg.rank_search = real
    for name in EMIT:
        with open(os.path.join(out_dir, name)) as f:
            got = f.read()
        with open(os.path.join(COMMITTED_PLANS, name)) as f:
            want = f.read()
        if got != want:
            raise AssertionError(f"the port's DSE emitted {name} with other "
                                 "bytes than the committed file")
    return secs, searches


# ---------------------------------------------------------------------------
# phase 2c: the autotuner on the card, and serving under its plans
# ---------------------------------------------------------------------------

#: measurements each full-width tune call must make (the reference's counts
#: over the same variant space, ``tests/test_torch_tune.py``)
TUNE_MEASUREMENTS = {"tune": 47, "B": 75, "fused": 100}
#: every kernel the measurements reach: K1 (streaming sweeps), K2-K4 (the
#: calibration times each dominant GEMM under every dataflow), K5 (fused)
TUNE_KERNELS = ("streaming_tt", "tt_gemm_os", "tt_gemm_ws", "tt_gemm_is",
                "fused_path")


def _quiet(main, argv) -> tuple[int, str]:
    """(exit code, stdout) of one in-process CLI call, stderr dropped."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        try:
            rc = main(argv)
        except SystemExit as e:   # argparse errors
            rc = e.code
    return rc, out.getvalue()


def _dse(argv: list[str], out_dir: str, tag: str) -> dict:
    """One ``python -m repro_torch.dse`` call, in process; its report."""
    from repro_torch import dse_cli

    path = os.path.join(out_dir, f"{tag}.report.json")
    rc, _ = _quiet(dse_cli.main, ["--arch", "tt-lm-100m"] + argv + ["--out", path])
    if rc != 0:
        raise AssertionError(f"python -m repro_torch.dse {argv}: exit {rc}")
    with open(path) as f:
        return json.load(f)


def plan_kernels(plan) -> set[str]:
    """The kernels a plan's layers launch when served: K1 for a streaming
    layer; for a tt_gemm layer K5 for each multi-step segment and its
    dataflow's kernel for every step outside one.  The tied head never
    runs."""
    out = set()
    for lp in plan.layers:
        if lp.name == "head":
            continue
        if lp.backend == "streaming_tt":
            out.add("streaming_tt")
        elif lp.backend == "tt_gemm":
            segs = lp.segments or ()
            if any(e - s >= 2 for s, e in segs):
                out.add("fused_path")
            if not segs or any(e - s == 1 for s, e in segs):
                out.add(f"tt_gemm_{lp.dataflow.lower()}")
    return out


def logits_vs_plain(plan, device) -> tuple[float, float]:
    """(max abs diff, max |logit|) of full-width tt-lm-100m prefill logits
    (seed-0 weights, 32 tokens) through ``plan``'s kernels against the
    plain executor on the card; a rank plan's factorizations stay
    installed for the plain run (``plan_backend="jnp"``), since they set
    the shapes.  Fails on a bad shape, a non-finite logit or a diff over
    1e-4 x max |logit|."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config("tt-lm-100m")
    toks = torch.randint(0, cfg.vocab, (1, 32),
                         generator=torch.Generator().manual_seed(5)).to(device)
    m = api(cfg, plan=plan, device=device)
    params = m.init_params(0)
    planned, _ = m.prefill_full(params, {"tokens": toks}, 48)
    plain_api = (api(cfg, plan=plan, plan_backend="jnp", device=device)
                 if any(lp.factorization is not None for lp in plan.layers)
                 else api(cfg, plan=None, device=device))
    plain, _ = plain_api.prefill_full(params, {"tokens": toks}, 48)
    torch.cuda.synchronize()
    if planned.shape != (1, 32, cfg.vocab) or not torch.isfinite(planned).all():
        raise AssertionError(f"bad logits {tuple(planned.shape)}")
    e = (planned - plain).abs().max().item()
    scale = plain.abs().max().item()
    if e > 1e-4 * max(scale, 1e-3) + 1e-6:
        raise AssertionError(f"planned vs plain logits differ by {e} (scale {scale})")
    return e, scale


def tune_phase(out_dir: str, device) -> tuple[dict, dict, list[str]]:
    """The autotuner on the card, then full-width serving under its plans.

    1. ``python -m repro_torch.tune --arch tt-lm-100m --mode measure`` on a
       cold cache (in ``out_dir``): 47 measurements by CUDA-graph replay,
       ``interpret`` false, the card's ``device_kind``; the calibration per
       dataflow, each family's heuristic and measured tiling, and the
       spread of K1's ``block_tokens`` variants per family (K1 builds one
       program whatever the block: the spread is the noise floor).
    2. ``repro_torch.dse --tune cache --emit-plan A`` over that cache,
       twice: the second call measures nothing and emits the same bytes;
       A's choices against the analytic ``tt-lm-100m.json``.
    3. ``--plan-backend tt_gemm --tune measure --emit-plan B`` (75
       measurements: K2-K4 at every swept tiling), then ``--fused-cost
       --tokens 2048 --plan-backend tt_gemm --tune measure`` (K5 over 21
       fused variants against 4 per-step routes; 100 measurements).
    4. Serve under A and under B (continuous and oneshot: the tokens must
       match; the banner must say "autotuned"), each between two runs of
       the analytic plan of the same backend; each run must launch
       every kernel its plan's layers name; prefill logits through A and B
       within 1e-4 x max |logit| of the plain executor.

    Returns the launch counts of the measurements (steps 1-3) and of the
    serving under A and B (step 4), each zeroed just before and read just
    after, and the report lines."""
    import contextlib
    import io

    import torch

    from repro_torch.kernels import launches
    from repro_torch.launch.serve import run
    from repro_torch.plan import load_plan
    from repro_torch.tune import Autotuner, TuningCache
    from repro_torch.tune import cli as tune_cli

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(device).replace(" ", "_")
    cache = os.path.join(out_dir, "tuning_cache.json")
    plan_a, plan_a2, plan_b = (os.path.join(out_dir, f"tuned.{t}.json")
                               for t in ("A", "A2", "B"))
    notes = []

    # 1. python -m repro_torch.tune on a cold cache
    stream_keys, real = [], Autotuner.tune_streaming

    def recording(self, tn, steps, tokens, **kw):
        stream_keys.append(self.streaming_key(tn, steps, tokens))
        return real(self, tn, steps, tokens, **kw)

    launches.reset()
    Autotuner.tune_streaming = recording
    try:
        t0 = time.perf_counter()
        rc, out = _quiet(tune_cli.main, ["--arch", "tt-lm-100m", "--mode",
                                         "measure", "--cache", cache])
        tune_s = time.perf_counter() - t0
    finally:
        Autotuner.tune_streaming = real
    if rc != 0:
        raise AssertionError(f"python -m repro_torch.tune: exit {rc}")
    rep = json.loads(out)
    if (rep["n_measured"], rep["interpret"], rep["device_kind"]) != (
            TUNE_MEASUREMENTS["tune"], False, kind):
        raise AssertionError(
            f"python -m repro_torch.tune: {rep['n_measured']} measurements, "
            f"interpret {rep['interpret']}, device_kind {rep['device_kind']}")
    notes.append(f"python -m repro_torch.tune --arch tt-lm-100m --mode measure "
                 f"(cold cache): {rep['n_measured']} measurements in {tune_s:.2f} s, "
                 f"device_kind {rep['device_kind']}, interpret {rep['interpret']}, "
                 f"{rep['n_shapes']} calibration shapes, tokens {rep['tokens']}")
    notes.append("calibration (measured / analytic fpga_vu9p seconds, geomean "
                 "per dataflow): " + ", ".join(
                     f"{d} {v!r}" for d, v in sorted(rep["calibration"].items())))
    entries = TuningCache.load(cache).entries
    stream_rows = [r for r in rep["families"] if r["backend"] == "streaming_tt"]
    spreads = dict(zip((r["name"] for r in stream_rows), stream_keys))
    for r in rep["families"]:
        line = (f"  family {r['name']}: {r['backend']} {r['dataflow']}, heuristic "
                f"{r['heuristic']}, measured {r.get('measured')}, "
                f"speedup_vs_heuristic {r.get('speedup_vs_heuristic')!r}")
        key = spreads.get(r["name"])
        if key is not None:
            ms = {k: v * 1e3 for k, v in entries[key].measured_s.items()}
            line += (f"; K1 block_tokens variants (ms): "
                     + ", ".join(f"{k} {v:.5f}" for k, v in sorted(
                         ms.items(), key=lambda kv: int(kv[0])))
                     + "; spread (max/min - 1) "
                     f"{max(ms.values()) / min(ms.values()) - 1:.4f}")
        notes.append(line)

    # 2. --tune cache --emit-plan A, twice
    argv_a = ["--tune", "cache", "--tune-cache", cache]
    rep_a = _dse(argv_a + ["--emit-plan", plan_a], out_dir, "A")
    rep_a2 = _dse(argv_a + ["--emit-plan", plan_a2], out_dir, "A2")
    with open(plan_a) as f, open(plan_a2) as g:
        same = f.read() == g.read()
    if rep_a2["tune"]["n_measured"] != 0 or not same:
        raise AssertionError(f"--tune cache replay: {rep_a2['tune']['n_measured']} "
                             f"measurements, same bytes {same}")
    a, analytic = load_plan(plan_a), load_plan(os.path.join(PLANS, "tt-lm-100m.json"))
    diff = [f"{x.name}: {x.backend} {x.dataflow} path {list(x.path_steps)} vs "
            f"{y.backend} {y.dataflow} path {list(y.path_steps)}"
            for x, y in zip(a.layers, analytic.layers)
            if (x.backend, x.dataflow, x.path_steps) != (y.backend, y.dataflow,
                                                         y.path_steps)]
    notes.append(f"dse --tune cache --emit-plan A: {rep_a['tune']['n_measured']} "
                 f"measurements, {rep_a['tune']['n_cache_hits']} cache hits; the "
                 "same call again: 0 measurements, the same bytes; A's choices vs "
                 "the analytic tt-lm-100m.json: "
                 + ("; ".join(diff) if diff else "same path, dataflow and backend "
                    "in every layer (the calibration moved no choice)")
                 + "; A's tilings: " + ", ".join(
                     f"{lp.name} {lp.tiling.to_json()}" for lp in a.layers))

    # 3. K2-K4 at every swept tiling (B), then K5 against per-step routes
    rep_b = _dse(["--plan-backend", "tt_gemm", "--tune", "measure",
                  "--tune-cache", cache, "--emit-plan", plan_b], out_dir, "B")
    rep_f = _dse(["--fused-cost", "--tokens", "2048", "--plan-backend", "tt_gemm",
                  "--tune", "measure", "--tune-cache", cache, "--emit-plan",
                  os.path.join(out_dir, "tuned.fused.json")], out_dir, "fused")
    for tag, r in (("B", rep_b), ("fused", rep_f)):
        if r["tune"]["n_measured"] != TUNE_MEASUREMENTS[tag]:
            raise AssertionError(f"dse --tune measure ({tag}): "
                                 f"{r['tune']['n_measured']} measurements")
    tune_counts = launches.snapshot()
    missing = [k for k in TUNE_KERNELS if tune_counts[k] <= 0]
    if missing:
        raise AssertionError(f"the tune path launched no {missing}")
    b = load_plan(plan_b)
    notes.append(f"dse --plan-backend tt_gemm --tune measure --emit-plan B: "
                 f"{rep_b['tune']['n_measured']} measurements; B: " + ", ".join(
                     f"{lp.name} {lp.dataflow} {lp.tiling.to_json()} segments "
                     f"{[list(g) for g in lp.segments or ()]}" for lp in b.layers))
    notes.append(f"dse --fused-cost --tokens 2048 --plan-backend tt_gemm --tune "
                 f"measure: {rep_f['tune']['n_measured']} measurements; "
                 "fused_cost.tune rows (seconds per call):")
    for r in rep_f["fused_cost"]["tune"] or ():
        notes.append(f"  {r['layer']} path {r['path_index']}: {r['measured']}, "
                     f"scale {r['scale']!r}")
    measure_s = time.perf_counter() - t_phase
    notes.append(f"tune measurements (steps 1-3): {measure_s:.1f} s; launches "
                 f"{tune_counts}")

    # 4. serve under A and B, beside the analytic plans of the same backend
    plan_bh = os.path.join(out_dir, "analytic.tt_gemm.json")
    _dse(["--plan-backend", "tt_gemm", "--emit-plan", plan_bh], out_dir, "Bh")
    full = os.path.join(PLANS, "tt-lm-100m.json")
    # each measured plan between two runs of its analytic counterpart: the
    # first serve run of a process pays one-time costs
    runs = []
    for label, path, analytic_label, analytic_path in (
            ("A", plan_a, "analytic tt-lm-100m.json", full),
            ("B", plan_b, "analytic --plan-backend tt_gemm", plan_bh)):
        runs += [(analytic_label, analytic_path, "continuous"),
                 (label, path, "continuous"), (label, path, "oneshot"),
                 (analytic_label, analytic_path, "continuous")]
    tokens, tok_s, tuned = {}, {}, {k: 0 for k in launches.COUNTS}
    launches.reset()
    for label, path, schedule in runs:
        before = launches.snapshot()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = run(["--plan", path, "--schedule", schedule] + SERVE)
        if res.code != 0:
            raise AssertionError(f"serve ({label}, {schedule}) exited {res.code}")
        delta = {k: res.launches[k] - before[k] for k in before}
        banner = next(ln for ln in buf.getvalue().splitlines()
                      if ln.startswith("plan tilings:"))
        if label in ("A", "B"):
            if "autotuned" not in banner:
                raise AssertionError(f"serve ({label}): banner {banner!r}")
            want = plan_kernels(load_plan(path))
            idle = sorted(k for k in want if delta[k] <= 0)
            if idle:
                raise AssertionError(f"serve ({label}, {schedule}) launched no {idle}")
            for k in tuned:
                tuned[k] += delta[k]
        tokens[(label, schedule)] = res.result.tokens_by_rid()
        s = res.summary
        tok_s.setdefault((label, schedule), []).append(s["gen_tok_s"])
        notes.append(f"serve {label} ({schedule}): {s['gen_tok_s']:.1f} gen tok/s, "
                     f"ttft p50 {s['ttft_p50_ms']:.1f} ms, wall "
                     f"{s['wall_s'] * 1e3:.1f} ms; {banner}; launches {delta}")
    for label in ("A", "B"):
        if tokens[(label, "continuous")] != tokens[(label, "oneshot")]:
            raise AssertionError(f"serve {label}: continuous and oneshot disagree")
    for label in ("A", "B"):
        e, scale = logits_vs_plain(load_plan(plan_a if label == "A" else plan_b),
                                   device)
        notes.append(f"{label}: continuous == oneshot per request: yes; prefill "
                     f"logits vs the plain executor: max abs diff {e:.3e} (max "
                     f"|logit| {scale:.3e})")
    cont = {label: " / ".join(f"{v:.1f}" for v in vs)
            for (label, sched), vs in tok_s.items() if sched == "continuous"}
    notes.append(f"gen tok/s (continuous; analytic before / after), not a "
                 f"claim: A {cont['A']} vs analytic "
                 f"{cont['analytic tt-lm-100m.json']}; B {cont['B']} vs "
                 f"analytic on tt_gemm {cont['analytic --plan-backend tt_gemm']}")
    notes.append(f"tune phase: {time.perf_counter() - t_phase:.1f} s")
    return tune_counts, tuned, notes


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
        if timed_case:
            timing[label.split(" (")[0], tokens] = k1_timing(
                label, tn, steps, tn_b, path, x, cores, bt, want, device)
    log(f"  streaming_tt: {len(seen)} (layer, path, tokens) cases, "
        f"max abs err {err:.3e}")
    for t in timing.values():
        log_timing("streaming_tt", t)
    return dict(name="streaming_tt", max_abs_err=err, **timing["mlp.wg", 32])


def k1_timing(label, tn, steps, tn_b, path, x, cores, bt, want, device) -> dict:
    """K1 on ``x`` timed (CUDA events and CUDA-graph replay) beside its
    plain version, one ``torch.einsum`` (library; checked against
    ``want`` first) and the bound, with the program and grid it ran."""
    import torch

    from repro_torch.kernels import streaming_tt

    tokens = x.shape[0]

    def kernel():
        return streaming_tt.streaming_tt_linear(x, cores, tn_b, path, block_tokens=bt)

    def plain():
        return streaming_tt.streaming_tt_linear_plain(x, cores, tn_b, path)

    library = _einsum_call(tn, x, cores)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (library() - want).abs().max().item() <= tol
    prog = streaming_tt.program_for(tn_b, path)
    grid = streaming_tt.launch_grid(
        prog, tokens, torch.cuda.get_device_properties(device).multi_processor_count)
    full = streaming_tt._rebatch(tn, tokens)
    macs = sum(g.macs for g in full.gemm_sequence(steps))
    nbytes = 4 * (x.numel() + sum(c.numel() for c in cores) + want.numel())
    b_ms, b_by = bound(nbytes, 2 * macs)
    ms, host_ms = timed(kernel)
    return dict(
        at=f"{label}, tokens {tokens}: {len(prog.free_ops)} token-free ops in "
           f"one launch, then {len(prog.tok_ops)} token steps over tiles of "
           f"{grid.tile} x {grid.slices} column slices ({grid.blocks} x "
           f"{grid.slices} blocks, {grid.smem_bytes} B shared memory)",
        ms=ms, host_ms=host_ms, graph_ms=graph_ms(kernel),
        plain_ms=timed(plain)[0], library_ms=timed(library)[0],
        library_graph_ms=graph_ms(library), bound_ms=b_ms, bound_by=b_by)


def log_timing(name: str, t: dict) -> None:
    log(f"  {name} at {t['at']}: kernel {_fmt(t['ms'])} (host "
        f"{_fmt(t['host_ms'])}, graph {_fmt(t['graph_ms'])}), plain "
        f"{_fmt(t['plain_ms'])}, library {_fmt(t['library_ms'])} (graph "
        f"{_fmt(t.get('library_graph_ms'))}), bound {_fmt(t['bound_ms'])} "
        f"({t['bound_by']})")


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
    layout ``(tokens, out_dim)``; an ``x (E, tokens, N_in)``: every operand
    and the output lead with the experts' axis."""
    import torch

    from repro_torch.kernels import streaming_tt

    letters = {}
    for n in tn.nodes:
        for e in n.edges:
            letters.setdefault(e, chr(ord("a") + len(letters)))
    z = "Z" if x.dim() == 3 else ""
    stream = streaming_tt._stream_node(tn)
    core_nodes = [n for n in tn.nodes if n.kind != "input"]
    out_edges = streaming_tt._stream_layout(tn)[3]
    eq = (",".join(z + "".join(letters[e] for e in n.edges)
                   for n in [stream] + core_nodes[::-1])
          + "->" + z + "".join(letters[e] for e in out_edges))
    lead = tuple(x.shape[:-1])
    x3 = x.reshape(lead + stream.dims[1:])
    ops_ = [x3] + list(cores)[::-1]
    return lambda: torch.einsum(eq, *ops_).reshape(lead + (-1,))


#: the MoE whose experts run batched (phase 3, and full depth in 4b / 4c)
MOE_ARCH = "qwen2-moe-a2.7b"
#: (label, plan, layer, slots an expert) of the experts' batched K1 checks:
#: a served step's 4 slots (a 32-token prompt's prefill and a 4-lane
#: decode step both give ``cap`` = 4), and the train step's 4 x 512
#: tokens: 4 router groups of 512, ``cap = ceil(4 * 512 * 1.25 / 60)`` =
#: 43 slots each, 172 an expert
MOE_BATCHED = (("serve", "qwen2-moe-a2.7b.pair.prefill.json", "moe.eu", 4),
               ("serve", "qwen2-moe-a2.7b.pair.decode.json", "moe.ed", 4),
               ("train", "qwen2-moe-a2.7b.train.json", "moe.eu", 172),
               ("train", "qwen2-moe-a2.7b.train.json", "moe.ed", 172))


def _batched_timing(label: str, batched, loop, plain, library, nbytes: int,
                    flops: int) -> dict:
    """One batched call timed (CUDA events and CUDA-graph replay) beside the
    loop of E unbatched launches, the plain version, one library call and
    the bound."""
    b_ms, b_by = bound(nbytes, flops)
    ms, host_ms = timed(batched)
    loop_ms, loop_host_ms = timed(loop, reps=10, warmup=2)
    return dict(at=label, ms=ms, host_ms=host_ms, graph_ms=graph_ms(batched),
                loop_ms=loop_ms, loop_host_ms=loop_host_ms,
                loop_graph_ms=graph_ms(loop, reps=5),
                plain_ms=timed(plain, reps=3, warmup=1)[0],
                library_ms=timed(library)[0], library_graph_ms=graph_ms(library),
                bound_ms=b_ms, bound_by=b_by)


def _log_batched(name: str, t: dict) -> None:
    log_timing(name, t)
    log(f"    the {MOE_EXPERTS} unbatched launches: {_fmt(t['loop_ms'])} (host "
        f"{_fmt(t['loop_host_ms'])}, graph {_fmt(t['loop_graph_ms'])})")


#: experts of :data:`MOE_ARCH`
MOE_EXPERTS = 60


def check_batched(device) -> tuple[list[dict], list[str]]:
    """The experts' batched launches at full-width qwen2-moe-a2.7b's shapes
    (:data:`MOE_BATCHED`): batched K1 forward (and, under the train plan,
    along the dx network) and batched K3 (WS) at every weight-gradient
    GEMM of the train plan's ``moe.eu`` and ``moe.ed``, over 60 experts of
    random cores.  Each within 1e-4 (K1) / 1e-5 (K3) of the output's scale
    against its batched plain version, bit for bit the 60 unbatched
    launches, or the run fails; each timed beside those 60 launches, one
    batched ``torch.einsum`` along the path (K1) / ``torch.bmm`` (K3) and
    the bound.  Returns the two kernels-line rows (K1 at the train
    forward of ``moe.eu``, K3 at its largest GEMM, every case under
    ``shapes``) and report lines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.backward import backward_networks, grad_input_network
    from repro_torch.dse_cli import model_dse_layers
    from repro_torch.kernels import ops, streaming_tt, tt_gemm
    from repro_torch.plan import load_plan
    from repro_torch.plan.executor import as_candidate_path

    E = MOE_EXPERTS
    nets = {n.split("[")[0]: tn for n, tn in
            model_dse_layers(get_config(MOE_ARCH), tokens=8)}
    gen = torch.Generator().manual_seed(13)
    k1, k3, gemms, notes = [], [], set(), []
    err1 = err3 = 0.0
    for label, plan_file, name, slots in MOE_BATCHED:
        lp = next(l for l in load_plan(os.path.join(PLANS, plan_file)).layers
                  if l.name == name)
        cases = [("forward", nets[name], lp.path_steps, lp.tiling.block_tokens)]
        for op in lp.backward:
            if op.wrt == "dx":
                cases.append(("dx", grad_input_network(nets[name]), op.path_steps,
                              op.tiling.block_tokens))
            else:
                full = streaming_tt._rebatch(nets[name], slots)
                net = dict(backward_networks(full))[op.wrt]
                t = op.tiling
                gemms |= {(g.M, g.K, g.N, ops.clamp_block(t.block_m, g.M),
                           ops.clamp_block(t.block_k, g.K),
                           ops.clamp_block(t.block_n, g.N))
                          for g in net.gemm_sequence(op.path_steps)}
        for kind, net, steps, block in cases:
            bt = ops.clamp_block(block, slots)
            net_b = streaming_tt._rebatch(net, bt)
            path = as_candidate_path(net_b, steps)
            cores = [(torch.randn((E,) + n.dims, generator=gen) * 0.2).to(device)
                     for n in net.nodes if n.kind != "input"]
            n_in = math.prod(streaming_tt._stream_node(net).dims[1:])
            x = torch.randn((E, slots, n_in), generator=gen).to(device)

            def batched():
                return streaming_tt.streaming_tt_linear_batched(
                    x, cores, net_b, path)

            def loop():
                return [streaming_tt.streaming_tt_linear(
                    x[e], [c[e] for c in cores], net_b, path, block_tokens=bt)
                    for e in range(E)]

            def plain():
                return streaming_tt.streaming_tt_linear_batched_plain(
                    x, cores, net_b, path)

            got, singles, want = batched(), loop(), plain()
            torch.cuda.synchronize()
            at = f"{name} {kind} ({label}, {plan_file}), {E} experts x {slots} slots"
            e1 = (got - want).abs().max().item()
            if not torch.isfinite(got).all() or e1 > 1e-4 * max(
                    1.0, want.abs().max().item()):
                raise AssertionError(f"batched K1 {at}: err {e1}")
            if not all(torch.equal(got[e], singles[e]) for e in range(E)):
                raise AssertionError(f"batched K1 {at}: not bit for bit the "
                                     f"{E} unbatched launches")
            err1 = max(err1, e1)
            library = _einsum_call(net, x, cores)
            assert (library() - want).abs().max().item() <= 1e-4 * max(
                1.0, want.abs().max().item())
            macs = E * sum(g.macs for g in streaming_tt._rebatch(net, slots)
                           .gemm_sequence(steps))
            nbytes = 4 * (x.numel() + sum(c.numel() for c in cores) + got.numel())
            row = _batched_timing(at, batched, loop, plain, library, nbytes, 2 * macs)
            _log_batched("streaming_tt_batched", row)
            k1.append(row)
            del x, cores, got, singles, want
    for m, k, n, bm, bk, bn in sorted(gemms):
        a = torch.randn((E, m, k), generator=gen).to(device)
        b = torch.randn((E, k, n), generator=gen).to(device)
        blk = dict(block_m=bm, block_k=bk, block_n=bn)

        def batched():
            return tt_gemm.tt_gemm_batched(a, b, dataflow="WS", **blk)

        def loop():
            return [tt_gemm.tt_gemm(a[e], b[e], dataflow="WS", **blk) for e in range(E)]

        def plain():
            return tt_gemm.tt_gemm_batched_plain(a, b, dataflow="WS", **blk)

        def library():
            return torch.bmm(a, b)

        got, singles, want = batched(), loop(), plain()
        torch.cuda.synchronize()
        at = (f"weight gradient {E} x M,K,N={m},{k},{n} blocks {bm},{bk},{bn} "
              f"({MOE_BATCHED[2][1]}, moe.eu / moe.ed at 172 slots)")
        e3 = (got - want).abs().max().item()
        if not torch.isfinite(got).all() or e3 > 1e-5 * max(1.0, want.abs().max().item()):
            raise AssertionError(f"batched K3 {at}: err {e3}")
        if not all(torch.equal(got[e], singles[e]) for e in range(E)):
            raise AssertionError(f"batched K3 {at}: not bit for bit the {E} "
                                 "unbatched launches")
        err3 = max(err3, e3)
        row = _batched_timing(at, batched, loop, plain, library,
                              4 * E * (m * k + k * n + m * n), 2 * E * m * k * n)
        _log_batched("tt_gemm_ws_batched", row)
        k3.append(row)
        del a, b, got, singles, want
    torch.cuda.empty_cache()
    for name, rows, err in (("streaming_tt_batched", k1, err1),
                            ("tt_gemm_ws_batched", k3, err3)):
        notes.append(f"{name}: {len(rows)} cases, max abs err {err:.3e}, every "
                     f"case bit for bit the {E} unbatched launches; graph ms "
                     f"summed {sum(r['graph_ms'] or 0 for r in rows):.4f}, the "
                     f"unbatched launches {sum(r['loop_graph_ms'] or 0 for r in rows):.4f}, "
                     f"library {sum(r['library_graph_ms'] or 0 for r in rows):.4f}, "
                     f"bound {sum(r['bound_ms'] for r in rows):.4f}")
    top1 = next(r for r in k1 if r["at"].startswith("moe.eu forward (train"))
    top3 = max(k3, key=lambda r: r["bound_ms"])
    return ([dict(name="streaming_tt_batched", max_abs_err=err1, shapes=k1, **top1),
             dict(name="tt_gemm_ws_batched", max_abs_err=err3, shapes=k3, **top3)],
            notes)


def moe_sync_check(device) -> list[str]:
    """One full-width qwen2-moe-a2.7b MoE layer (60 experts, bf16, seed-0
    weights) under its train plan at batch 4 x seq 512: after one warm-up
    call, ``moe_apply`` forward and backward under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
    sync; the experts on the batched kernels."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.models import blocks
    from repro_torch.nn import install_plan, moe
    from repro_torch.plan import load_plan
    from repro_torch.tree import leaves

    cfg = get_config(MOE_ARCH)
    spec = blocks.moe_spec(cfg)
    dtype = getattr(torch, cfg.dtype)
    params = moe.moe_init(spec, torch.Generator().manual_seed(0), dtype, device)
    for p in leaves(params):
        p.requires_grad_(True)
    x = torch.randn((4, 512, cfg.d_model), generator=torch.Generator().manual_seed(1)
                    ).to(device, dtype).requires_grad_(True)
    install_plan(load_plan(os.path.join(PLANS, f"{MOE_ARCH}.train.json")))
    try:
        for debug in (False, True):
            launches.reset()
            if debug:
                torch.cuda.set_sync_debug_mode("error")
            try:
                y, aux = moe.moe_apply(spec, params, x)
                (y.float().sum() + aux).backward()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    finally:
        install_plan(None)
    counts = {k: v for k, v in launches.snapshot().items() if v}
    if not (torch.isfinite(y.float()).all() and torch.isfinite(x.grad.float()).all()
            and counts.get("streaming_tt_batched") == 6
            and counts.get("tt_gemm_ws_batched", 0) > 0):
        raise AssertionError(f"moe_apply under sync debug: launches {counts}")
    return [f"{MOE_ARCH} moe_apply (one layer, 60 experts, bf16, 4 x 512, the train "
            "plan), forward and backward under torch.cuda.set_sync_debug_mode"
            f"('error'): no host sync; launches {counts}"]


def gemm_shapes(layers) -> tuple[dict, dict]:
    """The tt_gemm calls of the serving paths (decode at 4 lanes, prefill
    at 32, 37 and 1 tokens) with the plan's blocks clamped as the executor
    clamps them: ``({dataflow: {(M, K, N, bm, bk, bn)}}, {(dataflow, key):
    launches per decode step})``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

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
    return shapes, per_step


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

    from repro_torch.kernels import tt_gemm

    shapes, per_step = gemm_shapes(layers)
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


def check_rank_space(device, rres) -> tuple[dict, list[str], list[str]]:
    """K1 and K2-K4 at every candidate of the full-width rank search, as the
    dse phase ran it (15 decompositions of tt-lm-100m, 1-4 modes a side,
    ranks 4-24).  Each candidate's evaluation compiles to the plan it would
    emit; every layer but the tied head (it never executes) runs K1 along
    that plan's path at 4, 32 and 2048 tokens against the plain version
    (1e-4 of the output's scale), and K2-K4 at the path's GEMMs at 4 and 32
    tokens with the plan's blocks clamped (1e-5; WS == OS == IS bit for
    bit).  A layer K1 refuses (shared memory) is listed, and fails the run
    on the chosen candidate.  At the chosen candidate's shapes, K1 (mlp.wg
    at 4, 32 and 2048 tokens) and every GEMM of its layers (4 lanes of
    decode, 32 tokens of prefill) are timed beside ``torch.einsum`` /
    ``torch.matmul`` and the bound.  Returns ({kernel: its row at the
    chosen shapes}, refusals, report lines)."""
    import torch

    from repro_torch.hw import get_target
    from repro_torch.kernels import ops, streaming_tt, tt_gemm
    from repro_torch.plan import compile_plan
    from repro_torch.plan.executor import as_candidate_path

    hw = get_target("fpga_vu9p")
    gen = torch.Generator().manual_seed(7)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    refusals, notes, rows = [], [], {}
    k1_err, k1_cases, gemm_err, gemms = 0.0, 0, 0.0, {}
    chosen_gemms: dict = {}
    for i, ev in enumerate(rres.evals):
        cand, chosen = ev.candidate.name, i == rres.chosen
        plan = compile_plan(ev.named, ev.res, hw, arch=rres.arch, tokens=rres.tokens)
        nets = {n.split("[")[0]: tn for n, tn in ev.named}
        for lp in plan.layers:
            if lp.name == "head":
                continue
            tn = nets[lp.name]
            cores = [(torch.randn(n.dims, generator=gen) * 0.2).to(device)
                     for n in tn.nodes if n.kind != "input"]
            n_in = math.prod(streaming_tt._stream_node(tn).dims[1:])
            for tokens in (4, 32, 2048):
                bt = ops.clamp_block(lp.tiling.block_tokens, tokens)
                tn_b = streaming_tt._rebatch(tn, bt)
                path = as_candidate_path(tn_b, lp.path_steps)
                try:
                    grid = streaming_tt.launch_grid(
                        streaming_tt.program_for(tn_b, path), tokens, n_sm)
                except ValueError as err:
                    if chosen:
                        raise
                    refusals.append(f"{cand} {lp.name} ({lp.backend} in its plan), "
                                    f"{tokens} tokens, path {list(lp.path_steps)}: "
                                    f"{err}")
                    continue
                x = torch.randn(tokens, n_in, generator=gen).to(device)
                got = streaming_tt.streaming_tt_linear(x, cores, tn_b, path,
                                                       block_tokens=bt)
                want = streaming_tt.streaming_tt_linear_plain(x, cores, tn_b, path)
                e = (got - want).abs().max().item()
                tol = 1e-4 * max(1.0, want.abs().max().item())
                if not torch.isfinite(got).all() or e > tol:
                    raise AssertionError(
                        f"streaming_tt {cand} {lp.name} tokens {tokens}: max abs "
                        f"err {e} > {tol} (grid {grid})")
                k1_err, k1_cases = max(k1_err, e), k1_cases + 1
                if chosen and lp.name == "mlp.wg":
                    rows["streaming_tt", tokens] = k1_timing(
                        f"{lp.name} ({cand}, rank plan)", tn, lp.path_steps, tn_b,
                        path, x, cores, bt, want, device)
            for tokens in (4, 32):
                for g in streaming_tt._rebatch(tn, tokens).gemm_sequence(lp.path_steps):
                    key = (g.M, g.K, g.N, ops.clamp_block(lp.tiling.block_m, g.M),
                           ops.clamp_block(lp.tiling.block_k, g.K),
                           ops.clamp_block(lp.tiling.block_n, g.N))
                    gemms[key] = gemms.get(key, ()) + ((cand, lp.name),)
                    if chosen:
                        chosen_gemms[key] = "decode" if tokens == 4 else "prefill"
    for key, where in sorted(gemms.items()):
        m, k, n, bm, bk, bn = key
        a = torch.randn(m, k, generator=gen).to(device)
        b = torch.randn(k, n, generator=gen).to(device)
        blocks = dict(block_m=bm, block_k=bk, block_n=bn)
        outs = {df: tt_gemm.tt_gemm(a, b, dataflow=df, **blocks)
                for df in ("OS", "WS", "IS")}
        want = tt_gemm.tt_gemm_plain(a, b, dataflow="OS", **blocks)
        e = (outs["OS"] - want).abs().max().item()
        if not torch.isfinite(outs["OS"]).all() or e > 1e-5 * max(
                1.0, want.abs().max().item()):
            raise AssertionError(f"tt_gemm M,K,N={(m, k, n)} ({where[0]}): max abs "
                                 f"err {e}")
        if not (torch.equal(outs["OS"], outs["WS"])
                and torch.equal(outs["OS"], outs["IS"])):
            raise AssertionError(f"tt_gemm M,K,N={(m, k, n)}: WS, OS and IS are "
                                 "not bit-identical")
        row0 = tt_gemm.tt_gemm(a[:1].contiguous(), b, dataflow="OS", **blocks)
        if not torch.equal(row0[0], outs["OS"][0]):
            raise AssertionError(f"tt_gemm M,K,N={(m, k, n)}: row 0 depends on M")
        gemm_err = max(gemm_err, e)
        if key not in chosen_gemms:
            continue
        b_ms, b_by = bound(4 * (m * k + k * n + m * n), 2 * m * k * n)
        lib_graph = graph_ms(lambda: torch.matmul(a, b))
        for df in ("OS", "WS", "IS"):
            def kernel(df=df):
                return tt_gemm.tt_gemm(a, b, dataflow=df, **blocks)
            ms, host_ms = timed(kernel)
            row = dict(
                at=f"M,K,N={m},{k},{n} blocks {bm},{bk},{bn} "
                   f"({chosen_gemms[key]}, {rres.evals[rres.chosen].candidate.name})",
                ms=ms, host_ms=host_ms, graph_ms=graph_ms(kernel),
                plain_ms=timed(lambda: tt_gemm.tt_gemm_plain(
                    a, b, dataflow=df, **blocks))[0],
                library_ms=timed(lambda: torch.matmul(a, b))[0],
                library_graph_ms=lib_graph, bound_ms=b_ms, bound_by=b_by,
                macs=m * k * n, phase=chosen_gemms[key])
            rows.setdefault(("tt_gemm", df), []).append(row)
    notes.append(f"rank space: {len(rres.evals)} candidates, K1 at {k1_cases} "
                 f"(candidate, layer, tokens) cases along each candidate's plan, "
                 f"max abs err {k1_err:.3e}; K2-K4 at {len(gemms)} GEMM shapes, max "
                 f"abs err {gemm_err:.3e}, WS == OS == IS bit for bit: yes; K1 "
                 f"refusals: {len(refusals)}")
    for r in refusals:
        notes.append(f"  K1 refuses {r}")
    for tokens in (4, 32, 2048):
        log_timing("streaming_tt", rows["streaming_tt", tokens])
    for df in ("OS", "WS", "IS"):
        for r in rows[("tt_gemm", df)]:
            log_timing(f"tt_gemm_{df.lower()}", r)
    # the kernels line: K1 at 32 tokens; per dataflow the largest GEMM of
    # the phase the frozen plans run it in (OS, IS decode; WS prefill)
    out = {"streaming_tt": rows["streaming_tt", 32]}
    for df, phase in (("OS", "decode"), ("WS", "prefill"), ("IS", "decode")):
        out[f"tt_gemm_{df.lower()}"] = max(
            (r for r in rows[("tt_gemm", df)] if r["phase"] == phase),
            key=lambda r: r["macs"])
    return out, refusals, notes


def _bf16_close(label: str, got, want) -> float:
    """Max abs error of a bf16 kernel result against its plain version;
    raises unless it is bf16, finite and within the reference's bf16
    tolerance (rtol = atol = :data:`BF16_TOL`)."""
    import torch

    g, w = got.float(), want.float()
    if got.dtype != torch.bfloat16 or not torch.isfinite(g).all():
        raise AssertionError(f"{label} bf16: got {got.dtype}, finite "
                             f"{bool(torch.isfinite(g).all())}")
    if not torch.allclose(g, w, rtol=BF16_TOL, atol=BF16_TOL):
        raise AssertionError(f"{label} bf16: max abs err "
                             f"{(g - w).abs().max().item()} beyond {BF16_TOL}")
    return (g - w).abs().max().item()


def check_bf16(device, layers) -> tuple[dict, list[str]]:
    """Every kernel once in bf16 at a main-path shape against its plain
    version (on the same bf16 inputs, on the card): K1 at mlp.wg with 32
    tokens, K2-K4 at each dataflow's largest serving shape (64,128,16 OS,
    37,2048,16 WS, 32,16,256 IS) with WS == OS == IS bit for bit there, and
    K5 at the mlp.wg segment of ``tt-lm-100m.train.tt_gemm.json`` with 2048
    tokens.  Returns ({kernel: max abs err}, report lines)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dse_cli import model_dse_layers
    from repro_torch.kernels import fused_path, ops, streaming_tt, tt_gemm
    from repro_torch.plan import load_plan
    from repro_torch.plan.executor import as_candidate_path

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(6)
    errs, notes = {}, []

    _, lp, tn = next(c for c in layers
                     if c[0] == "tt-lm-100m.json" and c[1].name == "mlp.wg")
    bt = ops.clamp_block(lp.tiling.block_tokens, 32)
    tn_b = streaming_tt._rebatch(tn, bt)
    path = as_candidate_path(tn_b, lp.path_steps)
    cores = [(torch.randn(n.dims, generator=gen) * 0.2).to(device, bf16)
             for n in tn.nodes if n.kind != "input"]
    n_in = math.prod(streaming_tt._stream_node(tn).dims[1:])
    x = torch.randn(32, n_in, generator=gen).to(device, bf16)
    errs["streaming_tt"] = _bf16_close(
        "streaming_tt mlp.wg 32 tokens",
        streaming_tt.streaming_tt_linear(x, cores, tn_b, path, block_tokens=bt),
        streaming_tt.streaming_tt_linear_plain(x, cores, tn_b, path))
    notes.append(f"streaming_tt bf16 at mlp.wg, 32 tokens: max abs err "
                 f"{errs['streaming_tt']:.3e}")

    shapes, _ = gemm_shapes(layers)
    for df in ("OS", "WS", "IS"):
        m, k, n, bm, bk, bn = max(shapes[df], key=lambda s: s[0] * s[1] * s[2])
        blocks = dict(block_m=bm, block_k=bk, block_n=bn)
        a = torch.randn(m, k, generator=gen).to(device, bf16)
        b = torch.randn(k, n, generator=gen).to(device, bf16)
        outs = {d: tt_gemm.tt_gemm(a, b, dataflow=d, **blocks)
                for d in ("OS", "WS", "IS")}
        name = f"tt_gemm_{df.lower()}"
        errs[name] = _bf16_close(f"{name} {(m, k, n)}", outs[df],
                                 tt_gemm.tt_gemm_plain(a, b, dataflow=df, **blocks))
        if not (torch.equal(outs["OS"], outs["WS"])
                and torch.equal(outs["OS"], outs["IS"])):
            raise AssertionError(f"tt_gemm bf16 {(m, k, n)}: WS, OS and IS "
                                 "are not bit-identical")
        notes.append(f"{name} bf16 at M,K,N={m},{k},{n}: max abs err "
                     f"{errs[name]:.3e}; WS == OS == IS bit for bit: yes")

    plan = load_plan(os.path.join(PLANS, "tt-lm-100m.train.tt_gemm.json"))
    lp = plan.layer("mlp.wg")
    (s0, e0) = next(g for g in lp.segments if g[1] - g[0] >= 2)
    blocks = dict(block_m=lp.tiling.block_m, block_k=lp.tiling.block_k,
                  block_n=lp.tiling.block_n)
    tn = dict((nm.split("[")[0], t_) for nm, t_ in model_dse_layers(
        get_config("tt-lm-100m"), tokens=2048))["mlp.wg"]
    work = [(n.edges, (torch.randn(n.dims, generator=gen) * 0.3).to(device, bf16))
            for n in tn.nodes]
    contract = ops.gemm_contract(dataflow=lp.dataflow, **blocks)
    for (i, j) in lp.path_steps[:s0]:
        work = _replay(work, i, j, contract)
    chain = lp.path_steps[s0:e0]
    (_, got), (_, want) = (
        fused_path.fused_segment_contract(
            work, chain, block_tokens=lp.tiling.block_tokens, **blocks),
        fused_path.fused_segment_contract_plain(work, chain, **blocks))
    errs["fused_path"] = _bf16_close("fused_path mlp.wg 2048 tokens", got, want)
    notes.append(f"fused_path bf16 at the mlp.wg segment {[s0, e0]}, 2048 "
                 f"tokens: max abs err {errs['fused_path']:.3e}")
    return errs, notes


# ---------------------------------------------------------------------------
# phase 4 and 5: serving and the output check
# ---------------------------------------------------------------------------

def serve_runs() -> tuple[dict, dict, list[str]]:
    """Full-width tt-lm-100m served under the full plan, the plan pair, the
    pair on tt_gemm and the rank-searched plan (auto backends: K1; on
    tt_gemm: the dataflow kernels its layers plan).  Returns the launch
    counts of the whole serve path and of the rank plan's runs alone, and
    the report lines; continuous == oneshot per request under each of the
    full and the rank plan."""
    from repro_torch.kernels import launches
    from repro_torch.launch.serve import run

    full = os.path.join(PLANS, "tt-lm-100m.json")
    rank = os.path.join(PLANS, RANK_PLAN)
    pair = ["--plan-prefill", os.path.join(PLANS, "tt-lm-100m.pair.prefill.json"),
            "--plan-decode", os.path.join(PLANS, "tt-lm-100m.pair.decode.json")]
    runs = [
        ("full plan, continuous", ["--plan", full, "--schedule", "continuous"]),
        ("full plan, oneshot", ["--plan", full, "--schedule", "oneshot"]),
        ("plan pair, continuous", pair + ["--schedule", "continuous"]),
        ("plan pair on tt_gemm, continuous",
         pair + ["--schedule", "continuous", "--plan-backend", "tt_gemm"]),
        ("rank plan, continuous", ["--plan", rank, "--schedule", "continuous"]),
        ("rank plan, oneshot", ["--plan", rank, "--schedule", "oneshot"]),
        ("rank plan on tt_gemm, continuous",
         ["--plan", rank, "--schedule", "continuous", "--plan-backend", "tt_gemm"]),
    ]
    notes, tokens, rank_counts = [], {}, None
    launches.reset()
    for label, argv in runs:
        if label.startswith("rank") and rank_counts is None:
            rank_counts = launches.snapshot()
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
    rank_counts = {k: counts[k] - rank_counts[k] for k in counts}
    for plan in ("full plan", "rank plan"):
        if tokens[f"{plan}, continuous"] != tokens[f"{plan}, oneshot"]:
            raise AssertionError(f"{plan}: continuous and oneshot serving disagree")
        notes.append(f"{plan}: continuous == oneshot per request: yes")
    return counts, rank_counts, notes


# ---------------------------------------------------------------------------
# phase 4a: sharded serving, ranks sharing the card
# ---------------------------------------------------------------------------

#: the plan pair searched at per-rank shapes (``--shards 2``)
SHARD_PAIR = ("tt-lm-100m.shards2.pair.prefill.json",
              "tt-lm-100m.shards2.pair.decode.json")
#: (ranks, tt_model_reduce) of each sharded run
SHARD_RUNS = ((2, False), (4, True))
#: (label, --plan-backend) of each serve run on the ranks: the pair's own
#: backends (K1), and the pair forced to tt_gemm (K2, K3, K4)
SHARD_BACKENDS = (("auto", None), ("tt_gemm", "tt_gemm"))
SHARD_KERNELS = {"auto": ("streaming_tt",),
                 "tt_gemm": ("tt_gemm_os", "tt_gemm_ws", "tt_gemm_is")}
#: seconds a spawn of the ranks may take, start-up and every rank's runs
SHARD_TIMEOUT_S = 300
#: fp32 prefill batch of the logits check (tokens divide over 2 and 4 ranks)
SHARD_LOGITS_BATCH = (4, 32)


def _shard_pair_argv() -> list[str]:
    return ["--plan-prefill", os.path.join(PLANS, SHARD_PAIR[0]),
            "--plan-decode", os.path.join(PLANS, SHARD_PAIR[1])]


def _shard_tokens(cfg, device):
    import torch

    return torch.randint(0, cfg.vocab, SHARD_LOGITS_BATCH,
                         generator=torch.Generator().manual_seed(5)).to(device)


def _expected_shards(cfg, reduce: bool) -> dict:
    """TT layer name -> (mesh, d_in per rank) the sharded route must record:
    token-parallel over ``data=2``, and under ``reduce`` row-parallel too
    for the layers whose leading input mode divides by 2."""
    from repro_torch.models.blocks import attn_spec, mlp_spec
    from repro_torch.models.lm import head_spec

    a, m = attn_spec(cfg), mlp_spec(cfg)
    out = {}
    for spec in (a.q_spec, a.k_spec, a.v_spec, a.o_spec, m.up_spec,
                 m.gate_spec, m.down_spec, head_spec(cfg)):
        if not spec.tensorized:
            continue
        if reduce and spec.in_modes[0] % 2 == 0:
            out[spec.name] = ("data=2+reduce(model=2)", spec.d_in // 2)
        else:
            out[spec.name] = ("data=2", spec.d_in)
    return out


def step_collectives(cfg, plan, backend, step: str, batch: int, seq: int,
                     reduce: bool = True, frames: int = 0, mesh=(2, 2),
                     cell=None, policy=None) -> dict:
    """PERF.md's count (section 6) of the collectives of one step of
    ``cfg`` under ``plan`` (its backends forced to ``backend`` when given)
    on a ``data x model`` mesh of ``mesh`` (``data=2 x model=2`` unless
    told), with ``tt_model_reduce`` or without: a decode step of ``batch``
    lanes over caches of ``seq`` positions, the serve engine's prefill of
    ``batch`` prompts of ``seq`` tokens, or a train step of ``batch`` x
    ``seq`` (a ``{"fwd", "bwd"}`` pair; an encoder-decoder's encoder on
    ``frames`` frames, a VLM's image prefix of ``frames`` positions).  The
    rules are ``make_rules`` of the config ``policy`` (default ``cfg``) and
    the cell ``cell`` (default: the step's own shape), as the launchers
    make them.  The
    layout and each projection's route come from the port's own decisions
    (``splits_sequence``, ``kv_layout``, ``head_layout``, ``state_heads``,
    ``ff_split``, ``vocab_split``, ``nn.linear.sharded_route``); the
    counts a route sends are this formula's.

    Per site and application: attention gathers its output (``kv_major``)
    and, backward, the gradients of q, k, v (``kv_major``) or q
    (``q_block``, with one all-reduce of K and V's); the MLP gathers,
    backward, the gradients of its up and gate blocks (d_ff split); the
    SSM gathers its gated output before the norm and, backward, the
    gradients of its z/x, dt, per-head and conv blocks (4) and sums B and
    C's (one all-reduce); RWKV's time mix gathers, backward, its
    activations', fp32 parameters' and norm scale's blocks (3); the
    cross-attention gathers, backward, q, k and v's.  ``wo`` (``q_block``),
    ``wd`` (d_ff), RWKV's ``wo`` and ``xattn.wo`` (split) gather their
    input where they do not take their column block.  The logits: a decode
    step gathers the vocab and, in the serve engine (not the
    encoder-decoder's step builders), the lanes; a prefill gathers the
    vocab of its last row; a train step gathers the loss's per-token terms
    (each loss chunk twice, its checkpoint recomputes it) and, backward,
    each chunk's logit gradients.  A row-parallel projection all-reduces
    its partial output and, backward, all-gathers its input columns
    (unless it took its block) and its leading core's slice and
    all-reduces its other cores; a projection whose rows split over
    ``model`` all-gathers its output, and backward its rows, and
    all-reduces its cores.  A train step sums the loss and the gradients
    over ``data`` where the batch splits over it.

    Under SP, where the step's sequence splits over ``model``
    (``splits_sequence``), every head, d_ff and the vocab are whole and a
    planned projection runs on the rank's rows (no collective): attention
    all-gathers K and V once and, backward, all-reduces their gradient;
    the MoE sums its router statistics over the batch and sequence axes
    (one all-reduce, and one backward) where the router group divides the
    rank's positions, else all-gathers the sequence (one all-gather, one
    backward all-reduce) and routes as over the batch; a prefill gathers
    the positions of its logits (one all-gather); the train step sums the
    loss and the gradients over the batch and sequence axes.  The hybrid's
    Mamba2 layers under SP all-gather their conv tails and their SSD end
    states (two all-gathers a layer and, backward, two all-reduces); the
    encoder-decoder's frames split as its tokens do (the formula counts
    steps whose frames and tokens split alike), its encoder attention
    gathers K and V as the decoder's, and each decoder layer's cross K/V
    of the rank's frames are all-gathered once, outside the remat (one
    all-reduce backward).  With ``remat`` each block's forward
    collectives run again in the backward (counted forward, as the loss
    chunks' are), and the hybrid's Mamba layers inside a group (nested
    under the group's checkpoint) run a third time.  A decode step over KV
    caches split over their positions (``kv_layout``) all-gathers the
    blocks' softmax statistics once an attention layer.  The experts'
    planned projections are not counted: they run on the rank's rows
    under SP and ``batch_split``, and elsewhere which of them run depends
    on the router."""
    import dataclasses

    from repro_torch.launch.mesh import Mesh, batch_layout, make_rules
    from repro_torch.models.blocks import (attn_spec, mlp_spec, moe_spec, rwkv_spec,
                                           ssm_spec)
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.encdec import _xattn_specs
    from repro_torch.models.lm import _hybrid_groups, head_spec
    from repro_torch.nn.linear import sharded_route
    from repro_torch.sharding import (ff_split, head_layout, kv_layout, splits_sequence,
                                      state_heads, use_rules, vocab_split)

    train = step == "train"
    axes = {"data": mesh[0], "model": mesh[1]}
    mesh = Mesh(axes, {"data": 0, "model": 0}, {})
    rules = batch_layout(dataclasses.replace(make_rules(
        policy or cfg, cell or ShapeConfig("cli", seq, batch, step), mesh),
        tt_model_reduce=reduce), batch)
    rows = batch // rules.split_dp
    s = 1 if step == "decode" else seq
    prefix = frames if cfg.family == "vlm" else 0
    f = frames or seq                                   # the encoder's frames
    with use_rules(rules):
        sp = splits_sequence(cfg.family, rows, s + prefix)
        if cfg.family == "encdec" and step != "decode" and \
                splits_sequence(cfg.family, rows, f) != sp:
            raise ValueError("the formula counts steps whose frames and tokens "
                             "split alike")
    if step == "decode":
        rules = kv_layout(rules, cfg.family, cfg.n_kv_heads, seq)
    if sp:
        rules = dataclasses.replace(rules, seq_split=True)
        s = (s + prefix) // rules.tp
        f //= rules.tp
    again = 2 if train and cfg.remat != "none" else 1    # the remat recompute
    L, fam = cfg.n_layers, cfg.family
    # (site, spec, applications, positions a sequence)
    if fam == "hybrid":
        n_groups, rest = _hybrid_groups(cfg)
        sites = [("ssm", ssm_spec(cfg), L - rest, s, again + (again > 1)),
                 ("ssm", ssm_spec(cfg), rest, s, again),
                 ("attn", attn_spec(cfg, "shared_attn"), n_groups, s, again)]
    elif fam == "rwkv":
        sites = [("rwkv", rwkv_spec(cfg), L, s, again)]
    elif fam == "encdec":
        sites = [("attn", attn_spec(cfg, "dec_attn"), L, s, again),
                 ("cross", cfg, L, s, again), ("mlp", mlp_spec(cfg, "dec_mlp"), L, s, again)]
        if step != "decode":
            e = cfg.encoder_layers
            sites = [("attn", attn_spec(cfg, "enc_attn", causal=False), e, f, again),
                     ("mlp", mlp_spec(cfg, "enc_mlp"), e, f, again)] + sites
    elif fam == "moe":
        sites = [("attn", attn_spec(cfg), L, s, again), ("moe", moe_spec(cfg), L, s, again)]
        if moe_spec(cfg).shared_spec is not None:
            sites.append(("mlp", moe_spec(cfg).shared_spec, L, s, again))
    else:
        sites = [("attn", attn_spec(cfg), L, s, again), ("mlp", mlp_spec(cfg), L, s, again)]
    sums = int(train and (rules.batch_split or sp))     # the loss's and the grads'
    fwd = {"all_gather": 0, "all_reduce": sums, "grad_all_reduce": 0}
    bwd = {"all_gather": 0, "all_reduce": 0, "grad_all_reduce": sums}
    projections = []            # (spec, applications, tokens, takes its block)

    def route(sp, tokens) -> str:
        lp = plan.layer(sp.name) if (plan is not None and sp.tensorized) else None
        if lp is not None and backend:
            lp = lp.with_backend(backend)
        r = sharded_route(sp, lp, tokens)
        return "" if r is None else "reduce" if r[1].model_reduce else "tokens" if r[1].axes else ""

    with use_rules(rules):
        for site, spec, n, pos, again in sites:
            if site == "attn":
                layout = head_layout(cfg.n_heads, cfg.n_kv_heads)
                fwd["all_gather"] += n * again * ((layout == "kv_major") + sp
                                                  + rules.cache_seq_split)
                bwd["all_gather"] += n * {"kv_major": 3, "q_block": 1, "whole": 0}[layout]
                bwd["all_reduce"] += n * ((layout == "q_block") + sp * train)
                projections += [(p, n, rows * pos, p == spec.o_spec and layout == "q_block")
                                for p in (spec.q_spec, spec.k_spec, spec.v_spec,
                                          spec.o_spec)]
            elif site == "mlp":
                ff = ff_split((rows, pos), spec.d_ff)
                ups = ((spec.up_spec, spec.gate_spec) if spec.kind == "swiglu"
                       else (spec.up_spec,))
                bwd["all_gather"] += n * len(ups) * ff
                projections += [(p, n, rows * pos, p == spec.down_spec and ff)
                                for p in (*ups, spec.down_spec)]
            elif site == "moe":
                dp = rules.split_dp
                g = min(spec.router_group, dp * rows * rules.tp ** sp * pos)
                kind = "all_reduce" if (sp or dp > 1) else None
                if sp and pos % g:                 # the sequence gathered
                    fwd["all_gather"] += n * again
                    bwd["all_reduce"] += n * train
                    g = min(spec.router_group, dp * rows * seq)
                    kind = ("all_gather" if (rows * seq) % g else "all_reduce"
                            ) if dp > 1 else None
                elif dp > 1 and not sp and (rows * pos) % g:
                    kind = "all_gather"
                if kind is not None:               # the statistics or the batch
                    fwd[kind] += n * again
                    bwd["all_reduce"] += n * train
            elif site == "ssm":
                split = state_heads(spec.n_heads)
                fwd["all_gather"] += n * again * (split + 2 * sp)
                bwd["all_gather"] += 4 * n * split
                bwd["all_reduce"] += n * (split + 2 * sp * train)
                projections += [(p, n, rows * pos, False)
                                for p in (spec.in_spec, spec.out_spec)]
            elif site == "rwkv":
                split = state_heads(spec.n_heads)
                bwd["all_gather"] += 3 * n * split
                projections += [(spec.proj(t), n, rows * pos, t == "wo" and split)
                                for t in ("wr", "wk", "wv", "wg", "wo", "cmv")]
                projections += [(spec.proj("cmk", spec.ffn), n, rows * pos, False),
                                (spec.cmr_spec, n, rows * pos, False)]
            else:                                   # the cross-attention
                split = head_layout(cfg.n_heads, cfg.n_kv_heads) == "kv_major"
                bwd["all_gather"] += 3 * n * split
                fwd["all_gather"] += n * (sp + rules.cache_seq_split)   # K/V, or softmax
                bwd["all_reduce"] += n * sp * train
                xs = _xattn_specs(cfg)
                projections += [(xs["wq"], n, rows * pos, False),
                                (xs["wo"], n, rows * pos, split)]
                if step != "decode":
                    projections += [(xs[t], n, rows * f, False) for t in ("wk", "wv")]
        if not cfg.tie_embeddings:
            projections.append((head_spec(cfg), 1, rows * s, False))
        routes = [route(p, tokens) for p, _, tokens, _ in projections]
        if step == "decode":
            fwd["all_gather"] += vocab_split((rows, 1), cfg.vocab)
            fwd["all_gather"] += rules.batch_split and fam != "encdec"   # the lanes
        elif step == "prefill":
            fwd["all_gather"] += 1 if sp else vocab_split((rows, s), cfg.vocab)
        elif cfg.loss_chunk:
            c = min(cfg.loss_chunk, s)
            chunks = s // (c if s % c == 0 else s)
            vocab = vocab_split((rows * s // chunks,), cfg.vocab)
            fwd["all_gather"] += 2 * chunks * vocab
            bwd["all_gather"] += chunks * vocab
        else:
            vocab = vocab_split((rows, s), cfg.vocab)
            fwd["all_gather"] += vocab
            bwd["all_gather"] += vocab
    for (p, n, _, takes), r in zip(projections, routes):
        fwd["all_gather"] += n * (takes and r != "reduce")
        if r == "reduce":
            fwd["all_reduce"] += n
            bwd["all_gather"] += n * (2 - takes)
            bwd["all_reduce"] += n
        elif r == "tokens":
            fwd["all_gather"] += n
            bwd["all_gather"] += n
            bwd["all_reduce"] += n
    return {"fwd": fwd, "bwd": bwd} if train else fwd


def shard_rank(out_dir: str) -> int:
    """One rank of the shard phase (``chip_smoke.py --shard-rank DIR``):
    joins the ``gloo`` group, serves through ``launch.serve.run`` under
    each setting of :data:`SHARD_BACKENDS`, counts launches and collectives
    of one prefill and one decode step of 4 lanes, and compares fp32
    prefill logits and the decode step's with the parent's single-device
    ones.  Writes ``rank<r>.json``."""
    import contextlib
    import dataclasses
    import datetime
    import io

    import torch
    import torch.distributed as dist

    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.models import api
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.lm import whole_logits
    from repro_torch.plan import execution_log, load_plan
    from repro_torch.plan.sharded import COLLECTIVES, reset_collectives
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding import use_rules
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    dist.init_process_group("gloo", init_method="env://", timeout=datetime.timedelta(
        seconds=SHARD_TIMEOUT_S))
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
        # gloo's collectives on CUDA tensors, before the model needs them
        t = torch.full((2, 3), float(rank), device=device)
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        s = t.clone()
        dist.all_reduce(s)
        out = {"rank": rank, "device": str(device), "gloo_cuda": {
            "all_gather": all(torch.equal(p, torch.full_like(t, i))
                              for i, p in enumerate(parts)),
            "all_reduce": torch.equal(s, torch.full_like(t, sum(range(world))))}}
        pair = spec["pair"]
        for label, backend in SHARD_BACKENDS:
            argv = pair + SERVE + ["--schedule", "continuous"] + (
                ["--plan-backend", backend] if backend else [])
            launches.reset()
            reset_collectives()
            with contextlib.redirect_stdout(io.StringIO()) as text:
                run = serve.run(argv, tt_model_reduce=spec["reduce"])
            if run.code != 0:
                raise AssertionError(f"rank {rank}: serve ({label}) exited "
                                     f"{run.code}\n{text.getvalue()}")
            recs = execution_log()
            out[label] = {
                "report": text.getvalue(),
                "tokens": {str(k): list(v)
                           for k, v in run.result.tokens_by_rid().items()},
                "launches": dict(run.launches),
                "collectives": dict(COLLECTIVES),
                "wall_s": run.summary["wall_s"],
                "gen_tok_s": run.summary["gen_tok_s"],
                "records": sorted({(r["stream"], r["name"], r["backend"], r["mesh"],
                                    tuple(r["shard_shape"] or ()), r["tokens"])
                                   for r in recs})}
        cfg = get_config("tt-lm-100m")
        pre, dec = load_plan(pair[1]), load_plan(pair[3])
        rules = make_rules(cfg, ShapeConfig("cli", 48, 4, "decode"), make_test_mesh())
        rules = dataclasses.replace(rules, tt_model_reduce=spec["reduce"])
        out["coords"] = dict(rules.mesh.coords)
        toks = _shard_tokens(cfg, device)
        out["per_call"], out["logits"], out["decode"] = {}, {}, {}
        for label, backend in SHARD_BACKENDS:
            with use_rules(rules):
                m = api(cfg, plan=pre, plan_backend=backend, device=device)
                params = m.init_params(0)
                got, _ = m.prefill_full(params, {"tokens": toks}, 48)
                got = whole_logits(got, cfg.vocab)   # a rank's vocab block, gathered
                eng = ServeEngine(cfg, params, n_slots=4, max_seq=48,
                                  prompt_bucket=8, prefill_plan=pre,
                                  decode_plan=dec, arch="tt-lm-100m",
                                  plan_backend=backend)
                launches.reset()
                reset_collectives()
                first, step, caches, per_prefill, per_decode = _lane_decode(eng, toks)
                lanes, rows = eng.lanes, int(caches[0].k.shape[0])
                cache_bytes = sum(t.numel() * t.element_size() for t in leaves(caches))
            torch.cuda.synchronize(device)
            want = torch.load(spec["logits"][label]).to(device)
            want_dec = torch.load(spec["decode"][label])
            out["per_call"][label] = {"prefill": per_prefill, "decode": per_decode}
            out["logits"][label] = {
                "shape": list(got.shape), "finite": bool(torch.isfinite(got).all()),
                "equal": bool(torch.equal(got, want)),
                "max_abs_diff": float((got - want).abs().max()),
                "scale": float(want.abs().max())}
            step = torch.from_numpy(step)
            out["decode"][label] = {
                "lanes": list(lanes), "cache_rows": rows, "cache_bytes": cache_bytes,
                "kv_heads": int(caches[0].k.shape[2]),
                "first_equal": first == want_dec["first"],
                "finite": bool(torch.isfinite(step).all()),
                "equal": bool(torch.equal(step, want_dec["logits"])),
                "max_abs_diff": float((step - want_dec["logits"]).abs().max()),
                "scale": float(want_dec["logits"].abs().max())}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def _lane_decode(eng, toks) -> tuple:
    """The 4 prompts of ``toks`` (4, 32) prefilled (batch 1) and admitted
    into the engine's 4 lanes, then one decode step of every lane.
    Returns the greedy first tokens, the step's logits ((4, V) np.ndarray),
    the caches, and (launches, collectives) of the first prefill and of
    the decode step."""
    import numpy as np

    from repro_torch.kernels import launches
    from repro_torch.plan.sharded import COLLECTIVES, reset_collectives

    caches = eng.fresh_caches()
    first, per_prefill = [], None
    for lane in range(toks.shape[0]):
        launches.reset()
        reset_collectives()
        row, small = eng.prefill_request(toks[lane].tolist())
        if per_prefill is None:
            per_prefill = (launches.snapshot(), dict(COLLECTIVES))
        caches = eng.admit(caches, small, lane)
        first.append(int(np.argmax(row)))
    launches.reset()
    reset_collectives()
    logits, caches = eng.decode(np.array(first), np.full(len(first), toks.shape[1]),
                                caches)
    return (first, logits, caches, per_prefill,
            (launches.snapshot(), dict(COLLECTIVES)))


def _spawn_ranks(world: int, spec: dict, out_dir: str) -> tuple[list[dict], float]:
    """Run :func:`shard_rank` on ``world`` processes sharing the card; every
    rank must exit 0 within :data:`SHARD_TIMEOUT_S`, or all are killed and
    the phase fails.  Returns each rank's result and the wall seconds."""
    from repro_torch.launch.ranks import spawn_ranks

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump(spec, f)
    wall = spawn_ranks(
        [sys.executable, os.path.abspath(__file__), "--shard-rank", out_dir],
        world, out_dir, SHARD_TIMEOUT_S, env=dict(os.environ, OMP_NUM_THREADS="1"))
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, wall


def shard_phase(device, card: str) -> tuple[dict, list[str]]:
    """Full-width tt-lm-100m served by 2 ranks (``data=2``) and by 4 ranks
    (``data=2 x model=2``, ``tt_model_reduce``) that share ``cuda:0`` over
    ``gloo``, under the ``--shards 2`` pair with its own backends (K1) and
    forced to tt_gemm (K2-K4).  Each data rank holds and decodes 2 of the
    4 decode lanes (the batch layout); the batch-1 prefill is replicated.
    The oracle is the single-device route in this process: 2 ranks give
    its tokens and its fp32 prefill logits bit for bit (the prefill's route
    is unchanged); the decode step's fp32 logits of all 4 lanes, gathered,
    are within 1e-4 x max |logit| on 2 and 4 ranks (bit for bit where
    cuBLAS picks the same algorithms at half the batch: the report says),
    and so are the 4-rank prefill logits.  A decode step on 2 ranks under
    the auto pair sends the logits' gather alone.  Every rank's records
    sit at their mesh and per-shard shapes (the local rows), no planned
    kernel layer falls back to the plain executor, and every rank launches
    K1 (auto) and K2, K3, K4 (tt_gemm).  Returns the launches summed over
    every rank's serve runs, and the report lines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.launch.serve import run
    from repro_torch.models import api
    from repro_torch.plan import load_plan
    from repro_torch.serve import ServeEngine

    pair = _shard_pair_argv()
    cfg = get_config("tt-lm-100m")
    pre, dec = load_plan(pair[1]), load_plan(pair[3])
    notes, want_tokens = [], {}
    work = tempfile.mkdtemp(prefix="repro_torch_shards_")
    try:
        spec = {"pair": pair, "logits": {}, "decode": {}}
        toks = _shard_tokens(cfg, device)
        for label, backend in SHARD_BACKENDS:
            out = run(pair + SERVE + ["--schedule", "oneshot"]
                      + (["--plan-backend", backend] if backend else []))
            if out.code != 0:
                raise AssertionError(f"single-device serve ({label}) exited {out.code}")
            want_tokens[label] = {str(k): list(v)
                                  for k, v in out.result.tokens_by_rid().items()}
            m = api(cfg, plan=pre, plan_backend=backend, device=device)
            params = m.init_params(0)
            logits, _ = m.prefill_full(params, {"tokens": toks}, 48)
            path = os.path.join(work, f"logits.{label}.pt")
            torch.save(logits.cpu(), path)
            spec["logits"][label] = path
            eng = ServeEngine(cfg, params, n_slots=4, max_seq=48, prompt_bucket=8,
                              prefill_plan=pre, decode_plan=dec, arch="tt-lm-100m",
                              plan_backend=backend)
            first, step, _, _, _ = _lane_decode(eng, toks)
            path = os.path.join(work, f"decode.{label}.pt")
            torch.save({"first": first, "logits": torch.from_numpy(step)}, path)
            spec["decode"][label] = path
            del params, eng
        planned_backend = {label: {
            stream: {lp.name: backend or lp.backend for lp in plan.layers}
            for stream, plan in (("prefill", pre), ("decode", dec))}
            for label, backend in SHARD_BACKENDS}
        totals = {k: 0 for k in launches.COUNTS}
        cache_bytes = {}
        for world, reduce in SHARD_RUNS:
            ranks, wall = _spawn_ranks(world, {**spec, "reduce": reduce},
                                       os.path.join(work, f"w{world}"))
            cache_bytes[world] = {label: [res["decode"][label]["cache_bytes"]
                                          for res in ranks]
                                  for label, _ in SHARD_BACKENDS}
            expect = _expected_shards(cfg, reduce)
            for res in ranks:
                r = res["rank"]
                if not all(res["gloo_cuda"].values()):
                    raise AssertionError(f"rank {r}: gloo collectives on CUDA "
                                         f"tensors gave wrong values {res['gloo_cuda']}")
                for label, _ in SHARD_BACKENDS:
                    got = res[label]
                    for k, v in got["launches"].items():
                        totals[k] += v
                    for name in SHARD_KERNELS[label]:
                        if got["launches"][name] <= 0:
                            raise AssertionError(f"{world} ranks, rank {r}, {label}: "
                                                 f"kernel {name} never launched")
                    for stream, name, backend, mesh, shape, tokens in got["records"]:
                        planned = planned_backend[label][stream][name]
                        if backend == "jnp":
                            # a layer the plan puts on jnp (the decode pair's
                            # attention at 2 tokens a rank) runs whole on
                            # every rank; a kernel layer there was demoted
                            if planned != "jnp" or mesh:
                                raise AssertionError(
                                    f"{world} ranks, {label}: {name} ({stream}, "
                                    f"planned {planned}) ran on the plain executor")
                            continue
                        if (mesh, shape) != (expect[name][0], [tokens, expect[name][1]]):
                            raise AssertionError(
                                f"{world} ranks, {label}: record "
                                f"{(stream, name, mesh, shape, tokens)} not at its "
                                f"per-shard shape {expect[name]}")
                    lg = res["logits"][label]
                    if lg["shape"] != [*SHARD_LOGITS_BATCH, cfg.vocab] or not lg["finite"]:
                        raise AssertionError(f"rank {r}: bad logits {lg}")
                    if world == 2 and not (lg["equal"] and got["tokens"] == want_tokens[label]):
                        raise AssertionError(
                            f"2 ranks, rank {r}, {label}: not bit-identical to the "
                            f"single device (logits equal {lg['equal']}, max diff "
                            f"{lg['max_abs_diff']:.3e}; tokens equal "
                            f"{got['tokens'] == want_tokens[label]})")
                    if lg["max_abs_diff"] > 1e-4 * lg["scale"]:
                        raise AssertionError(f"{world} ranks, rank {r}, {label}: "
                                             f"logits differ by {lg['max_abs_diff']}")
                    # the decode lanes: this rank's block of the 4, the step's
                    # logits of every lane gathered
                    dc = res["decode"][label]
                    lo = 2 * res["coords"]["data"]
                    if dc["lanes"] != [lo, lo + 2] or dc["cache_rows"] != 2 or \
                            not dc["finite"] or not dc["first_equal"]:
                        raise AssertionError(f"{world} ranks, rank {r}, {label}: decode "
                                             f"lanes {dc}")
                    if dc["max_abs_diff"] > 1e-4 * dc["scale"]:
                        raise AssertionError(f"{world} ranks, rank {r}, {label}: decode "
                                             f"logits differ by {dc['max_abs_diff']}")
                    pc = res["per_call"][label]["decode"][1]
                    if world == 2 and label == "auto" and pc != {
                            "all_gather": 1, "all_reduce": 0, "grad_all_reduce": 0}:
                        raise AssertionError(f"2 ranks, rank {r}: a decode step sent "
                                             f"{pc}, not the logits' gather alone")
                    # the model split: 2 of the 4 kv heads a rank, and the
                    # decode step's collectives as PERF.md counts them
                    if world == 4:
                        want_pc = step_collectives(cfg, dec, dict(SHARD_BACKENDS)[label],
                                                   "decode", 4, 1)
                        if dc["kv_heads"] != 2 or pc != want_pc:
                            raise AssertionError(
                                f"4 ranks, rank {r}, {label}: {dc['kv_heads']} kv "
                                f"heads a rank; a decode step sent {pc}, not {want_pc}")
            r0 = ranks[0]
            said = [ln for ln in r0["auto"]["report"].splitlines()
                    if ln.startswith("sharded execution:")]
            layout = [ln for ln in r0["auto"]["report"].splitlines()
                      if ln.startswith("layout:")]
            if not said or f"{world} ranks share one card" not in said[0]:
                raise AssertionError(f"{world} ranks: rank 0's report lacks the "
                                     f"sharded-execution line: {said}")
            if not layout or "decode batch split over data=2: 2 of 4 lanes" not in layout[0] \
                    or (world == 4) != ("heads kv_major over model=2: 2 of 4 kv heads a "
                                        "rank" in layout[0]):
                raise AssertionError(f"{world} ranks: rank 0's layout line {layout}")
            notes.append(f"{world} ranks sharing one card, not a scaling figure "
                         f"({card}; mesh {'data=2 x model=2, tt_model_reduce' if reduce else 'data=2'}, "
                         f"gloo): spawn wall {wall:.1f} s; rank 0 said: {layout[0]}; "
                         f"{said[0]}")
            for label, _ in SHARD_BACKENDS:
                got = r0[label]
                same = sum(got["tokens"][k] == want_tokens[label][k]
                           for k in want_tokens[label])
                lg = [res["logits"][label] for res in ranks]
                shapes = sorted({(m, tuple(s)) for _, _, b, m, s, _ in got["records"]
                                 if b != "jnp"})
                pc = r0["per_call"][label]
                notes.append(
                    f"  {label}: rank 0 serve wall {got['wall_s']:.3f} s, "
                    f"{got['gen_tok_s']:.1f} gen tok/s; requests with the single "
                    f"device's tokens {same}/{len(want_tokens[label])}; prefill logits "
                    f"bit-identical on {sum(x['equal'] for x in lg)}/{len(lg)} ranks, "
                    f"max abs diff {max(x['max_abs_diff'] for x in lg):.3e} (max |logit| "
                    f"{lg[0]['scale']:.3e}); launches per rank "
                    f"{[{k: v for k, v in res[label]['launches'].items() if v} for res in ranks]}")
                dcs = [res["decode"][label] for res in ranks]
                notes.append(
                    f"    decode step, 4 lanes (2 a data rank, logits gathered): "
                    f"logits bit-identical to the single device on "
                    f"{sum(x['equal'] for x in dcs)}/{len(dcs)} ranks, max abs diff "
                    f"{max(x['max_abs_diff'] for x in dcs):.3e} (max |logit| "
                    f"{dcs[0]['scale']:.3e}); first tokens equal on "
                    f"{sum(x['first_equal'] for x in dcs)}/{len(dcs)}")
                notes.append(f"    per-shard (mesh, (tokens, d_in)): {shapes}; KV-cache "
                             f"bytes a rank {cache_bytes[world][label]}")
                notes.append(
                    f"    gloo collectives: {got['collectives']} in the serve run; "
                    f"per prefill {pc['prefill'][1]}, per decode step "
                    f"{pc['decode'][1]}; launches per prefill "
                    f"{ {k: v for k, v in pc['prefill'][0].items() if v} }, per decode "
                    f"step { {k: v for k, v in pc['decode'][0].items() if v} }")
        for label, _ in SHARD_BACKENDS:
            if any(4 * b != 2 * w for b in cache_bytes[4][label]
                   for w in cache_bytes[2][label]):
                raise AssertionError(f"{label}: KV-cache bytes a rank on 4 ranks "
                                     f"{cache_bytes[4][label]} are not half the 2-rank "
                                     f"run's {cache_bytes[2][label]}")
        notes.append(f"  KV-cache bytes a rank, 4 ranks / 2 ranks: "
                     f"{cache_bytes[4]['auto'][0] / cache_bytes[2]['auto'][0]:.3f} "
                     f"(the kv heads over model=2)")
        return totals, notes
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 4a': sharded training, ranks sharing the card
# ---------------------------------------------------------------------------

#: the train plans searched at per-rank shapes (``--shards 2``): K1
#: forward and dx with K3 weight gradients, and tt_gemm with K5 segments
SHARD_TRAIN_PLANS = ("tt-lm-100m.shards2.train.json",
                     "tt-lm-100m.shards2.train.tt_gemm.json")
#: (label, ranks, tt_model_reduce, plan, with a remat="full" step) of each
#: spawn: (a) token-parallel, its spawn also running (d) the remat step;
#: (b) the same plan with the reduce; (c) the tt_gemm plan (K5 on a mesh)
SHARD_TRAIN_RUNS = (("a", 2, False, SHARD_TRAIN_PLANS[0], True),
                    ("b", 4, True, SHARD_TRAIN_PLANS[0], False),
                    ("c", 2, False, SHARD_TRAIN_PLANS[1], False))
SHARD_TRAIN_STEPS = 3
#: a rank's train-run peak memory, at most this share of the single device's
SHARD_TRAIN_PEAK = 0.65


def _is_core(leaf: str) -> bool:
    return leaf.rsplit("/", 1)[-1].startswith("core")


def _shard_train_records(recs, expect: dict, planned: dict, steps: int) -> dict:
    """Check the execution records of sharded training: every record of a
    kernel layer, forward (recompute included) and backward, at its mesh
    and per-shard shape; none of a kernel layer on the plain executor.
    Returns K1's forward and dx calls a step."""
    for r in recs:
        if r["backend"] == "jnp":
            # a layer the plan puts on jnp runs whole on every rank
            if planned[r["name"]] != "jnp" or r["mesh"]:
                raise AssertionError(f"{r['name']} ({r['phase']}, planned "
                                     f"{planned[r['name']]}) ran on the plain executor")
            continue
        mesh, d_in = expect[r["name"]]
        if r["mesh"] != mesh or r["shard_shape"] != [r["tokens"], d_in] or \
                r["tokens"] != 1024:
            raise AssertionError(f"record {(r['name'], r['phase'], r.get('wrt'), r['mesh'], r['shard_shape'])} "
                                 f"not at its per-shard shape {(mesh, [1024, d_in])}")
    if not any(r["phase"] == "bwd" for r in recs):
        raise AssertionError("no backward record")
    return {"k1_fwd": sum(r["phase"] == "fwd" and r["backend"] == "streaming_tt"
                          and "segment" not in r for r in recs) // steps,
            "k1_dx": sum(r["phase"] == "bwd" and r.get("wrt") == "dx"
                         and r["backend"] == "streaming_tt" for r in recs) // steps}


def shard_train_rank(out_dir: str) -> int:
    """One rank of the shard-train phase (``chip_smoke.py --shard-train-rank
    DIR``): joins the ``gloo`` group, takes step 0 of full-width tt-lm-100m
    under the spawn's plan and rules and holds every gradient leaf against
    the single device's, trains :data:`SHARD_TRAIN_STEPS` AdamW steps
    through ``launch.train.run``, and with ``remat`` one ``remat="full"``
    step (its recompute on the autograd engine's device thread).  Writes
    ``rank<r>.json``."""
    import contextlib
    import dataclasses
    import datetime
    import io

    import torch
    import torch.distributed as dist

    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.launch import train
    from repro_torch.launch.mesh import batch_layout, make_rules, make_test_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.plan import execution_log, load_plan, reset_execution_log
    from repro_torch.plan.sharded import (BWD_COLLECTIVES, COLLECTIVES,
                                          reset_collectives)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    dist.init_process_group("gloo", init_method="env://", timeout=datetime.timedelta(
        seconds=SHARD_TIMEOUT_S))
    try:
        rank = dist.get_rank()
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
        cfg = get_config("tt-lm-100m")
        plan = load_plan(spec["plan"])
        planned = {lp.name: lp.backend for lp in plan.layers}
        expect = {k: tuple(v) for k, v in spec["expect"].items()}
        rules = batch_layout(dataclasses.replace(
            make_rules(cfg, ShapeConfig("cli", 256, 8, "train"), make_test_mesh()),
            tt_model_reduce=spec["reduce"]), 8)
        if not rules.batch_split:
            raise AssertionError(f"rank {rank}: batch 8 does not split over {rules.axis_sizes}")
        batch = train_batch(cfg, 256, 8, 0, device)
        out = {"rank": rank, "device": str(device)}

        def step0(cfg):
            reset_execution_log()
            reset_collectives()
            loss, grads = _layout_step0(cfg, plan, device, batch, rules)
            torch.cuda.synchronize(device)
            bwd = dict(BWD_COLLECTIVES)
            return loss, grads, execution_log(), {
                "fwd": {k: v - bwd[k] for k, v in COLLECTIVES.items()}, "bwd": bwd}

        loss, grads, recs, coll = step0(cfg)
        _shard_train_records(recs, expect, planned, 1)
        oracle = torch.load(spec["oracle"], weights_only=False)
        want = {k: v.to(device) for k, v in oracle["grads"].items()}
        gaps = _leaf_gaps(grads, want)
        bounds = spec.get("bounds") or {}
        out["step0"] = {
            "loss": loss, "loss_equal": loss == oracle["loss"],
            "loss_rel": abs(loss - oracle["loss"]) / abs(oracle["loss"]),
            "norm_rel": _norm_gap(grads, want),
            "unequal_noncore": sorted(k for k in grads if not _is_core(k)
                                      and not torch.equal(grads[k], want[k])),
            "n_leaves": len(grads), "n_noncore": sum(not _is_core(k) for k in grads),
            "worst_core": max((gaps[k], k) for k in gaps if _is_core(k)),
            "worst_noncore": max((gaps[k], k) for k in gaps if not _is_core(k)),
            "worst_share": max((g / bounds[k], k) for k, g in gaps.items())
            if bounds else None,
            "collectives": coll}
        del grads, want, oracle
        torch.cuda.empty_cache()

        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        launches.reset()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            run = train.run(["--plan", spec["plan"], "--steps", str(SHARD_TRAIN_STEPS),
                             "--ckpt-dir", spec["ckpt"]] + TRAIN,
                            tt_model_reduce=spec["reduce"])
        if run.code != 0:
            raise AssertionError(f"rank {rank}: train exited {run.code}\n{text.getvalue()}")
        out["run"] = {"report": text.getvalue(), "losses": run.losses,
                      "grad_norms": run.grad_norms, "step_s": run.step_s,
                      "launches": run.launches, "collectives": run.collectives,
                      "launches_total": launches.snapshot(),
                      "peak_gib": (torch.cuda.max_memory_allocated(device) - base) / 2**30,
                      **_shard_train_records(execution_log(), expect, planned,
                                             SHARD_TRAIN_STEPS)}
        if spec["remat"]:
            r_loss, _, r_recs, _ = step0(cfg.with_(remat="full"))
            fwd = sum(r["phase"] == "fwd" for r in r_recs)
            out["remat"] = {"loss_equal": r_loss == loss, "n_fwd": fwd,
                            "n_fwd_plain": sum(r["phase"] == "fwd" for r in recs),
                            "n_bwd": sum(r["phase"] == "bwd" for r in r_recs),
                            **_shard_train_records(r_recs, expect, planned, 1)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def _layout_step0(cfg, plan, device, batch, rules) -> tuple[float, dict]:
    """Step 0 of ``cfg`` under ``plan`` and the batch layout of ``rules``:
    this rank's block of ``batch`` through the train step's
    ``loss_and_grads`` (the loss over the global batch; every gradient
    summed over the batch axes).  Returns the loss and ``{path: fp64
    gradient}``."""
    from repro_torch.launch.mesh import LayoutBlocks, batch_shardings
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import api
    from repro_torch.sharding import use_rules
    from repro_torch.tree import leaves

    m = api(cfg, plan=plan, device=device)
    params = m.init_params(0)
    for p in leaves(params):
        p.requires_grad_(True)
    if rules.batch_split:
        batch = LayoutBlocks(batch_shardings(batch, rules), rules).block(batch)
    with use_rules(rules):
        loss, grads = loss_and_grads(m, params, batch)
    return loss.item(), {k: g.double() for k, g in _named_leaves(grads).items()}


def _spawn_train_ranks(world: int, spec: dict, out_dir: str) -> tuple[list[dict], float]:
    """Run :func:`shard_train_rank` on ``world`` processes sharing the card,
    each within :data:`SHARD_TIMEOUT_S`; returns each rank's result and the
    wall seconds."""
    from repro_torch.launch.ranks import spawn_ranks

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump(spec, f)
    wall = spawn_ranks(
        [sys.executable, os.path.abspath(__file__), "--shard-train-rank", out_dir],
        world, out_dir, SHARD_TIMEOUT_S, env=dict(os.environ, OMP_NUM_THREADS="1"))
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, wall


def shard_train_phase(device, card: str) -> tuple[dict, list[str]]:
    """Full-width tt-lm-100m (fp32, seed 0, batch 8 x seq 256) trained by
    ranks sharing ``cuda:0`` over ``gloo`` (:data:`SHARD_TRAIN_RUNS`).  The
    oracle is the single device in this process under the same plan and
    seed.  Each data rank holds 4 of the 8 sequences (the batch layout)
    and the step sums every gradient over ``data``.  On 2 and on 4 ranks:
    the step-0 loss and grad norm within rel 1e-4, every leaf within its
    bound of :func:`family_train_check` (max(1e-4, 10x the plain
    executor's fp32-vs-float64 gap)); on 2 ranks the losses of steps 1-2
    within rel 1e-4 and, under the K1 plan, a step's collectives the
    loss's sum and the gradients' sum alone.  A rank's peak
    ``max_memory_allocated`` over the train run (less what was allocated
    before it) at most :data:`SHARD_TRAIN_PEAK` of the single device's.
    Every record of a kernel layer, the remat step's recompute and
    backward included, at its mesh and per-shard shape (the local rows);
    K1 forward and dx and K3 every step (K3 and K5 under tt_gemm).
    Returns the launches of the train runs, summed over every rank, and
    the report lines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.launch.train import run
    from repro_torch.plan import load_plan

    cfg = get_config("tt-lm-100m")
    batch = train_batch(cfg, 256, 8, 0, device)
    notes, totals = [], {k: 0 for k in launches.COUNTS}
    work = tempfile.mkdtemp(prefix="repro_torch_shard_train_")
    try:
        single = {}
        for plan_file in SHARD_TRAIN_PLANS:
            path = os.path.join(PLANS, plan_file)
            plan = load_plan(path)
            loss, grads = _family_step0(cfg, plan, device, batch, None)
            oracle = os.path.join(work, f"oracle.{plan_file}.pt")
            torch.save({"loss": loss, "grads": {k: v.cpu() for k, v in grads.items()}},
                       oracle)
            plain = _family_step0(cfg, plan, device, batch, "jnp")
            wide = _family_step0(cfg.with_(dtype="float64"), plan, device, batch, "jnp")
            own = _leaf_gaps(plain[1], wide[1])
            bounds = {k: max(1e-4, 10 * g) for k, g in own.items()}
            del plain, wide, grads
            torch.cuda.empty_cache()
            torch.cuda.synchronize(device)
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            out = run(["--plan", path, "--steps", str(SHARD_TRAIN_STEPS), "--ckpt-dir",
                       os.path.join(work, f"single.{plan_file}")] + TRAIN)
            peak = (torch.cuda.max_memory_allocated(device) - base) / 2**30
            if out.code != 0:
                raise AssertionError(f"single-device train ({plan_file}) exited {out.code}")
            single[plan_file] = {"oracle": oracle, "bounds": bounds, "loss0": loss,
                                 "losses": out.losses, "step_s": out.step_s,
                                 "peak_gib": peak}
        peaks = {}
        for label, world, reduce, plan_file, remat in SHARD_TRAIN_RUNS:
            path = os.path.join(PLANS, plan_file)
            expect = _expected_shards(cfg, reduce)
            ranks, wall = _spawn_train_ranks(world, {
                "plan": path, "reduce": reduce, "remat": remat,
                "oracle": single[plan_file]["oracle"],
                "bounds": single[plan_file]["bounds"],
                "expect": expect, "ckpt": os.path.join(work, f"ckpt.{label}")},
                os.path.join(work, f"run.{label}"))
            want = single[plan_file]["losses"]
            need = ("tt_gemm_ws", "fused_path") if "tt_gemm" in plan_file else \
                ("streaming_tt", "tt_gemm_ws")
            for res in ranks:
                r, s0, tr = res["rank"], res["step0"], res["run"]
                where = f"({label}) {world} ranks, rank {r}, {plan_file}"
                for k, v in tr["launches_total"].items():
                    totals[k] += v
                for i, per in enumerate(tr["launches"]):
                    for k in need:
                        if per[k] <= 0:
                            raise AssertionError(f"{where}: step {i} launched no {k}")
                if "tt_gemm" not in plan_file and (tr["k1_fwd"] <= 0 or tr["k1_dx"] <= 0):
                    raise AssertionError(f"{where}: K1 forward {tr['k1_fwd']}, dx "
                                         f"{tr['k1_dx']} calls a step")
                if max(s0["loss_rel"], s0["norm_rel"]) > 1e-4 or \
                        s0["worst_share"][0] > 1.0:
                    raise AssertionError(
                        f"{where}: step 0 loss rel {s0['loss_rel']}, grad norm rel "
                        f"{s0['norm_rel']}, worst leaf share {s0['worst_share']}")
                if world == 2:
                    rel = max(abs(g - w) / abs(w) for g, w in zip(tr["losses"], want))
                    if rel > 1e-4:
                        raise AssertionError(f"{where}: losses {tr['losses']} vs one "
                                             f"device {want} (rel {rel})")
                    if "tt_gemm" not in plan_file and any(c != {
                            "fwd": {"all_gather": 0, "all_reduce": 1, "grad_all_reduce": 0},
                            "bwd": {"all_gather": 0, "all_reduce": 0, "grad_all_reduce": 1}}
                            for c in tr["collectives"]):
                        raise AssertionError(f"{where}: collectives a step "
                                             f"{tr['collectives']}: not the loss's "
                                             "and the gradients' sums alone")
                if world == 4:
                    want_c = step_collectives(cfg, load_plan(path), None, "train", 8, 256)
                    if any(c != want_c for c in tr["collectives"]):
                        raise AssertionError(f"{where}: collectives a step "
                                             f"{tr['collectives']}, not {want_c}")
                share = tr["peak_gib"] / single[plan_file]["peak_gib"]
                if share > SHARD_TRAIN_PEAK:
                    raise AssertionError(
                        f"{where}: peak {tr['peak_gib']:.3f} GiB is {share:.3f}x the "
                        f"single device's {single[plan_file]['peak_gib']:.3f} GiB")
                if remat:
                    rm = res["remat"]
                    if not rm["loss_equal"] or rm["n_fwd"] != 2 * rm["n_fwd_plain"] \
                            or rm["n_bwd"] <= 0:
                        raise AssertionError(f"{where}: remat step {rm}")
            peaks[label] = [res["run"]["peak_gib"] for res in ranks]
            if world == 4 and max(peaks[label]) >= min(peaks["a"]):
                raise AssertionError(
                    f"({label}) the 4-rank peak a rank {peaks[label]} GiB is not below "
                    f"the 2-rank run's {peaks['a']} GiB")
            r0 = ranks[0]
            tr, s0 = r0["run"], r0["step0"]
            said = [ln for ln in tr["report"].splitlines()
                    if ln.startswith("sharded planned execution:")]
            layout = [ln for ln in tr["report"].splitlines() if ln.startswith("layout:")]
            if not said or f"{world} ranks share one card" not in said[0]:
                raise AssertionError(f"({label}) rank 0's report lacks the mesh line: {said}")
            want_layout = "layout: batch split over data=2: 4 of 8 sequences a rank" + (
                "; heads kv_major over model=2: 2 of 4 kv heads a rank, d_ff 1024 of "
                "2048 a rank, vocab 16000 of 32000 a rank" if world == 4 else "")
            if layout != [want_layout]:
                raise AssertionError(f"({label}) rank 0's layout line {layout}")
            steady = tr["step_s"][1:]
            notes.append(
                f"({label}) {world} ranks sharing one card, not a scaling figure ({card}; "
                f"{'data=2 x model=2, tt_model_reduce' if reduce else 'data=2'}, gloo), "
                f"{plan_file}: spawn wall {wall:.1f} s; rank 0 said: {layout[0]}; "
                f"{said[0]}")
            notes.append(
                f"  step 0 vs one device: loss {s0['loss']:.7f} vs "
                f"{single[plan_file]['loss0']:.7f} (equal {s0['loss_equal']}, rel "
                f"{s0['loss_rel']:.1e}), grad norm rel {s0['norm_rel']:.1e}; "
                f"{s0['n_noncore'] - len(s0['unequal_noncore'])}/{s0['n_noncore']} "
                f"non-core leaves bit-identical (worst {s0['worst_noncore'][0]:.1e} "
                f"{s0['worst_noncore'][1]}), worst TT core {s0['worst_core'][0]:.1e} "
                f"({s0['worst_core'][1]}) of {s0['n_leaves']} leaves"
                + (f"; worst share of its bound {s0['worst_share'][0]:.2f} "
                   f"({s0['worst_share'][1]})" if s0["worst_share"] else ""))
            notes.append(
                f"  losses rank 0 {[round(x, 7) for x in tr['losses']]} vs one device "
                f"{[round(x, 7) for x in want]}; step ms a rank first "
                f"{1e3 * tr['step_s'][0]:.1f}, then "
                f"{[round(1e3 * t, 1) for t in steady]} (one device "
                f"{[round(1e3 * t, 1) for t in single[plan_file]['step_s'][1:]]}); peak "
                f"memory a rank {[round(res['run']['peak_gib'], 3) for res in ranks]} GiB, "
                f"{max(res['run']['peak_gib'] for res in ranks) / single[plan_file]['peak_gib']:.3f}x "
                f"the single device's {single[plan_file]['peak_gib']:.3f} GiB (limit "
                f"{SHARD_TRAIN_PEAK}x)")
            notes.append(
                f"  collectives a step (rank 0, the last step): forward "
                f"{tr['collectives'][-1]['fwd']}, backward {tr['collectives'][-1]['bwd']}; "
                f"step 0 (no optimizer) {s0['collectives']}; launches per step a rank "
                f"{ {k: v for k, v in tr['launches'][-1].items() if v} }; K1 calls a "
                f"step: forward {tr['k1_fwd']}, dx {tr['k1_dx']}")
            if remat:
                rm = r0["remat"]
                notes.append(
                    f"  (d) remat=\"full\" step: loss bit-identical {rm['loss_equal']}; "
                    f"{rm['n_fwd']} forward records (without remat {rm['n_fwd_plain']}) "
                    f"and {rm['n_bwd']} backward, every one at its mesh and per-shard "
                    f"shape; K1 forward {rm['k1_fwd']}, dx {rm['k1_dx']}")
        return totals, notes
    finally:
        shutil.rmtree(work, ignore_errors=True)


def model_params(cfg, plan, device, cache: dict):
    """Random weights from seed 0 in ``plan``'s decomposition (a v4 plan's
    factorizations set the TT shapes; the other plans share the frozen
    ones), made once per decomposition."""
    from repro_torch.models import api

    key = tuple(sorted((lp.name, lp.factorization.triple)
                       for lp in plan.layers if lp.factorization is not None))
    if key not in cache:
        cache[key] = api(cfg, plan=plan, device=device).init_params(0)
    return cache[key]


def launches_per_call(device) -> list[str]:
    """Kernel launches of one prefill (32-token prompt) and one decode step
    (4 lanes) under each plan setting the serve phase used."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.plan import load_plan
    from repro_torch.serve import ServeEngine

    cfg = get_config("tt-lm-100m")
    full = load_plan(os.path.join(PLANS, "tt-lm-100m.json"))
    pre = load_plan(os.path.join(PLANS, "tt-lm-100m.pair.prefill.json"))
    dec = load_plan(os.path.join(PLANS, "tt-lm-100m.pair.decode.json"))
    rank = load_plan(os.path.join(PLANS, RANK_PLAN))
    cache: dict = {}
    notes = []
    for label, p, d, backend in (("full plan", full, full, None),
                                 ("plan pair", pre, dec, None),
                                 ("plan pair on tt_gemm", pre, dec, "tt_gemm"),
                                 ("rank plan", rank, rank, None),
                                 ("rank plan on tt_gemm", rank, rank, "tt_gemm")):
        params = model_params(cfg, p, device, cache)
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


#: one device function's totals (device time in us), in the fields
#: :func:`kernel_split` and :func:`_dev_us` read
_Kernel = collections.namedtuple("_Kernel", "key count self_device_time_total")


def device_kernels(prof) -> tuple[float, list]:
    """(ms the card was busy, device functions by time) from the profiler's
    raw records of device activity (kernels, copies).  A host-side op (an
    aten op, an autograd Function) also carries the device time of the
    kernels it launched, so only device records count.  ``key_averages``
    builds one Python event per record, minutes for the ~170 000 kernels of
    a qwen2-moe train step; summing the raw records takes seconds."""
    from torch.autograd import DeviceType

    agg: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns, n = agg.get(e.name(), (0, 0))
            agg[e.name()] = (ns + e.duration_ns(), n + 1)
    rows = sorted((_Kernel(k, n, ns / 1e3) for k, (ns, n) in agg.items()),
                  key=_dev_us, reverse=True)
    return sum(_dev_us(r) for r in rows) / 1e3, rows


def profiled(run, host: bool = False) -> tuple | str:
    """Run ``run()`` once under ``torch.profiler``: (host wall ms, ms the
    card was busy, every event's device time summed in ms (with ``host``,
    which records the host's ops too; else None), device functions by
    time), or ``"not measured (...)"`` when the profiler fails to start or
    to be read.  The profiler is optional instrumentation; an error raised
    by ``run`` is not, and propagates."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA]
                   + ([ProfilerActivity.CPU] if host else []))
    try:
        prof.start()
    except Exception as e:  # the profiler's own failure
        return f"not measured ({type(e).__name__}: {e})"
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    try:
        prof.stop()
        busy, top = device_kernels(prof)
        every = sum(_dev_us(e) for e in prof.key_averages()) / 1e3 if host else None
    except Exception as e:  # the profiler's own failure
        return f"not measured ({type(e).__name__}: {e})"
    return wall, busy, every, top


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
    from repro_torch.configs import get_config
    from repro_torch.plan import load_plan
    from repro_torch.serve import ServeEngine

    cfg = get_config("tt-lm-100m")
    cache: dict = {}
    notes = []
    for label, pre, dec, backend, kernels in DECODE_SETTINGS:
        pre, dec = (load_plan(os.path.join(PLANS, n)) for n in (pre, dec))
        eng = ServeEngine(cfg, model_params(cfg, pre, device, cache), n_slots=4,
                          max_seq=64, prompt_bucket=8, prefill_plan=pre,
                          decode_plan=dec, arch="tt-lm-100m", plan_backend=backend)
        caches = eng.fresh_caches()
        for lane in range(4):
            _, small = eng.prefill_request(list(range(1 + lane, 33 + lane)))
            caches = eng.admit(caches, small, lane)
        notes += profile_decode(engine_step(eng, caches), label, kernels)
    return notes


def engine_step(eng, caches):
    """``step(i)``: one decode step of the serve engine ``eng`` with 4 busy
    lanes at position 32 + i, the caches carried from step to step."""
    import numpy as np

    tok, pos = np.array([7, 8, 9, 10]), np.array([32, 32, 32, 32])
    state = [caches]

    def step(i):
        _, state[0] = eng.decode(tok, pos + i, state[0])

    return step


def profile_decode(step, label: str, kernels) -> list[str]:
    """Profile decode steps 0-4 of ``step`` (4 busy lanes, after unprofiled
    steps 0-2): host wall per step, the card's busy time per step
    (``torch.profiler``, device events only), the kernels that take the
    most of it and the device time of ``kernels``.  A measurement only:
    when the profiler records no device time the lines say "not measured"
    and the run goes on."""
    import torch

    def steps(n):
        for i in range(n):
            step(i)

    steps(3)
    torch.cuda.synchronize()
    n = 5
    res = profiled(lambda: steps(n), host=True)
    if isinstance(res, str):
        return [f"decode step profile ({label}): {res}"]
    wall, busy, every, top = res
    wall, busy, every = wall / n, busy / n, every / n
    if busy <= 0:
        return [f"decode step ({label}, 4 lanes): {wall:.2f} ms wall; card "
                "busy time not measured (the profiler saw no device time)"]
    return ([f"decode step ({label}, 4 lanes, torch.profiler over {n} steps): "
             f"{wall:.2f} ms wall, card busy {busy:.2f} ms "
             f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}% "
             f"(device events only; every event's device time summed: "
             f"{every:.2f} ms)",
             "  top device time per step: " + "; ".join(
                 f"{e.key[:48]} {_dev_us(e) / 1e3 / n:.3f} ms x{e.count // n}"
                 for e in top[:6])]
            + kernel_split(top, busy, n, kernels))


def output_check(device) -> list[str]:
    """Kernel path vs the plain executor, on the card, at full width (the
    full plan and the rank plan); and tt-lm-smoke on the card vs the CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.plan import load_plan

    notes = []
    for name in ("tt-lm-100m.json", RANK_PLAN):
        e, scale = logits_vs_plain(load_plan(os.path.join(PLANS, name)), device)
        notes.append(f"full-width prefill logits under {name}, kernels vs plain "
                     f"executor on the card: max abs diff {e:.3e} (max |logit| "
                     f"{scale:.3e})")

    toks = torch.randint(0, get_config("tt-lm-100m").vocab, (1, 32),
                         generator=torch.Generator().manual_seed(5))
    smoke = get_config("tt-lm-100m", smoke=True)
    splan = load_plan(os.path.join(PLANS, "tt-lm-smoke.json"))
    sm_cpu = api(smoke, plan=splan, device="cpu")
    p_cpu = sm_cpu.init_params(0)
    st = toks[:, :12] % smoke.vocab
    want, _ = sm_cpu.prefill_full(p_cpu, {"tokens": st}, 16)
    sm_gpu = api(smoke, plan=splan, device=device)
    got, _ = sm_gpu.prefill_full(sm_gpu.init_params(0), {"tokens": st.to(device)}, 16)
    e2 = (got.cpu() - want).abs().max().item()
    if e2 > 1e-4:
        raise AssertionError(f"tt-lm-smoke card vs CPU logits differ by {e2}")
    notes.append(f"tt-lm-smoke prefill logits, card vs CPU: max abs diff {e2:.3e}")
    return notes


def calibration_check(device) -> list[str]:
    """The rank search's calibration forward (``activation_calibration``)
    of full-width tt-lm-100m under the installed rank plan, batch 2 x seq
    16 (32 tokens through K1), on the card against the same call on the
    CPU, rtol 1e-4; K1 must have launched."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.nn import install_plan
    from repro_torch.plan import load_plan
    from repro_torch.rank import activation_calibration

    cfg = get_config("tt-lm-100m")
    install_plan(load_plan(os.path.join(PLANS, RANK_PLAN)))
    try:
        launches.reset()
        t0 = time.perf_counter()
        got = activation_calibration(cfg, batch=2, seq=16, device=device)
        card_s = time.perf_counter() - t0
        k1 = launches.snapshot()["streaming_tt"]
        t0 = time.perf_counter()
        want = activation_calibration(cfg, batch=2, seq=16, device="cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        install_plan(None)
    if not k1:
        raise AssertionError("calibration on the card launched no streaming_tt")
    if sorted(got) != sorted(want) or not got:
        raise AssertionError(f"calibration families differ: {sorted(got)} vs "
                             f"{sorted(want)}")
    rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    if rel > 1e-4:
        raise AssertionError(f"calibration, card vs CPU: rel {rel}")
    return [f"calibration under {RANK_PLAN} (batch 2 x seq 16, {k1} K1 launches, "
            f"{card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU): family RMS "
            + ", ".join(f"{k} {got[k]:.6f}" for k in sorted(got))
            + f"; card vs CPU max rel {rel:.1e}"]


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


def train_batch(cfg, seq: int, batch: int, step: int, device) -> dict:
    """Step ``step``'s train batch of ``cfg`` on ``device``: tokens and
    labels from the synthetic pipeline, and for an encoder-decoder seeded
    random frames (batch, seq, d_model) in the config's dtype, made on the
    CPU from a ``torch.Generator``."""
    import torch

    from repro_torch.data import make_pipeline

    out = {k: torch.from_numpy(v).long().to(device)
           for k, v in make_pipeline(cfg.vocab, seq, batch).batch(step).items()}
    if cfg.family == "encdec":
        gen = torch.Generator().manual_seed(1000 + step)
        out["frontend"] = torch.randn(batch, seq, cfg.d_model, generator=gen).to(
            device=device, dtype=getattr(torch, cfg.dtype))
    return out


def train_profile(arch, plan_file, seq, batch, kernels, device,
                  warmup: bool = False) -> list[str]:
    """Where one full-width train step of ``arch`` (seed-0 weights, the
    config's dtype, remat and loss_chunk) under ``plan_file`` goes, after
    one unprofiled step if ``warmup``: host wall, the card's busy share and
    the device functions that take the most of it (``torch.profiler``,
    device activity only), and the device time of ``kernels``.  A
    measurement only: without device time the lines say "not measured"."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.nn import install_plan
    from repro_torch.optim import adamw_init
    from repro_torch.plan import load_plan
    from repro_torch.tree import leaves

    cfg = get_config(arch)
    install_plan(load_plan(os.path.join(PLANS, plan_file)))
    try:
        params = api(cfg, device=device).init_params(0)
        for p in leaves(params):
            p.requires_grad_(True)
        state = [params, adamw_init(params)]
        step = make_train_step(cfg)
        data = train_batch(cfg, seq, batch, 0, device)

        def one_step():
            state[0], state[1], _ = step(state[0], state[1], data)

        if warmup:
            one_step()
        torch.cuda.synchronize()
        res = profiled(one_step)
    finally:
        install_plan(None)
    label = f"{arch} {plan_file} train step"
    if isinstance(res, str):
        return [f"{label} profile: {res}"]
    wall, busy, _, top = res
    if busy <= 0:
        return [f"{label}: {wall:.1f} ms wall (profiled); card busy time not "
                "measured (no device time recorded)"]
    return [f"{label} (torch.profiler, 1 step): {wall:.1f} ms wall, card busy "
            f"{busy:.1f} ms ({100 * busy / wall:.1f}%), idle "
            f"{100 * (1 - busy / wall):.1f}%",
            "  top device time: " + "; ".join(
                f"{e.key[:40]} {_dev_us(e) / 1e3:.2f} ms x{e.count}" for e in top[:8])
            ] + kernel_split(top, busy, 1, kernels)


# ---------------------------------------------------------------------------
# phase 4b: the MoE, hybrid (Mamba2) and RWKV6 families at full width
# ---------------------------------------------------------------------------

#: full-width archs served under their committed plan pairs, and the
#: kernels each one's prefill must launch (K1 everywhere; K3, tt_gemm WS,
#: at zamba2's ssm.win and rwkv6's cmk/cmr); every decode step launches K1
FAMILIES = {"qwen2-moe-a2.7b": ("streaming_tt",),
            "zamba2-1.2b": ("streaming_tt", "tt_gemm_ws"),
            "rwkv6-7b": ("streaming_tt", "tt_gemm_ws")}


def family_pair(arch: str) -> tuple[str, str]:
    return tuple(os.path.join(PLANS, f"{arch}.pair.{p}.json")
                 for p in ("prefill", "decode"))


def family_serve(arch: str) -> tuple[dict, list[str]]:
    """``python -m repro_torch.launch.serve --arch ARCH --plan-prefill ..
    --plan-decode .. --strict-plan`` at full width and depth (seed-0
    weights, the config's dtype),
    continuous then oneshot; per-request
    tokens must agree.  Returns the two runs' launches and report lines."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.launch.serve import run

    pre, dec = family_pair(arch)
    vocab = get_config(arch).vocab
    notes, tokens, start = [], {}, launches.snapshot()
    for sched in ("continuous", "oneshot"):
        before = launches.snapshot()
        log(f"--- families: {arch}, {sched}")
        out = run(["--arch", arch, "--plan-prefill", pre, "--plan-decode", dec,
                   "--schedule", sched] + SERVE)
        if out.code != 0:
            raise AssertionError(f"serve {arch} ({sched}) exited {out.code}")
        delta = {k: out.launches[k] - before[k] for k in before}
        s = out.summary
        notes.append(f"{arch} {sched}: {s['gen_tok_s']:.2f} gen tok/s, "
                     f"{s['total_tok_s']:.2f} total tok/s, ttft p50 "
                     f"{s['ttft_p50_ms']:.1f} ms, wall {s['wall_s']:.2f} s, "
                     f"launches {delta}")
        tokens[sched] = out.result.tokens_by_rid()
        for rid, toks in tokens[sched].items():
            if len(toks) != 16 or not all(0 <= t < vocab for t in toks):
                raise AssertionError(f"{arch} {sched}: request {rid} tokens {toks}")
    if tokens["continuous"] != tokens["oneshot"]:
        raise AssertionError(f"{arch}: continuous and oneshot serving disagree")
    notes.append(f"{arch}: continuous == oneshot per request: yes")
    end = launches.snapshot()
    return {k: end[k] - start[k] for k in end}, notes


#: depth at which each arch's fp32 prefill logits are held to 1e-4 x max
#: |logit| of the plain executor: full depth, except rwkv6-7b.  Under its
#: seed-0 random weights every layer about doubles a rounding difference
#: (two plain fp32 contraction orders on the CPU differ by 1.8e-5, 1.8e-4,
#: 9.0e-3 and 1.19 of ~7 at 1, 4, 8 and 32 layers), so past ~5 layers fp32
#: itself cannot meet the tolerance; its full depth is reported beside the
#: plain executor's own spread between two orders
FAMILY_CHECK_LAYERS = {"rwkv6-7b": 4}


def family_logits(arch: str, device) -> list[str]:
    """Full-width prefill logits (seed-0 weights, a 32-token prompt) under
    the prefill plan's kernels against the plain executor along the same
    paths (``plan_backend="jnp"``) on the card.  In fp32 at full depth,
    beside the plain executor's spread between two contraction orders
    (the plan's paths against the MAC-optimal ones): held to 1e-4 x max
    |logit| at the depth of :data:`FAMILY_CHECK_LAYERS` (the run fails
    otherwise); in the config's bf16, reported."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.nn import install_plan
    from repro_torch.plan import load_plan

    plan = load_plan(family_pair(arch)[0])
    full = get_config(arch)
    depth = FAMILY_CHECK_LAYERS.get(arch, full.n_layers)
    cases = [(full.with_(dtype="float32"), depth == full.n_layers), (full, False)]
    if depth != full.n_layers:
        cases.insert(1, (full.with_(dtype="float32", n_layers=depth), True))
    notes = []
    try:
        for cfg, gate in cases:
            toks = torch.randint(0, cfg.vocab, (1, 32),
                                 generator=torch.Generator().manual_seed(5)).to(device)
            batch = {"tokens": toks}
            m = api(cfg, plan=plan, device=device)
            params = m.init_params(0)
            planned, _ = m.prefill_full(params, batch, 48)
            plain, _ = api(cfg, plan=plan, plan_backend="jnp",
                           device=device).prefill_full(params, batch, 48)
            other, _ = api(cfg, plan=None, device=device).prefill_full(params, batch, 48)
            torch.cuda.synchronize()
            planned, plain, other = planned.float(), plain.float(), other.float()
            if planned.shape != (1, 32, cfg.vocab) or not torch.isfinite(planned).all():
                raise AssertionError(f"{arch}: bad logits {tuple(planned.shape)}")
            e = (planned - plain).abs().max().item()
            spread = (other - plain).abs().max().item()
            scale = plain.abs().max().item()
            same = (planned.argmax(-1) == plain.argmax(-1)).float().mean().item()
            notes.append(f"{arch} prefill logits ({cfg.dtype}, {cfg.n_layers} layers), "
                         f"kernels vs plain executor on the card: max abs diff "
                         f"{e:.3e}, max |logit| {scale:.3e} (ratio {e / scale:.2e}); "
                         f"plain executor, plan paths vs MAC-optimal paths: "
                         f"{spread:.3e}; argmax agrees at {100 * same:.1f}% of "
                         f"positions{'; held to 1e-4' if gate else ''}")
            if gate and e > 1e-4 * max(scale, 1e-3) + 1e-6:
                raise AssertionError(f"{arch}: planned vs plain logits differ by "
                                     f"{e} (scale {scale})")
            del params, m
    finally:
        install_plan(None)
    return notes


def k1_row(label: str, tn, lp, tokens: int, gen, device) -> tuple[float, dict]:
    """K1 on ``tokens`` random rows along layer plan ``lp``'s path through
    network ``tn`` (random cores, the plan's clamped token block) against
    its plain version, within 1e-4 of the output's scale or the run fails;
    then timed by :func:`k1_timing`.  Returns (max abs err, the row)."""
    import torch

    from repro_torch.kernels import ops, streaming_tt
    from repro_torch.plan.executor import as_candidate_path

    bt = ops.clamp_block(lp.tiling.block_tokens, tokens)
    tn_b = streaming_tt._rebatch(tn, bt)
    cp = as_candidate_path(tn_b, lp.path_steps)
    n_in = math.prod(streaming_tt._stream_node(tn).dims[1:])
    cores = [(torch.randn(n.dims, generator=gen) * 0.2).to(device)
             for n in tn.nodes if n.kind != "input"]
    x = torch.randn(tokens, n_in, generator=gen).to(device)
    got = streaming_tt.streaming_tt_linear(x, cores, tn_b, cp, block_tokens=bt)
    want = streaming_tt.streaming_tt_linear_plain(x, cores, tn_b, cp)
    torch.cuda.synchronize()
    e = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or e > 1e-4 * max(1.0, want.abs().max().item()):
        raise AssertionError(f"K1 {label}, {tokens} tokens: err {e}")
    t = k1_timing(label, tn, lp.path_steps, tn_b, cp, x, cores, bt, want, device)
    log_timing("streaming_tt", t)
    return e, t


def k3_row(label: str, m: int, k: int, n: int, dataflow: str, tiling, gen,
           device) -> tuple[float, dict]:
    """One ``tt_gemm`` GEMM (M, K, N) of random operands with ``tiling``'s
    blocks clamped as the executor clamps them: bit for bit against OS and
    within 1e-5 of the output's scale against the plain version, or the
    run fails; timed (CUDA events and CUDA-graph replay) beside its plain
    version, one ``torch.matmul`` and the bound.  Returns (max abs err,
    the row)."""
    import torch

    from repro_torch.kernels import ops, tt_gemm

    blocks = dict(block_m=ops.clamp_block(tiling.block_m, m),
                  block_k=ops.clamp_block(tiling.block_k, k),
                  block_n=ops.clamp_block(tiling.block_n, n))
    a = torch.randn(m, k, generator=gen).to(device)
    b = torch.randn(k, n, generator=gen).to(device)

    def kernel():
        return tt_gemm.tt_gemm(a, b, dataflow=dataflow, **blocks)

    def plain():
        return tt_gemm.tt_gemm_plain(a, b, dataflow=dataflow, **blocks)

    def library():
        return torch.matmul(a, b)

    got, want = kernel(), plain()
    at = f"{label}, M,K,N={m},{k},{n} blocks {','.join(str(v) for v in blocks.values())}"
    if not torch.equal(got, tt_gemm.tt_gemm(a, b, dataflow="OS", **blocks)):
        raise AssertionError(f"tt_gemm {dataflow} {at}: not bit-identical to OS")
    e = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or e > 1e-5 * max(1.0, want.abs().max().item()):
        raise AssertionError(f"tt_gemm {dataflow} {at}: err {e}")
    b_ms, b_by = bound(4 * (m * k + k * n + m * n), 2 * m * k * n)
    ms, host_ms = timed(kernel)
    t = dict(at=at, ms=ms, host_ms=host_ms, graph_ms=graph_ms(kernel),
             plain_ms=timed(plain)[0], library_ms=timed(library)[0],
             library_graph_ms=graph_ms(library), bound_ms=b_ms, bound_by=b_by)
    log_timing(f"tt_gemm_{dataflow.lower()}", t)
    return e, t


def family_kernel_shapes(device) -> tuple[dict, list[str]]:
    """K1 at every streaming layer of the family pairs (prefill at 32 tokens,
    the MoE experts at their 4 capacity slots; decode at 4 lanes) and K3
    at every GEMM of their tt_gemm layers (prefill, 32 tokens), against the
    plain versions; each timed (CUDA events and CUDA-graph replay) beside
    one ``torch.einsum`` / ``torch.matmul`` and the bound.  Returns the
    worst error and the slowest case per kernel, and the report lines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dse_cli import model_dse_layers
    from repro_torch.kernels import streaming_tt
    from repro_torch.plan import load_plan

    gen = torch.Generator().manual_seed(9)
    notes, seen = [], set()
    k1 = {"err": 0.0, "rows": []}
    k3 = {"err": 0.0, "rows": []}
    for arch in FAMILIES:
        nets = {n.split("[")[0]: tn for n, tn in
                model_dse_layers(get_config(arch), tokens=8)}
        for phase, path in zip(("prefill", "decode"), family_pair(arch)):
            for lp in load_plan(path).layers:
                if lp.name == "head":
                    continue
                tn = nets[lp.name]
                tokens = 4 if phase == "decode" or lp.name.startswith("moe.e") else 32
                key = (tuple(n.dims for n in tn.nodes), lp.path_steps, tokens,
                       lp.backend, lp.dataflow)
                if key in seen or lp.backend == "jnp":
                    continue
                seen.add(key)
                label = f"{arch} {lp.name} ({phase})"
                if lp.backend == "streaming_tt":
                    e, t = k1_row(label, tn, lp, tokens, gen, device)
                    k1["err"] = max(k1["err"], e)
                    k1["rows"].append(t)
                    continue
                full = streaming_tt._rebatch(tn, tokens)
                for g in full.gemm_sequence(lp.path_steps):
                    e, t = k3_row(label, g.M, g.K, g.N, lp.dataflow, lp.tiling, gen,
                                  device)
                    k3["err"] = max(k3["err"], e)
                    k3["rows"].append(t)
    for name, rec in (("streaming_tt", k1), ("tt_gemm_ws", k3)):
        rows = [r for r in rec["rows"] if r["graph_ms"] is not None]
        kernel_ms = sum(r["graph_ms"] for r in rows)
        library_ms = sum(r["library_graph_ms"] or 0 for r in rows)
        notes.append(f"{name} at the family shapes: {len(rec['rows'])} cases, max "
                     f"abs err {rec['err']:.3e}; graph ms summed {kernel_ms:.4f} "
                     f"vs library {library_ms:.4f}")
    return {"streaming_tt": k1, "tt_gemm_ws": k3}, notes


def moe_launches(plan, n_layers: int, step: str) -> dict[str, int]:
    """K1 launches, and the experts' batched K3 launches, of one ``step``
    (``"prefill"``, ``"decode"`` or ``"train"``: forward, the
    ``remat="full"`` recompute and the backward) of a full-depth MoE model
    under ``plan``, counted from the plan: each planned layer runs once a
    layer (the experts' ``moe.e*`` projections one batched call for all
    experts); every ``streaming_tt`` entry and dx op is one K1 launch,
    every step of a WS ``tt_gemm`` backward op one K3 launch.  The plan's
    ``head`` entry never runs: the LM head is tied to the embedding's cores
    (``nn/embedding.py::head_apply``)."""
    out = {"streaming_tt": 0, "streaming_tt_batched": 0, "tt_gemm_ws_batched": 0}
    for lp in plan.layers:
        if lp.name == "head":
            continue
        experts = lp.name.startswith("moe.e")
        key = "streaming_tt_batched" if experts else "streaming_tt"
        if step != "train":
            out[key] += n_layers * (lp.backend == "streaming_tt")
            continue
        dx = sum(op.wrt == "dx" and op.backend == "streaming_tt"
                 for op in lp.backward)
        out[key] += n_layers * (2 * (lp.backend == "streaming_tt") + dx)
        if experts and lp.dataflow == "WS":
            out["tt_gemm_ws_batched"] += n_layers * sum(
                len(op.path_steps) for op in lp.backward if op.backend == "tt_gemm")
    return out


def family_engine(arch: str, device) -> list[str]:
    """Per arch: launches of one prefill (32-token prompt) and one decode
    step (4 lanes), the prefill kernels of :data:`FAMILIES` required; a
    profiled decode step; the peak device memory of the arch's runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.models import api
    from repro_torch.plan import load_plan
    from repro_torch.serve import ServeEngine

    cfg = get_config(arch)
    pre, dec = (load_plan(p) for p in family_pair(arch))
    eng = ServeEngine(cfg, api(cfg, device=device).init_params(0), n_slots=4,
                      max_seq=64, prefill_plan=pre, decode_plan=dec, arch=arch)
    caches = eng.fresh_caches()
    launches.reset()
    _, small = eng.prefill_request(list(range(1, 33)))
    per_prefill = {k: v for k, v in launches.snapshot().items() if v}
    for k in FAMILIES[arch]:
        if not per_prefill.get(k):
            raise AssertionError(f"{arch}: a prefill launched no {k}")
    caches = eng.admit(caches, small, 0)
    for lane in range(1, 4):
        _, small = eng.prefill_request(list(range(1 + lane, 33 + lane)))
        caches = eng.admit(caches, small, lane)
    launches.reset()
    eng.decode(np.array([5, 6, 7, 8]), np.array([32, 32, 32, 32]), caches)
    per_decode = {k: v for k, v in launches.snapshot().items() if v}
    if not per_decode.get("streaming_tt"):
        raise AssertionError(f"{arch}: a decode step launched no streaming_tt")
    notes = [f"{arch}: launches per prefill {per_prefill}, per decode step "
             f"(4 lanes) {per_decode}"]
    if cfg.family == "moe":
        for step, plan, got in (("prefill", pre, per_prefill),
                                ("decode", dec, per_decode)):
            want = moe_launches(plan, cfg.n_layers, step)
            if any(got.get(k, 0) != v for k, v in want.items()):
                raise AssertionError(f"{arch}: launches a {step} {got}, the "
                                     f"plan's count {want}")
            notes.append(f"{arch}: K1 launches a {step} "
                         f"{want['streaming_tt'] + want['streaming_tt_batched']} = "
                         f"the count from its plan at {cfg.n_layers} layers {want}")
    notes += profile_decode(engine_step(eng, caches), arch, ("K1 streaming_tt",))
    peak = torch.cuda.max_memory_allocated() / 2**30
    notes.append(f"{arch}: peak device memory {peak:.2f} GiB "
                 "(torch.cuda.max_memory_allocated since the arch's first run)")
    return notes


def families_phase(device) -> tuple[dict, dict, list[str]]:
    """Phase 4b: serve, check, time and profile each arch of
    :data:`FAMILIES` at full depth.  Returns the launches of the serve
    runs (counts zeroed just before them, read just after), the kernel
    rows at the family shapes and the report lines."""
    import torch

    from repro_torch.kernels import launches

    notes, counts = [], {}
    torch.cuda.init()
    launches.reset()
    for arch in FAMILIES:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        c, n = family_serve(arch)
        counts[arch] = c
        notes += n + family_logits(arch, device) + family_engine(arch, device)
        notes.append(f"{arch}: families phase {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    total = {k: sum(c[k] for c in counts.values()) for k in launches.snapshot()}
    notes.append(f"families serve-path launches per arch: {counts}")
    rows, more = family_kernel_shapes(device)
    return total, rows, notes + more


# ---------------------------------------------------------------------------
# phase 4c: training the MoE, hybrid (Mamba2) and RWKV6 families at full width
# ---------------------------------------------------------------------------

#: full-width train runs of the families-train phase: (arch, train plan,
#: extra argv, steps); each runs ``python -m repro_torch.launch.train``'s
#: code path at full width and depth, in the config's dtype, remat and
#: loss_chunk, batch 4 x seq 512 (the plans' 2048 tokens; two interleaved
#: loss chunks of 256)
FAMILY_TRAIN_RUNS = (
    ("qwen2-moe-a2.7b", "qwen2-moe-a2.7b.train.json", [], 3),
    ("zamba2-1.2b", "zamba2-1.2b.train.json", [], 3),
    ("zamba2-1.2b", "zamba2-1.2b.train.tt_gemm.json", [], 3),
    ("rwkv6-7b", "rwkv6-7b.train.json", [], 3),
    ("zamba2-1.2b", "zamba2-1.2b.train.json", ["--grad-compress"], 2),
)
FAMILY_TRAIN = ["--batch", "4", "--seq", "512", "--log-every", "1"]
FAMILY_TRAIN_TOKENS = 4 * 512
#: execution-log ring for the phase: a run's records (one per planned
#: call, forward, recompute and backward; a qwen2-moe step writes ~2 200,
#: its experts one record a projection) must all stay, since K1's forward
#: and dx launches are told apart by them; a run that drops one fails
FAMILY_TRAIN_LOG = 50_000


def _family_train_run(arch, plan_file, extra, steps, ckpt) -> tuple[object, list[str]]:
    """One train run; returns (its ``TrainRun``, report lines).  Fails
    unless every loss and gradient norm is finite and each step launched
    the kernels its plan names: K1 forward and dx and K3 under an auto
    plan, K3 and K5 under the tt_gemm plan."""
    from repro_torch.launch.train import run
    from repro_torch.plan import execution_log, execution_log_dropped

    log(f"--- families train: {arch}, {plan_file} {' '.join(extra)}")
    out = run(["--arch", arch, "--plan", os.path.join(PLANS, plan_file), "--steps",
               str(steps), "--ckpt-dir", ckpt] + extra + FAMILY_TRAIN)
    label = f"{plan_file}{' ' + ' '.join(extra) if extra else ''}"
    if out.code != 0 or len(out.losses) != steps:
        raise AssertionError(f"train {label} exited {out.code}")
    if not all(math.isfinite(x) for x in out.losses + out.grad_norms):
        raise AssertionError(f"train {label}: non-finite {out.losses} {out.grad_norms}")
    recs = execution_log()
    k1_fwd = sum(r["phase"] == "fwd" and r["backend"] == "streaming_tt" for r in recs)
    k1_dx = sum(r["phase"] == "bwd" and r.get("wrt") == "dx"
                and r["backend"] == "streaming_tt" for r in recs)
    need = ("tt_gemm_ws", "fused_path") if "tt_gemm" in plan_file else \
        ("streaming_tt", "tt_gemm_ws")
    for i, per in enumerate(out.launches):
        for k in need:
            if per[k] <= 0:
                raise AssertionError(f"train {label}: step {i} launched no {k}")
    if "tt_gemm" not in plan_file and (k1_fwd <= 0 or k1_dx <= 0):
        raise AssertionError(f"train {label}: K1 forward {k1_fwd}, dx {k1_dx} calls")
    if execution_log_dropped():
        raise AssertionError(f"train {label}: the execution log dropped "
                             f"{execution_log_dropped()} records")
    if arch == MOE_ARCH:
        from repro_torch.configs import get_config
        from repro_torch.plan import load_plan

        want = moe_launches(load_plan(os.path.join(PLANS, plan_file)),
                            get_config(arch).n_layers, "train")
        for i, per in enumerate(out.launches):
            if any(per[k] != v for k, v in want.items()):
                raise AssertionError(f"train {label}: step {i} launches {per}, "
                                     f"the plan's count {want}")
    steady = out.step_s[1:]
    ms = 1e3 * sum(steady) / len(steady)
    per_step = {k: v for k, v in out.launches[-1].items() if v}
    return out, [
        f"{arch} {label}: {out.n_params} parameters; losses "
        f"{[round(x, 6) for x in out.losses]}, grad norms "
        f"{[round(x, 6) for x in out.grad_norms]}; step ms first "
        f"{1e3 * out.step_s[0]:.1f}, then {[round(1e3 * t, 1) for t in steady]} "
        f"(mean {ms:.1f}); {FAMILY_TRAIN_TOKENS / ms * 1e3:.1f} train tokens/s; "
        f"launches per step {per_step} (the remat recompute included); K1 calls "
        f"over the run: forward {k1_fwd // steps} a step (recompute included), "
        f"dx {k1_dx // steps} a step; fwd backends {out.fwd_backends}, bwd "
        f"backends {out.bwd_backends}, fused chain runs {out.fused_runs}"]


def _named_leaves(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of a parameter tree (dict keys, list indices)."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _named_leaves(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _named_leaves(t, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def _family_step0(cfg, plan, device, batch, backend) -> tuple[float, dict]:
    """One step's loss and every gradient leaf (``{path: fp64 tensor}``;
    zeros where a leaf got none) of ``cfg`` under ``plan``, its backends
    forced to ``backend`` (None: as planned)."""
    import torch

    from repro_torch.models import api
    from repro_torch.tree import leaves

    m = api(cfg, plan=plan, plan_backend=backend, device=device)
    params = m.init_params(0)
    for p in leaves(params):
        p.requires_grad_(True)
    if "frontend" in batch:   # the frames in the model's dtype
        batch = dict(batch, frontend=batch["frontend"].to(getattr(torch, cfg.dtype)))
    loss = m.train_loss(params, batch)
    loss.backward()
    return loss.item(), {k: (torch.zeros_like(p) if p.grad is None else p.grad).double()
                         for k, p in _named_leaves(params).items()}


def _norm_gap(got: dict, want: dict) -> float:
    """Relative gap of the global gradient norms of two gradient trees."""
    import torch

    def norm(tensors):
        return math.sqrt(sum(float(torch.sum(torch.square(t))) for t in tensors))

    wn = norm(want.values())
    return abs(norm(got.values()) - wn) / wn


def _leaf_gaps(got: dict, want: dict) -> dict:
    """``{path: ||got - want|| / ||want||}`` per gradient leaf; a leaf whose
    ``want`` is exactly zero gets 0 if ``got``'s is too, else inf."""
    import torch

    out = {}
    for k, w in want.items():
        d = float(torch.linalg.vector_norm(got[k] - w))
        n = float(torch.linalg.vector_norm(w))
        out[k] = d / n if n else (0.0 if d == 0 else math.inf)
    return out


#: depths at which rwkv6-7b's step 0 is reported (its gate is at
#: :data:`FAMILY_CHECK_LAYERS`)
FAMILY_DEPTHS = (4, 8, 16, 32)


def family_train_check(arch, plan_file, device) -> list[str]:
    """Step 0 through the kernels in fp32 against the plain executor along
    the same paths (``--plan-backend jnp``) on the card, at the depth of
    :data:`FAMILY_CHECK_LAYERS` (full depth for the others): the loss and
    the global gradient norm within rel 1e-4, and every gradient leaf
    within ``||g_kernels - g_plain|| / ||g_plain|| <= max(1e-4, 10 r)``,
    where ``r`` is the same gap between the plain executor in fp32 and in
    float64 (the norms, the WKV state and the loss still round to fp32
    there, as in the model code): fp32's own rounding of that leaf.  A
    wrong kernel (a transposed, permuted or sign-flipped weight gradient,
    a lost expert) moves a leaf by O(1).  rwkv6-7b is also reported at
    each depth of :data:`FAMILY_DEPTHS`: a gap the kernels share with a
    change of rounding alone is the forward's chaos, one they do not share
    is theirs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.nn import install_plan
    from repro_torch.plan import load_plan

    plan = load_plan(os.path.join(PLANS, plan_file))
    full = get_config(arch).with_(dtype="float32")
    batch = train_batch(full, 512, 4, 0, device)
    depth = FAMILY_CHECK_LAYERS.get(arch, full.n_layers)
    depths = FAMILY_DEPTHS if arch in FAMILY_CHECK_LAYERS else (depth,)
    notes = []
    try:
        for n_layers in depths:
            cfg = full.with_(n_layers=n_layers)
            got = _family_step0(cfg, plan, device, batch, None)
            want = _family_step0(cfg, plan, device, batch, "jnp")
            wide = _family_step0(cfg.with_(dtype="float64"), plan, device, batch, "jnp")
            rel_loss = abs(got[0] - want[0]) / abs(want[0])
            rel_norm = _norm_gap(got[1], want[1])
            gaps, own = _leaf_gaps(got[1], want[1]), _leaf_gaps(want[1], wide[1])
            share = {k: g / max(1e-4, 10 * own[k]) for k, g in gaps.items()}
            top = sorted(gaps, key=gaps.get, reverse=True)[:3]
            worst = max(share, key=share.get)
            gate = n_layers == depth
            notes.append(
                f"{arch} {plan_file} step 0 (float32, {n_layers} layers), kernels vs "
                f"plain executor on the card: loss {got[0]:.7f} vs {want[0]:.7f} (rel "
                f"{rel_loss:.1e}), grad norm rel {rel_norm:.1e}; per leaf ||g - "
                f"g_plain|| / ||g_plain||, {len(gaps)} leaves: "
                + ", ".join(f"{k} {gaps[k]:.1e} (plain fp32 vs float64 {own[k]:.1e})"
                            for k in top)
                + f"; {sum(g > 1e-4 for g in gaps.values())} leaves over 1e-4; worst "
                f"share of its bound {share[worst]:.2f} ({worst}); plain fp32 vs "
                f"float64: loss rel {abs(want[0] - wide[0]) / abs(wide[0]):.1e}, grad "
                f"norm rel {_norm_gap(want[1], wide[1]):.1e}, worst leaf "
                f"{max(own.values()):.1e}; kernels vs float64: grad norm rel "
                f"{_norm_gap(got[1], wide[1]):.1e}, worst leaf "
                f"{max(_leaf_gaps(got[1], wide[1]).values()):.1e}"
                + ("; held to its bound" if gate else "; reported only"))
            if gate and not (rel_loss <= 1e-4 and rel_norm <= 1e-4
                             and share[worst] <= 1.0):
                raise AssertionError(
                    f"{arch} {plan_file}: step-0 loss {got[0]} vs plain executor "
                    f"{want[0]} (rel {rel_loss}), grad norm rel {rel_norm}, leaf "
                    f"{worst} {gaps[worst]} (plain fp32 vs float64 {own[worst]})")
            del got, want, wide
            torch.cuda.empty_cache()
    finally:
        install_plan(None)
    return notes


def families_train_phase(device, ckpt_root: str) -> tuple[dict, list[str]]:
    """Phase 4c: AdamW steps (:data:`FAMILY_TRAIN_RUNS`) of full-width
    qwen2-moe-a2.7b, zamba2-1.2b (also under its tt_gemm train plan, and
    two steps with ``--grad-compress``, whose checkpoint must restore) and
    rwkv6-7b; the step-0 check against the plain executor; a profiled step
    and the peak device memory per arch.  Returns the launches of the train runs
    (counts zeroed just before them, read just after) and report lines."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.models import api
    from repro_torch.optim import adamw_init, compress_init
    from repro_torch.plan import executor
    from repro_torch.tree import leaves

    notes, counts = [], {k: 0 for k in launches.snapshot()}
    ring = executor._EXEC_LOG_MAX
    executor._EXEC_LOG_MAX = FAMILY_TRAIN_LOG
    try:
        for i, (arch, plan_file, extra, steps) in enumerate(FAMILY_TRAIN_RUNS):
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            ckpt = os.path.join(ckpt_root, f"family-{i}")
            launches.reset()
            out, more = _family_train_run(arch, plan_file, extra, steps, ckpt)
            for k, v in launches.snapshot().items():
                counts[k] += v
            notes += more
            if "--grad-compress" in extra:
                params = api(get_config(arch), device=device).init_params(0)
                step, state = CheckpointManager(ckpt).restore(
                    {"params": params, "opt": (adamw_init(params),
                                               compress_init(params))})
                res = state["opt"][1].residual
                if step != steps or int(state["opt"][0].step) != steps or not all(
                        torch.isfinite(r).all() for r in leaves(res)):
                    raise AssertionError(f"{arch} --grad-compress checkpoint: step "
                                         f"{step}, optimizer step "
                                         f"{int(state['opt'][0].step)}")
                notes.append(f"{arch} --grad-compress: the step-{step} checkpoint "
                             "(params, (AdamWState, CompressState)) restores")
                del params, state, res
            notes.append(f"{arch} {plan_file}: peak device memory "
                         f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
                         f"(torch.cuda.max_memory_allocated over the run); "
                         f"{time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
    finally:
        executor._EXEC_LOG_MAX = ring
    for arch, plan_file, extra, _ in FAMILY_TRAIN_RUNS:
        if extra:
            continue
        t0 = time.perf_counter()
        notes += family_train_check(arch, plan_file, device)
        if plan_file == f"{arch}.train.json":
            notes += train_profile(arch, plan_file, 512, 4,
                                   ("K1 streaming_tt", "K3 tt_gemm_ws"), device)
        notes.append(f"{arch} {plan_file}: check and profile "
                     f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    return counts, notes


# ---------------------------------------------------------------------------
# phase 4d: the encoder-decoder (seamless-m4t-medium) at full width
# ---------------------------------------------------------------------------

ENCDEC = "seamless-m4t-medium"
#: serving: batch 4 x 512 seeded random frames, a 32-token prompt, 16
#: greedy tokens (the prefill's and 15 decode steps')
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_GEN = 4, 512, 32, 16
ENCDEC_TRAIN_PLAN = "seamless-m4t-medium.train.json"
#: training: batch 4 x seq 512 (the train plan's 2048 tokens) with 512
#: frames, remat full, loss_chunk 256 (two interleaved chunks), AdamW
ENCDEC_TRAIN_STEPS = 3


def encdec_pair() -> tuple[str, str]:
    return tuple(os.path.join(PLANS, f"{ENCDEC}.pair.{p}.json")
                 for p in ("prefill", "decode"))


def encdec_inputs(cfg, device, seed: int = 11) -> dict:
    """The serving batch: seeded random frames (in the config's dtype) and
    prompt tokens, made on the CPU from a ``torch.Generator``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    frames = torch.randn(ENCDEC_BATCH, ENCDEC_FRAMES, cfg.d_model, generator=gen)
    tokens = torch.randint(0, cfg.vocab, (ENCDEC_BATCH, ENCDEC_PROMPT), generator=gen)
    return {"tokens": tokens.to(device),
            "frontend": frames.to(device=device, dtype=getattr(torch, cfg.dtype))}


def encdec_generate(cfg, params, batch, device, steps: int):
    """Greedy generation through ``make_prefill_step`` and
    ``make_decode_step`` under the pair: (tokens (B, 1 + steps), prefill
    ms, decode ms per step, launches of the prefill, launches of each
    decode step).  Wall times on the host clock around synchronized
    calls."""
    import torch

    from repro_torch.kernels import launches
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.nn import plan_context
    from repro_torch.plan import load_plan

    pre, dec = (load_plan(p) for p in encdec_pair())
    prefill = make_prefill_step(cfg, max_seq=ENCDEC_PROMPT + ENCDEC_GEN)
    decode = make_decode_step(cfg)
    torch.cuda.synchronize()
    before = launches.snapshot()
    t0 = time.perf_counter()
    with plan_context(pre):
        logits, caches = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    mid = launches.snapshot()
    per_prefill = {k: mid[k] - before[k] for k in mid}
    if not torch.isfinite(logits.float()).all() or logits.shape != (
            ENCDEC_BATCH, cfg.vocab):
        raise AssertionError(f"{ENCDEC}: prefill logits {tuple(logits.shape)} not finite")
    tok = torch.argmax(logits, -1)[:, None]
    out, per_decode = [tok], []
    t0 = time.perf_counter()
    for i in range(steps):
        b = launches.snapshot()
        with plan_context(dec):
            logits, caches = decode(params, tok, caches,
                                    torch.tensor(ENCDEC_PROMPT + i, device=device))
        a = launches.snapshot()
        per_decode.append({k: a[k] - b[k] for k in a})
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    return torch.cat(out, 1), prefill_ms, decode_ms, per_prefill, per_decode


def encdec_logits(device) -> list[str]:
    """fp32 full width: prefill logits (B, V) and one decode step's logits
    under the pair's kernels against the plain executor along the same
    paths (``force_backend="jnp"``) on the card, within 1e-4 x max |logit|
    (the run fails otherwise), beside the plain executor's spread between
    two contraction orders (the plan's paths against the MAC-optimal
    ones)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import api
    from repro_torch.nn import install_plan, plan_context
    from repro_torch.plan import load_plan

    cfg = get_config(ENCDEC).with_(dtype="float32")
    pre, dec = (load_plan(p) for p in encdec_pair())
    params = api(cfg, plan=None, device=device).init_params(0)
    batch = encdec_inputs(cfg, device)
    prefill = make_prefill_step(cfg, max_seq=ENCDEC_PROMPT + ENCDEC_GEN)
    decode = make_decode_step(cfg)
    outs = {}
    try:
        for label, plans, force in (("kernels", (pre, dec), None),
                                    ("plain", (pre, dec), "jnp"),
                                    ("mac-optimal", (None, None), None)):
            with plan_context(plans[0], force_backend=force):
                first, caches = prefill(params, batch)
            tok = batch["tokens"][:, -1:]   # one fixed token: no argmax ties
            with plan_context(plans[1], force_backend=force):
                second, _ = decode(params, tok, caches,
                                   torch.tensor(ENCDEC_PROMPT, device=device))
            torch.cuda.synchronize()
            outs[label] = (first.float(), second.float())
            del caches
    finally:
        install_plan(None)
    notes = []
    for i, what in enumerate(("prefill", "decode step")):
        got, want, other = (outs[k][i] for k in ("kernels", "plain", "mac-optimal"))
        if got.shape != (ENCDEC_BATCH, cfg.vocab) or not torch.isfinite(got).all():
            raise AssertionError(f"{ENCDEC} {what}: bad logits {tuple(got.shape)}")
        e = (got - want).abs().max().item()
        scale = want.abs().max().item()
        spread = (other - want).abs().max().item()
        notes.append(f"{ENCDEC} {what} logits (float32, 12 + 12 layers, "
                     f"{ENCDEC_FRAMES} frames), kernels vs plain executor on the card: "
                     f"max abs diff {e:.3e}, max |logit| {scale:.3e} (ratio "
                     f"{e / scale:.2e}); plain executor, plan paths vs MAC-optimal "
                     f"paths: {spread:.3e}; argmax agrees for "
                     f"{int((got.argmax(-1) == want.argmax(-1)).sum())} of "
                     f"{ENCDEC_BATCH} lanes; held to 1e-4")
        if e > 1e-4 * max(scale, 1e-3) + 1e-6:
            raise AssertionError(f"{ENCDEC} {what}: planned vs plain logits differ by "
                                 f"{e} (scale {scale})")
    return notes


def encdec_serve(device) -> tuple[dict, list[str]]:
    """Full width and depth in the config's bf16 (seed-0 weights): one
    warm-up generation of 2 tokens, then the counted run: a prefill and 15
    decode steps (counts zeroed just before, read just after); K1 must
    launch in the prefill and in every decode step.  Then the fp32 check,
    a profiled decode step and the peak device memory.  Returns the counted
    run's launches and report lines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import api
    from repro_torch.nn import install_plan, plan_context
    from repro_torch.plan import load_plan

    cfg = get_config(ENCDEC)
    torch.cuda.reset_peak_memory_stats(device)
    params = api(cfg, plan=None, device=device).init_params(0)
    batch = encdec_inputs(cfg, device)
    try:
        encdec_generate(cfg, params, batch, device, 1)
        launches.reset()
        toks, prefill_ms, decode_ms, per_prefill, per_decode = encdec_generate(
            cfg, params, batch, device, ENCDEC_GEN - 1)
        counts = launches.snapshot()
    finally:
        install_plan(None)
    if toks.shape != (ENCDEC_BATCH, ENCDEC_GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{ENCDEC}: generated tokens {toks.tolist()}")
    if not per_prefill["streaming_tt"] or not all(d["streaming_tt"] for d in per_decode):
        raise AssertionError(f"{ENCDEC}: K1 launches per prefill "
                             f"{per_prefill['streaming_tt']}, per decode step "
                             f"{[d['streaming_tt'] for d in per_decode]}")
    steps = ENCDEC_GEN - 1
    notes = [f"{ENCDEC} (bf16, 12 + 12 layers, batch {ENCDEC_BATCH}, {ENCDEC_FRAMES} "
             f"frames, prompt {ENCDEC_PROMPT}, {ENCDEC_GEN} greedy tokens, make_prefill_"
             f"step / make_decode_step under the pair): prefill {prefill_ms:.1f} ms, "
             f"decode {decode_ms:.2f} ms a step over {steps} steps, "
             f"{steps * ENCDEC_BATCH / (decode_ms * steps) * 1e3:.1f} gen tok/s; "
             f"launches per prefill {({k: v for k, v in per_prefill.items() if v})}, "
             f"per decode step {({k: v for k, v in per_decode[0].items() if v})}; "
             f"sample {toks[0, :8].tolist()}"]
    notes += encdec_logits(device)

    pre, dec = (load_plan(p) for p in encdec_pair())
    decode = make_decode_step(cfg)
    with plan_context(pre):
        _, caches = make_prefill_step(cfg, max_seq=ENCDEC_PROMPT + 16)(params, batch)
    tok = batch["tokens"][:, -1:]

    def step(i):
        with plan_context(dec):
            decode(params, tok, caches, torch.tensor(ENCDEC_PROMPT + i, device=device))

    notes += profile_decode(step, ENCDEC, ("K1 streaming_tt",))
    notes.append(f"{ENCDEC} serving: peak device memory "
                 f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
                 "(torch.cuda.max_memory_allocated over the serve runs and the fp32 "
                 "check)")
    return counts, notes


def encdec_train(device) -> tuple[dict, list[str]]:
    """:data:`ENCDEC_TRAIN_STEPS` AdamW steps of ``make_train_step`` under
    the train plan at full width and depth (bf16, remat full, loss_chunk
    256, seed-0 weights), batch 4 x seq 512 with 512 frames (counts zeroed
    just before, read just after): every loss and gradient norm finite, and
    every step launches K1 forward and dx and K3, or the run fails.  Then
    the per-leaf step-0 check against the plain executor, a profiled step
    and the peak device memory.  Returns the run's launches and report
    lines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.nn import install_plan
    from repro_torch.optim import adamw_init
    from repro_torch.plan import execution_log, executor, load_plan, reset_execution_log
    from repro_torch.tree import leaves

    cfg = get_config(ENCDEC)
    if cfg.remat != "full" or cfg.loss_chunk != 256:
        raise AssertionError(f"{ENCDEC}: remat {cfg.remat}, loss_chunk {cfg.loss_chunk}")
    torch.cuda.reset_peak_memory_stats(device)
    ring = executor._EXEC_LOG_MAX
    executor._EXEC_LOG_MAX = FAMILY_TRAIN_LOG
    install_plan(load_plan(os.path.join(PLANS, ENCDEC_TRAIN_PLAN)))
    losses, norms, step_ms, per_step, k1 = [], [], [], [], []
    try:
        params = api(cfg, device=device).init_params(0)
        for p in leaves(params):
            p.requires_grad_(True)
        opt = adamw_init(params)
        step = make_train_step(cfg)
        batches = [train_batch(cfg, 512, 4, i, device)
                   for i in range(ENCDEC_TRAIN_STEPS)]
        torch.cuda.synchronize()
        launches.reset()
        for batch in batches:
            reset_execution_log()
            before = launches.snapshot()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            after = launches.snapshot()
            per_step.append({k: after[k] - before[k] for k in after})
            recs = execution_log()
            k1.append((sum(r["phase"] == "fwd" and r["backend"] == "streaming_tt"
                           for r in recs),
                       sum(r["phase"] == "bwd" and r.get("wrt") == "dx"
                           and r["backend"] == "streaming_tt" for r in recs)))
        counts = launches.snapshot()
        del params, opt, batches
    finally:
        executor._EXEC_LOG_MAX = ring
        install_plan(None)
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"{ENCDEC} train: non-finite {losses} {norms}")
    for i, (per, (fwd, dx)) in enumerate(zip(per_step, k1)):
        if per["streaming_tt"] <= 0 or per["tt_gemm_ws"] <= 0 or fwd <= 0 or dx <= 0:
            raise AssertionError(f"{ENCDEC} train step {i}: launches {per}, K1 forward "
                                 f"{fwd}, dx {dx} calls")
    steady = step_ms[1:]
    ms = sum(steady) / len(steady)
    notes = [f"{ENCDEC} {ENCDEC_TRAIN_PLAN} (bf16, remat full, loss_chunk 256, batch 4 "
             f"x seq 512, 512 frames, make_train_step): losses "
             f"{[round(x, 6) for x in losses]}, grad norms {[round(x, 6) for x in norms]};"
             f" step ms first {step_ms[0]:.1f}, then {[round(t, 1) for t in steady]} "
             f"(mean {ms:.1f}); {2048 / ms * 1e3:.1f} train tokens/s; launches per step "
             f"{({k: v for k, v in per_step[-1].items() if v})} (the remat recompute "
             f"included); K1 calls a step: forward {k1[-1][0]}, dx {k1[-1][1]}; peak "
             f"device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    notes += family_train_check(ENCDEC, ENCDEC_TRAIN_PLAN, device)
    notes += train_profile(ENCDEC, ENCDEC_TRAIN_PLAN, 512, 4,
                           ("K1 streaming_tt", "K3 tt_gemm_ws"), device)
    notes.append(f"{ENCDEC}: check and profile {time.perf_counter() - t0:.1f} s")
    return counts, notes


def encdec_kernel_shapes(device) -> tuple[dict, list[str]]:
    """K1 at ``enc_mlp.wu`` (1024 -> 4096) with the prefill's 2048 frames
    and at ``xattn.wq`` with a decode step's 4 tokens, under the pair's
    paths; K3 at every weight-gradient GEMM of ``enc_mlp.wu`` under the
    train plan at 2048 tokens; each against its plain version and timed
    beside one ``torch.einsum`` / ``torch.matmul`` and the bound
    (:func:`k1_row`, :func:`k3_row`).  Returns the rows per kernel and the
    report lines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.backward import backward_networks
    from repro_torch.dse_cli import _block_specs, model_dse_layers
    from repro_torch.plan import load_plan

    cfg = get_config(ENCDEC)
    nets = {n.split("[")[0]: tn for n, tn in model_dse_layers(cfg, tokens=8)}
    gen = torch.Generator().manual_seed(21)
    rows = {"streaming_tt": {"err": 0.0, "rows": []},
            "tt_gemm_ws": {"err": 0.0, "rows": []}}
    pre, dec = (load_plan(p) for p in encdec_pair())
    for plan, name, tokens, phase in ((pre, "enc_mlp.wu", 2048, "prefill"),
                                      (dec, "xattn.wq", 4, "decode")):
        e, t = k1_row(f"{ENCDEC} {name} ({phase})", nets[name], plan.layer(name),
                      tokens, gen, device)
        rows["streaming_tt"]["err"] = max(rows["streaming_tt"]["err"], e)
        rows["streaming_tt"]["rows"].append(t)
    spec = {sp.name: sp for sp, _, _ in _block_specs(cfg)}["enc_mlp.wu"]
    lp = load_plan(os.path.join(PLANS, ENCDEC_TRAIN_PLAN)).layer("enc_mlp.wu")
    bwd = dict(backward_networks(spec.network(2048)))
    seen = set()
    for op in lp.backward:
        if op.backend != "tt_gemm":
            continue
        for g in bwd[op.wrt].gemm_sequence(op.path_steps):
            if (g.M, g.K, g.N, op.tiling) in seen:
                continue
            seen.add((g.M, g.K, g.N, op.tiling))
            e, t = k3_row(f"{ENCDEC} enc_mlp.wu d{op.wrt} (train)", g.M, g.K, g.N,
                          lp.dataflow, op.tiling, gen, device)
            rows["tt_gemm_ws"]["err"] = max(rows["tt_gemm_ws"]["err"], e)
            rows["tt_gemm_ws"]["rows"].append(t)
    if not rows["tt_gemm_ws"]["rows"]:
        raise AssertionError(f"{ENCDEC} enc_mlp.wu: no tt_gemm weight gradient")
    return rows, [f"{name} at the {ENCDEC} shapes: {len(r['rows'])} cases, max abs err "
                  f"{r['err']:.3e}" for name, r in rows.items()]


def encdec_phase(device) -> tuple[dict, dict, dict, list[str]]:
    """Phase 4d: serve, check, train and time full-width seamless-m4t-medium.
    Returns the serve and train runs' launches, the kernel rows at its
    shapes and the report lines."""
    import torch

    torch.cuda.init()
    t0 = time.perf_counter()
    serve_counts, notes = encdec_serve(device)
    torch.cuda.empty_cache()
    notes.append(f"{ENCDEC}: serving and its check {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_counts, more = encdec_train(device)
    torch.cuda.empty_cache()
    notes += more + [f"{ENCDEC}: training, its check and profile "
                     f"{time.perf_counter() - t0:.1f} s"]
    rows, more = encdec_kernel_shapes(device)
    return serve_counts, train_counts, rows, notes + more


# ---------------------------------------------------------------------------
# phase 4e: the model axis of the SSM and WKV heads, their states and the
# encoder-decoder's own sites, ranks sharing the card
# ---------------------------------------------------------------------------

#: (arch, layers) of the states phase, at full width: zamba2 at two groups
#: of 6 (two applications of the shared attention), rwkv6 at the depth of
#: its fp32 check (:data:`FAMILY_CHECK_LAYERS`), seamless at full depth
STATE_RUNS = (("zamba2-1.2b", 12), ("rwkv6-7b", 4), ("seamless-m4t-medium", None))
#: lanes served, prompt length, greedy tokens, the cache's positions and the
#: encoder-decoder's frames
STATE_LANES, STATE_PROMPT, STATE_GEN, STATE_MAX_SEQ, STATE_FRAMES = 4, 32, 8, 48, 64
#: step 0's batch x seq (each data rank 2 sequences)
STATE_TRAIN = (4, 128)
#: cache leaves a rank holds a block of heads and lanes of
STATE_LEAVES = ("ssm", "wkv", "cross_k", "cross_v")


def _state_cfg(arch: str, layers):
    """``arch`` at full width in fp32 with no remat (the collectives
    formula's step), cut to ``layers``."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).with_(dtype="float32", remat="none")
    return cfg.with_(n_layers=layers) if layers else cfg


def _state_plans(arch: str) -> tuple[str, str, str]:
    return (*family_pair(arch), os.path.join(PLANS, f"{arch}.train.json"))


def _state_serve(arch: str, cfg, device, rules, lanes: int = STATE_LANES,
                 prompt: int = STATE_PROMPT, gen_tokens: int = STATE_GEN,
                 max_seq: int = STATE_MAX_SEQ, held_leaves=STATE_LEAVES) -> dict:
    """``lanes`` lanes of seeded prompts of ``prompt`` tokens served greedily
    (``gen_tokens`` steps) of ``cfg`` (``arch`` cut by :func:`_state_cfg`)
    under ``arch``'s plan pair and ``rules`` (None: one device) on the
    seed-0 weights, caches of ``max_seq`` positions: zamba2, rwkv6 and
    chatglm3 through a ``ServeEngine`` (each prompt prefilled at batch 1,
    then every lane decoded), seamless through the step builders (a data
    rank its lanes).  Returns the tokens, the whole-vocab fp32 prefill
    logits and first decode step's logits of every lane (on the CPU), the
    launches and collectives of the first prefill and of the first decode
    step, the bytes of the ``held_leaves`` cache leaves this process holds
    and of every cache leaf by name."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch.kernels import launches
    from repro_torch.launch.mesh import LayoutBlocks, _map_named, batch_shardings
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import api
    from repro_torch.nn import plan_context
    from repro_torch.plan import load_plan
    from repro_torch.plan.sharded import COLLECTIVES, reset_collectives
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding import use_rules

    pre, dec, _ = (load_plan(p) for p in _state_plans(arch))
    gen = torch.Generator().manual_seed(13)
    prompts = torch.randint(0, cfg.vocab, (lanes, prompt), generator=gen)
    out = {}
    with (use_rules(rules) if rules is not None else contextlib.nullcontext()), \
            torch.no_grad():
        params = api(cfg, device=device).init_params(0)
        if cfg.family == "encdec":
            frames = torch.randn(lanes, STATE_FRAMES, cfg.d_model, generator=gen)
            batch = {"tokens": prompts.to(device), "frontend": frames.to(device)}
            lanes = None              # every lane's rows from a data rank's
            if rules is not None and rules.batch_split:
                batch = LayoutBlocks(batch_shardings(batch, rules), rules).block(batch)
                lanes = LayoutBlocks(((rules.batch_axes, None),), rules)

            def rows_of(t):
                return t if lanes is None else lanes.gather((t,))[0]

            launches.reset()
            reset_collectives()
            with plan_context(pre):
                logits, caches = make_prefill_step(cfg, max_seq)(params, batch)
            out["prefill_launches"] = launches.snapshot()
            out["prefill_collectives"] = dict(COLLECTIVES)
            rows = rows_of(logits)
            tok, tokens, step = logits.argmax(-1)[:, None], [], None
            for i in range(gen_tokens):
                launches.reset()
                reset_collectives()
                with plan_context(dec):
                    logits, caches = make_decode_step(cfg)(
                        params, tok, caches, torch.tensor(prompt + i, device=device))
                if step is None:
                    out["decode_launches"] = launches.snapshot()
                    out["collectives"] = dict(COLLECTIVES)
                    step = rows_of(logits)
                tokens.append(rows_of(tok))
                tok = logits.argmax(-1)[:, None]
            tokens.append(rows_of(tok))
            tokens = torch.cat(tokens, 1).tolist()
        else:
            eng = ServeEngine(cfg, params, n_slots=lanes, max_seq=max_seq,
                              prompt_bucket=8, prefill_plan=pre, decode_plan=dec)
            caches, rows = eng.fresh_caches(), []
            for lane in range(lanes):
                launches.reset()
                reset_collectives()
                row, small = eng.prefill_request(prompts[lane].tolist())
                if lane == 0:
                    out["prefill_launches"] = launches.snapshot()
                    out["prefill_collectives"] = dict(COLLECTIVES)
                caches = eng.admit(caches, small, lane)
                del small
                rows.append(torch.from_numpy(row))
            rows = torch.stack(rows)
            tok, tokens, step = rows.argmax(-1).numpy(), [], None
            for i in range(gen_tokens):
                launches.reset()
                reset_collectives()
                logits, caches = eng.decode(tok, np.full(lanes, prompt + i), caches)
                if step is None:
                    out["decode_launches"] = launches.snapshot()
                    out["collectives"] = dict(COLLECTIVES)
                    step = torch.from_numpy(logits)
                tokens.append(tok)
                tok = logits.argmax(-1)
            tokens.append(tok)
            tokens = np.stack(tokens, 1).tolist()
        named = collections.Counter()

        def count(name, t):
            named[name] += t.numel() * t.element_size()

        _map_named(count, caches)
    out.update(tokens=tokens, prefill=rows.float().cpu(), decode=step.float().cpu(),
               state_bytes=sum(named[k] for k in held_leaves), leaf_bytes=dict(named))
    return out


def states_rank(out_dir: str) -> int:
    """One rank of the states phase (``chip_smoke.py --states-rank DIR``):
    joins the ``gloo`` group and, for each arch of :data:`STATE_RUNS`,
    serves four lanes (:func:`_state_serve`) and takes step 0 on its block
    of the batch under ``data=2 x model=2`` with ``tt_model_reduce``,
    holding logits, tokens and every gradient leaf against the single
    device's (the parent's oracle files).  Writes ``rank<r>.json``."""
    import dataclasses
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, SRC)
    from repro_torch.kernels import launches
    from repro_torch.launch.mesh import (batch_layout, describe_layout, make_rules,
                                         make_test_mesh)
    from repro_torch.models.config import ShapeConfig
    from repro_torch.nn import install_plan
    from repro_torch.plan import load_plan
    from repro_torch.plan.sharded import (BWD_COLLECTIVES, COLLECTIVES,
                                          reset_collectives)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    dist.init_process_group("gloo", init_method="env://", timeout=datetime.timedelta(
        seconds=SHARD_TIMEOUT_S))
    try:
        rank = dist.get_rank()
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
        mesh = make_test_mesh()
        out = {"rank": rank, "coords": dict(mesh.coords), "archs": {}}
        for arch, layers in STATE_RUNS:
            t0 = time.perf_counter()
            cfg = _state_cfg(arch, layers)
            oracle = torch.load(spec["oracle"][arch], weights_only=False)
            serve_rules = dataclasses.replace(make_rules(
                cfg, ShapeConfig("cli", STATE_MAX_SEQ, STATE_LANES, "decode"), mesh),
                tt_model_reduce=True)
            if cfg.family == "encdec":
                serve_rules = batch_layout(serve_rules, STATE_LANES)
            got = _state_serve(arch, cfg, device, serve_rules)
            res = {"layout": describe_layout(batch_layout(serve_rules, STATE_LANES),
                                             STATE_LANES, "lanes", cfg),
                   "tokens_equal": got["tokens"] == oracle["tokens"],
                   "state_bytes": got["state_bytes"],
                   "collectives": got["collectives"],
                   "prefill_launches": got["prefill_launches"],
                   "decode_launches": got["decode_launches"]}
            for key in ("prefill", "decode"):
                want = oracle[key]
                res[key] = {"shape": list(got[key].shape),
                            "max_abs_diff": float((got[key] - want).abs().max()),
                            "scale": float(want.abs().max())}
            b, s = STATE_TRAIN
            train_rules = batch_layout(dataclasses.replace(make_rules(
                cfg, ShapeConfig("cli", s, b, "train"), mesh), tt_model_reduce=True), b)
            batch = train_batch(cfg, s, b, 0, device)
            launches.reset()
            reset_collectives()
            loss, grads = _layout_step0(cfg, load_plan(_state_plans(arch)[2]), device,
                                        batch, train_rules)
            torch.cuda.synchronize(device)
            bwd = dict(BWD_COLLECTIVES)
            want = {k: v.to(device) for k, v in oracle["grads"].items()}
            gaps = _leaf_gaps(grads, want)
            bounds = spec["bounds"][arch]
            res["step0"] = {
                "loss": loss, "loss_rel": abs(loss - oracle["loss"]) / abs(oracle["loss"]),
                "norm_rel": _norm_gap(grads, want), "n_leaves": len(gaps),
                "worst_share": max((g / bounds[k], k) for k, g in gaps.items()),
                "launches": launches.snapshot(),
                "collectives": {"fwd": {k: v - bwd[k] for k, v in COLLECTIVES.items()},
                                "bwd": bwd}}
            res["seconds"] = time.perf_counter() - t0
            out["archs"][arch] = res
            install_plan(None)
            del grads, want, oracle
            torch.cuda.empty_cache()
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def states_phase(device, card: str) -> tuple[dict, list[str]]:
    """Full-width zamba2-1.2b (12 layers), rwkv6-7b (4) and
    seamless-m4t-medium (12 + 12), fp32, seed-0 weights, on 4 ranks sharing
    ``cuda:0`` over ``gloo`` (``data=2 x model=2``, ``tt_model_reduce``; one
    spawn of :func:`states_rank` for the three archs) under the committed
    family plans, against the single device in this process under the same
    plans: four lanes' greedy tokens equal; their fp32 prefill logits and
    first decode step's within 1e-4 x max |logit|; a rank's SSM, WKV and
    cross K/V cache bytes exactly 0.25x the single device's (half the lanes,
    half the heads); a decode step's and step 0's collectives equal
    :func:`step_collectives`; step 0 (batch 4 x seq 128, a data rank 2
    sequences): the loss and grad norm within rel 1e-4 and every leaf
    within its bound of :func:`family_train_check`; K1 launched on every
    rank in every prefill, decode step and step 0, K3 in zamba2's and
    rwkv6's prefill and in every step 0.  Returns the launches of the ranks'
    serve and train runs, summed over every rank, and the report lines."""
    import torch

    from repro_torch.kernels import launches
    from repro_torch.launch.ranks import spawn_ranks
    from repro_torch.nn import install_plan
    from repro_torch.plan import load_plan

    notes, totals = [], {k: 0 for k in launches.COUNTS}
    work = tempfile.mkdtemp(prefix="repro_torch_states_")
    t_phase = time.perf_counter()
    try:
        spec, single = {"oracle": {}, "bounds": {}}, {}
        for arch, layers in STATE_RUNS:
            cfg = _state_cfg(arch, layers)
            torch.cuda.reset_peak_memory_stats(device)
            got = _state_serve(arch, cfg, device, None)
            plan = load_plan(_state_plans(arch)[2])
            batch = train_batch(cfg, STATE_TRAIN[1], STATE_TRAIN[0], 0, device)
            loss, grads = _family_step0(cfg, plan, device, batch, None)
            plain = _family_step0(cfg, plan, device, batch, "jnp")
            wide = _family_step0(cfg.with_(dtype="float64"), plan, device, batch, "jnp")
            spec["bounds"][arch] = {k: max(1e-4, 10 * g)
                                    for k, g in _leaf_gaps(plain[1], wide[1]).items()}
            spec["oracle"][arch] = os.path.join(work, f"oracle.{arch}.pt")
            torch.save({"tokens": got["tokens"], "prefill": got["prefill"],
                        "decode": got["decode"], "loss": loss,
                        "grads": {k: v.cpu() for k, v in grads.items()}},
                       spec["oracle"][arch])
            single[arch] = {"state_bytes": got["state_bytes"], "loss": loss,
                            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
            install_plan(None)
            del grads, plain, wide
            torch.cuda.empty_cache()
        oracle_s = time.perf_counter() - t_phase
        run_dir = os.path.join(work, "run")
        os.makedirs(run_dir)
        with open(os.path.join(run_dir, "spec.json"), "w") as f:
            json.dump(spec, f)
        wall = spawn_ranks([sys.executable, os.path.abspath(__file__), "--states-rank",
                            run_dir], 4, run_dir, SHARD_TIMEOUT_S,
                           env=dict(os.environ, OMP_NUM_THREADS="1"))
        ranks = []
        for r in range(4):
            with open(os.path.join(run_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        notes.append(f"4 ranks sharing one card, not a scaling figure ({card}; "
                     f"data=2 x model=2, tt_model_reduce, gloo): single-device oracle "
                     f"{oracle_s:.1f} s, spawn wall {wall:.1f} s")
        for arch, layers in STATE_RUNS:
            cfg = _state_cfg(arch, layers)
            pre, dec, tr = (load_plan(p) for p in _state_plans(arch))
            want_dec = step_collectives(cfg, dec, None, "decode", STATE_LANES,
                                        STATE_MAX_SEQ)
            want_tr = step_collectives(cfg, tr, None, "train", *STATE_TRAIN,
                                       frames=STATE_TRAIN[1])
            k3_prefill = cfg.family != "encdec"
            for res in ranks:
                got, where = res["archs"][arch], f"{arch}, rank {res['rank']}"
                for k, v in got["prefill_launches"].items():
                    totals[k] += v
                if not got["tokens_equal"]:
                    raise AssertionError(f"{where}: greedy tokens differ from one device's")
                for key in ("prefill", "decode"):
                    g = got[key]
                    if g["shape"] != [STATE_LANES, cfg.vocab] or \
                            not g["max_abs_diff"] <= 1e-4 * g["scale"]:
                        raise AssertionError(f"{where}: {key} logits {g}")
                if got["state_bytes"] * 4 != single[arch]["state_bytes"]:
                    raise AssertionError(
                        f"{where}: {STATE_LEAVES} bytes a rank {got['state_bytes']}, "
                        f"one device {single[arch]['state_bytes']}: not 0.25x")
                if got["collectives"] != want_dec:
                    raise AssertionError(f"{where}: decode-step collectives "
                                         f"{got['collectives']}, not {want_dec}")
                s0 = got["step0"]
                if s0["collectives"] != want_tr:
                    raise AssertionError(f"{where}: step-0 collectives "
                                         f"{s0['collectives']}, not {want_tr}")
                if max(s0["loss_rel"], s0["norm_rel"]) > 1e-4 or \
                        s0["worst_share"][0] > 1.0:
                    raise AssertionError(
                        f"{where}: step 0 loss rel {s0['loss_rel']}, grad norm rel "
                        f"{s0['norm_rel']}, worst leaf share {s0['worst_share']}")
                need = [("prefill", got["prefill_launches"], "streaming_tt"),
                        ("decode", got["decode_launches"], "streaming_tt"),
                        ("step 0", s0["launches"], "streaming_tt"),
                        ("step 0", s0["launches"], "tt_gemm_ws")]
                if k3_prefill:
                    need.append(("prefill", got["prefill_launches"], "tt_gemm_ws"))
                for what, counts, k in need:
                    if counts[k] <= 0:
                        raise AssertionError(f"{where}: {what} launched no {k}")
                for counts in (got["decode_launches"], s0["launches"]):
                    for k, v in counts.items():
                        totals[k] += v
            r0 = ranks[0]["archs"][arch]
            notes.append(
                f"{arch} ({cfg.n_layers} layers{' + ' + str(cfg.encoder_layers) if cfg.encoder_layers else ''}"
                f", fp32): {r0['layout']}; rank 0 {r0['seconds']:.1f} s; tokens equal on "
                f"{sum(r['archs'][arch]['tokens_equal'] for r in ranks)}/4 ranks; "
                f"prefill logits max abs diff "
                f"{max(r['archs'][arch]['prefill']['max_abs_diff'] for r in ranks):.3e}, "
                f"decode {max(r['archs'][arch]['decode']['max_abs_diff'] for r in ranks):.3e}"
                f" (max |logit| {r0['prefill']['scale']:.3e}, {r0['decode']['scale']:.3e}); "
                f"{'/'.join(STATE_LEAVES)} bytes a rank {r0['state_bytes']} of one "
                f"device's {single[arch]['state_bytes']}")
            notes.append(
                f"  step 0 (batch {STATE_TRAIN[0]} x seq {STATE_TRAIN[1]}): loss "
                f"{r0['step0']['loss']:.7f} vs {single[arch]['loss']:.7f}, loss rel "
                f"{max(r['archs'][arch]['step0']['loss_rel'] for r in ranks):.1e}, grad "
                f"norm rel {max(r['archs'][arch]['step0']['norm_rel'] for r in ranks):.1e},"
                f" worst share of its bound "
                f"{max(r['archs'][arch]['step0']['worst_share'][0] for r in ranks):.2f} "
                f"({r0['step0']['worst_share'][1]}) of {r0['step0']['n_leaves']} leaves")
            notes.append(
                f"  collectives: decode step {r0['collectives']}; step 0 forward "
                f"{r0['step0']['collectives']['fwd']}, backward "
                f"{r0['step0']['collectives']['bwd']} (the formula's); launches rank 0: "
                f"prefill { {k: v for k, v in r0['prefill_launches'].items() if v} }, "
                f"decode step { {k: v for k, v in r0['decode_launches'].items() if v} }, "
                f"step 0 { {k: v for k, v in r0['step0']['launches'].items() if v} }")
        notes.append(f"peak memory a rank {[round(r['peak_gib'], 3) for r in ranks]} GiB;"
                     f" single device (oracle, per arch) "
                     f"{ {a: round(v['peak_gib'], 3) for a, v in single.items()} } GiB; "
                     f"phase {time.perf_counter() - t_phase:.1f} s")
        return totals, notes
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 4f: the SP sequence split, ranks sharing the card
# ---------------------------------------------------------------------------

#: the SP phase's model: full-width chatglm3-6b (2 kv heads: SP on a model
#: axis of 4) at 8 of its 28 layers, fp32, remat full as configured
SP_ARCH, SP_LAYERS = "chatglm3-6b", 8
#: step 0's batch x seq (a rank's 128 of the 512 positions)
SP_TRAIN = (4, 512)
#: lanes served, prompt length, greedy steps and the caches' positions: the
#: 28-layer config's cache there is 14.0 GiB a device, which turns SP on
SP_LANES, SP_PROMPT, SP_GEN, SP_MAX_SEQ = 16, 32, 8, 32_768
#: the ranks' mesh, data x model
SP_MESH = (1, 4)


def _sp_cfg():
    from repro_torch.configs import get_config

    return get_config(SP_ARCH).with_(dtype="float32", n_layers=SP_LAYERS)


def _sp_prefill(cfg, device, rules, batch: dict, arch: str = SP_ARCH) -> dict:
    """``prefill_full`` of ``batch`` (its tokens and an encoder-decoder's
    frames; every position's logits, gathered) under ``arch``'s prefill
    plan and ``rules`` (None: one device), with its launches and
    collectives."""
    import contextlib

    import torch

    from repro_torch.kernels import launches
    from repro_torch.models import api, encdec
    from repro_torch.nn import plan_context
    from repro_torch.plan import load_plan
    from repro_torch.plan.sharded import COLLECTIVES, reset_collectives
    from repro_torch.sharding import use_rules

    pre = load_plan(_state_plans(arch)[0])
    with (use_rules(rules) if rules is not None else contextlib.nullcontext()), \
            torch.no_grad(), plan_context(pre):
        m = api(cfg, device=device)
        params = m.init_params(0)
        full = m.prefill_full or functools.partial(encdec.prefill_full, cfg)
        launches.reset()
        reset_collectives()
        logits, _ = full(params, batch, batch["tokens"].shape[1])
        torch.cuda.synchronize(device)
        return {"logits": logits, "collectives": dict(COLLECTIVES),
                "launches": launches.snapshot()}


def _sp_step0(arch: str, cfg, device, batch: dict, rules, oracle: dict,
              bounds: dict) -> dict:
    """Step 0 of ``cfg`` (``arch`` cut) under its train plan at this rank's
    block of ``batch`` under ``rules``, held to the single device's
    ``oracle`` (loss, every leaf against ``bounds``): the gaps, launches,
    K1 forward and dx records, the records' meshes, collectives, peak
    memory, the layout line and the seconds."""
    import torch

    from repro_torch.kernels import launches
    from repro_torch.launch.mesh import describe_layout
    from repro_torch.nn import install_plan
    from repro_torch.plan import execution_log, load_plan, reset_execution_log
    from repro_torch.plan.sharded import (BWD_COLLECTIVES, COLLECTIVES,
                                          reset_collectives)

    b, s = batch["tokens"].shape
    t0 = time.perf_counter()
    launches.reset()
    reset_collectives()
    reset_execution_log()
    torch.cuda.reset_peak_memory_stats(device)
    loss, grads = _layout_step0(cfg, load_plan(_state_plans(arch)[2]), device, batch,
                                rules)
    torch.cuda.synchronize(device)
    bwd = dict(BWD_COLLECTIVES)
    recs = execution_log()
    want = {k: v.to(device) for k, v in oracle["grads"].items()}
    gaps = _leaf_gaps(grads, want)
    out = {
        "loss": loss, "loss_rel": abs(loss - oracle["loss"]) / abs(oracle["loss"]),
        "norm_rel": _norm_gap(grads, want), "n_leaves": len(gaps),
        "worst_share": max((g / bounds[k], k) for k, g in gaps.items()),
        "launches": launches.snapshot(),
        "k1_fwd": sum(r["phase"] == "fwd" and r["backend"] == "streaming_tt"
                      for r in recs),
        "k1_dx": sum(r["phase"] == "bwd" and r.get("wrt") == "dx"
                     and r["backend"] == "streaming_tt" for r in recs),
        "meshes": sorted({r["mesh"] for r in recs}),
        "collectives": {"fwd": {k: v - bwd[k] for k, v in COLLECTIVES.items()},
                        "bwd": bwd},
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
        "layout": describe_layout(rules, b, "sequences", cfg, s),
        "seconds": time.perf_counter() - t0}
    install_plan(None)
    del grads, want
    torch.cuda.empty_cache()
    return out


def _check_sp_step0(where: str, s0: dict) -> None:
    """Fails unless :func:`_sp_step0`'s figures meet the phase's bounds: loss
    and grad norm rel 1e-4, every leaf within its bound, K1 forward and dx
    and K3 launched, every record on ``model=4``."""
    if max(s0["loss_rel"], s0["norm_rel"]) > 1e-4 or s0["worst_share"][0] > 1.0:
        raise AssertionError(
            f"{where}: step 0 loss rel {s0['loss_rel']}, grad norm rel "
            f"{s0['norm_rel']}, worst leaf share {s0['worst_share']}")
    if s0["k1_fwd"] <= 0 or s0["k1_dx"] <= 0 or \
            s0["launches"]["tt_gemm_ws"] <= 0 or s0["meshes"] != ["model=4"]:
        raise AssertionError(f"{where}: step 0 K1 forward {s0['k1_fwd']}, dx "
                             f"{s0['k1_dx']}, launches {s0['launches']}, "
                             f"meshes {s0['meshes']}")


def sp_rank(out_dir: str) -> int:
    """One rank of the SP phase (``chip_smoke.py --sp-rank DIR``): joins the
    ``gloo`` group on ``data=1 x model=4`` and, under the policy's rules
    (``make_rules``: SP on), takes step 0 at its block of the positions,
    prefills the same batch, and serves :data:`SP_LANES` lanes over caches
    of :data:`SP_MAX_SEQ` positions, a quarter a rank (the rules of the
    28-layer config's decode cell), holding each against the single
    device's (the parent's oracle file); then the same for each arch of
    :data:`SPS_RUNS` (:func:`_sps_rank`).  Writes ``rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import _mesh, batch_layout, describe_layout, make_rules
    from repro_torch.models.config import ShapeConfig
    from repro_torch.nn import install_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    dist.init_process_group("gloo", init_method="env://", timeout=datetime.timedelta(
        seconds=SHARD_TIMEOUT_S))
    try:
        rank = dist.get_rank()
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
        mesh = _mesh(SP_MESH, ("data", "model"))
        cfg = _sp_cfg()
        b, s = SP_TRAIN
        oracle = torch.load(spec["oracle"], weights_only=False)
        out = {"rank": rank, "coords": dict(mesh.coords)}
        rules = batch_layout(make_rules(cfg, ShapeConfig("cli", s, b, "train"), mesh), b)
        batch = train_batch(cfg, s, b, 0, device)
        out["step0"] = _sp_step0(SP_ARCH, cfg, device, batch, rules, oracle,
                                 spec["bounds"])
        t0 = time.perf_counter()
        got = _sp_prefill(cfg, device, make_rules(
            cfg, ShapeConfig("cli", s, b, "prefill"), mesh), {"tokens": batch["tokens"]})
        w = oracle["logits"].to(device)
        out["prefill"] = {"shape": list(got["logits"].shape),
                          "max_abs_diff": float((got["logits"] - w).abs().max()),
                          "scale": float(w.abs().max()),
                          "bitwise": bool(torch.equal(got["logits"], w)),
                          "collectives": got["collectives"], "launches": got["launches"],
                          "seconds": time.perf_counter() - t0}
        del got, w
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        serve_rules = make_rules(get_config(SP_ARCH), ShapeConfig(
            "cli", SP_MAX_SEQ, SP_LANES, "decode"), mesh)
        got = _state_serve(SP_ARCH, cfg, device, serve_rules, lanes=SP_LANES,
                           prompt=SP_PROMPT, gen_tokens=SP_GEN, max_seq=SP_MAX_SEQ,
                           held_leaves=("k", "v"))
        res = {"layout": describe_layout(batch_layout(serve_rules, SP_LANES), SP_LANES,
                                         "lanes", cfg, max_seq=SP_MAX_SEQ),
               "tokens_equal": got["tokens"] == oracle["tokens"],
               "kv_bytes": got["state_bytes"],
               "prefill_collectives": got["prefill_collectives"],
               "collectives": got["collectives"],
               "prefill_launches": got["prefill_launches"],
               "decode_launches": got["decode_launches"]}
        for key in ("prefill", "decode"):
            w = oracle[key]
            res[key] = {"shape": list(got[key].shape),
                        "max_abs_diff": float((got[key] - w).abs().max()),
                        "scale": float(w.abs().max()),
                        "bitwise": bool(torch.equal(got[key], w))}
        res["seconds"] = time.perf_counter() - t0
        out["serve"] = res
        install_plan(None)
        del got
        torch.cuda.empty_cache()
        out["sps"] = {arch: _sps_rank(arch, layers, mesh, device, spec["sps"][arch])
                      for arch, layers in SPS_RUNS}
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


#: the SP phase's hybrid and encoder-decoder: full-width zamba2-1.2b at 12
#: of its 38 layers (two groups of 6) and seamless-m4t-medium at 12 + 12,
#: fp32, seed-0 weights, remat full as configured
SPS_RUNS = (("zamba2-1.2b", 12), ("seamless-m4t-medium", None))
#: the positions of the train shape whose policy they run under: their 32
#: and 16 kv heads divide model=4, so ``make_rules`` turns SP on from
#: 200 000 positions; its rules are applied at the phase's lengths (a
#: one-device fp32 oracle cannot hold 200 000 positions: one query chunk
#: of zamba2's shared attention scores 4 096 x 200 000 x 32 heads, 105 GB)
SPS_POLICY_SEQ = 1 << 18
#: the cache leaves a rank holds a quarter of (its kv heads and SSM heads)
SPS_HELD = {"zamba2-1.2b": ("ssm", "k", "v"),
            "seamless-m4t-medium": ("k", "v", "cross_k", "cross_v")}


def _sps_cfg(arch: str, layers):
    from repro_torch.configs import get_config

    cfg = get_config(arch).with_(dtype="float32")
    return cfg.with_(n_layers=layers) if layers else cfg


def _sps_batch(cfg, device) -> dict:
    """Step 0's batch (:data:`SP_TRAIN`; an encoder-decoder's frames as
    many as its tokens)."""
    b, s = SP_TRAIN
    return train_batch(cfg, s, b, 0, device)


def _sps_policy(cfg, mesh):
    """``make_rules`` of ``cfg`` at a train shape of :data:`SPS_POLICY_SEQ`
    positions on ``mesh``: SP on."""
    from repro_torch.launch.mesh import make_rules
    from repro_torch.models.config import ShapeConfig

    return make_rules(cfg, ShapeConfig("cli", SPS_POLICY_SEQ, SP_TRAIN[0], "train"), mesh)


def _sps_oracle(arch: str, layers, device, work: str) -> tuple[dict, dict]:
    """The single device's step 0 (with the per-leaf bounds of
    :func:`family_train_check`), prefill logits of every position and four
    served lanes of ``arch``, saved under ``work``: (the ranks' spec,
    figures of the single device)."""
    import torch

    from repro_torch.nn import install_plan
    from repro_torch.plan import load_plan

    cfg = _sps_cfg(arch, layers)
    tr = load_plan(_state_plans(arch)[2])
    batch = _sps_batch(cfg, device)
    torch.cuda.reset_peak_memory_stats(device)
    loss, grads = _family_step0(cfg, tr, device, batch, None)
    train_peak = torch.cuda.max_memory_allocated(device) / 2**30
    plain = _family_step0(cfg, tr, device, batch, "jnp")
    wide = _family_step0(cfg.with_(dtype="float64"), tr, device, batch, "jnp")
    bounds = {k: max(1e-4, 10 * g) for k, g in _leaf_gaps(plain[1], wide[1]).items()}
    install_plan(None)
    del plain, wide
    torch.cuda.empty_cache()
    prefill = {k: v for k, v in batch.items() if k != "labels"}
    logits = _sp_prefill(cfg, device, None, prefill, arch)["logits"].cpu()
    got = _state_serve(arch, cfg, device, None, held_leaves=SPS_HELD[arch])
    install_plan(None)
    path = os.path.join(work, f"oracle.{arch}.pt")
    torch.save({"tokens": got["tokens"], "prefill": got["prefill"],
                "decode": got["decode"], "loss": loss, "logits": logits,
                "grads": {k: v.cpu() for k, v in grads.items()}}, path)
    single = {"loss": loss, "train_peak": train_peak, "held_bytes": got["state_bytes"],
              "leaf_bytes": got["leaf_bytes"]}
    del grads, logits, got
    torch.cuda.empty_cache()
    return {"oracle": path, "bounds": bounds}, single


def _sps_rank(arch: str, layers, mesh, device, spec: dict) -> dict:
    """One rank's part of the SP phase for ``arch`` under :func:`_sps_policy`:
    step 0 at its block of the positions, the batch's prefill, four lanes
    served, each against the single device's (``spec``: the oracle file
    and the per-leaf bounds)."""
    import torch

    from repro_torch.launch.mesh import batch_layout
    from repro_torch.nn import install_plan

    cfg = _sps_cfg(arch, layers)
    oracle = torch.load(spec["oracle"], weights_only=False)
    policy = _sps_policy(cfg, mesh)
    batch = _sps_batch(cfg, device)
    out = {"step0": _sp_step0(arch, cfg, device, batch,
                              batch_layout(policy, SP_TRAIN[0]), oracle, spec["bounds"])}
    t0 = time.perf_counter()
    got = _sp_prefill(cfg, device, policy, {k: v for k, v in batch.items()
                                            if k != "labels"}, arch)
    w = oracle["logits"].to(device)
    out["prefill"] = {"shape": list(got["logits"].shape),
                      "max_abs_diff": float((got["logits"] - w).abs().max()),
                      "scale": float(w.abs().max()),
                      "collectives": got["collectives"], "launches": got["launches"],
                      "seconds": time.perf_counter() - t0}
    del got, w
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = _state_serve(arch, cfg, device, policy, held_leaves=SPS_HELD[arch])
    res = {"tokens_equal": got["tokens"] == oracle["tokens"],
           "held_bytes": got["state_bytes"], "leaf_bytes": got["leaf_bytes"],
           "prefill_collectives": got["prefill_collectives"],
           "collectives": got["collectives"],
           "prefill_launches": got["prefill_launches"],
           "decode_launches": got["decode_launches"]}
    for key in ("prefill", "decode"):
        w = oracle[key]
        res[key] = {"shape": list(got[key].shape),
                    "max_abs_diff": float((got[key] - w).abs().max()),
                    "scale": float(w.abs().max())}
    res["seconds"] = time.perf_counter() - t0
    out["serve"] = res
    install_plan(None)
    del got
    torch.cuda.empty_cache()
    return out


def _sps_check(arch: str, layers, ranks: list[dict], single: dict, totals: dict,
               card: str) -> list[str]:
    """Holds every rank's figures of ``arch`` to the single device's and to
    :func:`step_collectives`; adds the ranks' launches of step 0, the first
    served prefill and the first decode step to ``totals``.  Returns the
    report lines."""
    from repro_torch.models.config import ShapeConfig
    from repro_torch.plan import load_plan

    cfg = _sps_cfg(arch, layers)
    b, s = SP_TRAIN
    pre, dec, tr = (load_plan(p) for p in _state_plans(arch))
    cell = ShapeConfig("cli", SPS_POLICY_SEQ, b, "train")
    served = 1 if cfg.family == "hybrid" else STATE_LANES   # the engine's batch-1 prefill
    want = {
        "step 0": step_collectives(cfg, tr, None, "train", b, s, False, frames=s,
                                   mesh=SP_MESH, cell=cell),
        "prefill": step_collectives(cfg, pre, None, "prefill", b, s, False, frames=s,
                                    mesh=SP_MESH, cell=cell),
        "served prefill": step_collectives(cfg, pre, None, "prefill", served,
                                           STATE_PROMPT, False, frames=STATE_FRAMES,
                                           mesh=SP_MESH, cell=cell),
        "decode step": step_collectives(cfg, dec, None, "decode", STATE_LANES,
                                        STATE_MAX_SEQ, False, mesh=SP_MESH, cell=cell)}
    for res in ranks:
        got, where = res["sps"][arch], f"{arch}, rank {res['rank']}"
        s0, pf, sv = got["step0"], got["prefill"], got["serve"]
        seen = {"step 0": s0["collectives"], "prefill": pf["collectives"],
                "served prefill": sv["prefill_collectives"],
                "decode step": sv["collectives"]}
        for key, value in want.items():
            if seen[key] != value:
                raise AssertionError(f"{where}: {key} collectives {seen[key]}, not {value}")
        _check_sp_step0(where, s0)
        if pf["shape"] != [b, s, cfg.vocab] or not pf["max_abs_diff"] <= 1e-4 * pf["scale"]:
            raise AssertionError(f"{where}: prefill logits {pf}")
        if not sv["tokens_equal"]:
            raise AssertionError(f"{where}: greedy tokens differ from one device's")
        for key in ("prefill", "decode"):
            g = sv[key]
            if g["shape"] != [STATE_LANES, cfg.vocab] or \
                    not g["max_abs_diff"] <= 1e-4 * g["scale"]:
                raise AssertionError(f"{where}: served {key} logits {g}")
        whole = {k: v for k, v in single["leaf_bytes"].items() if k not in SPS_HELD[arch]}
        if sv["held_bytes"] * 4 != single["held_bytes"] or \
                {k: sv["leaf_bytes"][k] for k in whole} != whole:
            raise AssertionError(f"{where}: cache bytes a rank {sv['leaf_bytes']}, one "
                                 f"device {single['leaf_bytes']}: {SPS_HELD[arch]} not "
                                 "0.25x, or the rest not whole")
        need = [("step 0", s0["launches"], "streaming_tt"),
                ("prefill", pf["launches"], "streaming_tt"),
                ("served prefill", sv["prefill_launches"], "streaming_tt"),
                ("decode step", sv["decode_launches"], "streaming_tt")]
        if cfg.family == "hybrid":
            need.append(("prefill", pf["launches"], "tt_gemm_ws"))
        for what, counts, k in need:
            if counts[k] <= 0:
                raise AssertionError(f"{where}: {what} launched no {k}")
        for counts in (s0["launches"], sv["prefill_launches"], sv["decode_launches"]):
            for k, v in counts.items():
                totals[k] += v
    r0 = ranks[0]["sps"][arch]
    s0, pf, sv = r0["step0"], r0["prefill"], r0["serve"]
    depth = f"{cfg.n_layers}" + (f" + {cfg.encoder_layers}" if cfg.encoder_layers else "")
    return [
        f"{arch} ({depth} layers, fp32, remat {cfg.remat}) step 0 (batch {b} x seq "
        f"{s}{', ' + str(s) + ' frames' if cfg.encoder_layers else ''}): "
        f"{s0['layout']}; loss {s0['loss']:.7f} vs {single['loss']:.7f}, loss rel "
        f"{max(r['sps'][arch]['step0']['loss_rel'] for r in ranks):.1e}, grad norm rel "
        f"{max(r['sps'][arch]['step0']['norm_rel'] for r in ranks):.1e}, worst share "
        f"of its bound {max(r['sps'][arch]['step0']['worst_share'][0] for r in ranks):.2f}"
        f" ({s0['worst_share'][1]}) of {s0['n_leaves']} leaves; K1 forward "
        f"{s0['k1_fwd']} and dx {s0['k1_dx']} records on rank 0; peak a rank "
        f"{[round(r['sps'][arch]['step0']['peak_gib'], 3) for r in ranks]} GiB vs one "
        f"device {single['train_peak']:.3f} GiB; rank 0 {s0['seconds']:.1f} s",
        f"  prefill logits (batch {b} x {s}, every position): max abs diff "
        f"{max(r['sps'][arch]['prefill']['max_abs_diff'] for r in ranks):.3e} (max "
        f"|logit| {pf['scale']:.3e}); rank 0 {pf['seconds']:.1f} s",
        f"  serve ({STATE_LANES} lanes, prompt {STATE_PROMPT}, {STATE_GEN} greedy steps"
        f"{', ' + str(STATE_FRAMES) + ' frames' if cfg.encoder_layers else ''}): tokens "
        f"equal on {sum(r['sps'][arch]['serve']['tokens_equal'] for r in ranks)}/4 "
        f"ranks; prefill logits max abs diff "
        f"{max(r['sps'][arch]['serve']['prefill']['max_abs_diff'] for r in ranks):.3e},"
        f" decode {max(r['sps'][arch]['serve']['decode']['max_abs_diff'] for r in ranks):.3e}"
        f" (max |logit| {sv['prefill']['scale']:.3e}, {sv['decode']['scale']:.3e}); "
        f"cache bytes a rank {sv['leaf_bytes']} of one device's {single['leaf_bytes']}"
        f" ({'/'.join(SPS_HELD[arch])} 0.25x); rank 0 {sv['seconds']:.1f} s",
        f"  collectives (the formula's): step 0 forward {s0['collectives']['fwd']}, "
        f"backward {s0['collectives']['bwd']}; batch prefill {pf['collectives']}; "
        f"served prefill {sv['prefill_collectives']}; decode step {sv['collectives']}; "
        f"launches rank 0: step 0 { {k: v for k, v in s0['launches'].items() if v} }, "
        f"prefill { {k: v for k, v in pf['launches'].items() if v} }, served prefill "
        f"{ {k: v for k, v in sv['prefill_launches'].items() if v} }, decode step "
        f"{ {k: v for k, v in sv['decode_launches'].items() if v} }"]


def sp_phase(device, card: str) -> tuple[dict, list[str]]:
    """Full-width chatglm3-6b (8 of 28 layers, fp32, seed-0 weights, remat
    full) on 4 ranks sharing ``cuda:0`` over ``gloo`` (``data=1 x
    model=4``, the rules of ``make_rules``: its 2 kv heads do not divide the
    axis, so SP splits the sequence; one spawn of :func:`sp_rank`) under
    the committed chatglm3-6b plans, against the single device in this
    process under the same plans: (a) step 0 at batch 4 x seq 512 (128
    positions a rank): the loss and grad norm within rel 1e-4, every leaf
    within its bound of :func:`family_train_check`, K1 forward and dx and
    K3 launched on every rank, the peak memory a rank against one
    device's; (b) the fp32 prefill logits of every position of the same
    batch within 1e-4 x max |logit| (whether bit for bit is printed); (c)
    16 lanes served over caches of 32 768 positions (prompt 32, 8 greedy
    steps; the rules of the 28-layer config's cell, 14.0 GiB of cache a
    device): the tokens equal on every rank, the prefill and first decode
    step's logits within 1e-4 x max |logit|, a rank's KV-cache bytes
    exactly 0.25x one device's; (d) the collectives of the batch's prefill,
    of a served prompt's prefill, of a decode step and of step 0 equal
    :func:`step_collectives`; then (e) full-width zamba2-1.2b (12 layers)
    and seamless-m4t-medium (12 + 12) in the same spawn, each the same
    figures under :func:`_sps_policy` (:func:`_sps_check`).  Returns the
    launches of the ranks' step 0, first served prefill and first decode
    step of each arch, summed over every rank, and the report lines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.launch.ranks import spawn_ranks
    from repro_torch.models.config import ShapeConfig
    from repro_torch.nn import install_plan
    from repro_torch.plan import load_plan

    notes, totals = [], {k: 0 for k in launches.COUNTS}
    work = tempfile.mkdtemp(prefix="repro_torch_sp_")
    t_phase = time.perf_counter()
    try:
        cfg = _sp_cfg()
        b, s = SP_TRAIN
        pre, dec, tr = (load_plan(p) for p in _state_plans(SP_ARCH))
        torch.cuda.reset_peak_memory_stats(device)
        batch = train_batch(cfg, s, b, 0, device)
        loss, grads = _family_step0(cfg, tr, device, batch, None)
        train_peak = torch.cuda.max_memory_allocated(device) / 2**30
        plain = _family_step0(cfg, tr, device, batch, "jnp")
        wide = _family_step0(cfg.with_(dtype="float64"), tr, device, batch, "jnp")
        bounds = {k: max(1e-4, 10 * g) for k, g in _leaf_gaps(plain[1], wide[1]).items()}
        install_plan(None)
        del plain, wide
        torch.cuda.empty_cache()
        logits = _sp_prefill(cfg, device, None, {"tokens": batch["tokens"]})["logits"].cpu()
        got = _state_serve(SP_ARCH, cfg, device, None, lanes=SP_LANES, prompt=SP_PROMPT,
                           gen_tokens=SP_GEN, max_seq=SP_MAX_SEQ, held_leaves=("k", "v"))
        install_plan(None)
        oracle = os.path.join(work, "oracle.pt")
        torch.save({"tokens": got["tokens"], "prefill": got["prefill"],
                    "decode": got["decode"], "loss": loss, "logits": logits,
                    "grads": {k: v.cpu() for k, v in grads.items()}}, oracle)
        single = {"kv_bytes": got["state_bytes"], "loss": loss, "train_peak": train_peak}
        del grads, logits, got
        torch.cuda.empty_cache()
        sps_spec, sps_single = {}, {}
        for arch, layers in SPS_RUNS:
            sps_spec[arch], sps_single[arch] = _sps_oracle(arch, layers, device, work)
        single["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        oracle_s = time.perf_counter() - t_phase
        run_dir = os.path.join(work, "run")
        os.makedirs(run_dir)
        with open(os.path.join(run_dir, "spec.json"), "w") as f:
            json.dump({"oracle": oracle, "bounds": bounds, "sps": sps_spec}, f)
        wall = spawn_ranks([sys.executable, os.path.abspath(__file__), "--sp-rank",
                            run_dir], 4, run_dir, SHARD_TIMEOUT_S,
                           env=dict(os.environ, OMP_NUM_THREADS="1"))
        ranks = []
        for r in range(4):
            with open(os.path.join(run_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        policy = get_config(SP_ARCH)
        cell = ShapeConfig("cli", SP_MAX_SEQ, SP_LANES, "decode")
        want = {
            "step 0": step_collectives(cfg, tr, None, "train", b, s, False, mesh=SP_MESH),
            "prefill": step_collectives(cfg, pre, None, "prefill", b, s, False,
                                        mesh=SP_MESH),
            "served prefill": step_collectives(cfg, pre, None, "prefill", 1, SP_PROMPT,
                                               False, mesh=SP_MESH, cell=cell,
                                               policy=policy),
            "decode step": step_collectives(cfg, dec, None, "decode", SP_LANES,
                                            SP_MAX_SEQ, False, mesh=SP_MESH, cell=cell,
                                            policy=policy)}
        for res in ranks:
            where = f"{SP_ARCH}, rank {res['rank']}"
            s0, pf, sv = res["step0"], res["prefill"], res["serve"]
            got = {"step 0": s0["collectives"], "prefill": pf["collectives"],
                   "served prefill": sv["prefill_collectives"],
                   "decode step": sv["collectives"]}
            for key, value in want.items():
                if got[key] != value:
                    raise AssertionError(f"{where}: {key} collectives {got[key]}, "
                                         f"not {value}")
            _check_sp_step0(where, s0)
            if pf["shape"] != [b, s, cfg.vocab] or \
                    not pf["max_abs_diff"] <= 1e-4 * pf["scale"]:
                raise AssertionError(f"{where}: prefill logits {pf}")
            if not sv["tokens_equal"]:
                raise AssertionError(f"{where}: greedy tokens differ from one device's")
            for key in ("prefill", "decode"):
                g = sv[key]
                if g["shape"] != [SP_LANES, cfg.vocab] or \
                        not g["max_abs_diff"] <= 1e-4 * g["scale"]:
                    raise AssertionError(f"{where}: served {key} logits {g}")
            if sv["kv_bytes"] * 4 != single["kv_bytes"]:
                raise AssertionError(f"{where}: KV bytes a rank {sv['kv_bytes']}, one "
                                     f"device {single['kv_bytes']}: not 0.25x")
            for what, counts, k in (("prefill", pf["launches"], "streaming_tt"),
                                    ("prefill", pf["launches"], "tt_gemm_ws"),
                                    ("served prefill", sv["prefill_launches"],
                                     "streaming_tt"),
                                    ("decode step", sv["decode_launches"],
                                     "streaming_tt")):
                if counts[k] <= 0:
                    raise AssertionError(f"{where}: {what} launched no {k}")
            for counts in (s0["launches"], sv["prefill_launches"], sv["decode_launches"]):
                for k, v in counts.items():
                    totals[k] += v
        r0 = ranks[0]
        s0, pf, sv = r0["step0"], r0["prefill"], r0["serve"]
        notes.append(f"4 ranks sharing one card, not a scaling figure ({card}; "
                     f"data=1 x model=4, gloo): single-device oracle {oracle_s:.1f} s, "
                     f"spawn wall {wall:.1f} s")
        notes.append(
            f"{SP_ARCH} ({cfg.n_layers} of 28 layers, fp32, remat {cfg.remat}) step 0 "
            f"(batch {b} x seq {s}): {s0['layout']}; loss {s0['loss']:.7f} vs "
            f"{single['loss']:.7f}, loss rel "
            f"{max(r['step0']['loss_rel'] for r in ranks):.1e}, grad norm rel "
            f"{max(r['step0']['norm_rel'] for r in ranks):.1e}, worst share of its "
            f"bound {max(r['step0']['worst_share'][0] for r in ranks):.2f} "
            f"({s0['worst_share'][1]}) of {s0['n_leaves']} leaves; K1 forward "
            f"{s0['k1_fwd']} and dx {s0['k1_dx']} records on rank 0; peak a rank "
            f"{[round(r['step0']['peak_gib'], 3) for r in ranks]} GiB vs one device "
            f"{single['train_peak']:.3f} GiB; rank 0 {s0['seconds']:.1f} s")
        notes.append(
            f"  prefill logits (batch {b} x {s}, every position): max abs diff "
            f"{max(r['prefill']['max_abs_diff'] for r in ranks):.3e} (max |logit| "
            f"{pf['scale']:.3e}), bit for bit on "
            f"{sum(r['prefill']['bitwise'] for r in ranks)}/4 ranks; rank 0 "
            f"{pf['seconds']:.1f} s")
        notes.append(
            f"  serve ({SP_LANES} lanes, max_seq {SP_MAX_SEQ}, prompt {SP_PROMPT}, "
            f"{SP_GEN} greedy steps): {sv['layout']}; tokens equal on "
            f"{sum(r['serve']['tokens_equal'] for r in ranks)}/4 ranks; prefill "
            f"logits max abs diff "
            f"{max(r['serve']['prefill']['max_abs_diff'] for r in ranks):.3e}, decode "
            f"{max(r['serve']['decode']['max_abs_diff'] for r in ranks):.3e} "
            f"(max |logit| {sv['prefill']['scale']:.3e}, {sv['decode']['scale']:.3e}; "
            f"decode bit for bit on "
            f"{sum(r['serve']['decode']['bitwise'] for r in ranks)}/4); KV bytes a "
            f"rank {sv['kv_bytes']} of one device's {single['kv_bytes']}; rank 0 "
            f"{sv['seconds']:.1f} s")
        notes.append(
            f"  collectives (the formula's): step 0 forward {s0['collectives']['fwd']}, "
            f"backward {s0['collectives']['bwd']}; batch prefill {pf['collectives']}; "
            f"served prefill {sv['prefill_collectives']}; decode step "
            f"{sv['collectives']}; launches rank 0: step 0 "
            f"{ {k: v for k, v in s0['launches'].items() if v} }, served prefill "
            f"{ {k: v for k, v in sv['prefill_launches'].items() if v} }, decode step "
            f"{ {k: v for k, v in sv['decode_launches'].items() if v} }")
        from repro_torch.launch.mesh import Mesh

        shape_mesh = Mesh({"data": SP_MESH[0], "model": SP_MESH[1]},
                          {"data": 0, "model": 0}, {})
        notes.append(
            f"zamba2-1.2b and seamless-m4t-medium: the rules make_rules gives at a train "
            f"shape of {SPS_POLICY_SEQ} positions on data=1 x model=4 (seq_axis="
            f"{_sps_policy(_sps_cfg(*SPS_RUNS[0]), shape_mesh).seq_axis}: SP from 200 000 "
            f"positions, their 32 and 16 kv heads dividing the axis), applied at batch "
            f"{b} x seq {s}, prompts of {STATE_PROMPT} and {STATE_FRAMES} frames")
        for arch, layers in SPS_RUNS:
            notes += _sps_check(arch, layers, ranks, sps_single[arch], totals, card)
        notes.append(f"peak memory a rank {[round(r['peak_gib'], 3) for r in ranks]} GiB; "
                     f"single device (oracle) {single['peak_gib']:.3f} GiB; phase "
                     f"{time.perf_counter() - t_phase:.1f} s")
        return totals, notes
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 2a: the dry run and the roofline, held against the card
# ---------------------------------------------------------------------------

#: the dry run's cell held against the card: the train phase's step of
#: full-width tt-lm-100m, seq 256 x batch 8, no plan, one device
DRYRUN_CARD_SHAPE = (256, 8)
#: the sweep's cells: one shape per arch, every step kind and the
#: long-context skip among them, the longest first.  The whole 10 x 4
#: sweep (the CLI's ``--arch all --shape all``) took 178.1 s of the run's
#: 1200 (rwkv6-7b's train and prefill ~100 s each: its WKV runs 16-token
#: chunks), so the phase runs these ten
DRYRUN_CELLS = (("qwen2-moe-a2.7b", "train_4k"), ("grok-1-314b", "prefill_32k"),
                ("glm4-9b", "prefill_32k"), ("rwkv6-7b", "long_500k"),
                ("zamba2-1.2b", "decode_32k"), ("qwen1.5-110b", "decode_32k"),
                ("phi3-medium-14b", "decode_32k"), ("internvl2-2b", "decode_32k"),
                ("seamless-m4t-medium", "prefill_32k"), ("chatglm3-6b", "long_500k"))
#: processes of the sweep at a time, and the seconds it may take
DRYRUN_WORKERS = 8
DRYRUN_TIMEOUT_S = 300
#: the examples run beside the card check, each a subprocess: (script,
#: arguments); dse_explore_torch.py is host-only
EXAMPLES = (("quickstart_torch.py", ()),
            ("dse_explore_torch.py", ()),
            ("train_tt_lm_torch.py", ("--steps", "40")))
EXAMPLE_TIMEOUT_S = 300


def _start(argv: list[str], out_path: str) -> tuple:
    """A subprocess of ``python argv`` from the repository root, its
    output (both streams) to ``out_path``."""
    out = open(out_path, "w")
    proc = subprocess.Popen([sys.executable] + argv, cwd=ROOT, stdout=out,
                            stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONPATH=SRC,
                                     OMP_NUM_THREADS="1"))
    return proc, out, out_path


def _finish(job: tuple, deadline: float) -> tuple[int, str]:
    """Wait for a :func:`_start` job until ``deadline`` (killed after it);
    returns (exit code, its output)."""
    proc, out, path = job
    try:
        rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at its time limit"
    out.close()
    with open(path) as f:
        return rc, f.read()


def dryrun_vs_card(device, card: str) -> list[str]:
    """(b) full-width tt-lm-100m's train step (seq 256 x batch 8, no plan)
    traced on ``meta`` on a one-device mesh, against the same step run on
    the card under ``FlopCounterMode`` from seed-0 weights and the
    pipeline's batch: the FLOPs equal, the predicted peak within 0.5-2x
    of ``torch.cuda.max_memory_allocated`` (less what was allocated before
    the step's arguments)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, make_rules
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api, input_specs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.nn import install_plan
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import use_rules
    from repro_torch.tree import leaves

    cfg = get_config("tt-lm-100m")
    seq, batch = DRYRUN_CARD_SHAPE
    shape = ShapeConfig("chip_train", seq, batch, "train")
    mesh = Mesh({"data": 1, "model": 1}, {"data": 0, "model": 0}, {})
    install_plan(None)
    t0 = time.perf_counter()
    with use_rules(make_rules(cfg, shape, mesh)):
        pred = dryrun.trace_step(cfg, shape, mesh)
    trace_s = time.perf_counter() - t0

    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    params = api(cfg, device=device).init_params(0)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = adamw_init(params)
    specs = input_specs(cfg, shape)
    data = {k: torch.from_numpy(v).to(device=device, dtype=specs[k].dtype)
            for k, v in make_pipeline(cfg.vocab, seq, batch).batch(0).items()}
    step = make_train_step(cfg)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        _, _, metrics = step(params, opt, data)
    loss = float(metrics["loss"])
    torch.cuda.synchronize(device)
    step_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device) - base
    card_flops = fc.get_total_flops()
    del params, opt, data, metrics
    torch.cuda.empty_cache()

    mem = pred["memory"]
    ratio = mem["peak_bytes"] / peak
    if pred["flops"] != card_flops:
        raise AssertionError(f"dry run FLOPs {pred['flops']:.0f} != the card's "
                             f"{card_flops} for tt-lm-100m's train step")
    if not 0.5 <= ratio <= 2.0:
        raise AssertionError(f"dry run peak {mem['peak_bytes']} B is {ratio:.3f}x "
                             f"the card's max_memory_allocated {peak} B")
    if not math.isfinite(loss):
        raise AssertionError(f"tt-lm-100m train step on the card: loss {loss}")
    return [f"tt-lm-100m train step (seq {seq} x batch {batch}, fp32, no plan): "
            f"meta FLOPs {pred['flops']:.0f} == the card's {card_flops} "
            f"(FlopCounterMode); predicted peak {mem['peak_bytes']} B "
            f"({mem['peak_bytes'] / 2**30:.3f} GiB: arguments "
            f"{mem['argument_bytes']}, temporaries {mem['temp_bytes']}) vs "
            f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB), ratio "
            f"{ratio:.4f}; meta trace {trace_s:.1f} s on the host; the step "
            f"on the card {step_ms:.1f} ms (first step, FlopCounterMode on), "
            f"loss {loss:.6f}; {card}"]


def dryrun_sweep(cells: list, res_dir: str, log_dir: str, deadline: float,
                 jobs: list, stop) -> dict:
    """(a) one ``python -m repro_torch.launch.dryrun --arch A --shape S``
    process per cell, :data:`DRYRUN_WORKERS` at a time, until ``deadline``
    or ``stop`` is set; every process started is appended to ``jobs``.
    Returns {(arch, shape): (the cell's JSON result, its CLI line)}."""
    pending, running, results = list(cells), [], {}
    while pending or running:
        if stop.is_set():
            raise RuntimeError("the dry-run sweep was stopped")
        if time.perf_counter() > deadline:
            raise AssertionError(f"the dry-run sweep passed {DRYRUN_TIMEOUT_S} s "
                                 f"with {len(pending) + len(running)} cells left")
        while pending and len(running) < DRYRUN_WORKERS:
            arch, shape = pending.pop(0)
            job = _start(["-m", "repro_torch.launch.dryrun", "--arch", arch,
                          "--shape", shape, "--force", "--out-dir", res_dir],
                         os.path.join(log_dir, f"{arch}_{shape}.log"))
            jobs.append(job)
            running.append((arch, shape, job))
        done = [c for c in running if c[2][0].poll() is not None]
        if not done:
            time.sleep(0.1)
        for arch, shape, job in done:
            running.remove((arch, shape, job))
            rc, text = _finish(job, deadline)
            if rc != 0:
                raise AssertionError(f"dry run --arch {arch} --shape {shape} "
                                     f"exited {rc}:\n{text[-3000:]}")
            with open(os.path.join(res_dir, f"{arch}_{shape}_pod_tt.json")) as f:
                results[arch, shape] = json.load(f), text.strip().splitlines()[-1]
    return results


def dryrun_phase(device, card: str) -> tuple[dict, list[str]]:
    """Phase 2a: (a) the dry run's CLI for the cells of
    :data:`DRYRUN_CELLS` at full width on the single-pod production mesh
    (16 x 16), on ``meta``, with cost, one process per cell
    (:func:`dryrun_sweep`, on a thread): every cell
    ``ok``, or ``skipped`` with the reference's reason; the roofline table
    over the cells.  (c) the three examples, subprocesses started with the
    sweep, each with a time limit: each exits 0 and the quickstart
    launches a hand-written kernel on the card.  (b) :func:`dryrun_vs_card`
    in this process meanwhile.  Returns the quickstart's launch counts and
    the report lines."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import roofline
    from repro_torch.models import SHAPES, shape_applicable

    cells = list(DRYRUN_CELLS)
    if ({a for a, _ in cells} != set(ARCH_IDS) or len(cells) != len(ARCH_IDS)
            or {SHAPES[s].step for _, s in cells} != {"train", "prefill", "decode"}
            or "long_500k" not in {s for _, s in cells}):
        raise AssertionError(f"DRYRUN_CELLS must hold one shape of each of "
                             f"{ARCH_IDS} and every step kind: {cells}")
    out_dir = tempfile.mkdtemp(prefix="repro_torch_dryrun_")
    res_dir = os.path.join(out_dir, "results")
    start = time.perf_counter()
    stop, sweep_jobs, jobs = threading.Event(), [], {}
    pool = ThreadPoolExecutor(1)
    try:
        sweep = pool.submit(dryrun_sweep, cells, res_dir, out_dir,
                            start + DRYRUN_TIMEOUT_S, sweep_jobs, stop)
        for name, argv in EXAMPLES:
            if name.startswith("train"):
                argv += ("--ckpt-dir", os.path.join(out_dir, "ckpt"))
            jobs[name] = _start([os.path.join("examples", name), *argv],
                                os.path.join(out_dir, f"{name}.log"))
        notes = dryrun_vs_card(device, card)

        failed, counts = [], {}
        for name, job in jobs.items():
            rc, text = _finish(job, start + EXAMPLE_TIMEOUT_S)
            if rc != 0:
                failed.append(f"{name} exited {rc}:\n{text[-3000:]}")
                continue
            last = text.strip().splitlines()[-1]
            notes.append(f"example {name}: exit 0; {last}")
            if name.startswith("quickstart"):
                counts = ast.literal_eval(last.split(": ", 1)[1])
        if failed:
            raise AssertionError("\n".join(failed))

        results = {}
        for cell, (r, line) in sweep.result().items():
            results[cell] = r
            notes.append(line)
        sweep_s = time.perf_counter() - start
    finally:
        stop.set()
        pool.shutdown(wait=True)
        for proc, out, _ in list(jobs.values()) + sweep_jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
        shutil.rmtree(out_dir, ignore_errors=True)

    rows, statuses = [], collections.Counter()
    for (arch, shape), r in sorted(results.items()):
        ok, reason = shape_applicable(get_config(arch), SHAPES[shape])
        want = ("ok", None) if ok else ("skipped", reason)
        if (r["status"], r.get("reason")) != want:
            raise AssertionError(f"dry run {r['cell']}: {r['status']} "
                                 f"{r.get('reason') or r.get('error')}, want {want}")
        statuses[r["status"]] += 1
        if ok:
            rows.append(roofline.analyze_cell(r))
    if sum(counts.values()) <= 0:
        raise AssertionError(f"the quickstart launched no kernel: {counts}")
    notes.append(f"dry run: {len(cells)} cells (one shape of each arch) at full "
                 f"width on the 16 x 16 mesh, {dict(statuses)}; the sweep "
                 f"({DRYRUN_WORKERS} CLI processes at a time) and the "
                 f"examples {sweep_s:.1f} s wall")
    notes += ["roofline (H100: 989e12 bf16 FLOP/s, 3.35e12 B/s, 450e9 B/s "
              "NVLink):"] + roofline.markdown_table(rows).splitlines()
    return counts, notes


def main() -> int:
    global PLANS
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
    plan_dir = tempfile.mkdtemp(prefix="repro_torch_plans_")
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

        log("--- dryrun: every cell on meta at full width, held against the "
            "card; the examples on the card")
        t0 = time.perf_counter()
        example_counts, notes = dryrun_phase(device, card)
        for n in notes:
            log(f"  {n}")
        log(f"dryrun: {time.perf_counter() - t0:.1f} s; the quickstart's launches "
            f"{example_counts}")

        log("--- dse: the port's DSE emits the plans")
        secs, searches = dse_phase(plan_dir)
        PLANS = plan_dir
        log(f"dse: {len(EMIT)} plans emitted by python -m repro_torch.dse, each "
            "byte-identical to the committed file; emit seconds on the host "
            f"CPU ({card}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))

        log("--- tune: the autotuner on the card, and serving under its plans")
        tune_counts, tuned_counts, notes = tune_phase(plan_dir, device)
        for n in notes:
            log(f"  {n}")

        log("--- kernels against their plain versions")
        layers = main_path_layers()
        kernels = ([check_streaming(device, layers)] + check_tt_gemm(device, layers)
                   + [check_fused(device)])
        bf16_errs, notes = check_bf16(device, layers)
        for n in notes:
            log(f"  {n}")
        log("--- the experts' batched launches (60 experts of "
            f"{MOE_ARCH}) against their plain versions and the unbatched launches")
        t0 = time.perf_counter()
        rows, notes = check_batched(device)
        kernels += rows
        for n in notes + moe_sync_check(device):
            log(f"  {n}")
        log(f"batched: {time.perf_counter() - t0:.1f} s")
        log("--- kernels over the rank space (every candidate's plan)")
        rank_rows, refusals, notes = check_rank_space(device, searches[RANK_PLAN])
        for n in notes:
            log(f"  {n}")
        for k in kernels:
            log(f"  {k['name']} at {k['at']}: kernel {_fmt(k['ms'])} (host "
                f"{_fmt(k['host_ms'])}, graph {_fmt(k['graph_ms'])}), "
                f"plain {_fmt(k['plain_ms'])}, "
                f"library {_fmt(k['library_ms'])} (graph "
                f"{_fmt(k.get('library_graph_ms'))}), bound "
                f"{_fmt(k['bound_ms'])} ({k['bound_by']})")

        serve_counts, rank_counts, notes = serve_runs()
        for n in notes:
            log(f"  {n}")
        log(f"serve-path launches: {serve_counts}; of them, the rank plan's "
            f"runs: {rank_counts}")
        for name in SERVE_KERNELS:
            if serve_counts[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     "serve path")
        from repro_torch.plan import load_plan

        rank_kernels = {"streaming_tt"} | {
            f"tt_gemm_{lp.dataflow.lower()}"
            for lp in load_plan(os.path.join(PLANS, RANK_PLAN)).layers
            if lp.name != "head"}
        for name in sorted(rank_kernels):
            if rank_counts[name] <= 0:
                raise AssertionError(f"kernel {name} never launched by the rank "
                                     "plan's runs")

        log("--- shards: full-width tt-lm-100m served by 2 and 4 ranks sharing "
            "the card")
        t0 = time.perf_counter()
        sharded_counts, notes = shard_phase(device, card)
        for n in notes:
            log(f"  {n}")
        log(f"shards: {time.perf_counter() - t0:.1f} s; serve-path launches, "
            f"every rank of both runs: {sharded_counts}")

        log("--- shard train: full-width tt-lm-100m trained by 2 and 4 ranks "
            "sharing the card")
        t0 = time.perf_counter()
        shard_train_counts, notes = shard_train_phase(device, card)
        for n in notes:
            log(f"  {n}")
        log(f"shard train: {time.perf_counter() - t0:.1f} s; train-path launches, "
            f"every rank of the three runs: {shard_train_counts}")
        for name in ("streaming_tt", "tt_gemm_ws", "fused_path"):
            if shard_train_counts[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the sharded "
                                     "train path")

        log("--- families: full-width qwen2-moe-a2.7b, zamba2-1.2b, rwkv6-7b")
        t0 = time.perf_counter()
        family_counts, family_rows, notes = families_phase(device)
        for n in notes:
            log(f"  {n}")
        log(f"families: {time.perf_counter() - t0:.1f} s; serve-path launches "
            f"{family_counts}")

        log("--- families train: full-width qwen2-moe-a2.7b, zamba2-1.2b, rwkv6-7b")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as ckpt_root:
            family_train_counts, notes = families_train_phase(device, ckpt_root)
        for n in notes:
            log(f"  {n}")
        log(f"families train: {time.perf_counter() - t0:.1f} s; train-path "
            f"launches {family_train_counts}")
        for name in ("streaming_tt", "tt_gemm_ws", "fused_path"):
            if family_train_counts[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the families' "
                                     "train path")

        log(f"--- encdec: full-width {ENCDEC}, served through the prefill/decode "
            "steps and trained")
        t0 = time.perf_counter()
        encdec_serve_counts, encdec_train_counts, encdec_rows, notes = \
            encdec_phase(device)
        for n in notes:
            log(f"  {n}")
        log(f"encdec: {time.perf_counter() - t0:.1f} s; serve-path launches "
            f"{encdec_serve_counts}; train-path launches {encdec_train_counts}")
        for name, counts in (("streaming_tt", encdec_serve_counts),
                             ("streaming_tt", encdec_train_counts),
                             ("tt_gemm_ws", encdec_train_counts)):
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the encdec path")

        log("--- states: full-width zamba2-1.2b, rwkv6-7b and seamless-m4t-medium "
            "on 4 ranks sharing the card (the model axis of their heads)")
        t0 = time.perf_counter()
        states_counts, notes = states_phase(device, card)
        for n in notes:
            log(f"  {n}")
        log(f"states: {time.perf_counter() - t0:.1f} s; launches, every rank: "
            f"{states_counts}")

        log("--- sp: full-width chatglm3-6b (8 of 28 layers), zamba2-1.2b (12 of 38) "
            "and seamless-m4t-medium (12 + 12) on 4 ranks sharing the card, their "
            "sequences split over model=4")
        t0 = time.perf_counter()
        sp_counts, notes = sp_phase(device, card)
        for n in notes:
            log(f"  {n}")
        log(f"sp: {time.perf_counter() - t0:.1f} s; launches, every rank: {sp_counts}")

        for n in (launches_per_call(device) + decode_profile(device)
                  + output_check(device) + calibration_check(device)):
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
            profiles = [n for name in TRAIN_PLANS for n in train_profile(
                "tt-lm-100m", name, 256, 8, TRAIN_PROFILE, device, warmup=True)]
            for n in (train_check(device, first, ckpt_root) + profiles
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
    finally:
        shutil.rmtree(plan_dir, ignore_errors=True)

    sources = {"streaming_tt": ("src/repro_torch/csrc/streaming_tt.cu",
                                "src/repro/kernels/streaming_tt.py:149"),
               "tt_gemm_os": ("src/repro_torch/csrc/tt_gemm.cu",
                              "src/repro/kernels/tt_gemm.py:178"),
               "tt_gemm_ws": ("src/repro_torch/csrc/tt_gemm.cu",
                              "src/repro/kernels/tt_gemm.py:178"),
               "tt_gemm_is": ("src/repro_torch/csrc/tt_gemm.cu",
                              "src/repro/kernels/tt_gemm.py:178"),
               "fused_path": ("src/repro_torch/csrc/fused_path.cu",
                              "src/repro/kernels/fused_path.py:286"),
               # the reference's jax.vmap of these calls over the experts
               # (src/repro/nn/moe.py:148)
               "streaming_tt_batched": ("src/repro_torch/csrc/streaming_tt.cu",
                                        "src/repro/kernels/streaming_tt.py:149"),
               "tt_gemm_ws_batched": ("src/repro_torch/csrc/tt_gemm.cu",
                                      "src/repro/kernels/tt_gemm.py:178")}
    report = {"kernels": [
        {"name": k["name"], "route": "cuda", "source": sources[k["name"]][0],
         "replaces": sources[k["name"]][1],
         "launches": {"serve": serve_counts[k["name"]],
                      "serve_rank_plan": rank_counts[k["name"]],
                      "serve_sharded": sharded_counts[k["name"]],
                      "train_sharded": shard_train_counts[k["name"]],
                      "train": train_counts[k["name"]],
                      "tune": tune_counts[k["name"]],
                      "serve_tuned": tuned_counts[k["name"]],
                      "serve_families": family_counts[k["name"]],
                      "train_families": family_train_counts[k["name"]],
                      "serve_encdec": encdec_serve_counts[k["name"]],
                      "train_encdec": encdec_train_counts[k["name"]],
                      "states_sharded": states_counts[k["name"]],
                      "sp_sharded": sp_counts[k["name"]],
                      "examples": example_counts[k["name"]]},
         "max_abs_err": k["max_abs_err"],
         "bf16_max_abs_err": bf16_errs.get(k["name"]),
         "ms": k["ms"], "graph_ms": k["graph_ms"],
         "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"], "at": k["at"],
         **({"rank_plan": {key: rank_rows[k["name"]][key] for key in (
             "at", "ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms",
             "bound_ms", "bound_by")}} if k["name"] in rank_rows else {}),
         **({"families": {"max_abs_err": family_rows[k["name"]]["err"], "shapes": [
             {key: r[key] for key in ("at", "ms", "graph_ms", "plain_ms",
                                      "library_ms", "library_graph_ms",
                                      "bound_ms", "bound_by")}
             for r in family_rows[k["name"]]["rows"]]}}
            if k["name"] in family_rows else {}),
         **({"experts": {"shapes": [
             {key: r[key] for key in ("at", "ms", "host_ms", "graph_ms", "loop_ms",
                                      "loop_host_ms", "loop_graph_ms", "plain_ms",
                                      "library_ms", "library_graph_ms",
                                      "bound_ms", "bound_by")}
             for r in k["shapes"]]}} if "shapes" in k else {}),
         **({"encdec": {"max_abs_err": encdec_rows[k["name"]]["err"], "shapes": [
             {key: r[key] for key in ("at", "ms", "host_ms", "graph_ms", "plain_ms",
                                      "library_ms", "library_graph_ms",
                                      "bound_ms", "bound_by")}
             for r in encdec_rows[k["name"]]["rows"]]}}
            if k["name"] in encdec_rows else {})}
        for k in kernels],
        "k1_rank_space_refusals": refusals}
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
    if sys.argv[1:2] == ["--shard-rank"]:  # one rank of the shard phase
        sys.exit(shard_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--shard-train-rank"]:  # one rank of the shard-train phase
        sys.exit(shard_train_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--states-rank"]:  # one rank of the states phase
        sys.exit(states_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--sp-rank"]:  # one rank of the SP phase
        sys.exit(sp_rank(sys.argv[2]))
    sys.exit(main())
