"""End-to-end training on the PyTorch port: train the ~100M-param TT LM.

``examples/train_tt_lm.py`` on the port: TT layers, the deterministic data
pipeline, AdamW + warmup-cosine, gradient clipping, async checkpointing
and the fault-tolerant loop with straggler monitoring, composed through
``repro_torch.launch.steps.make_train_step``.  No plan is installed, so
every projection contracts on the plain executor.

  PYTHONPATH=src python examples/train_tt_lm_torch.py [--steps 300]

The same flags as the reference, plus ``--device`` (default ``cuda``;
``--device cpu`` runs on the CPU) and ``--smoke`` (the reduced tt-lm
config, for a quick CPU run).  Weights come from a ``torch.Generator``
seeded with 0.  Checkpoints go to ``--ckpt-dir`` (default
``tt_lm_ckpt_torch`` under the temporary directory).  The run fails unless
the last loss is below the first, as the reference's does.
"""

import argparse
import os
import sys
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.models.lm import count_params
from repro_torch.optim import adamw_init, linear_warmup_cosine
from repro_torch.runtime import FaultTolerantLoop, StragglerMonitor
from repro_torch.tree import leaves


def _trainable(state: dict) -> dict:
    """Restored parameters take part in autograd again."""
    for p in leaves(state["params"]):
        p.requires_grad_(True)
    return state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "tt_lm_ckpt_torch"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(pass --device cpu)", file=sys.stderr)
        return 2

    cfg = get_config("tt-lm-100m", smoke=args.smoke)
    m = api(cfg, device=device)
    params = m.init_params(torch.Generator().manual_seed(0))
    dense_equiv = (cfg.n_layers * (4 * cfg.d_model**2 + 3 * cfg.d_model * cfg.d_ff)
                   + cfg.vocab * cfg.d_model)
    print(f"arch {cfg.name}: {count_params(params):,} TT params "
          f"(dense-equivalent {dense_equiv:,}) on {device}")

    pipe = make_pipeline(cfg.vocab, args.seq, args.batch)
    step_fn = make_train_step(cfg, lr=linear_warmup_cosine(3e-4, 30, args.steps))
    state = _trainable({"params": params, "opt": adamw_init(params)})
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    mon = StragglerMonitor()
    t0 = time.time()
    losses = []

    def one(state, step):
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in pipe.batch(step).items()}
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % 20 == 0:
            tok_s = (step + 1) * args.batch * args.seq / (time.time() - t0)
            print(f"step {step:4d}  loss {loss:.4f}  {tok_s:,.0f} tok/s")
        return {"params": p, "opt": o}

    loop = FaultTolerantLoop(one, mgr, checkpoint_every=100, straggler=mon,
                             on_restore=_trainable)
    state, done = loop.run(state, 0, args.steps)
    print(f"done at step {done}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({time.time()-t0:.0f}s); checkpoints at {args.ckpt_dir}")
    if not losses[-1] < losses[0]:
        print("error: training must reduce loss", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
