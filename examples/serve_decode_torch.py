"""Batched serving with the PyTorch port: prefill a prompt batch, decode
with caches, through the prefill and decode step builders.

  PYTHONPATH=src python examples/serve_decode_torch.py [--arch seamless-m4t-medium --smoke]

The same flags as ``examples/serve_decode.py``, plus ``--device`` (default
``cuda``; ``--device cpu`` runs the plain versions of the kernels).  No
plan is installed, so every projection contracts on the plain executor.
An encoder-decoder or VLM arch gets seeded random frontend embeddings.
"""

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import api


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tt-lm-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(pass --device cpu to run the plain versions)", file=sys.stderr)
        return 2

    cfg = get_config(args.arch, smoke=args.smoke)
    m = api(cfg, device=device)
    params = m.init_params(torch.Generator().manual_seed(0))
    max_seq = args.prompt_len + args.gen
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(device)}
    if cfg.family in ("vlm", "encdec"):
        n = cfg.n_frontend_tokens or 8
        batch["frontend"] = torch.from_numpy(
            rng.normal(size=(args.batch, n, cfg.d_model))).to(
                device=device, dtype=getattr(torch, cfg.dtype))

    prefill = make_prefill_step(cfg, max_seq=max_seq)
    decode = make_decode_step(cfg)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.time()
    logits, caches = prefill(params, batch)
    sync()
    print(f"prefill {args.batch}x{args.prompt_len}: {(time.time()-t0)*1e3:.1f} ms")

    tok = torch.argmax(logits, -1)[:, None]
    generated = [tok.cpu()]
    t0 = time.time()
    for i in range(args.gen - 1):
        logits, caches = decode(params, tok, caches,
                                torch.tensor(args.prompt_len + i, device=device))
        tok = torch.argmax(logits, -1)[:, None]
        generated.append(tok.cpu())
    sync()
    dt = time.time() - t0
    print(f"decode {args.gen - 1} steps: {dt/(args.gen-1)*1e3:.2f} ms/step "
          f"({(args.gen-1)*args.batch/dt:,.0f} tok/s at batch {args.batch})")
    print("sample:", torch.cat(generated, 1)[0][:12].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
