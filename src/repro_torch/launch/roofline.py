"""Roofline analysis over the dry-run artifacts, against one NVIDIA H100.

Port of ``src/repro/launch/roofline.py``.  Reads ``results/dryrun/*.json``
(written by :mod:`repro_torch.launch.dryrun`) and derives, per (arch x
shape):

  compute_s    = flops_per_device / peak_FLOP/s           (989e12 bf16)
  memory_s     = bytes_per_device / HBM_bw                (3.35e12 B/s)
  collective_s = collective_bytes_per_device / link_bw    (450e9 B/s)

The dry run's figures are per rank, so dividing by one card's peaks is the
"global / (cards x peak)" roofline.  Also reports MODEL_FLOPS = 6*N*D
(dense) or 6*N_active*D (MoE) and the useful-compute ratio
MODEL_FLOPS / counted FLOPs.  Under the port's layout every rank computes
the whole step (activations are replicated, ``launch/dryrun.py``), so the
counted FLOPs per rank are the whole step's and the ratio falls with the
ranks.

  python -m repro_torch.launch.roofline --results results/dryrun
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.models import SHAPES
from repro_torch.models.lm import count_params  # noqa: F401  (exact counts from a tree)

# H100 SXM, NVIDIA's data sheet (dense, 700 W), as the hopper-kernels guide
# gives them: every FULL config of ARCH_IDS runs in bfloat16
PEAK_FLOPS = 989e12        # bf16 tensor-core FLOP/s / card
HBM_BW = 3.35e12           # HBM3 B/s / card
LINK_BW = 450e9            # NVLink B/s / card, each way (900 GB/s both ways)
RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun")


# ---------------------------------------------------------------------------
# analytic model FLOPs (the 6*N*D yardstick)
# ---------------------------------------------------------------------------

def arch_param_counts(arch: str) -> dict[str, float]:
    """Dense-equivalent and active parameter counts (analytic, no init)."""
    cfg = get_config(arch, tt=False)
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    hd = cfg.hd
    qk = cfg.n_heads * hd
    kv = cfg.n_kv_heads * hd
    attn = d * qk + 2 * d * kv + qk * d
    mlp3 = 3 * d * f
    embed = v * d
    if cfg.family == "dense" or cfg.family == "vlm":
        per = attn + mlp3
        total = L * per + embed
        active = total
    elif cfg.family == "moe":
        expert = 3 * d * f
        shared = 3 * d * (cfg.moe_shared_d_ff or 0) if cfg.moe_shared else 0
        per = attn + cfg.moe_experts * expert + shared
        per_active = attn + cfg.moe_top_k * expert + shared
        total = L * per + embed
        active = L * per_active + embed
    elif cfg.family == "hybrid":
        d_in = 2 * d
        ssm = d * (2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim) + d_in * d
        per = ssm + d * f * 0  # zamba2 mamba blocks have no separate MLP here
        n_groups = L // cfg.attn_every if cfg.attn_every else 0
        total = L * per + attn + embed          # ONE shared attention block
        active = L * per + n_groups * attn + embed  # applied n_groups times
    elif cfg.family == "rwkv":
        tm = 5 * d * d + 2 * d * 64 * 5        # projections + lora (approx)
        cm = 2 * d * f + d * d
        per = tm + cm
        total = L * per + embed
        active = total
    elif cfg.family == "encdec":
        enc_per = attn + 2 * d * f             # gelu mlp: up+down
        dec_per = attn + attn + 2 * d * f      # + cross attention
        total = cfg.encoder_layers * enc_per + L * dec_per + embed
        active = total
    else:
        raise ValueError(cfg.family)
    return {"total": float(total), "active": float(active)}


def model_flops(arch: str, shape_name: str) -> float:
    """6*N_active*D for train; 2*N_active*D per generated/processed token
    for inference (forward only)."""
    shape = SHAPES[shape_name]
    counts = arch_param_counts(arch)
    n_active = counts["active"]
    if shape.step == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.step == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens


# ---------------------------------------------------------------------------
# table
# ---------------------------------------------------------------------------

def analyze_cell(result: dict) -> Optional[dict]:
    if result.get("status") != "ok" or "cost" not in result:
        return None
    arch, shape_name = result["arch"], result["shape"]
    n_dev = result["n_devices"]
    flops = result["cost"]["flops_per_device"]
    bytes_ = result["cost"]["bytes_per_device"]
    coll = result["cost"]["collective_bytes_per_device"]
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_ / HBM_BW
    coll_s = coll / LINK_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s), ("collective", coll_s)),
        key=lambda t: t[1],
    )[0]
    mf = model_flops(arch, shape_name) / n_dev
    return {
        "cell": result["cell"],
        "arch": arch,
        "shape": shape_name,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "model_flops_per_dev": mf,
        "useful_ratio": mf / flops if flops else 0.0,
        "roofline_s": max(compute_s, memory_s, coll_s),
        "bound_fraction": mf / PEAK_FLOPS / max(compute_s, memory_s, coll_s)
        if max(compute_s, memory_s, coll_s) else 0.0,
    }


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| cell | compute (s) | memory (s) | collective (s) | dominant | "
           "MODEL_FLOPs/HLO | roofline frac |\n"
           "|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        lines.append(
            f"| {r['arch']} / {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | {r['dominant']} | "
            f"{r['useful_ratio']:.2f} | {r['bound_fraction']:.2f} |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS_DIR)
    ap.add_argument("--pattern", default="*_pod_tt.json")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for path in sorted(glob.glob(os.path.join(args.results, args.pattern))):
        with open(path) as f:
            res = json.load(f)
        row = analyze_cell(res)
        if row:
            rows.append(row)
    print(markdown_table(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
