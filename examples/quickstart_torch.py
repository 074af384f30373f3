"""Quickstart with the PyTorch port: tensorize one layer, search paths, run
the DSE, execute — then compile the DSE result into an execution plan and
run *that* through its hand-written kernel, and finally co-search the
hardware architecture itself.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The same six steps as ``examples/quickstart.py``, plus ``--device``
(default ``cuda``; ``--device cpu`` runs the plain versions of the
kernels).  Steps 1-3 and 6 are framework-neutral and print what the
reference prints.  The weights come from a ``torch.Generator`` (the
reference's ``jax.random`` cannot be replayed), so step 4's numbers are
this package's own.  Step 5 runs the layer under its plan: on the card
the planned backend's kernel (K1 ``streaming_tt`` or K2-K4 ``tt_gemm``),
whose launches the last line counts.
"""

import argparse
import sys

import torch

from repro_torch.core import explore_model, find_topk_paths, tt_linear_network
from repro_torch.hw import ArchSpace, get_target
from repro_torch.kernels import launches
from repro_torch.nn import LinearSpec, TTConfig, install_plan, linear_apply, linear_init
from repro_torch.plan import ExecutionPlan, compile_plan, execution_log

FPGA_VU9P = get_target("fpga_vu9p")
TPU_V5E = get_target("tpu_v5e")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(pass --device cpu to run the plain versions)", file=sys.stderr)
        return 2

    # 1. A 1024 -> 4096 projection, TT-factorized at rank 16 ----------------
    tt = TTConfig(enabled=True, d=3, rank=16, min_dim=512)
    spec = LinearSpec("demo", 1024, 4096, tag="mlp", tt=tt)
    print(f"dense params: {1024 * 4096:,}   TT params: {spec.n_params():,} "
          f"({1024 * 4096 / spec.n_params():.1f}x compression)")

    # 2. The layer as a tensor network; MAC-guided top-K path search --------
    tn = tt_linear_network(batch=256, in_modes=spec.in_modes,
                           out_modes=spec.out_modes, ranks=spec.tt_ranks)
    paths = find_topk_paths(tn, k=4)
    print("top-K path MACs:", [f"{p.macs:,}" for p in paths])
    print(f"dense GEMM MACs: {256 * 1024 * 4096:,}")

    # 3. Global latency-driven DSE (Algorithm 1) over (path, split, dataflow)
    results = {}
    for hw in (FPGA_VU9P, TPU_V5E):
        results[hw.name] = res = explore_model([tn], hw, top_k=4)
        c = res.choices[0]
        print(f"{hw.name}: strategy={res.strategy} path={c.path_index} "
              f"partition={c.partitioning} dataflow={c.dataflow.value} "
              f"latency={c.latency_s * 1e6:.1f} us")

    # 4. Execute the layer (the DSE-chosen path drives the contraction order)
    gen = torch.Generator().manual_seed(0)
    params = linear_init(spec, gen, torch.float32, device)
    x = torch.randn((256, 1024), generator=gen).to(device)
    with torch.no_grad():
        y = linear_apply(spec, params, x)
    print("forward:", tuple(x.shape), "->", tuple(y.shape), "finite:",
          bool(torch.all(torch.isfinite(y))))

    # 5. Compile the DSE result into an ExecutionPlan and execute *it* ------
    #    (the search -> compile -> install -> execute loop; docs/plan_format.md)
    plan = compile_plan([(spec.name, tn)], results[FPGA_VU9P.name], FPGA_VU9P,
                        arch="quickstart", tokens=256)
    lp = plan.layers[0]
    print(f"plan: backend={lp.backend} dataflow={lp.dataflow} "
          f"path_steps={list(map(list, lp.path_steps))}")
    assert ExecutionPlan.loads(plan.dumps()) == plan  # round-trips bit-equal

    launches.reset()
    install_plan(plan)
    try:
        with torch.no_grad():
            y_planned = linear_apply(spec, params, x)
    finally:
        install_plan(None)
    err = float(torch.max(torch.abs(y_planned - y)))
    ran = [(r["name"], r["backend"]) for r in execution_log()]
    print(f"planned execution {ran}: max |planned - default| = {err:.2e}")
    if err >= 1e-4:
        raise SystemExit(f"planned execution disagrees: {err:.2e}")

    # 6. Joint hardware co-search: re-shape the same silicon budget ---------
    #    (every feasible PE shape / SRAM split / bandwidth tier of the FPGA)
    space = ArchSpace(base=FPGA_VU9P)
    co = explore_model([tn], hw_space=space.candidates())
    fixed = results[FPGA_VU9P.name]
    assert co.total_latency_s <= fixed.total_latency_s  # base is in the space
    print(f"hw co-search over {len(co.hw_candidates)} candidates: "
          f"{fixed.total_latency_s * 1e6:.1f} us (fixed {FPGA_VU9P.name}) -> "
          f"{co.total_latency_s * 1e6:.1f} us on {co.hw.name}")
    print(f"kernel launches on {device.type}: {launches.snapshot()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
