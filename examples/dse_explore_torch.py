"""Reproduce the paper's Fig. 3 story on a tensorized ViT-Ti/4 layer
(reconstruction vs MAC-optimal vs latency-optimal contraction orders),
then run the full model-level DSE via the port's ``repro_torch.dse`` CLI
machinery and summarise its JSON report.

  PYTHONPATH=src python examples/dse_explore_torch.py

``examples/dse_explore.py`` on the PyTorch port.  The example is
host-only: the DSE is framework-neutral and no step of it touches a
device, so it takes no ``--device`` flag, runs wherever the reference
runs, and prints what the reference prints (the wall-clock timings
aside).
"""

import sys
from collections import Counter

from repro_torch.core import (
    ALL_DATAFLOWS,
    ALL_PARTITIONINGS,
    find_topk_paths,
    layer_latency,
    reconstruction_path,
)
from repro_torch.dse_cli import run_dse
from repro_torch.hw import get_target
from repro_torch.models.vision import vit_ti4_layers

FPGA_VU9P = get_target("fpga_vu9p")


def best(path):
    cfg = min(
        ((layer_latency(path, d, c, FPGA_VU9P).seconds, c, d.value)
         for c in ALL_PARTITIONINGS for d in ALL_DATAFLOWS),
        key=lambda t: t[0],
    )
    return cfg


def main() -> int:
    layer = vit_ti4_layers(batch=64)[2]     # fc1: 192 -> 768
    tn = layer.tt_network
    paths = find_topk_paths(tn, k=8)
    recon = reconstruction_path(tn)

    lat_r, c_r, d_r = best(recon)
    print(f"reconstruction order : {recon.macs:>12,} MACs  "
          f"{lat_r*1e6:8.1f} us  ({c_r}, {d_r})")
    lat_m, c_m, d_m = best(paths[0])
    print(f"MAC-optimal (Path-1) : {paths[0].macs:>12,} MACs  "
          f"{lat_m*1e6:8.1f} us  ({c_m}, {d_m})")
    lat_best, p_best = min(((best(p)[0], p) for p in paths), key=lambda t: t[0])
    k = paths.index(p_best) + 1
    _, c_b, d_b = best(p_best)
    print(f"latency-optimal (Path-{k}): {p_best.macs:>10,} MACs  "
          f"{lat_best*1e6:8.1f} us  ({c_b}, {d_b})")
    if p_best is not paths[0]:
        print(f"-> the latency-optimal path has {p_best.macs / paths[0].macs:.2f}x "
              f"the MACs but {100 * (1 - lat_best / lat_m):.0f}% lower latency "
              f"(the paper's Fig. 3 observation)")

    # model-level DSE: same report as `python -m repro_torch.dse --arch tt-lm-100m`
    report = run_dse("tt-lm-100m", top_k=4)
    print(f"\n[tt-lm-100m] strategy={report['strategy']}  "
          f"total={report['total_latency_s'] * 1e3:.2f} ms  "
          f"({report['n_layers']} tensorized projections)")
    t = report["timings"]
    print(f"  path search {t['path_search_s'] * 1e3:.1f} ms, "
          f"cost table {t['table_build_s'] * 1e3:.1f} ms "
          f"({report['table']['n_unique_gemm_evals']} unique GEMM evals "
          f"for {report['table']['n_cells']} cells), "
          f"argmin {t['argmin_s'] * 1e3:.1f} ms")
    dfs = Counter(l["dataflow"] for l in report["layers"])
    non_mac = sum(1 for l in report["layers"] if not l["mac_optimal_path"])
    print(f"  dataflows {dict(dfs)}; {non_mac}/{report['n_layers']} layers "
          f"pick a non-MAC-optimal path")

    # joint (architecture, path, dataflow) co-search under the VU9P budget
    co = run_dse("vit_ti4/cifar10", top_k=4, hw_search="budget")
    hs = co["hw_search"]
    chosen, fixed = hs["chosen"], hs["fixed"]
    print(f"\n[vit_ti4/cifar10] hw co-search over {hs['n_candidates']} "
          f"feasible archs: {fixed['total_latency_s'] * 1e3:.3f} ms "
          f"(fixed {fixed['name']}) -> {chosen['total_latency_s'] * 1e3:.3f} "
          f"ms on {chosen['pe_rows']}x{chosen['pe_cols']} PEs "
          f"({hs['improvement_pct']:.1f}% faster)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
