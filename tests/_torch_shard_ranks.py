"""Rank bodies of ``tests/test_torch_shard_exec.py``: the port's sharded
planned execution on ranks of a ``gloo`` process group, on the CPU.

:func:`spawn` starts ``world`` Python processes (one per rank, each with a
time limit) that run :func:`main`; each rank joins the process group,
runs one body of :data:`BODIES` and saves what it returns with
``torch.save``.  A rank that raises, or any rank still running at the time
limit, fails the spawn (every rank is killed).

The ranks run one BLAS thread each, and the single-device references of
the test module are computed on one thread too.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import pathlib
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"

#: time limit of one spawn, seconds
SPAWN_TIMEOUT_S = 60

#: TT projections the linear bodies shard: (in_modes, out_modes, ranks),
#: tt-lm-smoke's mlp.wu and a three-mode network of full-width
#: tt-lm-100m's mlp.wu shape
GEOMETRIES = (
    ((8, 16), (16, 16), (8, 8, 8)),
    ((8, 8, 12), (8, 16, 16), (16, 16, 16, 16, 16)),
)
#: (backend, dataflow) of K1 and of K2, K3, K4's plain versions
ROUTES = (("streaming_tt", "OS"), ("tt_gemm", "OS"), ("tt_gemm", "WS"),
          ("tt_gemm", "IS"))
TOKENS = 8


def spawn(bodies: str, world: int, spec: dict, out_dir: pathlib.Path,
          timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run the bodies ``bodies`` names (comma-separated, in order) on
    ``world`` ranks; returns each rank's ``{body: result}``."""
    from repro_torch.launch.ranks import spawn_ranks

    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")]))
    spawn_ranks([sys.executable, "-c", "import _torch_shard_ranks as m; "
                 f"m.main({bodies!r}, {str(out_dir)!r})"],
                world, str(out_dir), timeout, env=env)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def main(bodies: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        spec = json.loads((pathlib.Path(out_dir) / "spec.json").read_text())
        result = {b: BODIES[b](spec) for b in bodies.split(",")}
        torch.save(result, pathlib.Path(out_dir) / f"rank{dist.get_rank()}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# shared inputs (the same on every rank and in the test process)
# ---------------------------------------------------------------------------

def layer_plan(backend: str, dataflow: str, geometry):
    from repro_torch.core.paths import find_topk_paths
    from repro_torch.core.tensor_network import tt_linear_network
    from repro_torch.plan import LayerPlan
    from repro_torch.plan.schema import Tiling

    in_modes, out_modes, ranks = geometry
    tn = tt_linear_network(TOKENS, in_modes, out_modes, ranks)
    steps = find_topk_paths(tn, k=1)[0].steps
    return LayerPlan(name="t", path_index=0, path_steps=tuple(steps),
                     dataflow=dataflow, partitioning=(1, 1), backend=backend,
                     tiling=Tiling(block_m=16, block_k=16, block_n=16,
                                   block_tokens=8))


def linear_inputs(geometry, seed: int = 0):
    """``x (TOKENS, d_in)`` and the cores, made with numpy from ``seed``."""
    in_modes, out_modes, ranks = geometry
    rng = np.random.default_rng(seed)
    modes = out_modes + in_modes
    r = (1,) + ranks + (1,)
    cores = []
    for k, m in enumerate(modes):
        shape = (r[k], m, r[k + 1])
        if k == 0:
            shape = (m, r[1])
        elif k == len(modes) - 1:
            shape = (r[k], m)
        cores.append(torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * 0.3))
    x = torch.from_numpy(
        rng.standard_normal((TOKENS, int(np.prod(in_modes)))).astype(np.float32))
    return x, cores


def _rules(reduce: bool):
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import ShardingRules

    mesh = make_test_mesh()
    return ShardingRules(axis_sizes=dict(mesh.shape), mesh=mesh,
                         tt_model_reduce=reduce)


# ---------------------------------------------------------------------------
# bodies
# ---------------------------------------------------------------------------

def body_linear(spec: dict) -> dict:
    """``sharded_tt_linear`` on every geometry and route, its execution
    records, the collectives, the autograd refusal, and ``launch.serve``'s
    token agreement check."""
    import torch.distributed as dist

    from repro_torch.launch import serve
    from repro_torch.plan import (execution_log, reset_execution_log,
                                  shard_decision, sharded_tt_linear)
    from repro_torch.plan.sharded import COLLECTIVES, reset_collectives

    rules = _rules(spec["reduce"])
    out = {"mesh": dict(rules.mesh.shape), "coords": dict(rules.mesh.coords),
           "y": {}, "records": {}}
    for g, geometry in enumerate(GEOMETRIES):
        in_modes, out_modes, ranks = geometry
        x, cores = linear_inputs(geometry, seed=g)
        decision = shard_decision(rules, TOKENS, in_modes)
        for backend, dataflow in ROUTES:
            lp = layer_plan(backend, dataflow, geometry)
            reset_execution_log()
            reset_collectives()
            y = sharded_tt_linear(lp, x, cores, in_modes, out_modes, ranks,
                                  rules=rules, decision=decision)
            key = f"{g}:{backend}:{dataflow}"
            out["y"][key] = y
            out["records"][key] = [dict(r) for r in execution_log()]
            out.setdefault("collectives", {})[key] = dict(COLLECTIVES)
    x, cores = linear_inputs(GEOMETRIES[0])
    lp = layer_plan("streaming_tt", "OS", GEOMETRIES[0])
    try:
        sharded_tt_linear(lp, x.requires_grad_(), cores, *GEOMETRIES[0],
                          rules=rules,
                          decision=shard_decision(rules, TOKENS, GEOMETRIES[0][0]))
        out["autograd"] = "ran"
    except NotImplementedError as e:
        out["autograd"] = str(e)
    # launch.serve's check that the ranks generated the same tokens
    rank = dist.get_rank()
    ranks = serve.Ranks(rank, dist.get_world_size(), "gloo", False, False)
    out["agree"] = {}
    for case, other in (("same", 0), ("differ", rank)):
        result = type("Result", (), {"tokens_by_rid": lambda self, o=other: {
            0: (1, 2, 3), 1: (4, 5 + o)}})()
        out["agree"][case] = serve._tokens_agree(ranks, result, "cpu")
    return out


def body_serve(spec: dict) -> dict:
    """``launch.serve``'s code path on the ranks, then fp32 prefill logits
    of the smoke model under the installed rules, on the weights saved at
    ``spec["params"]``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.models import api
    from repro_torch.models.config import ShapeConfig
    from repro_torch.nn import plan_context
    from repro_torch.plan import execution_log, load_plan
    from repro_torch.sharding import use_rules

    out = {}
    for label, argv in spec["runs"].items():
        with contextlib.redirect_stdout(io.StringIO()) as text:
            run = serve.run(argv, tt_model_reduce=spec["reduce"])
        out[label] = {"code": run.code, "stdout": text.getvalue(),
                      "tokens": (run.result.tokens_by_rid()
                                 if run.result is not None else None),
                      "records": [dict(r) for r in execution_log()]}
    cfg = get_config("tt-lm-100m", smoke=True)
    plan = load_plan(spec["prefill_plan"])
    rules = make_rules(cfg, ShapeConfig("t", 16, 2, "decode"), make_test_mesh())
    if spec["reduce"]:
        import dataclasses

        rules = dataclasses.replace(rules, tt_model_reduce=True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, 8)))
    m = api(cfg, device="cpu")
    params = torch.load(spec["params"], weights_only=False)
    with use_rules(rules), plan_context(plan), torch.no_grad():
        out["logits"], _ = m.prefill_full(params, {"tokens": toks}, 16)
    return out


BODIES = {"linear": body_linear, "serve": body_serve}
