"""Rank bodies of ``tests/test_torch_shard_exec.py`` (serving) and
``tests/test_torch_shard_train.py`` (training): the port's sharded planned
execution on ranks of a ``gloo`` process group, on the CPU.

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
import functools
import io
import json
import math
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


def autograd_weights(shape) -> torch.Tensor:
    """The weights of ``loss = sum(y * w)`` in the autograd case."""
    return torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(shape)).astype(np.float32))


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
    records, the collectives, its gradients under autograd, and
    ``launch.serve``'s token agreement check."""
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
    x.requires_grad_(True)
    for c in cores:
        c.requires_grad_(True)
    y = sharded_tt_linear(lp, x, cores, *GEOMETRIES[0], rules=rules,
                          decision=shard_decision(rules, TOKENS, GEOMETRIES[0][0]))
    (y * autograd_weights(y.shape)).sum().backward()
    out["autograd"] = [x.grad] + [c.grad for c in cores]
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
    from repro_torch.models.lm import whole_logits
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
        logits, _ = m.prefill_full(params, {"tokens": toks}, 16)
        # on a model axis a rank holds its block of the vocab
        out["logits"] = whole_logits(logits, cfg.vocab)
    return out


# ---------------------------------------------------------------------------
# training bodies
# ---------------------------------------------------------------------------

PLANS = SRC / "repro_torch" / "plans"
TRAIN_PLANS = ("tt-lm-smoke.train.json", "tt-lm-smoke.train.tt_gemm.json")
#: the planned projections the layer bodies train: tt-lm-smoke's mlp.wg
#: (input modes (16, 8)) and, behind it in the mixed case, mlp.wd ((16, 16))
TRAIN_LAYER, MIXED_LAYER = "mlp.wg", "mlp.wd"
#: (label, plan file, forced backend, forced dataflow): K1 (dx on K1, weight
#: gradients on K3's plain version), K2-K4's plain versions with every
#: gradient on the same dataflow, and K5's (fused segments forward)
TRAIN_ROUTES = (("k1", TRAIN_PLANS[0], None, None),
                ("os", TRAIN_PLANS[0], "tt_gemm", "OS"),
                ("ws", TRAIN_PLANS[0], "tt_gemm", "WS"),
                ("is", TRAIN_PLANS[0], "tt_gemm", "IS"),
                ("k5", TRAIN_PLANS[1], None, None))
#: token counts of the layer bodies: 8 divide over ``data=2``; 7 do not,
#: so every rank runs the kernel whole (the decline case; on 4 ranks with
#: the reduce, the columns still split)
TRAIN_TOKENS = (8, 7)
#: (batch, seq) of the model bodies: 32 tokens split; 15 decline
MODEL_BATCHES = {"split": (2, 16), "decline": (3, 5)}


def smoke_specs() -> dict:
    from repro_torch import dse_cli
    from repro_torch.configs import get_config

    return {s.name: s for s, _, _ in dse_cli._block_specs(
        get_config("tt-lm-100m", smoke=True))}


def train_layer_plan(plan_module, route, name: str = TRAIN_LAYER):
    """The route's LayerPlan of ``name`` in ``plan_module`` (the port's or
    the reference's ``plan`` package: both load the same file)."""
    import dataclasses

    _, plan_file, backend, dataflow = route
    lp = plan_module.load_plan(str(PLANS / plan_file)).layer(name)
    if backend is not None:
        lp = lp.with_backend(backend)
    if dataflow is not None:
        lp = dataclasses.replace(lp, dataflow=dataflow)
    return lp


def train_layer_inputs(name: str, tokens: int, seed: int):
    """numpy ``x (tokens, d_in)``, the cores and the output weights ``w``
    of ``loss = sum(y * w)``, made from ``seed``."""
    spec = smoke_specs()[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tokens, spec.d_in)).astype(np.float32)
    cores = [(rng.standard_normal(n.dims) * 0.5).astype(np.float32)
             for n in spec.network(tokens).nodes if n.kind != "input"]
    w = rng.standard_normal((tokens, spec.d_out)).astype(np.float32)
    return x, cores, w


def _geometry(name: str):
    spec = smoke_specs()[name]
    return spec.in_modes, spec.out_modes, spec.tt_ranks


def _dispatch(lp, x, cores, geometry, rules):
    """``nn/linear.py``'s route for a kernel-planned projection: sharded
    where the rules' decision accepts the tokens, whole where it declines."""
    from repro_torch.nn import linear
    from repro_torch.plan import planned_tt_linear, sharded_tt_linear
    from repro_torch.sharding import use_rules

    with use_rules(rules):
        sharded = linear._shard_decision(x.shape[0], geometry[0])
    if sharded is None:
        return planned_tt_linear(lp, x, cores, *geometry)
    return sharded_tt_linear(lp, x, cores, *geometry, rules=sharded[0],
                             decision=sharded[1])


def _leaves_grad(tensors):
    return [t.grad.clone() for t in tensors]


def body_train_layers(spec: dict) -> dict:
    """One planned projection on every route and token count, and a mixed
    pair (mlp.wg split, mlp.wd on 7 of its rows, declined on 2 ranks):
    outputs, dx and core gradients of ``sum(y * w)``, the records and the
    collectives."""
    from repro_torch import plan as port_plan
    from repro_torch.plan import execution_log, reset_execution_log
    from repro_torch.plan.sharded import (BWD_COLLECTIVES, COLLECTIVES,
                                          reset_collectives)

    rules = _rules(spec["reduce"])
    out = {}

    def grads(key, fn, inputs):
        reset_execution_log()
        reset_collectives()
        ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
        loss = fn(*ts)
        loss.backward()
        out[key] = {"loss": loss.detach(), "grads": _leaves_grad(ts),
                    "records": [dict(r) for r in execution_log()],
                    "collectives": dict(COLLECTIVES),
                    "bwd_collectives": dict(BWD_COLLECTIVES)}

    geometry = _geometry(TRAIN_LAYER)
    for route in TRAIN_ROUTES:
        lp = train_layer_plan(port_plan, route)
        for tokens in TRAIN_TOKENS:
            x, cores, w = train_layer_inputs(TRAIN_LAYER, tokens, seed=tokens)
            grads(f"{route[0]}:{tokens}", lambda x, *cs, w=w, lp=lp: (
                _dispatch(lp, x, list(cs), geometry, rules)
                * torch.from_numpy(w)).sum(), [x, *cores])
    # local rows (batch_split): each rank its block of the 8 rows and of
    # w, no collective over data in the route; the step's sum over data
    # (here by hand: core gradients and the loss summed, dx gathered)
    # must give the whole-batch gradients, each core's counted once
    import dataclasses

    import torch.distributed as dist

    split = dataclasses.replace(rules, batch_split=True)
    mesh = rules.mesh
    group, index = mesh.group(("data",)), mesh.index(("data",))
    for route in TRAIN_ROUTES:
        lp = train_layer_plan(port_plan, route)
        x, cores, w = train_layer_inputs(TRAIN_LAYER, 8, seed=8)
        rows = slice(4 * index, 4 * index + 4)
        reset_execution_log()
        reset_collectives()
        ts = [torch.from_numpy(x[rows]).requires_grad_(True)] + [
            torch.from_numpy(c).requires_grad_(True) for c in cores]
        loss = (_dispatch(lp, ts[0], ts[1:], geometry, split)
                * torch.from_numpy(w[rows])).sum()
        loss.backward()
        done = {"records": [dict(r) for r in execution_log()],
                "collectives": dict(COLLECTIVES),
                "bwd_collectives": dict(BWD_COLLECTIVES)}
        got = _leaves_grad(ts)
        parts = [torch.empty_like(got[0]) for _ in range(2)]
        dist.all_gather(parts, got[0], group=group)
        for g in got[1:]:
            dist.all_reduce(g, group=group)
        total = loss.detach().clone()
        dist.all_reduce(total, group=group)
        out[f"{route[0]}:split"] = {"loss": total, "grads": [torch.cat(parts)] + got[1:],
                                    **done}
    route = TRAIN_ROUTES[0]
    first = train_layer_plan(port_plan, route, TRAIN_LAYER)
    second = train_layer_plan(port_plan, route, MIXED_LAYER)
    x, c1, _ = train_layer_inputs(TRAIN_LAYER, 8, seed=21)
    _, c2, w = train_layer_inputs(MIXED_LAYER, 7, seed=22)
    n1 = len(c1)

    def mixed(x, *cs):
        h = _dispatch(first, x, list(cs[:n1]), geometry, rules)
        y = _dispatch(second, h[:7], list(cs[n1:]), _geometry(MIXED_LAYER), rules)
        return (y * torch.from_numpy(w)).sum()

    grads("mixed", mixed, [x, *c1, *c2])
    return out


def _model_batch(cfg, key: str) -> dict:
    b, s = MODEL_BATCHES[key]
    rng = np.random.default_rng(3)
    return {k: rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int64)
            for k in ("tokens", "labels")}


def _model_rules(cfg, key: str, reduce: bool):
    import dataclasses

    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.models.config import ShapeConfig

    from repro_torch.launch.mesh import batch_layout

    b, s = MODEL_BATCHES[key]
    rules = make_rules(cfg, ShapeConfig("t", s, b, "train"), make_test_mesh())
    return batch_layout(dataclasses.replace(rules, tt_model_reduce=reduce), b)


def rank_block(batch: dict, rules) -> dict:
    """This rank's block of ``batch`` under ``rules``' batch layout (the
    whole batch where it stays replicated)."""
    from repro_torch.launch.mesh import LayoutBlocks, batch_shardings

    if not rules.batch_split:
        return batch
    return LayoutBlocks(batch_shardings(batch, rules), rules).block(batch)


def body_train_model(spec: dict) -> dict:
    """tt-lm-smoke's loss and every gradient leaf under each smoke train
    plan and batch, on the weights saved at ``spec["params"]``, through
    the train step's ``loss_and_grads`` under the batch layout (the split
    batch: each rank its block, the gradients summed over ``data``; the
    declined one replicated); then one ``remat="full"`` step whose
    backward runs on a thread of its own (where this thread's sharding
    rules are not installed, as on the card's autograd device thread)."""
    import dataclasses
    import threading

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (global_loss, loss_and_grads,
                                          sum_batch_grads)
    from repro_torch.models import api
    from repro_torch.nn import plan_context
    from repro_torch.plan import execution_log, load_plan, reset_execution_log
    from repro_torch.plan.sharded import (BWD_COLLECTIVES, COLLECTIVES,
                                          reset_collectives)
    from repro_torch.sharding import use_rules
    from repro_torch.tree import leaves, map_tree

    cfg = get_config("tt-lm-100m", smoke=True)
    out = {}

    def step(cfg, plan_file, key, threaded=False):
        params = torch.load(spec["params"], weights_only=False)
        for p in leaves(params):
            p.requires_grad_(True)
        rules = _model_rules(cfg, key, spec["reduce"])
        batch = rank_block({k: torch.from_numpy(v) for k, v in
                            _model_batch(cfg, key).items()}, rules)
        reset_execution_log()
        reset_collectives()
        with plan_context(load_plan(str(PLANS / plan_file))), use_rules(rules):
            m = api(cfg, device="cpu")
            if threaded:
                loss = m.train_loss(params, batch)
                t = threading.Thread(target=loss.backward)
                t.start()
                t.join(SPAWN_TIMEOUT_S)
                assert not t.is_alive()
                loss = global_loss(loss)
                grads = sum_batch_grads(map_tree(lambda p: p.grad, params))
            else:
                loss, grads = loss_and_grads(m, params, batch)
        return {"loss": float(loss), "grads": named_leaves(grads),
                "rows": int(batch["tokens"].shape[0]),
                "records": [dict(r) for r in execution_log()],
                "collectives": dict(COLLECTIVES),
                "bwd_collectives": dict(BWD_COLLECTIVES)}

    for plan_file in TRAIN_PLANS:
        for key in MODEL_BATCHES:
            out[f"{plan_file}:{key}"] = step(cfg, plan_file, key)
    out["remat"] = step(dataclasses.replace(cfg, remat="full"), TRAIN_PLANS[0],
                        "split", threaded=True)
    return out


def named_leaves(tree) -> dict:
    """``{key path: leaf}`` of a tree of tensors (lists by index), cloned."""
    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: v for key in t for k, v in walk(t[key], f"{prefix}/{key}").items()}
        if isinstance(t, list):
            return {k: v for i, x in enumerate(t)
                    for k, v in walk(x, f"{prefix}[{i}]").items()}
        return {prefix: t.detach().clone()}
    return walk(tree, "")


def adamw_tree(seed: int) -> dict:
    """A parameter tree with leaves ``param_shardings`` splits on every
    test mesh (a layer list included) and leaves it replicates."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (512, 160), "blocks": [{"w": (256, 384), "b": (384,)},
                                              {"w": (256, 384), "b": (384,)}],
              "cube": (8, 16, 8, 72), "norm": (64, 64)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, list):
            return [make(v) for v in s]
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return make(shapes)


def body_train_adamw(spec: dict) -> dict:
    """Three AdamW steps with the state split by ``param_shardings`` against
    the same steps unsplit, on this rank: parameters and the moments'
    blocks, bit for bit."""
    from repro_torch.launch.mesh import ParamShards, make_test_mesh
    from repro_torch.optim import adamw_init, adamw_update, linear_warmup_cosine
    from repro_torch.tree import leaves

    mesh = make_test_mesh()
    split, whole = adamw_tree(0), adamw_tree(0)
    shards = ParamShards(split, mesh)
    s_opt, w_opt = adamw_init(split, shards), adamw_init(whole)
    lr = linear_warmup_cosine(1e-2, 2, 10)
    for k in range(3):
        grads = adamw_tree(10 + k)
        split, s_opt = adamw_update(grads, s_opt, split, lr, shards=shards)
        whole, w_opt = adamw_update(grads, w_opt, whole, lr)
    return {
        "params_equal": [torch.equal(a, b) for a, b in zip(leaves(split), leaves(whole))],
        "moments_equal": [
            torch.equal(m, shards.block(i, wm)) and torch.equal(v, shards.block(i, wv))
            for i, (m, v, wm, wv) in enumerate(zip(
                leaves(s_opt.m), leaves(s_opt.v), leaves(w_opt.m), leaves(w_opt.v)))],
        "moment_shapes": [tuple(m.shape) for m in leaves(s_opt.m)],
        "param_shapes": [tuple(p.shape) for p in leaves(whole)],
        "specs": list(shards.specs), "coords": dict(mesh.coords)}


def body_train_cli(spec: dict) -> dict:
    """``launch.train.run`` on the ranks (the group is already up): each
    run of ``spec["runs"]``, in order, with rank 0's report."""
    from repro_torch.launch import train

    out = {}
    for label, argv in spec["runs"]:
        with contextlib.redirect_stdout(io.StringIO()) as text:
            run = train.run(argv, tt_model_reduce=spec["reduce"])
        out[label] = {"code": run.code, "losses": run.losses,
                      "grad_norms": run.grad_norms, "done": run.done,
                      "collectives": run.collectives, "stdout": text.getvalue()}
    return out


def smoke_step0(plan_file: str, device, rules=None) -> dict:
    """tt-lm-smoke's step 0 (seed-0 weights, the split batch) on ``device``
    under ``plan_file`` and ``rules`` (this rank's block of the batch where
    their layout splits it) through the train step's ``loss_and_grads``:
    the loss, every gradient leaf (on the CPU), the kernel launches and
    the planned records' meshes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import api
    from repro_torch.nn import plan_context
    from repro_torch.plan import execution_log, load_plan, reset_execution_log
    from repro_torch.sharding import use_rules
    from repro_torch.tree import leaves

    cfg = get_config("tt-lm-100m", smoke=True)
    batch = {k: torch.from_numpy(v) for k, v in _model_batch(cfg, "split").items()}
    if rules is not None:
        batch = rank_block(batch, rules)
    batch = {k: v.to(device) for k, v in batch.items()}
    with plan_context(load_plan(str(PLANS / plan_file))), use_rules(rules):
        m = api(cfg, device=device)
        params = m.init_params(0)
        for p in leaves(params):
            p.requires_grad_(True)
        reset_execution_log()
        launches.reset()
        loss, grads = loss_and_grads(m, params, batch)
    return {"loss": loss.item(),
            "grads": {k: g.cpu() for k, g in named_leaves(grads).items()},
            "launches": launches.snapshot(),
            "meshes": sorted({r["mesh"] for r in execution_log()
                              if r["backend"] != "jnp"})}


def body_cuda_train(spec: dict) -> dict:
    """:func:`smoke_step0` on the card the ranks share, under each smoke
    train plan and the ranks' rules (the batch of 2 split: a sequence a
    rank; on 4 ranks the model axis splits the heads, d_ff and the vocab,
    with ``tt_model_reduce`` as ``spec["reduce"]`` says)."""
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                          % torch.cuda.device_count())
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config

    cfg = get_config("tt-lm-100m", smoke=True)
    return {f: smoke_step0(f, device, _model_rules(cfg, "split", spec.get("reduce", False)))
            for f in TRAIN_PLANS}


# ---------------------------------------------------------------------------
# the batch layout: serving lanes, the MoE's global statistics, recurrent
# states
# ---------------------------------------------------------------------------

#: the two prompts the lanes body admits (8 tokens each, no bucket padding)
LANE_PROMPTS_SEED, LANE_PROMPT_LEN, LANE_MAX_SEQ = 3, 8, 16


def lane_prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(LANE_PROMPTS_SEED).integers(
        0, vocab, size=(2, LANE_PROMPT_LEN))


def body_lanes(spec: dict) -> dict:
    """A 2-lane ``ServeEngine`` of tt-lm-smoke under the smoke pair on the
    saved weights: two prompts prefilled (batch 1: replicated) and
    admitted, then one decode step on this rank's lanes.  The whole
    ``(2, V)`` logits, the greedy first tokens, the rank's lanes and
    cache rows, and the decode step's collectives."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.plan import load_plan
    from repro_torch.plan.sharded import COLLECTIVES, reset_collectives
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding import use_rules

    cfg = get_config("tt-lm-100m", smoke=True)
    rules = dataclasses.replace(
        make_rules(cfg, ShapeConfig("t", LANE_MAX_SEQ, 2, "decode"), make_test_mesh()),
        tt_model_reduce=spec["reduce"])
    params = torch.load(spec["params"], weights_only=False)
    with use_rules(rules), torch.no_grad():
        eng = ServeEngine(cfg, params, n_slots=2, max_seq=LANE_MAX_SEQ,
                          prompt_bucket=8, prefill_plan=load_plan(spec["prefill_plan"]),
                          decode_plan=load_plan(spec["decode_plan"]))
        caches = eng.fresh_caches()
        first = []
        for lane, prompt in enumerate(lane_prompts(cfg.vocab)):
            row, small = eng.prefill_request(prompt.tolist())
            caches = eng.admit(caches, small, lane)
            first.append(int(np.argmax(row)))
        reset_collectives()
        logits, caches = eng.decode(np.array(first), np.full(2, LANE_PROMPT_LEN),
                                    caches)
    return {"logits": torch.from_numpy(logits), "first": first, "lanes": eng.lanes,
            "cache_rows": int(caches[0].k.shape[0]), "collectives": dict(COLLECTIVES)}


#: the MoE layer of the moe body: (B, S) tokens and the router groups of
#: each case: 4 (a rank's 8 tokens hold two whole groups), 16 (one group
#: straddles the ranks) and 6 (groups straddle, the last one padded)
MOE_BATCH = (4, 4)
MOE_GROUPS = {"inside": 4, "straddle": 16, "padded": 6}


def moe_spec(router_group: int):
    from repro_torch.nn.moe import MoESpec

    return MoESpec(name="moe", d_model=16, d_ff=8, n_experts=4, top_k=2,
                   n_shared=1, shared_d_ff=16, router_group=router_group)


def moe_inputs():
    """numpy ``x (B, S, 16)`` and the output weights ``w`` of
    ``loss = sum(y * w) + aux``."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal(MOE_BATCH + (16,)).astype(np.float32)
    return x, rng.standard_normal(MOE_BATCH + (16,)).astype(np.float32)


def body_moe(spec: dict) -> dict:
    """``moe_apply`` on this rank's block of the batch (``batch_split``) in
    each router-group case of :data:`MOE_GROUPS`, on the weights saved at
    ``spec["moe_params"]``: the output and the aux loss gathered and
    summed as the train step does, and the gradients of ``sum(y w) +
    aux`` (dx gathered, every parameter's summed over ``data``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.nn.moe import moe_apply
    from repro_torch.plan.sharded import COLLECTIVES, reset_collectives
    from repro_torch.sharding import ShardingRules, use_rules
    from repro_torch.tree import leaves, map_tree

    mesh = make_test_mesh()
    rules = ShardingRules(axis_sizes=dict(mesh.shape), mesh=mesh, batch_split=True)
    group, index = mesh.group(("data",)), mesh.index(("data",))
    x, w = moe_inputs()
    rows = slice(2 * index, 2 * index + 2)
    out = {}
    for case, g in MOE_GROUPS.items():
        params = torch.load(spec["moe_params"], weights_only=False)
        for p in leaves(params):
            p.requires_grad_(True)
        xs = torch.from_numpy(x[rows]).requires_grad_(True)
        reset_collectives()
        with use_rules(rules):
            y, aux = moe_apply(moe_spec(g), params, xs)
            loss = (y * torch.from_numpy(w[rows])).sum() + aux / 2
        loss.backward()
        coll = dict(COLLECTIVES)
        grads = map_tree(lambda p: p.grad, params)
        for t in leaves(grads):
            dist.all_reduce(t, group=group)
        parts = [torch.empty_like(y) for _ in range(2)]
        dist.all_gather(parts, y.detach().contiguous(), group=group)
        dxs = [torch.empty_like(xs.grad) for _ in range(2)]
        dist.all_gather(dxs, xs.grad, group=group)
        total = loss.detach().clone()
        dist.all_reduce(total, group=group)
        out[case] = {"y": torch.cat(parts), "aux": float(aux), "loss": float(total),
                     "dx": torch.cat(dxs), "grads": named_leaves(grads),
                     "collectives": coll}
    return out


#: the sharded routes of the experts' batched projections in the
#: moe_batched body, on 2 ranks: (mesh shape (data, model), the rules'
#: options).  ``rows``: the batch whole on every rank, each projection's
#: rows split over ``data``; ``batch``: each rank its block of the batch
#: (``batch_split``); ``reduce``: the leading input mode split over
#: ``model`` and the partial outputs summed; ``seq``: each rank its block
#: of the positions (``seq_split`` on ``model``)
MOE_ROUTES = {"rows": ((2, 1), {}),
              "batch": ((2, 1), {"batch_split": True}),
              "reduce": ((1, 2), {"tt_model_reduce": True}),
              "seq": ((1, 2), {"seq_axis": "model", "seq_split": True})}


def body_moe_batched(spec: dict) -> dict:
    """The MoE layer of ``spec["arch"]``'s smoke config (tensorized
    experts, weights at ``spec["params"]``) under the K1 train plan
    ``spec["plan"]``, on each route of :data:`MOE_ROUTES` and each input
    case of ``spec["cases"]`` (``{case: (B, S, router_group,
    capacity_factor)}``; ``x (B, S, D)`` and ``w`` made with numpy from
    the seeds 70 and 71): the output gathered whole, the aux loss, dx
    gathered and every parameter's gradient of ``sum(y w) + aux`` (summed
    over the ranks whose losses are shares of one loss), the collectives
    of the forward and of the backward, the same of the shared experts'
    FFN alone on the same rows (the rest is the routed experts' and the
    routing's), and the ``moe.*`` execution records."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models import blocks
    from repro_torch.nn import install_plan
    from repro_torch.nn.mlp import mlp_apply
    from repro_torch.nn.moe import moe_apply
    from repro_torch.plan import execution_log, load_plan, reset_execution_log
    from repro_torch.plan.sharded import (BWD_COLLECTIVES, COLLECTIVES,
                                          reset_collectives)
    from repro_torch.sharding import ShardingRules, use_rules
    from repro_torch.tree import leaves, map_tree

    cfg = get_config(spec["arch"], smoke=True)
    base = blocks.moe_spec(cfg)
    install_plan(load_plan(spec["plan"]))
    out = {}
    try:
        for route, (shape, options) in MOE_ROUTES.items():
            mesh = _mesh(shape, ("data", "model"))
            rules = ShardingRules(axis_sizes=dict(mesh.shape), mesh=mesh, **options)
            # the dim a rank holds its block of and its axis (None: the
            # whole input on every rank)
            dim, axis = {"batch": (0, "data"), "seq": (1, "model")}.get(
                route, (None, None))
            if axis is not None:
                group, index = mesh.group((axis,)), mesh.coords[axis]
            for case, (b, s, router_group, cf) in spec["cases"].items():
                moe = dataclasses.replace(base, router_group=router_group,
                                          capacity_factor=cf)
                x, w = (torch.from_numpy(np.random.default_rng(seed).normal(
                    size=(b, s, cfg.d_model)).astype(np.float32)) for seed in (70, 71))
                if dim is not None:
                    size = x.shape[dim] // 2
                    x, w = (t.narrow(dim, index * size, size).contiguous()
                            for t in (x, w))
                params = torch.load(spec["params"], weights_only=False)
                for p in leaves(params):
                    p.requires_grad_(True)
                xs = x.requires_grad_(True)
                reset_collectives()
                reset_execution_log()
                with use_rules(rules):
                    y, aux = moe_apply(moe, params, xs)
                    fwd = dict(COLLECTIVES)
                    shares = 1 if dim is None else 2
                    ((y * w).sum() + aux / shares).backward()
                bwd = dict(BWD_COLLECTIVES)
                records = [(r["name"], r["phase"], r.get("wrt"), r["tokens"],
                            r["mesh"]) for r in execution_log()
                           if r["name"].startswith("moe.")]
                shared = torch.load(spec["params"], weights_only=False)["shared"]
                for p in leaves(shared):
                    p.requires_grad_(True)
                reset_collectives()
                with use_rules(rules):
                    ys = mlp_apply(moe.shared_spec, shared,
                                   x.detach().requires_grad_(True))
                    shared_fwd = dict(COLLECTIVES)
                    (ys * w).sum().backward()
                grads = map_tree(lambda p: p.grad, params)
                dx, y = xs.grad, y.detach()
                if dim is not None:
                    for t in leaves(grads):
                        dist.all_reduce(t, group=group)
                    parts = [[torch.empty_like(t) for _ in range(2)] for t in (y, dx)]
                    dist.all_gather(parts[0], y.contiguous(), group=group)
                    dist.all_gather(parts[1], dx.contiguous(), group=group)
                    y, dx = (torch.cat(p, dim) for p in parts)
                out[(route, case)] = {
                    "y": y, "aux": float(aux), "dx": dx,
                    "grads": named_leaves(grads), "fwd": fwd, "bwd": bwd,
                    "shared": {"fwd": shared_fwd, "bwd": dict(BWD_COLLECTIVES)},
                    "records": records}
    finally:
        install_plan(None)
    return out


#: rwkv6-smoke's batch in the rwkv body: 2 sequences of 8 tokens
RWKV_BATCH = (2, 8)


def rwkv_tokens(vocab: int) -> dict:
    rng = np.random.default_rng(23)
    return {k: rng.integers(0, vocab, size=RWKV_BATCH).astype(np.int64)
            for k in ("tokens", "labels", "next")}


def body_rwkv(spec: dict) -> dict:
    """rwkv6-smoke (no plan) under the batch layout of 2 sequences on the
    weights saved at ``spec["rwkv_params"]``: the train step's loss and
    gradients (``loss_and_grads``), and a prefill of the rank's block then
    one decode step: the logits and every recurrent state gathered back
    over ``data`` (``LayoutBlocks.gather``), and the rank's state rows."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (LayoutBlocks, batch_layout, cache_shardings,
                                         make_rules, make_test_mesh)
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import api
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding import use_rules
    from repro_torch.tree import leaves

    cfg = get_config("rwkv6-7b", smoke=True)
    b, s = RWKV_BATCH
    rules = batch_layout(make_rules(cfg, ShapeConfig("t", s, b, "train"),
                                    make_test_mesh()), b)
    data = {k: torch.from_numpy(v) for k, v in rwkv_tokens(cfg.vocab).items()}
    local = rank_block(data, rules)
    m = api(cfg, device="cpu")
    params = torch.load(spec["rwkv_params"], weights_only=False)
    for p in leaves(params):
        p.requires_grad_(True)
    with use_rules(rules):
        loss, grads = loss_and_grads(m, params, {k: local[k] for k in ("tokens", "labels")})
        with torch.no_grad():
            logits, caches = m.prefill_full(params, {"tokens": local["tokens"]}, s + 1)
            step, caches = m.decode_step(params, local["next"][:, :1], caches,
                                         torch.tensor(s))
        whole = api(cfg, device="meta").init_caches(b, s + 1)
        blocks = LayoutBlocks(cache_shardings(cfg, whole, rules), rules)
        states = blocks.gather(caches)
        gathered = LayoutBlocks(((rules.batch_axes, None),), rules).gather(
            (torch.cat([logits[:, -1], step], dim=1),))[0]
    return {"loss": float(loss), "grads": named_leaves(grads),
            "batch_split": rules.batch_split,
            "state_rows": [int(t.shape[0]) for t in leaves(caches)],
            "states": [t.clone() for t in leaves(states)],
            "logits": gathered}


# ---------------------------------------------------------------------------
# the model axis: heads, KV cache, d_ff and vocab split over ``model``
# ---------------------------------------------------------------------------

#: tt-lm-smoke's overrides of each head layout on ``model=2``: kv_major (1
#: of 2 kv heads a rank), q_block (1 kv head: 2 of 4 query heads a rank)
#: and whole (one head)
MODEL_AXIS_CONFIGS = {"kv_major": {}, "q_block": {"n_kv_heads": 1},
                      "whole": {"n_heads": 1, "n_kv_heads": 1, "head_dim": 256}}
#: (head layout, pair, tt_model_reduce) of each case
MODEL_AXIS_CASES = tuple(("kv_major", pair, reduce) for pair in ("auto", "tt_gemm")
                         for reduce in (False, True)) + (
    ("q_block", "auto", True), ("whole", "auto", True))
#: the serving plan (prefill and decode) and the train plan of each pair
MODEL_AXIS_PLANS = {"auto": ("tt-lm-smoke.json", TRAIN_PLANS[0]),
                    "tt_gemm": ("tt-lm-smoke.tt_gemm.json", TRAIN_PLANS[1])}
#: the families whose one forward runs on the model axis: (B, S) tokens and,
#: for the encoder-decoder, its frames
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "zamba2-1.2b", "rwkv6-7b", "seamless-m4t-medium")
FAMILY_BATCH, FAMILY_FRAMES = (2, 8), 12


def model_axis_cfg(label: str):
    from repro_torch.configs import get_config

    return get_config("tt-lm-100m", smoke=True).with_(**MODEL_AXIS_CONFIGS[label])


def family_inputs(cfg) -> dict:
    rng = np.random.default_rng(31)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, size=FAMILY_BATCH))}
    if cfg.family == "encdec":
        batch["frontend"] = torch.from_numpy(rng.standard_normal(
            (FAMILY_BATCH[0], FAMILY_FRAMES, cfg.d_model)).astype(np.float32))
    return batch


def family_logits(arch: str, params: dict) -> torch.Tensor:
    """One forward of ``arch``'s smoke config on ``params`` (no plan, the
    batch replicated) under the installed rules: the prefill's logits,
    the vocab whole (every position for the causal LMs, the last for the
    encoder-decoder)."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.lm import whole_logits

    cfg = get_config(arch, smoke=True)
    m = api(cfg, device="cpu")
    with torch.no_grad():
        if cfg.family == "encdec":
            logits, _ = m.prefill(params, family_inputs(cfg), FAMILY_BATCH[1])
        else:
            logits, _ = m.prefill_full(params, family_inputs(cfg), FAMILY_BATCH[1])
        return whole_logits(logits, cfg.vocab)


def body_model_axis(spec: dict) -> dict:
    """Each case of :data:`MODEL_AXIS_CASES` on the weights saved at
    ``spec["params"][layout]``: a 2-lane ``ServeEngine`` (two prompts
    prefilled at batch 1 and admitted, one decode step of this rank's lane;
    the whole logits, the first tokens, the rank's cache leaf shapes and
    the step's collectives), then step 0 of training on the split batch
    through ``loss_and_grads`` (loss, every gradient leaf, the step's
    collectives).  Then one forward of each of :data:`FAMILY_ARCHS` on the
    weights saved at ``spec["params"][arch]``."""
    import dataclasses

    from repro_torch.launch.mesh import batch_layout, make_rules, make_test_mesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import api
    from repro_torch.models.config import ShapeConfig
    from repro_torch.nn import plan_context
    from repro_torch.plan import load_plan
    from repro_torch.plan.sharded import (BWD_COLLECTIVES, COLLECTIVES,
                                          reset_collectives)
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding import use_rules
    from repro_torch.tree import leaves

    mesh = make_test_mesh()
    out = {"coords": dict(mesh.coords), "cases": {}, "families": {}}
    for label, pair, reduce in MODEL_AXIS_CASES:
        cfg = model_axis_cfg(label)
        serve_plan, train_plan = (load_plan(str(PLANS / f))
                                  for f in MODEL_AXIS_PLANS[pair])
        params = torch.load(spec["params"][label], weights_only=False)
        rules = dataclasses.replace(make_rules(
            cfg, ShapeConfig("t", LANE_MAX_SEQ, 2, "decode"), mesh),
            tt_model_reduce=reduce)
        case = {}
        with use_rules(rules), torch.no_grad():
            eng = ServeEngine(cfg, params, n_slots=2, max_seq=LANE_MAX_SEQ,
                              prompt_bucket=8, prefill_plan=serve_plan,
                              decode_plan=serve_plan)
            caches = eng.fresh_caches()
            rows, first = [], []
            for lane, prompt in enumerate(lane_prompts(cfg.vocab)):
                row, small = eng.prefill_request(prompt.tolist())
                caches = eng.admit(caches, small, lane)
                rows.append(torch.from_numpy(row))
                first.append(int(np.argmax(row)))
            reset_collectives()
            step, caches = eng.decode(np.array(first), np.full(2, LANE_PROMPT_LEN),
                                      caches)
            case["decode_collectives"] = dict(COLLECTIVES)
        case.update(prefill=torch.stack(rows), first=first,
                    decode=torch.from_numpy(step),
                    cache_shapes=[tuple(t.shape) for t in leaves(caches)])
        rules = batch_layout(dataclasses.replace(make_rules(
            cfg, ShapeConfig("t", 16, 2, "train"), mesh), tt_model_reduce=reduce), 2)
        batch = rank_block({k: torch.from_numpy(v) for k, v in
                            _model_batch(cfg, "split").items()}, rules)
        for p in leaves(params):
            p.requires_grad_(True)
        reset_collectives()
        with plan_context(train_plan), use_rules(rules):
            loss, grads = loss_and_grads(api(cfg, device="cpu"), params, batch)
        bwd = dict(BWD_COLLECTIVES)
        case.update(loss=float(loss), grads=named_leaves(grads), train_collectives={
            "fwd": {k: v - bwd[k] for k, v in COLLECTIVES.items()}, "bwd": bwd})
        out["cases"][f"{label}:{pair}:{reduce}"] = case
    for arch in FAMILY_ARCHS:
        from repro_torch.configs import get_config

        cfg = get_config(arch, smoke=True)
        with use_rules(make_rules(cfg, ShapeConfig("t", FAMILY_BATCH[1], FAMILY_BATCH[0],
                                                   "prefill"), mesh)):
            out["families"][arch] = family_logits(
                arch, torch.load(spec["params"][arch], weights_only=False))
    return out


# ---------------------------------------------------------------------------
# the model axis of the SSM and WKV heads, their states and the
# encoder-decoder's own sites
# ---------------------------------------------------------------------------

#: the families whose heads, states and cross-attention split over
#: ``model``: each under its smoke K1 plans (serving pair and train plan,
#: forced to streaming_tt) with ``tt_model_reduce``, and under no plan
#: without it (every projection gathers its column block)
STATE_ARCHS = ("zamba2-1.2b", "rwkv6-7b", "seamless-m4t-medium")
STATE_CASES = tuple((arch, plans, plans == "k1") for arch in STATE_ARCHS
                    for plans in ("k1", "none"))


def state_batch(cfg, key: str = "split") -> dict:
    """:func:`_model_batch`, with seeded frames for the encoder-decoder."""
    batch = _model_batch(cfg, key)
    if cfg.family == "encdec":
        batch["frontend"] = np.random.default_rng(37).standard_normal(
            (batch["tokens"].shape[0], FAMILY_FRAMES, cfg.d_model)).astype(np.float32)
    return batch


def lane_frames(cfg) -> np.ndarray:
    """The encoder-decoder's frames of the two lane prompts."""
    return np.random.default_rng(41).standard_normal(
        (2, FAMILY_FRAMES, cfg.d_model)).astype(np.float32)


def _encdec_lanes(cfg, params, rules, pre, dec) -> tuple:
    """The two lane prompts (and :func:`lane_frames`) through the step
    builders under ``rules`` (each data rank its lane): the whole-vocab
    prefill logits and greedy first tokens of both lanes, one decode step's
    logits of both lanes, the rank's caches and the decode step's
    collectives."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.nn import plan_context
    from repro_torch.plan.sharded import (COLLECTIVES, batch_axes_split, collective,
                                          reset_collectives)

    batch = rank_block({"tokens": torch.from_numpy(lane_prompts(cfg.vocab)),
                        "frontend": torch.from_numpy(lane_frames(cfg))}, rules)
    group = batch_axes_split(rules)[0]
    with plan_context(pre):
        rows, caches = make_prefill_step(cfg, LANE_MAX_SEQ)(params, batch)
    rows = collective("all_gather", rows, group)
    first = rows.argmax(dim=-1)
    index = rules.mesh.index(rules.batch_axes)
    reset_collectives()
    with plan_context(dec):
        step, caches = make_decode_step(cfg)(
            params, first[index:index + 1, None], caches, torch.tensor(LANE_PROMPT_LEN))
        coll = dict(COLLECTIVES)
    step = collective("all_gather", step, group)
    return rows, [int(t) for t in first], step, caches, coll


def body_model_axis_states(spec: dict) -> dict:
    """Each case of :data:`STATE_CASES` on the weights saved at
    ``spec["params"][arch]`` and the plans at ``spec["plans"][arch]``:
    two lanes served (zamba2 and rwkv6 through a 2-lane ``ServeEngine``,
    as :func:`body_model_axis`; seamless through the step builders, a
    lane a data rank), with the whole prefill and decode logits, the
    first tokens, the rank's cache leaf shapes and the decode step's
    collectives; then step 0 of training on the split batch through
    ``loss_and_grads`` (loss, every gradient leaf, the step's
    collectives)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import batch_layout, make_rules, make_test_mesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import api
    from repro_torch.models.config import ShapeConfig
    from repro_torch.nn import plan_context
    from repro_torch.plan import load_plan
    from repro_torch.plan.sharded import (BWD_COLLECTIVES, COLLECTIVES,
                                          reset_collectives)
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding import use_rules
    from repro_torch.tree import leaves

    mesh = make_test_mesh()
    out = {"coords": dict(mesh.coords), "cases": {}}
    for arch, plans, reduce in STATE_CASES:
        cfg = get_config(arch, smoke=True)
        pre, dec, train = ((load_plan(spec["plans"][arch][k])
                            for k in ("prefill", "decode", "train"))
                           if plans == "k1" else (None, None, None))
        params = torch.load(spec["params"][arch], weights_only=False)
        rules = batch_layout(dataclasses.replace(make_rules(
            cfg, ShapeConfig("t", LANE_MAX_SEQ, 2, "decode"), mesh),
            tt_model_reduce=reduce), 2)
        case = {}
        with use_rules(rules), torch.no_grad():
            if cfg.family == "encdec":
                rows, first, step, caches, coll = _encdec_lanes(cfg, params, rules,
                                                                pre, dec)
            else:
                eng = ServeEngine(cfg, params, n_slots=2, max_seq=LANE_MAX_SEQ,
                                  prompt_bucket=8, prefill_plan=pre, decode_plan=dec)
                caches = eng.fresh_caches()
                rows, first = [], []
                for lane, prompt in enumerate(lane_prompts(cfg.vocab)):
                    row, small = eng.prefill_request(prompt.tolist())
                    caches = eng.admit(caches, small, lane)
                    rows.append(torch.from_numpy(row))
                    first.append(int(np.argmax(row)))
                rows = torch.stack(rows)
                reset_collectives()
                step, caches = eng.decode(np.array(first),
                                          np.full(2, LANE_PROMPT_LEN), caches)
                coll = dict(COLLECTIVES)
                step = torch.from_numpy(step)
        case.update(prefill=rows.float(), first=first, decode=step.float(),
                    decode_collectives=coll,
                    cache_shapes=[tuple(t.shape) for t in leaves(caches)])
        rules = batch_layout(dataclasses.replace(make_rules(
            cfg, ShapeConfig("t", 16, 2, "train"), mesh), tt_model_reduce=reduce), 2)
        batch = rank_block({k: torch.from_numpy(v) for k, v in
                            state_batch(cfg).items()}, rules)
        for p in leaves(params):
            p.requires_grad_(True)
        reset_collectives()
        with plan_context(train), use_rules(rules):
            loss, grads = loss_and_grads(api(cfg, device="cpu"), params, batch)
        bwd = dict(BWD_COLLECTIVES)
        case.update(loss=float(loss), grads=named_leaves(grads), train_collectives={
            "fwd": {k: v - bwd[k] for k, v in COLLECTIVES.items()}, "bwd": bwd})
        out["cases"][f"{arch}:{plans}:{reduce}"] = case
    return out


# ---------------------------------------------------------------------------
# the SP sequence split on data=1 x model=4
# ---------------------------------------------------------------------------

#: smoke configs of the families SP splits, 2 kv heads each: on ``model=4``
#: ``make_rules`` turns SP on for every train and prefill step
SP_ARCHS = ("chatglm3-6b", "grok-1-314b", "internvl2-2b")
#: rows x text positions of the forward and of step 0 (the VLM's 8-position
#: image prefix first: 24 positions, 6 a rank, so rank 0 holds prefix alone)
SP_BATCH = (2, 16)
#: (positions, lanes) of the decode cell whose policy (``sp_enabled``:
#: over 12 GiB of KV cache a device) splits the smoke configs' caches
SP_DECODE_CELL = (1 << 22, 128)


def sp_mesh():
    """``data=1 x model=4`` over the process group's 4 ranks."""
    from repro_torch.launch.mesh import _mesh

    return _mesh((1, 4), ("data", "model"))


def sp_batch(cfg) -> dict:
    """Tokens and labels (:data:`SP_BATCH`) and a VLM's image prefix."""
    rng = np.random.default_rng(43)
    b, s = SP_BATCH
    batch = {k: rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int64)
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["frontend"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def body_seq_parallel(spec: dict) -> dict:
    """Each of :data:`SP_ARCHS` on ``data=1 x model=4``, on the weights saved
    at ``spec["params"][arch]`` and its K1 plans ``spec["plans"][arch]``:
    the whole prefill logits of :func:`sp_batch` under the prefill plan
    (and the planned records' meshes and shard shapes) and that prefill's
    collectives; step 0 under the train plan through ``loss_and_grads``
    (loss, every gradient leaf, the step's collectives), the dense config's
    also under ``remat="full"``; then two lanes served under the rules of
    :data:`SP_DECODE_CELL` (each lane's KV cache a
    rank's block of the positions; grok without a plan): the prefill
    logits, first tokens, one
    decode step's logits and collectives, and the rank's cache shapes."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import batch_layout, make_rules
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import api
    from repro_torch.models.config import ShapeConfig
    from repro_torch.nn import plan_context
    from repro_torch.plan import execution_log, load_plan, reset_execution_log
    from repro_torch.plan.sharded import (BWD_COLLECTIVES, COLLECTIVES,
                                          reset_collectives)
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding import use_rules
    from repro_torch.tree import leaves

    mesh = sp_mesh()
    out = {"coords": dict(mesh.coords), "cases": {}}
    b, s = SP_BATCH
    for arch in SP_ARCHS:
        cfg = get_config(arch, smoke=True)
        pre, dec, train = (load_plan(spec["plans"][arch][k])
                           for k in ("prefill", "decode", "train"))
        params = torch.load(spec["params"][arch], weights_only=False)
        batch = {k: torch.from_numpy(v) for k, v in sp_batch(cfg).items()}
        m = api(cfg, device="cpu")
        case = {}
        prefix = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
        rules = make_rules(cfg, ShapeConfig("t", s, b, "prefill"), mesh)
        with use_rules(rules), plan_context(pre), torch.no_grad():
            reset_collectives()
            reset_execution_log()
            logits, _ = m.prefill_full(params, {k: v for k, v in batch.items()
                                                if k != "labels"}, s + prefix)
            case["prefill_collectives"] = dict(COLLECTIVES)
            case["records"] = sorted({(r["name"], r["mesh"],
                                       tuple(r["shard_shape"] or ()))
                                      for r in execution_log()})
        case["forward"] = logits
        rules = batch_layout(make_rules(cfg, ShapeConfig("t", s, b, "train"), mesh), b)
        for p in leaves(params):
            p.requires_grad_(True)
        reset_collectives()
        with plan_context(train), use_rules(rules):
            loss, grads = loss_and_grads(m, params, batch)
        bwd = dict(BWD_COLLECTIVES)
        case.update(loss=float(loss), grads=named_leaves(grads), train_collectives={
            "fwd": {k: v - bwd[k] for k, v in COLLECTIVES.items()}, "bwd": bwd})
        if cfg.family == "dense":        # the remat recompute gathers K and V again
            reset_collectives()
            with plan_context(train), use_rules(rules):
                loss, grads = loss_and_grads(api(cfg.with_(remat="full"), device="cpu"),
                                             params, batch)
            bwd = dict(BWD_COLLECTIVES)
            case["remat"] = {"loss": float(loss), "grads": named_leaves(grads),
                             "collectives": {"fwd": {k: v - bwd[k] for k, v
                                                     in COLLECTIVES.items()}, "bwd": bwd}}
        for p in leaves(params):
            p.requires_grad_(False)
        rules = make_rules(cfg, ShapeConfig("t", *SP_DECODE_CELL, "decode"), mesh)
        lanes = None if cfg.family == "moe" else dec
        with use_rules(rules), torch.no_grad():
            eng = ServeEngine(cfg, params, n_slots=2, max_seq=LANE_MAX_SEQ,
                              prompt_bucket=8, prefill_plan=pre, decode_plan=lanes)
            caches = eng.fresh_caches()
            rows, first = [], []
            for lane, prompt in enumerate(lane_prompts(cfg.vocab)):
                row, small = eng.prefill_request(prompt.tolist())
                caches = eng.admit(caches, small, lane)
                rows.append(torch.from_numpy(row))
                first.append(int(np.argmax(row)))
            reset_collectives()
            step, caches = eng.decode(np.array(first), np.full(2, LANE_PROMPT_LEN),
                                      caches)
            case["decode_collectives"] = dict(COLLECTIVES)
        case.update(prefill=torch.stack(rows), first=first,
                    decode=torch.from_numpy(step),
                    cache_shapes=[tuple(t.shape) for t in leaves(caches)])
        out["cases"][arch] = case
    return out


# ---------------------------------------------------------------------------
# the SP sequence split of the hybrid and the encoder-decoder on data=1 x model=4
# ---------------------------------------------------------------------------

#: the hybrid's and the encoder-decoder's smoke configs, under the rules of
#: :func:`sps_rules` (SP on: each rank 4 of the batch's 16 positions and
#: frames, and 2 of a served prompt's 8: fewer than ``d_conv - 1``)
SPS_ARCHS = ("zamba2-1.2b", "seamless-m4t-medium")
#: the encoder-decoder's frames of the forward and of step 0
SPS_FRAMES = 16
#: seamless-smoke with 2 kv heads: served under the same rules, its
#: decode caches hold a rank's block of the positions and of the frames
SPS_KV2 = {"n_kv_heads": 2}
#: seamless-smoke's steps whose frames or tokens alone divide model=4:
#: (frames, tokens)
SPS_MIXED = {"frames": (16, 6), "tokens": (10, 16)}


def sps_rules(mesh, **kw):
    """The reference tests' SP rules (``tests/test_shard_exec.py``): the
    batch over ``data``, the model and the sequence over ``model``."""
    from repro_torch.sharding import ShardingRules

    return ShardingRules(axis_sizes=dict(mesh.shape), batch_axes=("data",),
                         model_axis="model", seq_axis="model", mesh=mesh, **kw)


def sps_batch(cfg, frames: int = SPS_FRAMES, seq: int = SP_BATCH[1]) -> dict:
    """Tokens and labels (:data:`SP_BATCH`'s rows, ``seq`` positions) and the
    encoder-decoder's ``frames`` frames."""
    rng = np.random.default_rng(53)
    b = SP_BATCH[0]
    batch = {k: rng.integers(0, cfg.vocab, size=(b, seq)).astype(np.int64)
             for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["frontend"] = rng.standard_normal(
            (b, frames, cfg.d_model)).astype(np.float32)
    return batch


def _collectives_of(run) -> dict:
    """``run()``'s collectives, forward and backward."""
    from repro_torch.plan.sharded import (BWD_COLLECTIVES, COLLECTIVES,
                                          reset_collectives)

    reset_collectives()
    out = run()
    bwd = dict(BWD_COLLECTIVES)
    return out, {"fwd": {k: v - bwd[k] for k, v in COLLECTIVES.items()}, "bwd": bwd}


def sps_serve(cfg, params, rules, pre, dec) -> dict:
    """The two lane prompts served under ``rules`` (every lane on every
    rank): the hybrid through a 2-lane ``ServeEngine``, the encoder-decoder
    (with :func:`lane_frames`) through the step builders, its decode step
    under the caches' rules (``kv_layout``).  The whole-vocab prefill
    logits and greedy first tokens, one decode step's logits, the first
    prefill's and the decode step's collectives and the rank's cache leaf
    shapes."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.nn import plan_context
    from repro_torch.plan.sharded import COLLECTIVES, reset_collectives
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding import kv_layout, use_rules
    from repro_torch.tree import leaves

    out = {}
    with use_rules(rules), torch.no_grad():
        if cfg.family == "encdec":
            batch = {"tokens": torch.from_numpy(lane_prompts(cfg.vocab)),
                     "frontend": torch.from_numpy(lane_frames(cfg))}
            reset_collectives()
            with plan_context(pre):
                rows, caches = make_prefill_step(cfg, LANE_MAX_SEQ)(params, batch)
            out["prefill_collectives"] = dict(COLLECTIVES)
            first = rows.argmax(dim=-1)
            reset_collectives()
            with plan_context(dec), use_rules(kv_layout(rules, cfg.family,
                                                        cfg.n_kv_heads, LANE_MAX_SEQ)):
                step, caches = make_decode_step(cfg)(
                    params, first[:, None], caches, torch.tensor(LANE_PROMPT_LEN))
            first = [int(t) for t in first]
        else:
            eng = ServeEngine(cfg, params, n_slots=2, max_seq=LANE_MAX_SEQ,
                              prompt_bucket=8, prefill_plan=pre, decode_plan=dec)
            caches = eng.fresh_caches()
            rows, first = [], []
            for lane, prompt in enumerate(lane_prompts(cfg.vocab)):
                reset_collectives()
                row, small = eng.prefill_request(prompt.tolist())
                if lane == 0:
                    out["prefill_collectives"] = dict(COLLECTIVES)
                caches = eng.admit(caches, small, lane)
                rows.append(torch.from_numpy(row))
                first.append(int(np.argmax(row)))
            rows = torch.stack(rows)
            reset_collectives()
            step, caches = eng.decode(np.array(first), np.full(2, LANE_PROMPT_LEN),
                                      caches)
            step = torch.from_numpy(step)
        out.update(decode_collectives=dict(COLLECTIVES), prefill=rows.float(),
                   first=first, decode=step.float(),
                   cache_shapes=[tuple(t.shape) for t in leaves(caches)])
    return out


def body_seq_parallel_states(spec: dict) -> dict:
    """Each of :data:`SPS_ARCHS` on ``data=1 x model=4`` under
    :func:`sps_rules`, on the weights saved at ``spec["params"][arch]`` and
    its K1 plans ``spec["plans"][arch]``: the whole prefill logits of every
    position of :func:`sps_batch` under the prefill plan (the
    encoder-decoder's through ``encdec.prefill_full``) (its records'
    meshes and shard shapes, its collectives); step 0 under the train plan
    through ``loss_and_grads`` (loss, every gradient leaf, collectives),
    and again under ``remat="full"``; two lanes served (:func:`sps_serve`).
    Seamless-smoke's steps of :data:`SPS_MIXED` (one of frames and tokens
    split): step 0 and the last-token prefill logits.  Then
    seamless-smoke with :data:`SPS_KV2` served without a plan on the
    weights at ``spec["params"]["kv2"]``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import batch_layout
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import api, encdec
    from repro_torch.nn import plan_context
    from repro_torch.plan import execution_log, load_plan, reset_execution_log
    from repro_torch.sharding import use_rules
    from repro_torch.tree import leaves

    mesh = sp_mesh()
    out = {"coords": dict(mesh.coords), "cases": {}}
    b, s = SP_BATCH
    rules = batch_layout(sps_rules(mesh), b)
    for arch in SPS_ARCHS:
        cfg = get_config(arch, smoke=True)
        pre, dec, train = (load_plan(spec["plans"][arch][k])
                           for k in ("prefill", "decode", "train"))
        params = torch.load(spec["params"][arch], weights_only=False)
        batch = {k: torch.from_numpy(v) for k, v in sps_batch(cfg).items()}
        case = {}
        with use_rules(rules), plan_context(pre), torch.no_grad():
            reset_execution_log()
            full = (functools.partial(encdec.prefill_full, cfg) if cfg.family == "encdec"
                    else api(cfg, device="cpu").prefill_full)
            (logits, _), case["prefill_collectives"] = _collectives_of(
                lambda: full(params, {k: v for k, v in batch.items() if k != "labels"}, s))
            case["records"] = sorted({(r["name"], r["mesh"], tuple(r["shard_shape"] or ()))
                                      for r in execution_log()})
        case["forward"] = logits
        for p in leaves(params):
            p.requires_grad_(True)
        for key, c in (("step0", cfg), ("remat", cfg.with_(remat="full"))):
            with plan_context(train), use_rules(rules):
                (loss, grads), coll = _collectives_of(
                    lambda: loss_and_grads(api(c, device="cpu"), params, batch))
            case[key] = {"loss": float(loss), "grads": named_leaves(grads),
                         "collectives": coll}
        for p in leaves(params):
            p.requires_grad_(False)
        case["serve"] = sps_serve(cfg, params, rules, pre, dec)
        out["cases"][arch] = case
        if cfg.family != "encdec":
            continue
        for key, (frames, seq) in SPS_MIXED.items():
            batch = {k: torch.from_numpy(v) for k, v in sps_batch(cfg, frames, seq).items()}
            with use_rules(rules), torch.no_grad():
                rows, _ = encdec.prefill(cfg, params, batch, seq)
            for p in leaves(params):
                p.requires_grad_(True)
            with plan_context(train), use_rules(rules):
                loss, grads = loss_and_grads(api(cfg, device="cpu"), params, batch)
            for p in leaves(params):
                p.requires_grad_(False)
            out["cases"][f"mixed-{key}"] = {"prefill": rows, "loss": float(loss),
                                            "grads": named_leaves(grads)}
    cfg = get_config("seamless-m4t-medium", smoke=True).with_(**SPS_KV2)
    out["cases"]["kv2"] = {"serve": sps_serve(
        cfg, torch.load(spec["params"]["kv2"], weights_only=False), rules, None, None)}
    return out


#: chatglm3-6b's K and V on the card's SP path: a rank's 128 of 512
#: positions of 4 sequences, K and V of 2 kv heads each, head dim 128; and
#: its decode step: 16 lanes over 32 768 cache positions, 32 query heads
SP_CUDA_KV = (4, 512, 4, 128)
SP_CUDA_DECODE = (16, 32_768, 32, 2, 128)


def sp_cuda_inputs(device) -> dict:
    """The whole tensors of :func:`body_cuda_sp`, from a seed, on ``device``:
    K/V and each rank's upstream gradient of them, a decode step's queries,
    new K/V, whole caches and per-lane positions spread over every rank's
    block of the positions."""
    gen = torch.Generator().manual_seed(47)
    b, n, h, hkv, d = SP_CUDA_DECODE
    out = {"kv": torch.randn(SP_CUDA_KV, generator=gen),
           "grads": torch.randn((4,) + SP_CUDA_KV, generator=gen),
           "q": torch.randn(b, 1, h, d, generator=gen),
           "k": torch.randn(b, 1, hkv, d, generator=gen),
           "v": torch.randn(b, 1, hkv, d, generator=gen),
           "ck": torch.randn(b, n, hkv, d, generator=gen),
           "cv": torch.randn(b, n, hkv, d, generator=gen),
           "pos": (torch.arange(b) * 2048 + 1000) % n}
    return {k: v.to(device) for k, v in out.items()}


def one_device_decode(q, ck, cv, pos) -> torch.Tensor:
    """The single-process decode attention of ``nn/attention.py`` over whole
    caches (already written): masked scores, one softmax, the weighted sum."""
    b, _, h, d = q.shape
    hkv = ck.shape[2]
    kv_pos = torch.arange(ck.shape[1], device=q.device)
    vmask = (kv_pos[None, :] <= pos[:, None])[:, None, None, None, :]
    qg = q.reshape(b, 1, h // hkv, hkv, d)
    scores = torch.einsum("bqghd,bkhd->bghqk", qg.float(), ck.float()) * (1.0 / math.sqrt(d))
    scores = torch.where(vmask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    return torch.einsum("bghqk,bkhd->bqghd", probs, cv).reshape(b, 1, h, d)


def body_cuda_sp(spec: dict) -> dict:
    """On the card the 4 ranks share (``data=1 x model=4``): ``seq_gather``
    of a rank's block of chatglm3-6b's K and V (the whole tensor forward;
    backward, the sum of every rank's gradient of it at the rank's block),
    and a decode step over a rank's block of the cache's positions
    (``nn/attention.py::_decode_blocks``: the lane writes and the ranks'
    softmax combined) against the single-process forms."""
    from repro_torch.nn import attention
    from repro_torch.nn.attention import AttentionSpec, KVCache
    from repro_torch.plan.sharded import seq_axis_split, seq_gather
    from repro_torch.sharding import ShardingRules

    device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                          % torch.cuda.device_count())
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = sp_mesh()
    rules = ShardingRules(axis_sizes=dict(mesh.shape), mesh=mesh, seq_axis="model",
                          seq_split=True)
    split = seq_axis_split(rules)
    r, tp = split[1], split[2]
    x = sp_cuda_inputs(device)
    size = SP_CUDA_KV[1] // tp
    blk = x["kv"][:, r * size:(r + 1) * size].clone().requires_grad_(True)
    whole = seq_gather(blk, 1, split)
    (whole * x["grads"][r]).sum().backward()
    want = x["grads"].sum(dim=0)[:, r * size:(r + 1) * size]
    out = {"gather_equal": torch.equal(whole.detach(), x["kv"]),
           "grad_gap": float((blk.grad - want).abs().max() / want.abs().max())}
    b, n, h, hkv, d = SP_CUDA_DECODE
    lanes = torch.arange(b, device=device)
    ck, cv = x["ck"].clone(), x["cv"].clone()
    ck[lanes, x["pos"]] = x["k"][:, 0]
    cv[lanes, x["pos"]] = x["v"][:, 0]
    ref = one_device_decode(x["q"], ck, cv, x["pos"])
    m = n // tp
    cache = KVCache(x["ck"][:, r * m:(r + 1) * m].clone(),
                    x["cv"][:, r * m:(r + 1) * m].clone())
    spec_ = AttentionSpec("attn", h * d, h, hkv, d)
    got = attention._decode_blocks(spec_, x["q"], x["k"], x["v"], cache, x["pos"],
                                   (split[0], r, tp))
    torch.cuda.synchronize(device)
    out.update(decode_gap=float((got - ref).abs().max()), scale=float(ref.abs().max()),
               writes_equal=torch.equal(cache.k, ck[:, r * m:(r + 1) * m])
               and torch.equal(cache.v, cv[:, r * m:(r + 1) * m]),
               held=int(((x["pos"] >= r * m) & (x["pos"] < (r + 1) * m)).sum()))
    return out


#: zamba2-1.2b's SSD on the card's SP path: 4 sequences of 512 positions
#: (128 a rank), 64 heads of 64, state 64, in chunks of 128; its conv: 4 224
#: channels, ``d_conv`` 4
SPS_CUDA = (4, 512, 64, 64, 64, 128)
SPS_CUDA_CONV = (4224, 4)


def body_cuda_sps(spec: dict) -> dict:
    """On the card the 4 ranks share (``data=1 x model=4``): the Mamba2
    scan's hand-off (``nn/ssm.py::_ssd_handoff``: the rank's block scanned
    from zero, every rank's end state and total decay stacked by
    ``seq_stack``, folded, the entering state's term added) and a conv over
    the rank's block with the halo of the ranks before it
    (``seq_stack`` of the tails, ``conv_halo``), forward and backward,
    against the single-process scan and conv of the whole sequence that
    every rank also runs: the gaps relative to each tensor's scale."""
    from repro_torch.nn import ssm
    from repro_torch.plan.sharded import seq_axis_split, seq_stack
    from repro_torch.sharding import ShardingRules

    device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                          % torch.cuda.device_count())
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = sp_mesh()
    split = seq_axis_split(ShardingRules(axis_sizes=dict(mesh.shape), mesh=mesh,
                                         seq_axis="model", seq_split=True))
    r, tp = split[1], split[2]
    b, s, h, p, n, chunk = SPS_CUDA
    c, k = SPS_CUDA_CONV
    gen = torch.Generator().manual_seed(61)
    x = {"x": torch.randn(b, s, h, p, generator=gen),
         # a block's decay about e^-1: the hand-off carries weight
         "da": -torch.rand(b, s, h, generator=gen) * (8.0 / s),
         "bmat": torch.randn(b, s, n, generator=gen),
         "cmat": torch.randn(b, s, n, generator=gen),
         "u": torch.randn(b, s, c, generator=gen)}
    w, bias = torch.randn(k, c, generator=gen), torch.randn(c, generator=gen)
    gy, gc = torch.randn(b, s, h, p, generator=gen), torch.randn(b, s, c, generator=gen)
    x = {key: v.to(device).requires_grad_(True) for key, v in x.items()}
    w, bias, gy, gc = (t.to(device) for t in (w, bias, gy, gc))
    m = s // tp
    blk = slice(r * m, (r + 1) * m)
    y, end = ssm._ssd_chunked(x["x"], x["da"], x["bmat"], x["cmat"], chunk)
    conv = ssm._causal_conv(x["u"], w, bias)
    ((y * gy).sum() + (conv * gc).sum()).backward()
    xb = {key: v.detach()[:, blk].clone().requires_grad_(True) for key, v in x.items()}
    yb, endb = ssm._ssd_handoff(xb["x"], xb["da"], xb["bmat"], xb["cmat"], chunk, None,
                                split)
    tails = seq_stack(xb["u"][:, m - min(k - 1, m):], split)
    halo = ssm.conv_halo(tails, r, None, k)
    convb = ssm._causal_conv(xb["u"], w, bias, halo)
    ((yb * gy[:, blk]).sum() + (convb * gc[:, blk]).sum()).backward()
    torch.cuda.synchronize(device)

    def gap(got, want):
        return float((got - want).abs().max() / want.abs().max())

    before = x["u"].detach()[:, max(r * m - (k - 1), 0):r * m]
    before = torch.cat([before.new_zeros((b, k - 1 - before.shape[1], c)), before], 1)
    out = {"y": gap(yb, y.detach()[:, blk]), "end": gap(endb, end.detach()),
           "conv": gap(convb, conv.detach()[:, blk]),
           "halo_equal": torch.equal(halo.detach(), before)}
    out.update({f"grad_{key}": gap(xb[key].grad, v.grad[:, blk]) for key, v in x.items()})
    return out


BODIES = {"seq_parallel": body_seq_parallel, "cuda_sps": body_cuda_sps,
          "seq_parallel_states": body_seq_parallel_states, "cuda_sp": body_cuda_sp, "model_axis": body_model_axis, "model_axis_states": body_model_axis_states, "linear": body_linear, "serve": body_serve, "cuda_train": body_cuda_train,
          "train_layers": body_train_layers, "train_model": body_train_model,
          "train_adamw": body_train_adamw, "train_cli": body_train_cli,
          "lanes": body_lanes, "moe": body_moe, "moe_batched": body_moe_batched,
          "rwkv": body_rwkv}
