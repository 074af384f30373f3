"""Dry run: every (arch x shape x mesh) cell's step, shapes only.

Port of ``src/repro/launch/dryrun.py``.  The reference lowers and compiles
each cell with XLA on forced host devices and reads XLA's memory and cost
analyses and the collectives of the HLO.  Here each cell's step from
:mod:`repro_torch.launch.steps` runs on the ``meta`` device (shapes and
dtypes, no storage, no arithmetic), at full width on a CPU host, and the
run itself is measured:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the whole
    step, backward included;
  * bytes: the input and output bytes of every aten op (a dispatch mode;
    views are not counted);
  * memory per rank: the high-water mark of live storage bytes during the
    step, under the port's own layout (below);
  * collectives per rank: what the port sends in the cell (below).

PyTorch runs layers in a Python loop, so the full-depth step is counted
exactly (``scanned_cost``), and ``cost``, which the roofline reads, holds
that count under the reference's keys.  The reference extrapolates
``cost`` from unrolled depth variants because XLA's cost analysis counts
a scanned layer once; the port has no scan to undo and traces no
variants.  :func:`_cost_variants` and :func:`extrapolate` are kept
verbatim as the reference's arithmetic (parity-tested): for the hybrid
they count the shared attention once where the model applies it
``n_layers // attn_every`` times, which the full-depth count does not.

The layout is the port's (``repro_torch.sharding``): every rank holds the
whole parameters; where the cell's global batch divides the batch axes
(``launch/mesh.py::batch_layout``), a rank's step is traced at its block
of the batch, the block ``batch_shardings`` and ``applied_cache_shardings``
give its inputs and caches, as the reference's partitioned step runs it,
and where it does not, at the whole batch (replicated).  Along the model
axis the rank computes its block of the attention heads, the KV cache,
d_ff and the vocab, of the SSM and WKV heads and their states, and of the
encoder-decoder's cross-attention heads and cross K/V cache
(``repro_torch.sharding``: ``head_layout``, ``model_dim``,
``state_heads``), through the same functions as on ranks, their
collectives over the shape-only group; the experts stay whole, as the
reference's ``expert_in`` constraint has them.  Where the policy turns
SP on (``sp_enabled``) a train or prefill cell of any family but RWKV
traces a rank at its block of the positions (``models/lm.py::seq_block``;
the encoder-decoder's frames and tokens: every head, d_ff and the vocab
whole on it, K and V all-gathered, the hybrid's conv tails and SSD end
states and the encoder-decoder's cross K/V too, each gather counted at
its bytes and, in a train step, its backward all-reduce), and
a decode cell whose KV cache takes the ``seq`` entry at its block of the
cache's positions (``sharding.kv_layout``), the blocks' attention
combined by one all-gather a layer.  The SSD scan's C.B scores, which do not depend on
the heads, are computed whole on every rank.  The projections stay whole
too: every rank computes each projection's whole
output, the LM head's all V logits included, and keeps its block, so a
rank's FLOPs count the whole head and only the loss is per vocab block.
So FLOPs, peak and collective bytes are a rank's under the batch and
model layout as the port runs it, not as the reference's column-split
projections would.
The AdamW moments of each leaf
that ``param_shardings`` splits hold only the rank's block.  No plan is
installed, as in the reference's cells, so no planned TT projection runs.
The collectives are the port's, counted at their bytes through
``plan/sharded.py::collective`` on the shape-only mesh: a train step
sums its gradients over the batch axes (one all-reduce a dtype, the
gradients' bytes) and its loss (4 bytes); a model group gathers the
attention output (``kv_major``), the SSM's gated output, the loss's
per-token terms and, in the backward, the gradients of the blocks it
took (``plan/sharded.py``:
``model_block``, ``model_gather``, ``model_copy``); an MoE layer sums its router
statistics, or gathers its input where a router group straddles ranks;
a train step also all-gathers every split leaf back whole after its
AdamW update (``optim/adamw.py`` through ``ParamShards.gather``), counted
at the gathered (output) shape's bytes, as the reference counts.  The
reference's ``collective_bytes`` parses XLA HLO text, which the port
never produces, and has no counterpart.

The mesh has no ranks: a shape-only :class:`~repro_torch.launch.mesh.Mesh`
of the production shape (16 x 16, or 2 x 16 x 16 with ``--multi-pod``),
or with ``--test-mesh`` of ``small_mesh_shape(n)`` over
``REPRO_DRYRUN_DEVICES`` (default 512) ranks.

Results land incrementally in ``results/dryrun/*.json``, with the
reference's keys; re-runs skip existing cells unless ``--force``.

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all            # 16x16
  python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod  # 2x16x16
  REPRO_DRYRUN_DEVICES=8 python -m repro_torch.launch.dryrun --test-mesh ...
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import (
    LayoutBlocks,
    Mesh,
    ParamShards,
    applied_cache_shardings,
    batch_layout,
    batch_shardings,
    make_rules,
    small_mesh_shape,
)
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.models import (SHAPES, api, decode_cache_len, input_specs,
                                shape_applicable)
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import adamw_init
from repro_torch.plan import sharded
from repro_torch.sharding import get_rules, kv_layout, use_rules
from repro_torch.tree import leaves, map_tree

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _jsonable(x):
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return float(x)


# ---------------------------------------------------------------------------
# the mesh, without ranks
# ---------------------------------------------------------------------------

def shape_mesh(multi_pod: bool = False, test_mesh: bool = False) -> Mesh:
    """The cell's mesh as axis sizes only: no process group, coordinates 0."""
    if test_mesh:
        n = int(os.environ.get("REPRO_DRYRUN_DEVICES", "512"))
        shape, axes = small_mesh_shape(n, multi_pod)
    elif multi_pod:
        shape, axes = (2, 16, 16), ("pod", "data", "model")
    else:
        shape, axes = (16, 16), ("data", "model")
    return Mesh(dict(zip(axes, shape)), {a: 0 for a in axes}, {})


class ShapeShards(ParamShards):
    """:class:`ParamShards` on a mesh without ranks: the AdamW moments of a
    split leaf take this rank's block shape, and :meth:`gather` makes the
    whole leaf's empty tensor and counts the all-gather's output bytes."""

    def __init__(self, params: Any, mesh: Mesh):
        super().__init__(params, mesh)
        self.gathered = 0

    def gather(self, i: int, block: torch.Tensor) -> torch.Tensor:
        whole = block.new_empty(self.shapes[i])
        self.gathered += whole.numel() * whole.element_size()
        return whole


# ---------------------------------------------------------------------------
# measuring one step: bytes moved and live storage
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Adds the input and output bytes of every aten op but views, and
    tracks the bytes of live storages: one that a registered tensor (an
    op's output, an argument, a tensor autograd saved) still refers to.
    ``peak`` is their high-water mark."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, int] = {}      # storage -> registered tensors
        self._sizes: dict[int, int] = {}

    def register(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        n = self._refs.get(key, 0)
        if n == 0:
            self._sizes[key] = storage.nbytes()
            self.live += self._sizes[key]
            self.peak = max(self.peak, self.live)
        self._refs[key] = n + 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        n = self._refs[key] - 1
        if n:
            self._refs[key] = n
        else:
            del self._refs[key]
            self.live -= self._sizes.pop(key)

    def saved(self, t):
        """The pack hook: autograd may keep a tensor of its own on a
        storage whose op output has died."""
        if isinstance(t, torch.Tensor):
            self.register(t)
        return t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self.register(t)
        return out


def _storage_sizes(tree) -> dict[int, int]:
    """Storage -> bytes, of the distinct storages of the tensors in ``tree``."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)}


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> dict:
    """Run the cell's step once on ``meta`` tensors and measure it.

    Returns ``{"flops", "bytes", "memory": {...}, "collectives": {...}}``
    per rank: FLOPs and op bytes of the whole step, the reference's memory
    keys and its collective kinds plus ``total``.  Under the installed
    rules the inputs and caches are the rank's block (the batch under
    ``batch_split``, the heads of the KV, SSM, WKV and cross K/V caches),
    and the model axis splits the heads, d_ff and the vocab as on ranks.
    """
    m = api(cfg, device="meta")
    specs = _rank_block(cfg, input_specs(cfg, shape))
    params = m.init_params(0)
    shards = None
    if shape.step == "train":
        for p in leaves(params):
            p.requires_grad_(True)
        shards = ShapeShards(params, mesh)
        step = make_train_step(cfg, shards=shards)
        args = (params, adamw_init(params, shards), specs)
    elif shape.step == "prefill":
        extra = (cfg.n_frontend_tokens or 256) if cfg.family == "vlm" else 0
        step = make_prefill_step(cfg, max_seq=shape.seq_len + extra)
        args = (params, specs)
    elif shape.step == "decode":
        step = make_decode_step(cfg)
        args = (params, specs["token"], specs["caches"], specs["cache_pos"])
    else:
        raise ValueError(shape.step)

    sharded.reset_collectives()
    counter = StepCounter()
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor):
            counter.register(t)
    arg_bytes = counter.live
    flops = FlopCounterMode(display=False)
    with flops, counter, torch.autograd.graph.saved_tensors_hooks(
            counter.saved, lambda t: t):
        out = step(*args)
    in_args = _storage_sizes(args)
    out_bytes = sum(n for k, n in _storage_sizes(out).items() if k not in in_args)
    coll = {k: 0.0 for k in _COLLECTIVES}
    moved = sharded.COLLECTIVE_BYTES
    coll["all-gather"] = float((shards.gathered if shards is not None else 0)
                               + moved["all_gather"])
    coll["all-reduce"] = float(moved["all_reduce"] + moved["grad_all_reduce"])
    coll["total"] = sum(coll[k] for k in _COLLECTIVES)
    return {
        "flops": float(flops.get_total_flops()),
        "bytes": float(counter.bytes),
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(counter.peak - arg_bytes),
            # the port donates no argument to an output: the train step
            # updates parameters and moments in place, in the argument
            # storages, so its outputs beyond them are the two metrics
            "alias_bytes": 0,
            "peak_bytes": int(counter.peak),
        },
        "collectives": coll,
    }


def _rank_block(cfg: ModelConfig, specs: dict) -> dict:
    """This rank's block of a cell's input specs under the installed rules
    (``batch_shardings`` of the inputs under ``batch_split``,
    ``applied_cache_shardings`` of the caches: the batch and the heads
    of the KV, SSM, WKV and cross K/V leaves), each a meta tensor of its
    own; ``specs`` without a mesh."""
    rules = get_rules()
    if rules is None or rules.mesh is None:
        return specs
    specs = dict(specs)
    caches = specs.pop("caches", None)
    out = LayoutBlocks(batch_shardings(specs, rules), rules).block(specs)
    if caches is not None:
        out["caches"] = LayoutBlocks(applied_cache_shardings(cfg, caches, rules),
                                     rules).block(caches)
    return map_tree(lambda t: t.clone(), out)


# ---------------------------------------------------------------------------
# depth-extrapolated cost variants (the reference's, verbatim; run_cell
# counts the full depth and calls neither)
# ---------------------------------------------------------------------------

def _cost_variants(cfg: ModelConfig, shape: ShapeConfig
                   ) -> list[tuple[str, ModelConfig, float]]:
    """(label, unrolled variant, weight) triples; the total cost is the
    weighted sum after solving the per-layer deltas (see extrapolate).

    The reference's variants: unrolled layers, q_chunk = seq, no loss
    chunking.  Exact where the depth variants are homogeneous stacks.  A
    hybrid variant with ``attn_every=0`` is one group of every layer with
    the shared attention once (``models/lm.py::_hybrid_groups``, in both
    packages), so the hybrid's extrapolation counts one shared attention
    where the model applies ``n_layers // attn_every``.
    """
    base = dict(scan_layers=False, q_chunk=max(shape.seq_len, cfg.q_chunk),
                loss_chunk=0)
    if cfg.family == "hybrid":
        g = cfg.attn_every
        return [
            ("m1", cfg.with_(n_layers=1, attn_every=0, **base), 0.0),
            ("m2", cfg.with_(n_layers=2, attn_every=0, **base), 0.0),
            ("g1", cfg.with_(n_layers=g, attn_every=g, **base), 0.0),
        ]
    if cfg.family == "encdec":
        return [
            ("e1d1", cfg.with_(n_layers=1, encoder_layers=1, **base), 0.0),
            ("e2d1", cfg.with_(n_layers=1, encoder_layers=2, **base), 0.0),
            ("e1d2", cfg.with_(n_layers=2, encoder_layers=1, **base), 0.0),
        ]
    return [
        ("l1", cfg.with_(n_layers=1, **base), 0.0),
        ("l2", cfg.with_(n_layers=2, **base), 0.0),
    ]


def extrapolate(cfg: ModelConfig, values: dict[str, float]) -> float:
    """Combine variant costs into the full-depth estimate."""
    if cfg.family == "hybrid":
        mamba = values["m2"] - values["m1"]
        base = values["m1"] - mamba
        g = cfg.attn_every
        attn = values["g1"] - base - g * mamba
        n_groups = cfg.n_layers // g
        return base + cfg.n_layers * mamba + n_groups * attn
    if cfg.family == "encdec":
        enc = values["e2d1"] - values["e1d1"]
        dec = values["e1d2"] - values["e1d1"]
        base = values["e1d1"] - enc - dec
        return base + cfg.encoder_layers * enc + cfg.n_layers * dec
    per = values["l2"] - values["l1"]
    base = values["l1"] - per
    return base + cfg.n_layers * per


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------

def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    tt: bool = True,
    test_mesh: bool = False,
    with_cost: bool = True,
    out_dir: str = RESULTS_DIR,
    force: bool = False,
    smoke: bool = False,
) -> dict:
    mesh_tag = ("test" if test_mesh else "") + ("multipod" if multi_pod else "pod")
    tt_tag = "tt" if tt else "dense"
    cell_id = f"{arch}_{shape_name}_{mesh_tag}_{tt_tag}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_id + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch, tt=tt, smoke=smoke)
    shape = SHAPES[shape_name]
    result: dict[str, Any] = {
        "cell": cell_id, "arch": arch, "shape": shape_name,
        "multi_pod": multi_pod, "tt": tt, "step": shape.step,
    }
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        result["status"] = "skipped"
        result["reason"] = reason
        _write(path, result)
        return result

    mesh = shape_mesh(multi_pod=multi_pod, test_mesh=test_mesh)
    rules = batch_layout(make_rules(cfg, shape, mesh), shape.global_batch)
    if shape.step == "decode":
        rules = kv_layout(rules, cfg.family, cfg.n_kv_heads, decode_cache_len(cfg, shape))
    result["mesh"] = {k: int(v) for k, v in mesh.shape.items()}
    result["n_devices"] = int(math.prod(mesh.shape.values()))
    result["sp_enabled"] = rules.seq_axis is not None

    try:
        t0 = time.time()
        with use_rules(rules):
            full = trace_step(cfg, shape, mesh)
        result["trace_s"] = round(time.time() - t0, 1)   # the reference's compile_s
        result["memory"] = full["memory"]
        result["scanned_cost"] = {"flops": full["flops"], "bytes": full["bytes"]}
        result["scanned_collectives"] = full["collectives"]

        if with_cost and not multi_pod:
            result["cost"] = {
                "flops_per_device": full["flops"],
                "bytes_per_device": full["bytes"],
                "collective_bytes_per_device": full["collectives"]["total"],
            }
        result["status"] = "ok"
    except Exception as e:  # record the failure, keep sweeping
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]

    _write(path, result)
    return result


def _write(path: str, result: dict) -> None:
    with open(path, "w") as f:
        json.dump(_jsonable(result), f, indent=1)


def cell_line(r: dict, seconds: float) -> str:
    """The CLI's line for one cell's result."""
    status = r.get("status")
    extra = ""
    if status == "ok":
        mem = r["memory"]["peak_bytes"] or (
            r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"])
        extra = f"peak={mem/2**30:.2f}GiB"
        if "cost" in r:
            extra += f" flops/dev={r['cost']['flops_per_device']:.3e}"
    elif status == "error":
        extra = r["error"][:120]
    elif status == "skipped":
        extra = r["reason"]
    return f"[{seconds:7.1f}s] {r['cell']:60s} {status:8s} {extra}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dense", action="store_true", help="dense baseline (no TT)")
    ap.add_argument("--test-mesh", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    for arch in archs:
        for shape in shapes:
            t0 = time.time()
            r = run_cell(
                arch, shape,
                multi_pod=args.multi_pod,
                tt=not args.dense,
                test_mesh=args.test_mesh,
                with_cost=not args.no_cost,
                out_dir=args.out_dir,
                force=args.force,
                smoke=args.smoke,
            )
            print(cell_line(r, time.time() - t0), flush=True)


if __name__ == "__main__":
    main()
