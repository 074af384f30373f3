"""``python -m repro_torch.dse`` — end-to-end design-space exploration CLI.

Port of ``src/repro/dse_cli.py`` (NumPy, no JAX): the same parser, flags,
defaults, report keys, exit codes and plan bytes.  Runs the paper's
Algorithm 1 for any named config in ``repro_torch.configs`` (e.g.
``tt-lm-100m``, ``glm4-9b``) or the paper's vision workloads
(``resnet18/cifar10``, ``resnet18/tiny_imagenet``, ``vit_ti4/cifar10``):

    PYTHONPATH=src python -m repro_torch.dse --arch tt-lm-100m
    PYTHONPATH=src python -m repro_torch.dse --arch resnet18/cifar10 --hw tpu_v5e \
        --top-k 8 --objective edp --out report.json
    PYTHONPATH=src python -m repro_torch.dse --arch vit_ti4/cifar10 \
        --hw-search budget --emit-plan plan.json   # joint arch co-search (v3)
    PYTHONPATH=src python -m repro_torch.dse --arch tt-lm-100m \
        --rank-search budget --search guided --emit-plan plan.json   # v4

Pipeline: enumerate the model's tensorized projections as per-layer
tensor networks -> MAC-guided top-K path search (memoised across the
model's repeated layers) -> batched cost-table build
(``repro_torch.core.cost_table``) -> hierarchical global argmin.  Emits a JSON
report (schema documented in the README) with the winning strategy,
per-layer (path, partitioning, dataflow) choices and stage timings;
``examples/dse_explore.py`` and ``benchmarks/table2_dse_choices.py``
consume the same report via ``run_dse``.

``--tune cache|measure`` measures on the card (``repro_torch.tune``;
``--device cpu`` times the plain versions on the CPU).  ``--shards N``
searches the per-rank problems of an N-way token-sharded run
(``repro_torch.plan.sharded``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Optional, Sequence

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import (
    ALL_PARTITIONINGS,
    TensorNetwork,
    build_cost_tables,
    find_topk_paths,
    global_search,
)
from repro_torch.core.cost_table import table_cells as _table_cells
from repro_torch.core.dse import build_cost_table
from repro_torch.hw import ArchSpace, get_target, list_targets
from repro_torch.hw import HW_TARGETS  # noqa: F401  (re-export; registry is repro_torch.hw)
from repro_torch.models.config import ModelConfig
from repro_torch.nn.linear import LinearSpec
from repro_torch.rank import RANK_SEARCH_MODES

OBJECTIVES = ("latency", "edp", "throughput")
MODES = ("infer", "train", "both")
HW_SEARCH_MODES = ("off", "budget")
TUNE_MODES = ("off", "cache", "measure")
SEARCH_MODES = ("exhaustive", "guided")

#: dominant-GEMM shapes measured for the --tune calibration table (per
#: dataflow, at the heuristic tiling; heaviest shapes first)
TUNE_CALIBRATION_SHAPES = 8

#: vision workloads of the paper's Tables 1-4 (model_layers-backed)
VISION_ARCHS = ("resnet18/cifar10", "resnet18/tiny_imagenet", "vit_ti4/cifar10")


# ---------------------------------------------------------------------------
# config -> per-layer DSE problems
# ---------------------------------------------------------------------------

def _block_specs(cfg: ModelConfig) -> list[tuple[LinearSpec, int, float]]:
    """(spec, instance_count, token_scale) for every projection family.

    ``token_scale`` rescales the streamed token count for projections that
    see a fraction of the batch (MoE expert capacity).
    """
    from repro_torch.models.blocks import attn_spec, mlp_spec, moe_spec, ssm_spec, rwkv_spec
    from repro_torch.models.lm import head_spec

    L = cfg.n_layers
    out: list[tuple[LinearSpec, int, float]] = []

    def attn(spec, count):
        out.extend([(spec.q_spec, count, 1.0), (spec.k_spec, count, 1.0),
                    (spec.v_spec, count, 1.0), (spec.o_spec, count, 1.0)])

    def mlp(spec, count, scale=1.0):
        if spec.kind == "swiglu":
            out.append((spec.gate_spec, count, scale))
        out.extend([(spec.up_spec, count, scale), (spec.down_spec, count, scale)])

    if cfg.family in ("dense", "vlm"):
        attn(attn_spec(cfg), L)
        mlp(mlp_spec(cfg), L)
    elif cfg.family == "moe":
        attn(attn_spec(cfg), L)
        ms = moe_spec(cfg)
        # capacity-padded execution (nn/moe.py): ALL experts run, each on
        # its capacity slice of ~ top_k * cf / E of the token stream
        cap = ms.top_k * cfg.capacity_factor / max(ms.n_experts, 1)
        if ms.kind == "swiglu":
            out.append((ms.expert_gate, L * ms.n_experts, cap))
        out.extend([(ms.expert_up, L * ms.n_experts, cap),
                    (ms.expert_down, L * ms.n_experts, cap)])
        if ms.shared_spec is not None:
            # shared experts are merged into ONE wider MLP per layer
            mlp(ms.shared_spec, L)
    elif cfg.family == "hybrid":
        ss = ssm_spec(cfg)
        out.extend([(ss.in_spec, L, 1.0), (ss.out_spec, L, 1.0)])
        n_groups = L // cfg.attn_every if cfg.attn_every else 0
        if n_groups:  # one shared parameter set, applied once per group
            attn(attn_spec(cfg, name="shared_attn"), n_groups)
    elif cfg.family == "rwkv":
        rs = rwkv_spec(cfg)
        for tag in ("wr", "wk", "wv", "wg", "wo", "cmv"):
            out.append((rs.proj(tag), L, 1.0))
        out.append((rs.proj("cmk", rs.ffn), L, 1.0))
        out.append((LinearSpec(f"{rs.name}.cmr", rs.ffn, cfg.d_model,
                               False, "attn", cfg.tt), L, 1.0))
    elif cfg.family == "encdec":
        attn(attn_spec(cfg, "enc_attn", causal=False), cfg.encoder_layers)
        mlp(mlp_spec(cfg, "enc_mlp"), cfg.encoder_layers)
        attn(attn_spec(cfg), L)
        attn(attn_spec(cfg, "xattn"), L)
        mlp(mlp_spec(cfg), L)
    else:  # pragma: no cover
        raise ValueError(cfg.family)
    out.append((head_spec(cfg), 1, 1.0))
    return out


def model_dse_layers(
    cfg: ModelConfig, tokens: int,
    factorizations: Optional[dict] = None,
) -> list[tuple[str, TensorNetwork]]:
    """Tensorized projections of ``cfg`` as named contraction problems.

    One entry per projection *instance* (repeated transformer layers
    appear L times — the batched cost-table engine dedups them), with the
    streamed token count as the batch edge.

    ``factorizations`` maps family names to explicit ``(out_modes,
    in_modes, ranks)`` overrides (the rank search's candidate handle);
    families not named keep their TTConfig-derived decomposition.
    """
    layers: list[tuple[str, TensorNetwork]] = []
    for spec, count, scale in _block_specs(cfg):
        if factorizations is not None and spec.name in factorizations:
            spec = spec.with_factorization(*factorizations[spec.name])
        if not spec.tensorized:
            continue  # dense projections have no path/dataflow freedom here
        t = max(1, math.ceil(tokens * scale))
        tn = spec.network(t)
        for i in range(count):
            layers.append((f"{spec.name}[{i}]" if count > 1 else spec.name, tn))
    if not layers:
        raise ValueError(
            f"config {cfg.name!r} has no tensorized projections "
            f"(tt.enabled={cfg.tt.enabled}, min_dim={cfg.tt.min_dim})"
        )
    return layers


def _vision_dse_layers(arch: str, tokens: int) -> list[tuple[str, TensorNetwork]]:
    from repro_torch.models.vision import model_layers

    model, dataset = arch.split("/")
    batch = max(1, tokens)
    return [(l.name, l.tt_network) for l in model_layers(model, dataset, batch=batch)]


def dse_problems(
    arch: str, tokens: Optional[int] = None, smoke: bool = False
) -> tuple[list[tuple[str, TensorNetwork]], int]:
    """Enumerate ``arch``'s per-layer DSE problems.

    Returns ``(named_layers, tokens)`` — one (instance name, tensor
    network) pair per tensorized projection instance, plus the effective
    streamed-token count (1024 default; im2col batch 1 for vision archs).
    """
    if arch in VISION_ARCHS:
        tokens = 1 if tokens is None else tokens
        return _vision_dse_layers(arch, tokens), tokens
    tokens = 1024 if tokens is None else tokens
    try:
        cfg = get_config(arch, smoke=smoke)
    except KeyError:
        raise KeyError(
            f"unknown arch {arch!r}; have ('tt-lm-100m',) + "
            f"{tuple(ARCH_IDS)} + {VISION_ARCHS}"
        ) from None
    return model_dse_layers(cfg, tokens), tokens


def model_layer_paths(
    named: Sequence[tuple[str, TensorNetwork]], top_k: int
) -> list:
    """Stage 1: top-K path search, memoised over repeated layers."""
    memo: dict = {}
    out = []
    for _, tn in named:
        key = tuple((n.edges, n.dims, n.kind) for n in tn.nodes)
        if key not in memo:
            memo[key] = find_topk_paths(tn, k=top_k)
        out.append(memo[key])
    return out


# ---------------------------------------------------------------------------
# end-to-end run
# ---------------------------------------------------------------------------

def run_dse(
    arch: str,
    hw: str = "fpga_vu9p",
    top_k: int = 4,
    objective: str = "latency",
    tokens: Optional[int] = None,
    smoke: bool = False,
    engine: str = "vectorized",
    mode: str = "infer",
    hw_search: str = "off",
    hw_budget: Optional[int] = None,
    tune: str = "off",
    tune_cache: Optional[str] = None,
    serve_gen: int = 128,
    serve_slots: int = 8,
    decode_tokens: Optional[int] = None,
    search: str = "exhaustive",
    search_budget: Optional[int] = None,
    search_seed: int = 0,
    rank_search: str = "off",
    accuracy_budget: Optional[float] = None,
    shards: Optional[int] = None,
    fused_cost: bool = False,
    device: str = "cuda",
) -> dict:
    """Run Algorithm 1 end-to-end; returns the JSON-serializable report.

    ``tokens`` is the streamed token count per projection (default 1024);
    for vision archs it is the im2col batch size (default 1).

    ``mode="train"`` optimizes the training step (joint fwd+bwd+update —
    per-layer reports carry the latency decomposition and the backward
    path choices); ``"both"`` runs both searches and nests their reports
    under ``"infer"`` / ``"train"`` with the layers whose choices diverge.

    ``hw_search="budget"`` turns on the joint architecture co-search: the
    ``--hw`` target becomes the *base* of a feasible architecture space
    (``repro_torch.hw.ArchSpace``, PE shape x SRAM split x bandwidth tier
    under ``hw_budget`` MACs — default: the base target's own PE count),
    every candidate is evaluated through the hw-batched cost-table
    engine, and the report gains a per-candidate ``hw_search`` section.

    ``search="guided"`` replaces the exhaustive sweep with the budgeted
    explorer of ``repro_torch.search`` (``search_budget`` cost-model
    evaluations, ``search_seed`` for the proposal stream); the report's
    ``search`` section records the provenance (evals, found-at-eval,
    the exhaustive count it avoided).

    ``rank_search="budget"`` adds the decomposition itself as a fourth
    searched axis (``repro_torch.rank``): every TT factorization candidate
    is evaluated end-to-end and the report gains a ``rank_search`` section
    with the (latency, accuracy-proxy) frontier; ``accuracy_budget``
    caps the chosen candidate's reconstruction-error proxy (default:
    no worse than the frozen decomposition).

    ``tune`` turns on the measured-latency loop (``repro_torch.tune``):
    the model's dominant GEMM shapes are measured per dataflow on
    ``device`` (the card unless the caller asks for the CPU; ``"cache"``
    = only cache misses, ``"measure"`` = re-measure) and the resulting
    calibration rescales the analytic table before the argmin.  The
    report gains a ``tune`` section; with ``--emit-plan`` the plan
    additionally carries measured kernel tilings.

    ``shards=N`` searches at per-rank shard shapes (``tokens / N``) so the
    emitted tilings match what the sharded executor streams per rank on
    an N-way data-parallel mesh; defaults to installed sharding rules,
    else unsharded.
    """
    if mode == "both":
        _check_train_compatible(objective, engine)  # fail before any search
        _check_tune_compatible(tune, "both", objective, hw_search)
        _check_rank_compatible(rank_search, "both", objective, engine, tune)
        _check_fused_compatible(fused_cost, "both", objective, engine,
                                hw_search, search, rank_search)
        infer, _, _, _, _, _ = _run_dse(
            arch, hw, top_k, objective, tokens, smoke, engine, "infer",
            hw_search, hw_budget, search=search, search_budget=search_budget,
            search_seed=search_seed, shards=shards)
        train, _, _, _, _, _ = _run_dse(
            arch, hw, top_k, objective, tokens, smoke, engine, "train",
            hw_search, hw_budget, search=search, search_budget=search_budget,
            search_seed=search_seed, shards=shards)
        return _both_report(infer, train)
    report, _, _, _, tuner, _ = _run_dse(
        arch, hw, top_k, objective, tokens, smoke, engine, mode, hw_search,
        hw_budget, tune, tune_cache, serve_gen, serve_slots, decode_tokens,
        search, search_budget, search_seed, rank_search, accuracy_budget,
        shards, fused_cost, device)
    _save_tuner(tuner)
    return report


def _both_report(infer: dict, train: dict) -> dict:
    """Combined infer+train report with the per-layer choice divergence.

    Under ``hw_search`` each mode co-searches its *own* architecture, so
    the per-layer deltas may partly reflect the architecture change; the
    top-level ``hw_search`` block names both winners and flags
    ``hw_divergent`` so consumers can tell the two apart (an emitted plan
    always embeds the train winner — plans are compiled from the train
    leg).
    """
    div = []
    train_by_name = {l["name"]: l for l in train["layers"]}
    for li in infer["layers"]:
        lt = train_by_name.get(li["name"])
        if lt is None:
            continue
        delta = {
            k: [li[k], lt[k]]
            for k in ("path_index", "partitioning", "dataflow")
            if li[k] != lt[k]
        }
        if delta:
            div.append({"name": li["name"], **delta})
    out = {
        "arch": infer["arch"],
        "hw": infer["hw"],
        "mode": "both",
        "tokens": infer["tokens"],
        "infer": infer,
        "train": train,
        "divergent_layers": div,
        "n_divergent_layers": len(div),
    }
    hs_i, hs_t = infer.get("hw_search"), train.get("hw_search")
    if hs_i is not None and hs_t is not None:
        out["hw_search"] = {
            "infer_chosen": hs_i["chosen"]["name"],
            "train_chosen": hs_t["chosen"]["name"],
            "hw_divergent": hs_i["chosen"]["name"] != hs_t["chosen"]["name"],
        }
    return out


def run_dse_plan(
    arch: str,
    hw: str = "fpga_vu9p",
    top_k: int = 4,
    objective: str = "latency",
    tokens: Optional[int] = None,
    smoke: bool = False,
    engine: str = "vectorized",
    plan_backend: str = "auto",
    mode: str = "infer",
    hw_search: str = "off",
    hw_budget: Optional[int] = None,
    tune: str = "off",
    tune_cache: Optional[str] = None,
    serve_gen: int = 128,
    serve_slots: int = 8,
    decode_tokens: Optional[int] = None,
    phase: str = "",
    search: str = "exhaustive",
    search_budget: Optional[int] = None,
    search_seed: int = 0,
    rank_search: str = "off",
    accuracy_budget: Optional[float] = None,
    shards: Optional[int] = None,
    fused_cost: bool = False,
    device: str = "cuda",
):
    """Run the DSE and compile its result into an ExecutionPlan.

    ``phase`` stamps the emitted plan as one half of a serving plan pair
    (``"prefill"`` / ``"decode"``); the serve driver then refuses to
    install it as the other half.  ``--emit-plan-pair`` runs this twice
    — once per phase, each at its own token count.

    Returns ``(report, plan)`` — the same report as :func:`run_dse` plus
    the installable plan (``repro_torch.plan.ExecutionPlan``).  This is
    the search->compile half of the deploy loop; ``launch/serve.py
    --plan`` / ``launch/train.py --plan`` is the install->execute half.
    Under ``mode="train"`` (or ``"both"``) the emitted plan is schema
    v2-style with per-layer backward paths/backends/tilings.  Under
    ``hw_search="budget"`` the plan embeds the co-searched winning
    architecture (schema v3 ``hardware``) and its kernel tilings derive
    from that architecture's array shape and buffer sizes.  Under
    ``tune`` the search is measured-calibrated and the plan's tilings
    are the autotuner's measured argmins (``tilings: "measured"``) —
    served from the persistent cache, so a warm cache re-emits the
    identical plan without measuring.  Under ``rank_search`` the plan
    embeds the chosen candidate's factorizations
    (schema v4) so the executor contracts the *searched* decomposition —
    vision archs excepted (their conv decompositions are structural, not
    plan-installable).
    """
    from repro_torch.plan import BACKENDS, compile_plan

    if plan_backend != "auto" and plan_backend not in BACKENDS:
        raise ValueError(
            f"unknown plan backend {plan_backend!r}; have "
            f"{('auto',) + BACKENDS}")
    if mode not in MODES:
        raise KeyError(f"unknown mode {mode!r}; have {MODES}")
    infer_report = None
    if mode == "both":
        _check_train_compatible(objective, engine)  # fail before any search
        _check_tune_compatible(tune, "both", objective, hw_search)
        _check_rank_compatible(rank_search, "both", objective, engine, tune)
        _check_fused_compatible(fused_cost, "both", objective, engine,
                                hw_search, search, rank_search)
        infer_report, _, _, _, _, _ = _run_dse(
            arch, hw, top_k, objective, tokens, smoke, engine, "infer",
            hw_search, hw_budget, search=search, search_budget=search_budget,
            search_seed=search_seed, shards=shards)
    plan_mode = "train" if mode in ("train", "both") else "infer"
    report, named, res, plan_hw, tuner, calibration = _run_dse(
        arch, hw, top_k, objective, tokens, smoke, engine, plan_mode,
        hw_search, hw_budget, tune, tune_cache,
        serve_gen, serve_slots, decode_tokens,
        search, search_budget, search_seed, rank_search, accuracy_budget,
        shards, fused_cost, device)
    factorizations = None
    rank_report = report.get("rank_search")
    if rank_report is not None and rank_report.get("plan_embeddable"):
        from repro_torch.plan import Factorization

        factorizations = {
            f["name"]: Factorization(
                out_modes=tuple(f["out_modes"]),
                in_modes=tuple(f["in_modes"]),
                ranks=tuple(f["ranks"]),
                accuracy_proxy=float(f["accuracy_proxy"]))
            for f in rank_report["chosen"]["families"]
        }
    plan_sharding = None
    shard_rep = report.get("sharding")
    if shard_rep is not None:
        from repro_torch.plan import PlanSharding

        plan_sharding = PlanSharding(
            n_shards=int(shard_rep["n_shards"]),
            axes=tuple((str(a), int(s)) for a, s in shard_rep["axes"]),
            tokens_per_shard=int(shard_rep["tokens_per_shard"]))
    plan = compile_plan(
        named, res, plan_hw,
        arch=arch,
        objective=report["objective"],
        tokens=report["tokens"],
        backend=plan_backend,
        total_latency_s=report["total_latency_s"],
        tilings="heuristic" if tuner is None else "measured",
        tuner=tuner,
        phase=phase,
        factorizations=factorizations,
        sharding=plan_sharding,
    )
    if tuner is not None:
        if calibration is not None and report["objective"] == "latency":
            # the argmin ran over the calibrated table, so each choice's
            # latency landed in measured-rescaled units; divide the scale
            # back out so the plan's per-layer provenance stays in the
            # same analytic seconds as its total_latency_s (up to float
            # rounding — (analytic * cal) / cal can differ from analytic
            # by an ulp).  The correction model scales per (shape bucket,
            # dataflow), so each family's scale comes from its own
            # choice's dominant GEMM.  Train-mode searches run analytic
            # (calibration is None) — their latencies need no unscaling.
            # Throughput objectives keep calibrated units: the combined
            # value mixes two phases' scales, so no single factor
            # recovers analytic seconds.
            from repro_torch.plan.compiler import base_name
            from repro_torch.tune.variants import dominant_gemm

            fam_choice = {}
            for (inst_name, _), choice in zip(named, res.choices):
                fam_choice.setdefault(base_name(inst_name), choice)

            def _unscale(lp):
                c = fam_choice[lp.name]
                M, K, N = dominant_gemm(c.path)
                return dataclasses.replace(
                    lp, latency_s=lp.latency_s / calibration.scale(
                        M, K, N, lp.dataflow))

            plan = dataclasses.replace(
                plan, layers=tuple(_unscale(lp) for lp in plan.layers))
        # compilation may have measured additional (per-family) sweeps;
        # refresh the report's counters and persist the cache
        report["tune"]["n_measured"] = tuner.n_measured
        report["tune"]["n_cache_hits"] = tuner.n_cache_hits
        report["tune"]["n_cache_entries"] = len(tuner.cache)
        _save_tuner(tuner)
    if mode == "both":
        report = _both_report(infer_report, report)
    return report, plan


def _hw_search_report(space: ArchSpace, res, base_cfg,
                      n_space: int) -> dict:
    """Per-candidate section of the report (sorted best-first).

    ``res.hw_candidates`` is the full space for an exhaustive co-search
    and the *visited* (exactly refined) candidates for a guided one —
    the guided driver always visits the base target first, so ``fixed``
    is present either way.
    """
    def row(cand) -> dict:
        return {
            **space.describe(cand.hw),
            "strategy": cand.strategy,
            "total_latency_s": cand.total_latency_s,
        }

    by_latency = sorted(res.hw_candidates,
                        key=lambda c: (c.total_latency_s, c.hw.name))
    fixed = next((c for c in res.hw_candidates
                  if c.hw.name == base_cfg.name), None)
    chosen = next(c for c in res.hw_candidates if c.hw is res.hw)
    return {
        "mode": "budget",
        "search": res.search,
        "mac_budget": space.mac_budget,
        "n_candidates": len(res.hw_candidates),
        "n_space": n_space,
        "chosen": row(chosen),
        "fixed": row(fixed) if fixed is not None else None,
        "improvement_pct": (
            100.0 * (1.0 - chosen.total_latency_s / fixed.total_latency_s)
            if fixed is not None and fixed.total_latency_s > 0 else None),
        "candidates": [row(c) for c in by_latency],
    }


def _check_train_compatible(objective: str, engine: str) -> None:
    """Reject mode/objective/engine combinations the train search cannot
    honour — called up front so ``--mode both`` fails before the (valid)
    inference leg burns any search time."""
    if objective != "latency":
        raise ValueError(
            "--mode train optimizes the train-latency objective; "
            f"--objective {objective} is an inference objective")
    if engine == "scalar":
        raise ValueError("--mode train requires the vectorized engine")


def _check_tune_compatible(tune: str, mode: str, objective: str,
                           hw_search: str) -> None:
    """Reject combinations the measured-latency loop cannot honour yet.

    The calibration rescales the inference latency table — per candidate
    under an architecture co-search (ROADMAP gap c, closed).  Train mode
    is allowed since the tiling lift (ROADMAP gap b): the train *search*
    stays analytic, but train-mode plans serve measured forward tilings
    and any backward-op tilings already in the cache.  The throughput
    objective is calibrated per phase (ROADMAP serving follow-on (a),
    closed): the correction rescales the prefill and decode tables at
    their own GEMM shapes inside ``combine_phase_tables``.  Composing
    the calibration with the fwd+bwd decomposition or the EDP objective
    are still open items (ROADMAP.md)."""
    if tune == "off":
        return
    if tune not in TUNE_MODES:
        raise KeyError(f"unknown tune mode {tune!r}; have {TUNE_MODES}")
    if mode == "both":
        raise ValueError(
            "--tune with --mode both is ambiguous (the infer leg searches "
            "a calibrated table, the train leg an analytic one); run the "
            "modes separately")
    if objective not in ("latency", "throughput"):
        raise ValueError(
            "--tune calibrates the latency and throughput objectives; "
            f"--objective {objective} is analytic-only for now")


def _check_rank_compatible(rank_search: str, mode: str, objective: str,
                           engine: str, tune: str) -> None:
    """Reject combinations the rank search cannot honour.

    The decomposition axis re-derives every layer's tensor network per
    candidate, so it composes with the path/partitioning/dataflow axes,
    the architecture co-search, and the guided explorer — but not (yet)
    with the train decomposition, non-latency objectives, the scalar
    engine, or the measured calibration (whose cache keys would have to
    span every candidate's GEMM shapes)."""
    if rank_search == "off":
        return
    if rank_search not in RANK_SEARCH_MODES:
        raise KeyError(
            f"unknown rank_search {rank_search!r}; have {RANK_SEARCH_MODES}")
    if mode != "infer":
        raise ValueError(
            "--rank-search explores the inference latency/accuracy "
            f"frontier; --mode {mode} is frozen-decomposition only")
    if objective != "latency":
        raise ValueError(
            "--rank-search trades latency against the accuracy proxy; "
            f"--objective {objective} is frozen-decomposition only")
    if engine == "scalar":
        raise ValueError("--rank-search requires the vectorized engine")
    if tune != "off":
        raise ValueError(
            "--rank-search is analytic: the measured calibration would "
            "need per-candidate GEMM coverage (open item)")


def _check_fused_compatible(fused_cost: bool, mode: str, objective: str,
                            engine: str, hw_search: str, search: str,
                            rank_search: str) -> None:
    """Reject combinations the fusion-aware cost tables cannot honour.

    ``--fused-cost`` overrides the (1,1)-partitioning cells of the
    inference seconds/traffic tables with the fused-segment accounting
    (``repro_torch.core.cost_table.fused_cost_tables``), so it composes with
    the latency and EDP objectives on a fixed target under the
    exhaustive vectorized search.  The throughput objective would need
    both phase tables fused, the architecture co-search would need the
    per-candidate hw-batched engine to know about segments, the guided
    explorer reads raw tables rather than the provided objective table,
    and the rank search re-derives networks per candidate — all open
    items (ROADMAP.md)."""
    if not fused_cost:
        return
    if mode != "infer":
        raise ValueError(
            "--fused-cost overrides the inference cost tables; "
            f"--mode {mode} is spill-always only for now")
    if objective not in ("latency", "edp"):
        raise ValueError(
            "--fused-cost composes with the latency and EDP objectives; "
            f"--objective {objective} would need fused per-phase tables "
            "(open item)")
    if engine == "scalar":
        raise ValueError("--fused-cost requires the vectorized engine")
    if hw_search != "off":
        raise ValueError(
            "--fused-cost with --hw-search would need fused hw-batched "
            "tables per candidate (open item)")
    if search != "exhaustive":
        raise ValueError(
            "--fused-cost requires --search exhaustive (the guided "
            "explorer rebuilds its own tables)")
    if rank_search != "off":
        raise ValueError(
            "--fused-cost with --rank-search would need per-candidate "
            "segmentation (open item)")


def _make_tuner(tune: str, tune_cache: Optional[str], device: str,
                shards: int = 1):
    """Build the Autotuner over the persistent cache (lazy import); it
    measures on ``device``."""
    from repro_torch.tune import Autotuner, DEFAULT_CACHE_PATH, TuningCache

    path = tune_cache or DEFAULT_CACHE_PATH
    return Autotuner(TuningCache.load_or_empty(path), tune, cache_path=path,
                     shards=shards, device=device)


def _shard_context(shards: Optional[int]) -> Optional[dict]:
    """Resolve the per-rank shard context for the search, or ``None``.

    An explicit ``--shards N`` wins; otherwise installed
    :class:`~repro_torch.sharding.ShardingRules` supply their token axes
    (library callers running the DSE under ``use_rules``).  When a
    context is active the searched problems, cost tables, tilings, and
    tuning sweeps are all built at ``tokens / n_shards``: the per-rank
    block the sharded executor streams (``repro_torch.plan.sharded``).
    """
    if shards is not None:
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if shards == 1:
            return None
        return {"n_shards": int(shards), "axes": [["data", int(shards)]]}
    from repro_torch.sharding import get_rules

    rules = get_rules()
    if rules is None or rules.mesh is None:
        return None
    axes = [[a, int(rules.axis_sizes[a])] for a in rules.resolve("tokens")
            if rules.axis_sizes.get(a, 1) > 1]
    n = math.prod(s for _, s in axes)
    if n <= 1:
        return None
    return {"n_shards": int(n), "axes": axes}


def _save_tuner(tuner) -> None:
    if tuner is not None and tuner.cache_path is not None:
        tuner.save()


def _apply_fused_cost(tables, named, layer_paths, hw_cfg, tokens, tuner):
    """Overlay the fusion-aware accounting on the inference cost tables.

    Re-costs every fuseable monolithic cell with the fused-segment model
    (``core.cost_table.fused_cost_tables``) at the same ``block_tokens``
    the plan compiler's tiling heuristic would stream and the same VMEM
    budget its segmentation pass enforces (fixed target => no hw caps,
    ``_streaming_budget(None)``).  With a live ``tuner``, each fused
    layer is additionally *measured* — fused (K5) vs per-step seconds on
    the tuner's device (``Autotuner.tune_fused``) — and its fused cells are
    rescaled by measured/analytic fusion-advantage disagreement, so
    ``--tune cache|measure`` calibrates the fused path too.

    Returns ``(tables, report_section)``.
    """
    from repro_torch.core import fusion
    from repro_torch.core.cost_table import fused_cost_tables
    from repro_torch.plan.compiler import _pow2_le, _streaming_budget

    block_tokens = max(8, _pow2_le(min(256, tokens)))
    budget_bytes = _streaming_budget(None)
    base_seconds = dict(tables.seconds)
    t0 = time.perf_counter()
    tables = fused_cost_tables(
        layer_paths, [tn for _, tn in named], hw_cfg,
        block_tokens=block_tokens, budget_bytes=budget_bytes, base=tables)
    fused_cells = sorted(k for k, s in tables.seconds.items()
                         if s != base_seconds[k])
    tune_rows = None
    if tuner is not None and fused_cells:
        tune_rows = []
        done: dict[str, float] = {}  # layer signature -> measured scale
        from repro_torch.tune import network_signature

        for li, ((name, tn), paths) in enumerate(zip(named, layer_paths)):
            keys = [k for k in fused_cells if k[0] == li]
            if not keys:
                continue
            p_idx = min(k[1] for k in keys)
            steps = tuple(tuple(s) for s in paths[p_idx].steps)
            sig = network_signature(tn, steps)
            if sig not in done:
                segs = fusion.segment_path(
                    tn, steps, block_tokens=block_tokens,
                    budget_bytes=budget_bytes)
                meas = tuner.tune_fused(
                    tn, steps, segs, tokens, include=(block_tokens,),
                    budget_bytes=budget_bytes)
                scale = 1.0
                if meas is not None and meas["per_step_s"] > 0:
                    k_rep = next(k for k in keys if k[1] == p_idx)
                    analytic_adv = tables.seconds[k_rep] / base_seconds[k_rep]
                    measured_adv = meas["fused_s"] / meas["per_step_s"]
                    if analytic_adv > 0 and measured_adv > 0:
                        scale = measured_adv / analytic_adv
                done[sig] = scale
                tune_rows.append({
                    "layer": name,
                    "path_index": int(p_idx),
                    "measured": meas,
                    "scale": scale,
                })
            if done[sig] != 1.0:
                for k in keys:
                    tables.seconds[k] *= done[sig]
    report = {
        "enabled": True,
        "block_tokens": int(block_tokens),
        "budget_bytes": int(budget_bytes),
        "n_fused_cells": len(fused_cells),
        "n_fused_layers": len({k[0] for k in fused_cells}),
        "tune": tune_rows,
        "build_s": time.perf_counter() - t0,
    }
    return tables, report


def _run_dse(
    arch: str,
    hw: str = "fpga_vu9p",
    top_k: int = 4,
    objective: str = "latency",
    tokens: Optional[int] = None,
    smoke: bool = False,
    engine: str = "vectorized",
    mode: str = "infer",
    hw_search: str = "off",
    hw_budget: Optional[int] = None,
    tune: str = "off",
    tune_cache: Optional[str] = None,
    serve_gen: int = 128,
    serve_slots: int = 8,
    decode_tokens: Optional[int] = None,
    search: str = "exhaustive",
    search_budget: Optional[int] = None,
    search_seed: int = 0,
    rank_search: str = "off",
    accuracy_budget: Optional[float] = None,
    shards: Optional[int] = None,
    fused_cost: bool = False,
    device: str = "cuda",
):
    """Shared pipeline; returns (report, named_layers, DSEResult, hw_cfg,
    tuner, calibration).

    ``shards`` activates the per-rank shard context
    (:func:`_shard_context`): every problem network, and therefore every
    cost table, tiling and tuning sweep, is built at the per-shard token
    count the sharded executor streams, and the report gains a
    ``sharding`` section for plan provenance.

    The tuner is the live ``repro_torch.tune.Autotuner`` (measuring on
    ``device``) when ``tune`` is on (``run_dse_plan`` hands it to the plan
    compiler for measured tilings, then persists its cache), else
    ``None``; the calibration is the fitted
    ``repro_torch.tune.CostCorrection`` the search ran under
    (``run_dse_plan`` divides its scales back out of plan latencies).

    ``search="guided"`` routes the argmin through
    ``repro_torch.search.guided_search`` — a budgeted explorer over the
    same cost tables (latency / train-latency objectives; EDP and
    throughput tables are pre-combined and stay exhaustive).  With
    ``hw_search`` it replaces the exhaustive outer architecture loop;
    without it the single target is refined exactly (same result, guided
    provenance).

    The returned hardware config is the one the plan should compile for:
    the co-searched winner under ``hw_search``, else the fixed target.

    ``objective="throughput"`` optimizes serving tokens/s under a
    sustained continuous-batching load: each layer's cost becomes
    ``T_prefill(tokens) + (serve_gen / serve_slots) * T_decode``, where
    the decode table replays the same candidate paths at
    ``decode_tokens`` streamed tokens (default ``serve_slots`` — one
    fixed-width decode step).  The report gains a ``serving`` section
    with the phase decomposition of the winning configuration.
    """
    hw_cfg = get_target(hw)
    if objective not in OBJECTIVES:
        raise KeyError(f"unknown objective {objective!r}; have {OBJECTIVES}")
    if mode not in ("infer", "train"):
        raise KeyError(f"unknown mode {mode!r}; have {MODES}")
    if engine == "scalar" and objective in ("edp", "throughput"):
        raise ValueError(
            f"objective={objective} requires the vectorized engine")
    if objective == "throughput":
        if arch in VISION_ARCHS:
            raise ValueError(
                "objective=throughput models the serving prefill/decode "
                "split of causal LMs; vision archs have no decode phase")
        if serve_gen < 1 or serve_slots < 1:
            raise ValueError("serve_gen and serve_slots must be >= 1")
    if mode == "train":
        _check_train_compatible(objective, engine)
    if hw_search not in HW_SEARCH_MODES:
        raise KeyError(
            f"unknown hw_search {hw_search!r}; have {HW_SEARCH_MODES}")
    if hw_search != "off":
        if objective != "latency":
            raise ValueError(
                "--hw-search optimizes the latency (or train-latency) "
                f"objective; --objective {objective} is fixed-architecture "
                "only")
        if engine == "scalar":
            raise ValueError("--hw-search requires the vectorized engine")
    if search not in SEARCH_MODES:
        raise KeyError(f"unknown search {search!r}; have {SEARCH_MODES}")
    if search == "guided":
        if objective != "latency":
            raise ValueError(
                "--search guided explores the latency (or train-latency) "
                f"objective; the pre-combined --objective {objective} "
                "table stays on the exhaustive path")
        if engine == "scalar":
            raise ValueError("--search guided requires the vectorized "
                             "engine")
    if search_budget is not None and search != "guided":
        raise ValueError("search_budget requires search='guided'")
    _check_tune_compatible(tune, mode, objective, hw_search)
    _check_fused_compatible(fused_cost, mode, objective, engine, hw_search,
                            search, rank_search)
    shard_ctx = _shard_context(shards)
    if rank_search != "off":
        _check_rank_compatible(rank_search, mode, objective, engine, tune)
        if shard_ctx is not None:
            raise ValueError(
                "--rank-search re-derives networks per decomposition "
                "candidate; composing it with the --shards context is not "
                "supported yet")
        return _run_rank_dse(
            arch, hw, top_k, tokens, smoke, engine, hw_search, hw_budget,
            search, search_budget, search_seed, accuracy_budget)
    if accuracy_budget is not None:
        raise ValueError("accuracy_budget requires rank_search='budget'")

    named, tokens = dse_problems(arch, tokens, smoke)
    if shard_ctx is not None:
        # per-rank problems: the searched tilings/tables must match the
        # (tokens / n_shards) block each rank actually streams
        from repro_torch.core.cost_table import shard_streamed_tokens

        global_tokens = tokens
        tokens = shard_streamed_tokens(tokens, shard_ctx["n_shards"])
        named, _ = dse_problems(arch, tokens, smoke)
        shard_ctx = {**shard_ctx, "tokens_per_shard": tokens,
                     "global_tokens": global_tokens}

    # stage 1 — top-K path search, memoised over repeated layers
    t0 = time.perf_counter()
    layer_paths = model_layer_paths(named, top_k)
    path_search_s = time.perf_counter() - t0

    # stage 2 — batched cost table (scalar engine kept for benchmarking)
    all_parts = ALL_PARTITIONINGS
    train_tables = None
    layer_backwards = None
    hw_search_report = None
    if mode == "train":
        from repro_torch.core import memoised_layer_backwards

        t0 = time.perf_counter()
        layer_backwards = memoised_layer_backwards(
            [tn for _, tn in named], k=top_k)
        bwd_search_s = time.perf_counter() - t0
        path_search_s += bwd_search_s

    # stage 2b — measured calibration (repro_torch.tune): measure the model's
    # dominant GEMM shapes per dataflow on this machine, fit the learned
    # per-(shape-bucket, dataflow) correction from the cache, and rescale
    # the analytic table(s) before the argmin.  Runs before the search
    # stages because the co-search applies it per candidate (gap c).
    tuner = None
    tune_report = None
    calibration = None
    fused_report = None
    if tune != "off" and mode == "train":
        # ROADMAP gap (b): train-mode plans may serve measured tilings —
        # forward ops through the usual measured sweep, backward ops from
        # whatever the cache already holds (analytic fallback on miss) —
        # but the train *search* stays analytic: composing the measured
        # calibration with the fwd+bwd+update decomposition is open.
        tuner = _make_tuner(tune, tune_cache, device,
                            shards=(shard_ctx or {}).get("n_shards", 1))
        tune_report = {
            "mode": tune,
            "cache": tuner.cache_path,
            "device_kind": tuner.device_kind,
            "interpret": tuner.interpret,
            "n_calibration_shapes": 0,
            "calibration": None,
            "correction": None,
            "note": "train search is analytic; measured tilings only",
            "n_measured": tuner.n_measured,
            "n_cache_hits": tuner.n_cache_hits,
            "n_cache_entries": len(tuner.cache),
            "measure_s": 0.0,
        }
    elif tune != "off":
        from repro_torch.tune import (
            fit_cost_correction,
            gemm_work_items,
            measured_calibration,
        )

        tuner = _make_tuner(tune, tune_cache, device,
                            shards=(shard_ctx or {}).get("n_shards", 1))
        t0 = time.perf_counter()
        shapes = gemm_work_items(layer_paths,
                                 max_shapes=TUNE_CALIBRATION_SHAPES)
        flat_calibration = measured_calibration(shapes, tuner, hw_cfg)
        # the learned correction: per (shape bucket, dataflow) geomean
        # ratios, falling back to the flat per-dataflow scales above on
        # sparse buckets.  The fit is pinned to the calibration shape
        # set so a warm cache holding extra sweep entries still fits the
        # identical model (bit-identical re-emission is CI-asserted).
        calibration = fit_cost_correction(
            tuner.cache, hw_cfg, device_kind=tuner.device_kind,
            interpret=tuner.interpret, shapes=shapes)
        tune_report = {
            "mode": tune,
            "cache": tuner.cache_path,
            "device_kind": tuner.device_kind,
            "interpret": tuner.interpret,
            "n_calibration_shapes": len(shapes),
            "calibration": flat_calibration,
            "correction": calibration.describe(),
            "n_measured": tuner.n_measured,
            "n_cache_hits": tuner.n_cache_hits,
            "n_cache_entries": len(tuner.cache),
            "measure_s": time.perf_counter() - t0,
        }

    n_space = 1
    if hw_search != "off":
        # stage 2+3 joint: hw-batched tables + outer architecture loop
        from repro_torch.core import (
            build_cost_tables_hw,
            build_train_cost_tables_hw,
        )

        space = ArchSpace(base=hw_cfg, mac_budget=hw_budget)
        cands = space.candidates()
        n_space = len(cands)
        if search == "guided":
            from repro_torch.search import guided_search

            t0 = time.perf_counter()
            res = guided_search(
                layer_paths, hw_cfg,
                objective=("train-latency" if mode == "train"
                           else "latency"),
                hw_space=cands, budget=search_budget, seed=search_seed,
                layer_backwards=layer_backwards, calibration=calibration)
            argmin_s = time.perf_counter() - t0
            # rebuild the winner's analytic tables for the report: the
            # per-layer latencies below must stay in analytic seconds
            # even when the argmin ran over a calibrated table
            if mode == "train":
                train_tables = build_train_cost_tables_hw(
                    layer_paths, layer_backwards, (res.hw,), all_parts)[0]
                tables = train_tables.fwd
                table_build_s = train_tables.build_seconds
            else:
                tables = build_cost_tables_hw(layer_paths, (res.hw,),
                                              all_parts)[0]
                table_build_s = tables.build_seconds
        elif mode == "train":
            trains = build_train_cost_tables_hw(
                layer_paths, layer_backwards, cands, all_parts)
            table_build_s = trains[0].build_seconds
            t0 = time.perf_counter()
            res = global_search(layer_paths, objective="train-latency",
                                hw_space=cands, hw_train_tables=trains)
            argmin_s = time.perf_counter() - t0
            win = cands.index(res.hw)
            train_tables = trains[win]
            tables = train_tables.fwd
        else:
            per_hw = build_cost_tables_hw(layer_paths, cands, all_parts)
            table_build_s = per_hw[0].build_seconds
            t0 = time.perf_counter()
            res = global_search(layer_paths, hw_space=cands,
                                hw_tables=[t.seconds for t in per_hw],
                                calibration=calibration)
            argmin_s = time.perf_counter() - t0
            win = cands.index(res.hw)
            tables = per_hw[win]
        seconds_table = tables.seconds
        hw_search_report = _hw_search_report(space, res, hw_cfg, n_space)
    elif mode == "train":
        from repro_torch.core import build_train_cost_tables

        train_tables = build_train_cost_tables(
            layer_paths, layer_backwards, hw_cfg, all_parts)
        tables = train_tables.fwd
        seconds_table = tables.seconds
        table_build_s = train_tables.build_seconds
    elif engine == "scalar":
        t0 = time.perf_counter()
        seconds_table = build_cost_table(
            layer_paths, hw_cfg, all_parts, engine="scalar"
        )
        tables = None
        table_build_s = time.perf_counter() - t0
        obj_table = seconds_table
    decode_seconds = None
    dec_tokens = decode_tokens if decode_tokens is not None else serve_slots
    if shard_ctx is not None:
        from repro_torch.core.cost_table import shard_streamed_tokens

        dec_tokens = shard_streamed_tokens(dec_tokens,
                                           shard_ctx["n_shards"])
    if hw_search == "off" and mode != "train" and engine != "scalar":
        tables = build_cost_tables(layer_paths, hw_cfg, all_parts)
        seconds_table = tables.seconds
        table_build_s = tables.build_seconds
        if fused_cost:
            tables, fused_report = _apply_fused_cost(
                tables, named, layer_paths, hw_cfg, tokens, tuner)
            seconds_table = tables.seconds
            table_build_s += fused_report["build_s"]
        if objective == "edp":
            obj_table = tables.edp(hw_cfg)
        elif objective == "throughput":
            # second cost table at decode shape: same contraction orders,
            # activations replayed at dec_tokens streamed tokens so the
            # (layer, path) keys line up across the phase tables
            from repro_torch.core.dse import combine_phase_tables, replay_paths

            decode_named, _ = dse_problems(arch, dec_tokens, smoke)
            decode_paths = replay_paths(
                layer_paths, [tn for _, tn in decode_named])
            decode_tables = build_cost_tables(decode_paths, hw_cfg, all_parts)
            decode_seconds = decode_tables.seconds
            table_build_s += decode_tables.build_seconds
            # measured calibration applies per phase, at each phase's own
            # GEMM shapes (ROADMAP serving follow-on (a)); the combined
            # table is then final — stage 3 must not rescale it again
            obj_table = combine_phase_tables(
                seconds_table, decode_seconds,
                w_decode=serve_gen / serve_slots,
                calibration=calibration,
                prefill_paths=layer_paths,
                decode_paths=decode_paths)
        else:
            obj_table = seconds_table

    # stage 3 — hierarchical global argmin over the chosen objective
    # (already folded into the outer architecture loop under hw search)
    if hw_search == "off":
        t0 = time.perf_counter()
        if search == "guided":
            from repro_torch.search import guided_search

            res = guided_search(
                layer_paths, hw_cfg,
                objective=("train-latency" if mode == "train"
                           else "latency"),
                budget=search_budget, seed=search_seed,
                layer_backwards=layer_backwards, calibration=calibration)
        elif mode == "train":
            res = global_search(layer_paths, hw_cfg,
                                objective="train-latency",
                                train_tables=train_tables)
        else:
            res = global_search(
                layer_paths, hw_cfg, table=obj_table,
                # throughput tables arrive pre-calibrated per phase
                calibration=(None if objective == "throughput"
                             else calibration),
                objective="throughput" if objective == "throughput"
                else "latency")
        argmin_s = time.perf_counter() - t0

    layers = []
    total_latency = 0.0
    for (name, _), choice in zip(named, res.choices):
        key = (choice.layer, choice.path_index, choice.partitioning,
               choice.dataflow)
        # train mode: per-step cost = fwd + bwd + update; infer: fwd only
        latency_s = choice.latency_s if mode == "train" else seconds_table[key]
        total_latency += latency_s
        entry = {
            "name": name,
            "path_index": choice.path_index,
            "mac_optimal_path": choice.path_index == 0,
            "macs": choice.path.macs,
            "partitioning": list(choice.partitioning),
            "dataflow": choice.dataflow.value,
            "latency_s": latency_s,
            # the argmin's objective value: == latency_s unless EDP or
            # --tune (then in measured-rescaled units, see the tune
            # section's calibration scales)
            "objective": choice.latency_s,
        }
        if mode == "train":
            entry["fwd_latency_s"] = choice.fwd_latency_s
            entry["bwd_latency_s"] = choice.bwd_latency_s
            entry["update_latency_s"] = choice.update_latency_s
            entry["backward"] = [
                {"wrt": ch.wrt, "path_index": ch.path_index,
                 "latency_s": ch.latency_s}
                for ch in choice.backward
            ]
        layers.append(entry)
    report = {
        "arch": arch,
        "hw": hw,
        # the architecture the numbers below describe: the co-searched
        # winner under --hw-search, else the --hw target itself
        "hw_chosen": res.hw.name if res.hw is not None else hw,
        "hw_search": hw_search_report,
        "tune": tune_report,
        "fused_cost": fused_report,
        "mode": mode,
        "objective": "train-latency" if mode == "train" else objective,
        "top_k": top_k,
        "tokens": tokens,
        "engine": engine,
        "strategy": res.strategy,
        "total_latency_s": total_latency,
        "total_objective": res.total_latency_s,
        "search": {
            "mode": res.search,
            "budget": search_budget,
            "seed": search_seed if search == "guided" else None,
            "evals": res.evals,
            "found_at_eval": res.found_at_eval,
            "exhaustive_evals": n_space * _table_cells(layer_paths,
                                                      all_parts),
        },
        "sharding": shard_ctx,
        "n_layers": len(layers),
        "timings": {
            "path_search_s": path_search_s,
            "table_build_s": table_build_s,
            "argmin_s": argmin_s,
        },
        "table": {
            "n_cells": len(seconds_table),
            "n_unique_gemm_evals": tables.n_unique_gemm_evals if tables else None,
            "n_unique_layers": tables.n_unique_layers if tables else None,
        },
        "layers": layers,
    }
    if mode == "train":
        report["total_fwd_latency_s"] = sum(
            c.fwd_latency_s for c in res.choices)
        report["total_bwd_latency_s"] = sum(
            c.bwd_latency_s for c in res.choices)
        report["total_update_latency_s"] = sum(
            c.update_latency_s for c in res.choices)
    if decode_seconds is not None:
        # phase decomposition of the winning serving configuration:
        # total objective = prefill + (gen/slots) * decode per admission
        keys = [(c.layer, c.path_index, c.partitioning, c.dataflow)
                for c in res.choices]
        report["serving"] = {
            "prefill_tokens": tokens,
            "decode_tokens": dec_tokens,
            "gen_tokens": serve_gen,
            "n_slots": serve_slots,
            "decode_weight": serve_gen / serve_slots,
            # True when the combined table was measured-calibrated per
            # phase (--tune with --objective throughput); the analytic
            # phase split below stays in analytic seconds either way
            "calibrated": calibration is not None,
            "total_prefill_s": sum(seconds_table[k] for k in keys),
            "total_decode_step_s": sum(decode_seconds[k] for k in keys),
            "total_combined_s": res.total_latency_s,
        }
    return (report, named, res,
            (res.hw if res.hw is not None else hw_cfg), tuner, calibration)


def _run_rank_dse(
    arch: str,
    hw: str,
    top_k: int,
    tokens: Optional[int],
    smoke: bool,
    engine: str,
    hw_search: str,
    hw_budget: Optional[int],
    search: str,
    search_budget: Optional[int],
    search_seed: int,
    accuracy_budget: Optional[float],
):
    """The ``--rank-search budget`` pipeline (``repro_torch.rank``).

    Evaluates every decomposition candidate through the same cost-table
    /argmin stack as :func:`_run_dse` and reports the chosen candidate's
    per-layer choices plus a ``rank_search`` frontier section.  Same
    return contract as ``_run_dse`` — ``run_dse_plan`` compiles the
    chosen candidate's networks/choices into a (v4) plan.
    """
    from repro_torch.rank import rank_search as _rank_search

    hw_cfg = get_target(hw)
    hw_space = None
    space = None
    n_space = 1
    if hw_search == "budget":
        space = ArchSpace(base=hw_cfg, mac_budget=hw_budget)
        hw_space = space.candidates()
        n_space = len(hw_space)

    t0 = time.perf_counter()
    rres = _rank_search(
        arch, hw_cfg, top_k=top_k, tokens=tokens, smoke=smoke,
        hw_space=hw_space, search=search, search_budget=search_budget,
        search_seed=search_seed, accuracy_budget=accuracy_budget)
    rank_search_s = time.perf_counter() - t0

    ce = rres.chosen_eval
    named, res = ce.named, ce.res
    plan_hw = res.hw if res.hw is not None else hw_cfg

    # rebuild the chosen candidate's analytic table for the per-layer
    # report (under --hw-search: on its winning architecture)
    t0 = time.perf_counter()
    layer_paths = model_layer_paths(named, top_k)
    path_search_s = time.perf_counter() - t0
    if hw_search == "budget":
        from repro_torch.core import build_cost_tables_hw

        tables = build_cost_tables_hw(layer_paths, (plan_hw,),
                                      ALL_PARTITIONINGS)[0]
    else:
        tables = build_cost_tables(layer_paths, hw_cfg, ALL_PARTITIONINGS)
    seconds_table = tables.seconds
    hw_search_report = (_hw_search_report(space, res, hw_cfg, n_space)
                        if hw_search == "budget" else None)

    layers = []
    total_latency = 0.0
    for (name, _), choice in zip(named, res.choices):
        key = (choice.layer, choice.path_index, choice.partitioning,
               choice.dataflow)
        latency_s = seconds_table[key]
        total_latency += latency_s
        layers.append({
            "name": name,
            "path_index": choice.path_index,
            "mac_optimal_path": choice.path_index == 0,
            "macs": choice.path.macs,
            "partitioning": list(choice.partitioning),
            "dataflow": choice.dataflow.value,
            "latency_s": latency_s,
            "objective": choice.latency_s,
        })

    def cand_row(i: int) -> dict:
        e = rres.evals[i]
        c = e.candidate
        return {
            "name": c.name,
            "d": c.d,
            "rank": c.rank,
            "n_params": c.n_params,
            "compression": c.compression,
            "accuracy_proxy": e.accuracy_proxy,
            "total_latency_s": e.total_latency_s,
            "strategy": e.res.strategy,
            "on_frontier": i in rres.frontier,
            "eval_seconds": e.eval_seconds,
        }

    rows = [cand_row(i) for i in range(len(rres.evals))]
    chosen_row = dict(rows[rres.chosen])
    chosen_row["families"] = [
        {
            "name": f.name,
            "out_modes": list(f.out_modes),
            "in_modes": list(f.in_modes),
            "ranks": list(f.ranks),
            "instances": f.instances,
            "accuracy_proxy": ce.family_proxies[f.name],
        }
        for f in ce.candidate.families
    ]
    rank_report = {
        "mode": "budget",
        "accuracy_budget": accuracy_budget,
        "param_budget_ratio": rres.param_budget_ratio,
        "n_candidates": len(rres.evals),
        "frontier": [rres.evals[i].candidate.name for i in rres.frontier],
        "chosen": chosen_row,
        "frozen": rows[rres.frozen],
        "dominates_frozen": rres.dominates_frozen,
        "improvement_pct": rres.improvement_pct,
        # vision decompositions are structural (TT-conv) — their rank
        # rides in the networks, not in an installable plan
        "plan_embeddable": arch not in VISION_ARCHS,
        "rank_search_s": rank_search_s,
        "candidates": sorted(
            rows, key=lambda r: (r["total_latency_s"], r["name"])),
    }

    report = {
        "arch": arch,
        "hw": hw,
        "hw_chosen": res.hw.name if res.hw is not None else hw,
        "hw_search": hw_search_report,
        "tune": None,
        "mode": "infer",
        "objective": "latency",
        "top_k": top_k,
        "tokens": rres.tokens,
        "engine": engine,
        "strategy": res.strategy,
        "total_latency_s": total_latency,
        "total_objective": res.total_latency_s,
        "search": {
            "mode": res.search,
            "budget": search_budget,
            "seed": search_seed if search == "guided" else None,
            "evals": sum(e.res.evals for e in rres.evals),
            "found_at_eval": res.found_at_eval,
            # per-candidate table sizes differ; scale the chosen
            # candidate's cell count by the candidate count
            "exhaustive_evals": (n_space * len(rres.evals)
                                 * _table_cells(layer_paths,
                                                ALL_PARTITIONINGS)),
        },
        "rank_search": rank_report,
        "n_layers": len(layers),
        "timings": {
            "path_search_s": path_search_s,
            "table_build_s": tables.build_seconds,
            "argmin_s": rank_search_s,
            "rank_search_s": rank_search_s,
        },
        "table": {
            "n_cells": len(seconds_table),
            "n_unique_gemm_evals": tables.n_unique_gemm_evals,
            "n_unique_layers": tables.n_unique_layers,
        },
        "layers": layers,
    }
    return report, named, res, plan_hw, None, None


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.dse",
        description="Global latency/EDP-driven DSE (paper Algorithm 1).",
    )
    p.add_argument("--arch", help="named config (see --list-archs)")
    p.add_argument("--hw", default="fpga_vu9p",
                   help="hardware target name (see --list-hw; "
                        "default fpga_vu9p)")
    p.add_argument("--hw-search", default="off", choices=HW_SEARCH_MODES,
                   help="off: fixed --hw target (default); budget: joint "
                        "(architecture, path, dataflow) co-search over the "
                        "feasible variants of --hw under a MAC/DSP budget "
                        "(repro_torch.hw.ArchSpace); the report gains a "
                        "per-candidate hw_search section and --emit-plan "
                        "embeds the winning architecture (plan v3)")
    p.add_argument("--hw-budget", type=int, default=None, metavar="MACS",
                   help="MAC/DSP budget for --hw-search budget "
                        "(default: the base target's own PE count)")
    p.add_argument("--search", default="exhaustive", choices=SEARCH_MODES,
                   help="exhaustive: Algorithm 1's full sweep, optimal over "
                        "the pruned space (default); guided: the budgeted "
                        "evolutionary explorer (repro_torch.search) over the "
                        "same "
                        "cost tables — exact per visited architecture, "
                        "bounded by --search-budget evaluations; the report "
                        "gains a search provenance section")
    p.add_argument("--search-budget", type=int, default=None, metavar="N",
                   help="evaluation budget for --search guided, in cost-"
                        "table cells read (default: the full table for a "
                        "fixed target, 25%% of the exhaustive count under "
                        "--hw-search)")
    p.add_argument("--search-seed", type=int, default=0, metavar="SEED",
                   help="RNG seed of the guided proposal stream (same seed "
                        "-> bit-identical result; default 0)")
    p.add_argument("--rank-search", default="off", choices=RANK_SEARCH_MODES,
                   help="off: frozen TT decomposition (default); budget: "
                        "search the decomposition (modes-per-side x rank "
                        "ladder per projection family, repro_torch.rank) "
                        "jointly "
                        "with the mapping axes under a parameter budget — "
                        "the report gains a rank_search frontier section "
                        "and --emit-plan embeds the chosen factorizations "
                        "(plan v4)")
    p.add_argument("--accuracy-budget", type=float, default=None,
                   metavar="EPS",
                   help="cap the chosen candidate's accuracy proxy "
                        "(relative TT-SVD reconstruction error) at EPS "
                        "(default: no worse than the frozen decomposition; "
                        "requires --rank-search budget)")
    p.add_argument("--top-k", type=int, default=4, metavar="K",
                   help="candidate paths kept per layer (default 4)")
    p.add_argument("--objective", default="latency", choices=OBJECTIVES,
                   help="latency: single-pass latency (default); edp: "
                        "energy-delay product; throughput: serving tokens/s "
                        "under sustained continuous-batching load — per "
                        "layer, prefill latency at --tokens plus "
                        "(--serve-gen / --serve-slots) decode steps at "
                        "--decode-tokens (one compromise plan; for a "
                        "per-phase pair see --emit-plan-pair)")
    p.add_argument("--serve-gen", type=int, default=128, metavar="N",
                   help="throughput objective: generated tokens per request "
                        "(default 128)")
    p.add_argument("--serve-slots", type=int, default=8, metavar="N",
                   help="throughput objective: fixed decode batch width "
                        "(default 8)")
    p.add_argument("--decode-tokens", type=int, default=None, metavar="N",
                   help="streamed tokens of one decode step for the "
                        "throughput objective / the decode leg of "
                        "--emit-plan-pair (default: --serve-slots)")
    p.add_argument("--mode", default="infer", choices=MODES,
                   help="infer: forward-only DSE (default); train: joint "
                        "fwd+bwd+update search (per-layer decomposition in "
                        "the report, --emit-plan writes schema v2 with "
                        "backward entries); both: run both and report the "
                        "divergent layer choices")
    p.add_argument("--fused-cost", action="store_true",
                   help="fusion-aware cost tables: re-cost fuseable "
                        "(1,1)-partitioned paths with the fused-segment "
                        "accounting (interior intermediates charge zero "
                        "HBM traffic, one launch overhead per chain run) "
                        "so the argmin can prefer paths that segment well; "
                        "with --tune the fused advantage is additionally "
                        "measured per layer (infer mode, fixed target, "
                        "latency/EDP objectives, exhaustive search)")
    p.add_argument("--tokens", type=int, default=None,
                   help="streamed tokens per projection (default 1024; "
                        "vision archs: im2col batch, default 1)")
    p.add_argument("--shards", type=int, default=None, metavar="N",
                   help="search per-shard problems for an N-way token-"
                        "parallel mesh: each projection is costed at "
                        "--tokens/N streamed tokens and emitted plans carry "
                        "sharding provenance (default: installed sharding "
                        "rules, else 1)")
    p.add_argument("--smoke", action="store_true",
                   help="use the config's reduced SMOKE variant")
    p.add_argument("--engine", default="vectorized",
                   choices=("vectorized", "scalar"),
                   help="cost-table engine (scalar = per-cell oracle)")
    p.add_argument("--tune", default="off", choices=TUNE_MODES,
                   help="off: analytic search (default); cache/measure: "
                        "measure dominant GEMM shapes per dataflow on this "
                        "machine (cache = only cache misses, measure = "
                        "re-measure), rescale the analytic table by the "
                        "measured calibration before the argmin, and give "
                        "--emit-plan measured kernel tilings "
                        "(repro_torch.tune; warm the cache with "
                        "python -m repro_torch.tune)")
    p.add_argument("--tune-cache", default=None, metavar="PATH",
                   help="tuning-cache file for --tune "
                        "(default results/tuning_cache.json)")
    p.add_argument("--device", default="cuda",
                   help="torch device the --tune measurements run on "
                        "(default cuda; cpu times the plain versions of "
                        "the kernels)")
    p.add_argument("--out", default="-", metavar="PATH",
                   help="report destination ('-' = stdout, default)")
    p.add_argument("--emit-plan", default=None, metavar="PATH",
                   help="compile the result into an executable plan "
                        "(docs/plan_format.md) and write it to PATH")
    p.add_argument("--phase", default=None, choices=("prefill", "decode"),
                   help="stamp the --emit-plan plan as one half of a "
                        "serving plan pair (the serve driver refuses to "
                        "install it as the other half)")
    p.add_argument("--emit-plan-pair", default=None, metavar="PREFIX",
                   help="run two searches — prefill at --tokens, decode at "
                        "--decode-tokens — and write the phase-stamped pair "
                        "to PREFIX.prefill.json / PREFIX.decode.json "
                        "(serve with --plan-prefill/--plan-decode)")
    p.add_argument("--plan-backend", default="auto",
                   choices=("auto", "jnp", "tt_gemm", "streaming_tt"),
                   help="force one kernel backend for every emitted layer "
                        "plan (default: per-layer heuristic)")
    p.add_argument("--list-archs", action="store_true",
                   help="print supported --arch values and exit")
    p.add_argument("--list-hw", action="store_true",
                   help="print registered --hw targets and exit")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_archs:
        for a in ("tt-lm-100m",) + tuple(ARCH_IDS) + VISION_ARCHS:
            print(a)
        return 0
    if args.list_hw:
        for name in list_targets():
            print(name)
        return 0
    if not args.arch:
        _build_parser().error("--arch is required (see --list-archs)")
    if args.plan_backend != "auto" and not (args.emit_plan
                                            or args.emit_plan_pair):
        _build_parser().error(
            "--plan-backend requires --emit-plan or --emit-plan-pair")
    if args.phase and not args.emit_plan:
        _build_parser().error("--phase requires --emit-plan "
                              "(--emit-plan-pair stamps both phases itself)")
    if args.emit_plan_pair:
        if args.emit_plan:
            _build_parser().error(
                "--emit-plan-pair and --emit-plan are mutually exclusive")
        if args.objective == "throughput":
            _build_parser().error(
                "--objective throughput emits one compromise plan via "
                "--emit-plan; --emit-plan-pair optimizes each phase "
                "separately (pick one)")
        if args.mode != "infer":
            _build_parser().error(
                "--emit-plan-pair compiles serving (inference) plans; "
                f"--mode {args.mode} is not applicable")
        if args.hw_search != "off":
            _build_parser().error(
                "--emit-plan-pair compiles a pair for one fixed --hw "
                "target; co-searching a different architecture per phase "
                "is unservable in one engine")
    if args.hw_budget is not None and args.hw_search == "off":
        _build_parser().error("--hw-budget requires --hw-search budget")
    if args.search_budget is not None and args.search != "guided":
        _build_parser().error("--search-budget requires --search guided")
    if args.tune_cache is not None and args.tune == "off":
        _build_parser().error("--tune-cache requires --tune cache|measure")
    if args.accuracy_budget is not None and args.rank_search == "off":
        _build_parser().error("--accuracy-budget requires --rank-search "
                              "budget")
    if args.rank_search != "off" and args.emit_plan_pair:
        _build_parser().error(
            "--rank-search with --emit-plan-pair would search a different "
            "decomposition per phase; factorizations set parameter shapes, "
            "so a serving pair must share one (use --emit-plan)")
    try:
        if args.emit_plan_pair:
            common = dict(
                arch=args.arch, hw=args.hw, top_k=args.top_k,
                objective=args.objective, smoke=args.smoke,
                engine=args.engine, plan_backend=args.plan_backend,
                mode="infer", tune=args.tune, tune_cache=args.tune_cache,
                search=args.search, search_budget=args.search_budget,
                search_seed=args.search_seed, shards=args.shards,
                fused_cost=args.fused_cost, device=args.device,
            )
            dec_tokens = (args.decode_tokens if args.decode_tokens is not None
                          else args.serve_slots)
            report_p, plan_p = run_dse_plan(
                tokens=args.tokens, phase="prefill", **common)
            report_d, plan_d = run_dse_plan(
                tokens=dec_tokens, phase="decode", **common)
            for plan, path in ((plan_p, f"{args.emit_plan_pair}.prefill.json"),
                               (plan_d, f"{args.emit_plan_pair}.decode.json")):
                plan.save(path)
                backends = sorted({lp.backend for lp in plan.layers})
                print(f"wrote {plan.phase} plan {path} "
                      f"({len(plan.layers)} layer plans, backends {backends}"
                      f", tokens {plan.tokens}, tilings {plan.tilings})",
                      file=sys.stderr)
            report = {
                "arch": args.arch, "hw": args.hw, "mode": "plan-pair",
                "prefill": report_p, "decode": report_d,
            }
        elif args.emit_plan:
            report, plan = run_dse_plan(
                arch=args.arch,
                hw=args.hw,
                top_k=args.top_k,
                objective=args.objective,
                tokens=args.tokens,
                smoke=args.smoke,
                engine=args.engine,
                plan_backend=args.plan_backend,
                mode=args.mode,
                hw_search=args.hw_search,
                hw_budget=args.hw_budget,
                tune=args.tune,
                tune_cache=args.tune_cache,
                serve_gen=args.serve_gen,
                serve_slots=args.serve_slots,
                decode_tokens=args.decode_tokens,
                phase=args.phase or "",
                search=args.search,
                search_budget=args.search_budget,
                search_seed=args.search_seed,
                rank_search=args.rank_search,
                accuracy_budget=args.accuracy_budget,
                shards=args.shards,
                fused_cost=args.fused_cost,
                device=args.device,
            )
            plan.save(args.emit_plan)
            backends = sorted({lp.backend for lp in plan.layers})
            hw_note = (f", hardware {plan.hardware.name}"
                       if plan.hardware is not None else "")
            print(f"wrote plan {args.emit_plan} "
                  f"({len(plan.layers)} layer plans, backends {backends}"
                  f"{hw_note}, tilings {plan.tilings})",
                  file=sys.stderr)
        else:
            report = run_dse(
                arch=args.arch,
                hw=args.hw,
                top_k=args.top_k,
                objective=args.objective,
                tokens=args.tokens,
                smoke=args.smoke,
                engine=args.engine,
                mode=args.mode,
                hw_search=args.hw_search,
                hw_budget=args.hw_budget,
                tune=args.tune,
                tune_cache=args.tune_cache,
                serve_gen=args.serve_gen,
                serve_slots=args.serve_slots,
                decode_tokens=args.decode_tokens,
                search=args.search,
                search_budget=args.search_budget,
                search_seed=args.search_seed,
                rank_search=args.rank_search,
                accuracy_budget=args.accuracy_budget,
                shards=args.shards,
                fused_cost=args.fused_cost,
                device=args.device,
            )
    except (KeyError, ValueError) as e:
        msg = e.args[0] if e.args else e
        print(f"error: {msg}", file=sys.stderr)
        return 2
    text = json.dumps(report, indent=2)
    if args.out == "-":
        print(text)
    else:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
