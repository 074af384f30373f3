"""DSEResult -> ExecutionPlan compiler (the "deploy" half of Algorithm 1).

Framework-neutral copy of ``src/repro/plan/compiler.py`` (the port never imports
the JAX package).

The DSE emits per-layer-*instance* choices; the model executes repeated
blocks under one scanned trace.  The compiler therefore:

1. collapses instances (``attn.wq[0]``..``attn.wq[L-1]``) to one
   :class:`LayerPlan` per projection family — lossless, because identical
   tensor networks produce identical cost-table rows and argmins;
2. picks the kernel **backend** per layer:
   - ``streaming_tt`` when the whole contraction fits the VMEM budget at
     the plan's token-block size (cores pinned, activations streamed, no
     intermediate spills) — the fused in-VMEM chain of paper §4.2;
   - ``tt_gemm`` otherwise, lowering every pairwise contraction of the
     path to the dataflow-configurable Pallas GEMM;
   - ``jnp`` when the layer's GEMMs are too small for kernel tiling to
     pay off (and always available as the reference fallback);
3. derives the **tiling** from the path's dominant GEMM — and, for
   *co-searched* results, from the winning architecture: ``block_m``/
   ``block_n`` are capped by the searched array shape (R rows stream M,
   C columns stream N), ``block_k`` by its longer side, and the
   streaming backend's VMEM budget by the searched on-chip buffer
   capacity, so a plan emitted under ``--hw-search`` tiles for the
   architecture that won.  Fixed-target results keep the MXU-aligned
   default caps: the cost-model target (e.g. the FPGA) is *not* the
   execution substrate, and shrinking TPU Pallas blocks to an FPGA's
   32x32 array would only multiply grid steps.

Core partitioning (``1x2``/``2x1``) is an FPGA half-core construct with
no TPU kernel realization; it is recorded verbatim for provenance and for
the analytic latency numbers, but does not affect backend routing.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping, Optional, Sequence

from repro_torch.core import fusion
from repro_torch.core.backward import backward_networks
from repro_torch.core.dse import DSEResult, LayerChoice
from repro_torch.core.paths import CandidatePath
from repro_torch.core.simulator import HardwareConfig
from repro_torch.core.tensor_network import Node, TensorNetwork

from .schema import (
    BACKENDS,
    PHASES,
    TILING_MODES,
    BackwardOp,
    ExecutionPlan,
    Factorization,
    LayerPlan,
    PlanSharding,
    Tiling,
)

#: conservative VMEM ceiling for the streaming backend (half a v5e core's
#: 16 MiB VMEM, leaving headroom for double-buffering the token blocks);
#: the effective budget is the min of this and the plan architecture's
#: on-chip buffer capacity (:func:`_streaming_budget`)
VMEM_BUDGET_BYTES = 8 * 2**20

#: below this many MACs in the dominant GEMM, kernel dispatch overhead
#: dominates and the plan keeps the pure-jnp executor
MIN_KERNEL_MACS = 1 << 16

#: fallback tiling caps when no architecture is supplied (MXU-aligned)
_DEFAULT_BLOCK_CAP = 128


def _streaming_budget(hw: Optional[HardwareConfig]) -> int:
    """VMEM budget for the streaming backend under ``hw``'s buffers."""
    if hw is None:
        return VMEM_BUDGET_BYTES
    return min(VMEM_BUDGET_BYTES,
               hw.sram_input_bytes + hw.sram_output_bytes)

_INSTANCE_RE = re.compile(r"\[\d+\]$")


def base_name(instance_name: str) -> str:
    """``attn.wq[3]`` -> ``attn.wq`` (DSE instance -> projection family)."""
    return _INSTANCE_RE.sub("", instance_name)


def _pow2_le(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _input_node(tn: TensorNetwork) -> Node:
    return next(n for n in tn.nodes if n.kind == "input")


def batch_dim(tn: TensorNetwork) -> int:
    """The streamed (batch) extent of a layer network.

    The batch dims are exactly the input node's *free* edges — the mode
    edges are all shared with cores.  Works for TT-linear networks (edge
    ``b``, or ``b0``/``b1`` split; leading) and TT-conv networks (patch
    edge ``l``; trailing).
    """
    x = _input_node(tn)
    free = set(tn.free_edges)
    return math.prod(d for e, d in zip(x.edges, x.dims) if e in free)


def rebatch(tn: TensorNetwork, tokens: int) -> TensorNetwork:
    """Rebind the input node's batch (free) edges to ``tokens`` total."""
    x = _input_node(tn)
    free = set(tn.free_edges)
    dims, first = [], True
    for e, d in zip(x.edges, x.dims):
        if e in free:
            dims.append(tokens if first else 1)
            first = False
        else:
            dims.append(d)
    nodes = [Node(n.name, n.edges, tuple(dims), n.kind)
             if n.name == x.name else n for n in tn.nodes]
    return TensorNetwork(nodes)


def _peak_live_elements(tn: TensorNetwork, steps) -> int:
    """Max total elements live at any point while replaying ``steps``."""
    peak = sum(n.size for n in tn.nodes)
    cur = tn
    for (i, j) in steps:
        cur, _ = cur.contract_pair(i, j)
        peak = max(peak, sum(n.size for n in cur.nodes))
    return peak


def streaming_fits(
    tn: TensorNetwork,
    steps,
    block_tokens: int,
    *,
    bytes_per_elem: int = 4,
    budget_bytes: int = VMEM_BUDGET_BYTES,
) -> bool:
    """Whether the full contraction of one token block stays in VMEM."""
    block = rebatch(tn, block_tokens)
    return _peak_live_elements(block, steps) * bytes_per_elem <= budget_bytes


def default_blocks(
    M: int, K: int, N: int,
    cap_m: int = _DEFAULT_BLOCK_CAP,
    cap_k: Optional[int] = None,
    cap_n: int = _DEFAULT_BLOCK_CAP,
) -> tuple[int, int, int]:
    """The heuristic ``(block_m, block_k, block_n)`` for one GEMM shape.

    Shared with the autotuner (``repro_torch.tune.heuristic_blocks``), which
    measures its calibration at exactly this operating point — the
    tiling the analytic argmin would deploy.
    """
    cap_k = max(cap_m, cap_n) if cap_k is None else cap_k
    return (max(8, _pow2_le(min(cap_m, M))),
            max(8, _pow2_le(min(cap_k, K))),
            max(8, _pow2_le(min(cap_n, N))))


def _tiling_for_path(
    path: CandidatePath, tokens: int, hw: Optional[HardwareConfig] = None
) -> Tiling:
    """Blocks from the path's dominant (highest-MAC) GEMM, capped by the
    architecture's array shape: R rows stream the M dimension, C columns
    the N dimension, and the reduction tile by the longer side."""
    cap_m = hw.pe_rows if hw is not None else _DEFAULT_BLOCK_CAP
    cap_n = hw.pe_cols if hw is not None else _DEFAULT_BLOCK_CAP
    g = max(path.gemms, key=lambda g: g.macs)
    bm, bk, bn = default_blocks(g.M, g.K, g.N, cap_m=cap_m, cap_n=cap_n)
    return Tiling(
        block_m=bm,
        block_k=bk,
        block_n=bn,
        block_tokens=max(8, _pow2_le(min(256, tokens))),
    )


def choose_tiling(
    choice: LayerChoice, tokens: int, hw: Optional[HardwareConfig] = None
) -> Tiling:
    return _tiling_for_path(choice.path, tokens, hw)


def _measured_tiling(
    tn: TensorNetwork,
    choice: LayerChoice,
    heuristic: Tiling,
    backend: str,
    tokens: int,
    tuner,
    hw: Optional[HardwareConfig],
) -> Tiling:
    """Replace the heuristic tiling by the autotuner's measured argmin.

    The heuristic is injected into every sweep, so the measured tiling
    can tie it but never lose to it (on the machine doing the tuning).
    ``tt_gemm`` layers tune the dominant GEMM's ``block_m/k/n`` under
    the plan's dataflow; ``streaming_tt`` layers sweep ``block_tokens``
    within the same VMEM budget the backend choice assumed; ``jnp``
    layers (and streaming networks the kernel layout cannot express)
    keep the heuristic.
    """
    if backend == "tt_gemm":
        g = max(choice.path.gemms, key=lambda g: g.macs)
        bm, bk, bn = tuner.tune_gemm(
            int(g.M), int(g.K), int(g.N), choice.dataflow.value,
            include=[(heuristic.block_m, heuristic.block_k,
                      heuristic.block_n)])
        return dataclasses.replace(heuristic, block_m=bm, block_k=bk,
                                   block_n=bn)
    if backend == "streaming_tt":
        bt = tuner.tune_streaming(
            tn, choice.path.steps, tokens,
            include=[heuristic.block_tokens],
            budget_bytes=_streaming_budget(hw))
        if bt is not None:
            return dataclasses.replace(heuristic, block_tokens=bt)
    return heuristic


def choose_segments(
    tn: TensorNetwork,
    steps,
    tiling: Tiling,
    hw: Optional[HardwareConfig] = None,
) -> Optional[tuple[tuple[int, int], ...]]:
    """Fusion segmentation for a ``tt_gemm`` layer (``None`` = nothing fuses).

    Greedy maximal chain runs (``repro_torch.core.fusion.segment_path``) under
    the same on-chip budget the streaming backend gets
    (:func:`_streaming_budget`), at the plan's token-block size.  The
    plan only records segments when at least one run spans >= 2 steps —
    an all-singleton segmentation is the absent-on-wire default, so
    pre-fusion plans and unfusable paths serialize identically.
    """
    segs = fusion.segment_path(
        tn, tuple(tuple(s) for s in steps),
        block_tokens=tiling.block_tokens,
        budget_bytes=_streaming_budget(hw))
    return segs if fusion.has_fused(segs) else None


def choose_backend(
    tn: TensorNetwork,
    choice: LayerChoice,
    tiling: Tiling,
    hw: Optional[HardwareConfig] = None,
) -> str:
    if max(g.macs for g in choice.path.gemms) < MIN_KERNEL_MACS:
        return "jnp"
    if streaming_fits(tn, choice.path.steps, tiling.block_tokens,
                      budget_bytes=_streaming_budget(hw)):
        return "streaming_tt"
    return "tt_gemm"


def _choose_bwd_backend(
    wrt: str,
    net: TensorNetwork,
    path: CandidatePath,
    tiling: Tiling,
    hw: Optional[HardwareConfig] = None,
) -> str:
    """Backend heuristic for one backward contraction.

    Mirrors the forward heuristic; only the single-streamed-operand dx
    gradient qualifies for the streaming kernel (weight gradients stream
    both X and dY).
    """
    if max(g.macs for g in path.gemms) < MIN_KERNEL_MACS:
        return "jnp"
    if wrt == "dx" and streaming_fits(net, path.steps, tiling.block_tokens,
                                      budget_bytes=_streaming_budget(hw)):
        return "streaming_tt"
    return "tt_gemm"


def _cached_bwd_tiling(
    net: TensorNetwork,
    ch,
    tiling: Tiling,
    be: str,
    dataflow: str,
    tokens: int,
    tuner,
) -> Tiling:
    """Measured backward-op tiling from the tuner's cache *only*.

    Train-mode plans may reuse measurements the forward sweeps already
    deposited (the cache is keyed by GEMM problem, not by direction), but
    backward ops never trigger new measurements — a cache miss keeps the
    analytic heuristic.
    """
    if be == "tt_gemm":
        g = max(ch.path.gemms, key=lambda g: g.macs)
        blocks = tuner.cached_gemm_blocks(int(g.M), int(g.K), int(g.N),
                                          dataflow)
        if blocks is not None:
            bm, bk, bn = blocks
            return dataclasses.replace(tiling, block_m=bm, block_k=bk,
                                       block_n=bn)
    elif be == "streaming_tt":
        bt = tuner.cached_streaming_tokens(net, ch.path.steps, tokens)
        if bt is not None:
            return dataclasses.replace(tiling, block_tokens=bt)
    return tiling


def _compile_backward(
    tn: TensorNetwork,
    choice: LayerChoice,
    tokens: int,
    backend: str,
    hw: Optional[HardwareConfig] = None,
    *,
    tilings: str = "heuristic",
    tuner=None,
) -> tuple[BackwardOp, ...]:
    """BackwardOps from a train-DSE choice (empty for inference results)."""
    if not choice.backward:
        return ()
    nets = dict(backward_networks(tn))
    ops = []
    for ch in choice.backward:
        net = nets[ch.wrt]
        tiling = _tiling_for_path(ch.path, tokens or batch_dim(tn), hw)
        if backend == "auto":
            be = _choose_bwd_backend(ch.wrt, net, ch.path, tiling, hw)
        elif backend == "streaming_tt" and ch.wrt != "dx":
            be = "tt_gemm"  # weight grads cannot stream; closest kernel
        else:
            be = backend
        if tilings == "measured" and tuner is not None:
            tiling = _cached_bwd_tiling(net, ch, tiling, be,
                                        choice.dataflow.value,
                                        tokens or batch_dim(tn), tuner)
        ops.append(BackwardOp(
            wrt=ch.wrt,
            path_index=ch.path_index,
            path_steps=tuple(tuple(s) for s in ch.path.steps),
            backend=be,
            tiling=tiling,
        ))
    return tuple(ops)


def _steps_in_range(n_nodes: int, steps) -> bool:
    """Replay current-index bookkeeping: every (i, j) must name two
    distinct live nodes (the merged node is appended, shrinking the list
    by one per step)."""
    n = n_nodes
    for (i, j) in steps:
        if i == j or not (0 <= i < n and 0 <= j < n):
            return False
        n -= 1
    return n == 1


def _model_dims(tn: TensorNetwork) -> tuple[int, int]:
    """(d_in, d_out) of the projection a TT-linear network computes.

    The input node's *shared* edges are the input modes (their product is
    ``d_in``), and the free edges of the core nodes are the output modes
    (their product is ``d_out``).  Both products are invariant under
    re-factorization, so they identify the projection regardless of which
    decomposition the network was built with.
    """
    x = _input_node(tn)
    free = set(tn.free_edges)
    d_in = math.prod(d for e, d in zip(x.edges, x.dims) if e not in free)
    d_out = math.prod(d for n in tn.nodes if n.kind != "input"
                      for e, d in zip(n.edges, n.dims) if e in free)
    return d_in, d_out


def validate_plan(
    plan,
    named_layers: Sequence[tuple[str, TensorNetwork]],
) -> list[str]:
    """Structural compatibility of a plan with a model's layer networks.

    Returns human-readable problem strings (empty = compatible): a plan
    layer whose step count cannot contract the model's network (emitted
    for a different TT geometry / smoke setting), a v4 factorization
    whose modes do not factor the model's projection dims, or a plan
    that matches no projection at all.  Called by the serve/train
    drivers before installing — a mismatched plan should fail loudly,
    not replay bogus steps deep inside tracing.

    Layers carrying a v4 ``factorization`` are checked against the
    geometry the plan *itself* prescribes (the installed plan overrides
    the model's default decomposition, so the model network's node count
    is not the reference for them — only its projection dims are).
    """
    families: dict[str, TensorNetwork] = {}
    for inst_name, tn in named_layers:
        families.setdefault(base_name(inst_name), tn)
    problems = []
    matched = 0
    for lp in plan.layers:
        tn = families.get(lp.name)
        if tn is None:
            continue  # plans may cover projections this model lacks
        matched += 1
        if lp.factorization is not None:
            f = lp.factorization
            d_in, d_out = _model_dims(tn)
            if (math.prod(f.in_modes) != d_in
                    or math.prod(f.out_modes) != d_out):
                problems.append(
                    f"{lp.name}: plan factorization "
                    f"{list(f.out_modes)}x{list(f.in_modes)} does not factor "
                    f"the model's {d_out}x{d_in} projection "
                    "(plan emitted for a different arch or smoke setting?)")
                continue
            # the factorized network: one node per core plus the input
            want_nodes = len(f.out_modes) + len(f.in_modes) + 1
        else:
            want_nodes = len(tn.nodes)
        if not lp.path_steps:
            if lp.backend == "jnp":
                continue  # index-only entry: steps resolve at trace time
            problems.append(
                f"{lp.name}: backend {lp.backend!r} requires path_steps "
                "(only jnp entries may be index-only)")
            continue
        if len(lp.path_steps) != want_nodes - 1:
            problems.append(
                f"{lp.name}: plan has {len(lp.path_steps)} contraction steps "
                f"but the model's network needs {want_nodes - 1} "
                "(plan emitted for a different TT geometry or smoke setting?)")
        elif not _steps_in_range(want_nodes, lp.path_steps):
            problems.append(
                f"{lp.name}: plan step indices {list(map(list, lp.path_steps))} "
                "do not describe a valid pairwise contraction of "
                f"{want_nodes} nodes (corrupted or hand-edited plan?)")
        if (lp.segments is not None and fusion.has_fused(lp.segments)
                and len(lp.path_steps) == len(tn.nodes) - 1
                and _steps_in_range(len(tn.nodes), lp.path_steps)):
            problems.extend(
                f"{lp.name}: {p}"
                for p in fusion.chain_problems(tn, lp.path_steps,
                                               lp.segments))
        if lp.backward and lp.factorization is None:
            want = {"dx"} | {n.name for n in tn.nodes if n.kind != "input"}
            got = {op.wrt for op in lp.backward}
            if got != want:
                problems.append(
                    f"{lp.name}: backward entries cover {sorted(got)} but "
                    f"the layer's gradients are {sorted(want)} "
                    "(hand-edited or geometry-mismatched plan?)")
        # every backward network of a TT layer has the same node count as
        # the forward (one node swapped for / replaced by dY), so the same
        # step-count check applies
        for op in lp.backward:
            if len(op.path_steps) != want_nodes - 1:
                problems.append(
                    f"{lp.name}: backward[{op.wrt}] has {len(op.path_steps)} "
                    f"steps but the gradient network needs "
                    f"{want_nodes - 1}")
            elif not _steps_in_range(want_nodes, op.path_steps):
                problems.append(
                    f"{lp.name}: backward[{op.wrt}] step indices are not a "
                    f"valid pairwise contraction of {want_nodes} nodes")
    if matched == 0:
        problems.append(
            "plan matches no tensorized projection of this model "
            f"(plan layers: {sorted(lp.name for lp in plan.layers)})")
    return problems


def check_plan_for_config(plan, arch: str, cfg,
                          *, phase: Optional[str] = None) -> list[str]:
    """Driver-side guard: is ``plan`` installable for (arch, cfg)?

    Combines the arch provenance check with :func:`validate_plan` over
    the model's actual tensorized projections.  LLM layer names collide
    across architectures (every transformer has an ``attn.wq``), so name
    matching alone would let a foreign plan install silently.

    ``phase`` additionally asserts the plan's serving-phase hint: a plan
    stamped ``"decode"`` installed as the prefill half of a pair (or vice
    versa) is flagged.  Phase-agnostic plans (``phase == ""``) install
    under any phase.
    """
    problems = []
    if plan.arch and plan.arch != arch:
        problems.append(
            f"plan was emitted for arch {plan.arch!r}, not {arch!r}")
    if phase is not None:
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}; have {PHASES}")
        if plan.phase and phase and plan.phase != phase:
            problems.append(
                f"plan is a {plan.phase} plan but would install as the "
                f"{phase} half of the pair (swapped --plan-prefill/"
                "--plan-decode?)")
    from repro_torch.dse_cli import model_dse_layers

    # a v4 plan's factorizations define the networks it executes over —
    # rebuild the model's problems under them so path/step validation
    # runs against the decomposition the plan was actually compiled for
    fact = {lp.name: lp.factorization.triple
            for lp in plan.layers if lp.factorization is not None}
    try:
        named = model_dse_layers(cfg, tokens=8,
                                 factorizations=fact or None)
    except ValueError as e:
        problems.append(str(e.args[0] if e.args else e))
        return problems
    problems.extend(validate_plan(plan, named))
    return problems


def compile_plan(
    named_layers: Sequence[tuple[str, TensorNetwork]],
    result: DSEResult,
    hw: HardwareConfig,
    *,
    arch: str = "",
    objective: str = "latency",
    tokens: int = 0,
    backend: str = "auto",
    total_latency_s: Optional[float] = None,
    tilings: str = "heuristic",
    phase: str = "",
    tuner=None,
    factorizations: Optional[Mapping[str, Factorization]] = None,
    sharding: Optional[PlanSharding] = None,
) -> ExecutionPlan:
    """Compile a DSE result into an installable :class:`ExecutionPlan`.

    ``named_layers`` are the (instance_name, network) problems the search
    ran over, aligned with ``result.choices``.  ``backend`` forces every
    layer onto one executor (``"auto"`` = per-layer heuristic).  ``hw``
    is the architecture the result was evaluated on (pass ``result.hw``
    after a co-search): it is embedded in the plan (schema v3), and for
    co-searched results it also drives the kernel tiling caps and the
    streaming-backend VMEM budget.

    ``tilings="measured"`` replaces each layer's heuristic forward
    tiling by the measured argmin of ``tuner`` (a
    ``repro_torch.tune.Autotuner`` — required in this mode): sweeps are
    deduped across layer families and served from the tuner's
    persistent cache, so a warm cache compiles without any measurement.
    Backend selection and backward-op tilings stay heuristic — the
    executor is unchanged either way.

    ``phase`` stamps the plan's serving-phase hint (``"prefill"`` /
    ``"decode"``; default phase-agnostic) — ``repro_torch.dse
    --emit-plan-pair`` compiles one plan per phase, searched at that
    phase's token count, and the serve driver checks the stamp before
    installing.

    ``factorizations`` maps projection-family names to the searched TT
    decomposition (schema v4, from ``repro_torch.rank``): the named layers
    must already have been built *under* that factorization — the
    compiler records it, it does not re-derive networks.

    ``sharding`` stamps the mesh provenance (``repro_torch.dse --shards``):
    like factorizations, the named layers must already be the per-shard
    problems — ``tokens`` is then the per-shard token count the tilings
    derive from, matching what the shard_map executor streams per
    device.
    """
    if backend != "auto" and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {('auto',) + BACKENDS}")
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}; have {PHASES}")
    if tilings not in TILING_MODES:
        raise ValueError(
            f"unknown tilings mode {tilings!r}; have {TILING_MODES}")
    if tilings == "measured" and tuner is None:
        raise ValueError(
            "tilings='measured' requires a tuner (repro_torch.tune.Autotuner)")
    if len(named_layers) != len(result.choices):
        raise ValueError(
            f"{len(named_layers)} layers vs {len(result.choices)} choices")
    # hw caps apply only when the architecture was actually searched;
    # a fixed cost-model target says nothing about the execution device
    tile_hw = hw if result.hw_candidates else None

    by_family: dict[str, LayerPlan] = {}
    counts: dict[str, int] = {}
    for (inst_name, tn), choice in zip(named_layers, result.choices):
        name = base_name(inst_name)
        counts[name] = counts.get(name, 0) + 1
        if name in by_family:
            prev = by_family[name]
            bwd_steps = tuple(ch.path.steps for ch in choice.backward)
            prev_bwd_steps = tuple(op.path_steps for op in prev.backward)
            if (prev.path_steps != choice.path.steps
                    or prev.dataflow != choice.dataflow.value
                    or prev.partitioning != tuple(choice.partitioning)
                    or prev_bwd_steps != bwd_steps):
                raise ValueError(
                    f"instances of {name!r} received divergent DSE choices; "
                    "cannot collapse to one scanned layer plan")
            continue
        tiling = choose_tiling(choice, tokens or batch_dim(tn), tile_hw)
        be = (backend if backend != "auto"
              else choose_backend(tn, choice, tiling, tile_hw))
        if tilings == "measured":
            tiling = _measured_tiling(tn, choice, tiling, be,
                                      tokens or batch_dim(tn), tuner,
                                      tile_hw)
        segments = (choose_segments(tn, choice.path.steps, tiling, tile_hw)
                    if be == "tt_gemm" else None)
        by_family[name] = LayerPlan(
            name=name,
            path_index=choice.path_index,
            path_steps=tuple(tuple(s) for s in choice.path.steps),
            dataflow=choice.dataflow.value,
            partitioning=tuple(choice.partitioning),
            backend=be,
            tiling=tiling,
            backward=_compile_backward(tn, choice, tokens, backend, tile_hw,
                                       tilings=tilings, tuner=tuner),
            factorization=(factorizations.get(name)
                           if factorizations is not None else None),
            segments=segments,
            macs=choice.path.macs,
            latency_s=choice.latency_s,
            bwd_latency_s=choice.bwd_latency_s,
        )

    layers = tuple(
        dataclasses.replace(lp, instances=counts[lp.name])
        for lp in by_family.values()
    )
    return ExecutionPlan(
        layers=layers,
        arch=arch,
        hw=hw.name,
        objective=objective,
        strategy=result.strategy,
        tokens=tokens,
        total_latency_s=(result.total_latency_s if total_latency_s is None
                         else total_latency_s),
        hardware=hw,
        tilings=tilings,
        phase=phase,
        sharding=sharding,
    )
