"""Driver-side plan guards (port of part of ``src/repro/plan/compiler.py``).

Only the checks a serving driver runs before installing a plan are
ported: :func:`validate_plan` and :func:`check_plan_for_config`.  Plan
compilation itself (the DSE) stays in the JAX package; its emitted plans
cross to the port as committed JSON under ``src/repro_torch/plans/``.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

from repro_torch.core.tensor_network import Node, TensorNetwork

from .schema import PHASES

_INSTANCE_RE = re.compile(r"\[\d+\]$")


def base_name(instance_name: str) -> str:
    """``attn.wq[3]`` -> ``attn.wq`` (DSE instance -> projection family)."""
    return _INSTANCE_RE.sub("", instance_name)


def _input_node(tn: TensorNetwork) -> Node:
    return next(n for n in tn.nodes if n.kind == "input")


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
    """(d_in, d_out) of the projection a TT-linear network computes."""
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

    Returns human-readable problem strings (empty = compatible), as the
    reference does.  The reference's extra check of fused ``segments``
    (``repro.core.fusion.chain_problems``) is not ported: the executor
    refuses fused segments outright.
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
            want_nodes = len(f.out_modes) + len(f.in_modes) + 1
        else:
            want_nodes = len(tn.nodes)
        if not lp.path_steps:
            if lp.backend == "jnp":
                continue  # index-only entry: steps resolve at run time
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
        if lp.backward and lp.factorization is None:
            want = {"dx"} | {n.name for n in tn.nodes if n.kind != "input"}
            got = {op.wrt for op in lp.backward}
            if got != want:
                problems.append(
                    f"{lp.name}: backward entries cover {sorted(got)} but "
                    f"the layer's gradients are {sorted(want)} "
                    "(hand-edited or geometry-mismatched plan?)")
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

    The arch provenance check, the serving-phase check of a pair half,
    and :func:`validate_plan` over the model's tensorized projections.
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

    fact = {lp.name: lp.factorization.triple
            for lp in plan.layers if lp.factorization is not None}
    try:
        named = model_dse_layers(cfg, tokens=8, factorizations=fact or None)
    except ValueError as e:
        problems.append(str(e.args[0] if e.args else e))
        return problems
    problems.extend(validate_plan(plan, named))
    return problems
