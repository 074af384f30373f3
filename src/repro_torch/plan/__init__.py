"""Execution plans: search -> compile -> install -> execute.

``python -m repro_torch.dse --emit-plan plan.json`` compiles the DSE
result into an :class:`ExecutionPlan` (schema and compiler copied from
``src/repro/plan/``); ``repro_torch.nn.install_plan(load_plan(path))``
installs it; the TT projections then contract along the planned path
through the planned kernel backend (the torch executor).
"""

from .schema import (
    BACKENDS,
    PHASES,
    PLAN_FORMAT_VERSION,
    SUPPORTED_VERSIONS,
    TILING_MODES,
    BackwardOp,
    ExecutionPlan,
    Factorization,
    LayerPlan,
    PlanSharding,
    Tiling,
    load_plan,
    migrate_plan_json,
)
from .executor import (
    as_candidate_path,
    execution_log,
    execution_log_dropped,
    execution_stream,
    planned_tt_linear,
    record_execution,
    reset_execution_log,
    shard_execution,
)
from .sharded import ShardDecision, shard_decision, sharded_tt_linear
from .compiler import (
    base_name,
    batch_dim,
    check_plan_for_config,
    choose_segments,
    compile_plan,
    streaming_fits,
    validate_plan,
)

__all__ = [
    "BACKENDS", "PHASES", "PLAN_FORMAT_VERSION", "SUPPORTED_VERSIONS",
    "TILING_MODES",
    "BackwardOp",
    "ExecutionPlan", "Factorization", "LayerPlan", "PlanSharding",
    "Tiling", "load_plan", "migrate_plan_json",
    "base_name", "batch_dim", "check_plan_for_config", "choose_segments",
    "compile_plan", "streaming_fits", "validate_plan",
    "as_candidate_path", "execution_log", "execution_log_dropped",
    "execution_stream",
    "planned_tt_linear", "record_execution", "reset_execution_log",
    "shard_execution",
    "ShardDecision", "shard_decision", "sharded_tt_linear",
]
