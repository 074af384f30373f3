"""Execution plans: schema (copied), driver guards and the planned executor."""

from .schema import (
    BACKENDS,
    PLAN_FORMAT_VERSION,
    BackwardOp,
    ExecutionPlan,
    Factorization,
    LayerPlan,
    Tiling,
    load_plan,
    migrate_plan_json,
)
from .executor import (
    execution_log,
    execution_log_dropped,
    execution_stream,
    planned_tt_linear,
    record_execution,
    reset_execution_log,
)
from .compiler import check_plan_for_config, validate_plan

__all__ = [
    "BACKENDS", "PLAN_FORMAT_VERSION", "BackwardOp", "ExecutionPlan",
    "Factorization", "LayerPlan", "Tiling", "load_plan", "migrate_plan_json",
    "execution_log", "execution_log_dropped", "execution_stream",
    "planned_tt_linear", "record_execution", "reset_execution_log",
    "check_plan_for_config", "validate_plan",
]
