"""Serving loop: request queue, continuous batching, phase-specialized plans
(port of ``src/repro/serve/``)."""

from .engine import ServeEngine
from .metrics import percentile, summarize
from .request import (
    Completion,
    Request,
    load_trace,
    synthetic_trace,
)
from .scheduler import SCHEDULES, Scheduler, ServePolicy, ServeResult

__all__ = [
    "ServeEngine",
    "Scheduler", "ServePolicy", "ServeResult", "SCHEDULES",
    "Request", "Completion", "synthetic_trace", "load_trace",
    "percentile", "summarize",
]
