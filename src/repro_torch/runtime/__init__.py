"""Runtime: fault tolerance and stragglers (port of ``src/repro/runtime``)."""

from .fault import FaultTolerantLoop, PreemptionGuard, StragglerMonitor

__all__ = ["FaultTolerantLoop", "PreemptionGuard", "StragglerMonitor"]
