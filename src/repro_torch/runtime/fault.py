"""Fault-tolerant step-loop machinery.

A copy of ``src/repro/runtime/fault.py`` over the port's checkpoint
manager (``repro_torch.checkpoint``), but for the retry count of
``FaultTolerantLoop``: the reference resets it whenever a step succeeds,
the replayed steps after a restore included, so a step that always fails
just after a checkpoint is replayed forever once that checkpoint has
landed; here only a step past the furthest one reached resets it.

* ``PreemptionGuard`` — converts SIGTERM/SIGINT into a checkpoint-then-
  exit at the next step boundary (the TPU preemption contract).
* ``StragglerMonitor`` — per-step wall-time EMA + robust deviation; flags
  steps slower than ``threshold``x the running median.  On a real pod the
  per-host heartbeats feed this; the single-host build monitors the jitted
  step itself (the mechanism, not the telemetry transport, is what the
  framework provides).
* ``FaultTolerantLoop`` — wraps a step function with bounded retry +
  restore-from-checkpoint: a step that raises is retried after restoring
  the last good state; repeated failure at the same step aborts (poison
  batch guard), counted across the replay of the steps between the
  checkpoint and it.  Combined with the stateless data pipeline, recovery
  is bit-exact.
"""

from __future__ import annotations

import signal
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint import CheckpointManager


class PreemptionGuard:
    def __init__(self):
        self._preempted = False
        self._orig: dict[int, Any] = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._orig[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc):
        for sig, h in self._orig.items():
            signal.signal(sig, h)
        return False

    def _handler(self, signum, frame):
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted


class StragglerMonitor:
    """Flags steps slower than ``threshold`` x the running median."""

    def __init__(self, threshold: float = 2.0, window: int = 32):
        self.threshold = threshold
        self.window = window
        self.times: list[float] = []
        self.flagged: list[int] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        history = self.times[-self.window:]
        self.times.append(seconds)
        if len(history) < 4:
            return False
        median = sorted(history)[len(history) // 2]
        if seconds > self.threshold * median:
            self.flagged.append(step)
            return True
        return False


class FaultTolerantLoop:
    """Runs ``step_fn(state, step) -> state`` with checkpointed recovery."""

    def __init__(
        self,
        step_fn: Callable[[Any, int], Any],
        manager: CheckpointManager,
        checkpoint_every: int = 50,
        max_retries_per_step: int = 2,
        straggler: Optional[StragglerMonitor] = None,
        on_restore: Optional[Callable[[Any], Any]] = None,
    ):
        self.step_fn = step_fn
        self.manager = manager
        self.checkpoint_every = checkpoint_every
        self.max_retries = max_retries_per_step
        self.straggler = straggler or StragglerMonitor()
        self.on_restore = on_restore
        self.recoveries = 0

    def run(self, state: Any, start_step: int, num_steps: int) -> tuple[Any, int]:
        """Returns (final_state, last_completed_step + 1)."""
        step = start_step
        retries = 0
        # the furthest step reached: a step replayed after a restore is not
        # progress, so it leaves the failing step's retry count standing
        frontier = start_step
        with PreemptionGuard() as guard:
            while step < start_step + num_steps:
                t0 = time.monotonic()
                try:
                    state = self.step_fn(state, step)
                except Exception:
                    retries += 1
                    self.recoveries += 1
                    if retries > self.max_retries:
                        raise
                    latest = self.manager.latest_step()
                    if latest is not None:
                        _, state = self.manager.restore(state, latest)
                        if self.on_restore is not None:
                            state = self.on_restore(state)
                        step = latest
                    continue
                self.straggler.record(step, time.monotonic() - t0)
                step += 1
                if step > frontier:
                    frontier, retries = step, 0
                if step % self.checkpoint_every == 0 or guard.preempted:
                    self.manager.save_async(step, state)
                if guard.preempted:
                    self.manager.wait()
                    break
        self.manager.wait()
        return state, step
