"""Continuous-batching request scheduler over a :class:`ServeEngine`.

Framework-neutral copy of ``src/repro/serve/scheduler.py`` (numpy only).

The scheduler runs a virtual step clock (1 tick = 1 fixed-width decode
step).  Each tick it (1) moves arrived requests from the future queue
into a FIFO ready queue, (2) admits ready requests into free decode
lanes — prefilling each at batch 1 and slot-writing its caches — up to
the admission policy's per-step cap, then (3) runs one decode step for
all occupied lanes.  ``schedule="oneshot"`` is the same loop with
concurrency capped at 1: each request decodes alone (at the same fixed
slot width), which is the bit-exact reference the continuous mode is
tested against.

Token selection is host-side and per-request deterministic: greedy
``np.argmax`` (first-max tie-break) at temperature 0, Gumbel-max
sampling from a per-``(seed, rid)`` generator otherwise — a request's
tokens never depend on which lanes its neighbours occupy.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np

from .engine import ServeEngine
from .request import Completion, Request

SCHEDULES = ("oneshot", "continuous")


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """Admission policy knobs.

    ``max_admissions_per_step`` bounds how many prefills one tick may
    run before the decode step (None = fill every free lane); FIFO order
    means a waiting request is admitted after at most
    ``ceil(queue_position / admissions_per_tick)`` ticks once lanes
    free up — the starvation bound the robustness suite pins down.
    """

    schedule: str = "continuous"
    max_admissions_per_step: Optional[int] = None

    def __post_init__(self) -> None:
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"unknown schedule {self.schedule!r}; have {SCHEDULES}")
        if (self.max_admissions_per_step is not None
                and self.max_admissions_per_step < 1):
            raise ValueError("max_admissions_per_step must be >= 1 or None")


@dataclasses.dataclass(frozen=True)
class ServeResult:
    completions: tuple[Completion, ...]
    steps: int
    wall_s: float
    n_slots: int
    #: mean fraction of decode lanes occupied over all decode steps
    occupancy: float

    def tokens_by_rid(self) -> dict[int, tuple[int, ...]]:
        return {c.rid: c.tokens for c in self.completions}


class _Active:
    """A request occupying (or about to occupy) a decode lane."""

    __slots__ = ("req", "tokens", "t_ready", "t_first", "admitted_step")

    def __init__(self, req: Request, first: int, t_ready: float,
                 t_first: float, admitted_step: int) -> None:
        self.req = req
        self.tokens = [first]
        self.t_ready = t_ready
        self.t_first = t_first
        self.admitted_step = admitted_step


class Scheduler:
    def __init__(self, engine: ServeEngine,
                 policy: Optional[ServePolicy] = None, *,
                 temperature: float = 0.0, seed: int = 0) -> None:
        self.engine = engine
        self.policy = policy or ServePolicy()
        self.temperature = float(temperature)
        self.seed = int(seed)

    def _select(self, row: np.ndarray, rng: np.random.Generator) -> int:
        if self.temperature <= 0:
            return int(np.argmax(row))
        z = row.astype(np.float64) / self.temperature
        return int(np.argmax(z + rng.gumbel(size=z.shape)))

    def _validate(self, requests: Sequence[Request]) -> list[Request]:
        eng = self.engine
        seen: set[int] = set()
        for r in requests:
            if r.rid in seen:
                raise ValueError(f"duplicate request id {r.rid}")
            seen.add(r.rid)
            pp = eng.padded_len(len(r.prompt))
            need = max(pp, len(r.prompt) + r.max_new_tokens - 1)
            if need > eng.max_seq:
                raise ValueError(
                    f"request {r.rid} needs {need} cache positions "
                    f"(prompt {len(r.prompt)} padded to {pp}, "
                    f"gen {r.max_new_tokens}) but max_seq is {eng.max_seq}")
        # stable sort: arrival order, rid breaks ties deterministically
        return sorted(requests, key=lambda r: (r.arrival, r.rid))

    def run(self, requests: Sequence[Request]) -> ServeResult:
        reqs = self._validate(requests)
        eng = self.engine
        ns = eng.n_slots
        concurrency = 1 if self.policy.schedule == "oneshot" else ns

        future = collections.deque(reqs)
        ready: collections.deque[tuple[Request, float]] = collections.deque()
        slots: list[Optional[_Active]] = [None] * ns
        tok = np.zeros(ns, np.int64)
        pos = np.zeros(ns, np.int64)
        caches = eng.fresh_caches()
        rngs: dict[int, np.random.Generator] = {}
        done: list[Completion] = []

        step = 0
        active = 0
        lane_steps = 0   # sum over decode steps of occupied lanes
        decode_steps = 0
        t0 = time.perf_counter()

        while future or ready or active:
            while future and future[0].arrival <= step:
                ready.append((future.popleft(), time.perf_counter()))

            admitted = 0
            cap = self.policy.max_admissions_per_step
            while (ready and active < concurrency
                   and (cap is None or admitted < cap)):
                free = next((i for i, s in enumerate(slots) if s is None),
                            None)
                if free is None:
                    break
                req, t_ready = ready.popleft()
                rng = np.random.default_rng((self.seed, req.rid))
                rngs[req.rid] = rng
                row, small = eng.prefill_request(req.prompt)
                first = self._select(row, rng)
                st = _Active(req, first, t_ready, time.perf_counter(), step)
                admitted += 1
                if req.max_new_tokens == 1:
                    # done at admission — never occupies a decode lane
                    done.append(self._complete(st, step))
                    continue
                caches = eng.admit(caches, small, free)
                slots[free] = st
                tok[free] = first
                pos[free] = len(req.prompt)
                active += 1

            if active == 0:
                if not future and not ready:
                    break  # drained
                if ready:
                    # admission cap hit on single-token requests — next
                    # tick's fresh cap admits the rest
                    step += 1
                else:
                    # idle: jump the clock to the next arrival
                    step = max(step + 1, math.ceil(future[0].arrival))
                continue

            rows, caches = eng.decode(tok, pos, caches)
            decode_steps += 1
            lane_steps += active
            step += 1
            for i, st in enumerate(slots):
                if st is None:
                    continue
                nxt = self._select(rows[i], rngs[st.req.rid])
                st.tokens.append(nxt)
                tok[i] = nxt
                pos[i] += 1
                if len(st.tokens) >= st.req.max_new_tokens:
                    done.append(self._complete(st, step))
                    slots[i] = None
                    tok[i] = 0
                    pos[i] = 0
                    active -= 1

        wall = time.perf_counter() - t0
        occ = lane_steps / (decode_steps * ns) if decode_steps else 0.0
        return ServeResult(
            completions=tuple(sorted(done, key=lambda c: c.rid)),
            steps=step, wall_s=wall, n_slots=ns, occupancy=occ)

    @staticmethod
    def _complete(st: _Active, step: int) -> Completion:
        return Completion(
            rid=st.req.rid, prompt_len=len(st.req.prompt),
            tokens=tuple(st.tokens), arrival=st.req.arrival,
            admitted_step=st.admitted_step, done_step=step,
            t_ready=st.t_ready, t_first=st.t_first,
            t_done=time.perf_counter())
