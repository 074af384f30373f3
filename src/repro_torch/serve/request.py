"""Request / trace model for the serving layer.

Framework-neutral copy of ``src/repro/serve/request.py`` (the port never imports
the JAX package).

A :class:`Request` is one generation job: a prompt (token ids), a
generation budget, and an *arrival time* measured in engine decode steps
(the scheduler's virtual clock — deterministic, replayable, independent
of wall-clock jitter).  Traces are plain JSON lists so CI jobs and
benchmarks can pin workloads; :func:`synthetic_trace` draws a
deterministic sustained-load trace from a seed.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Union

import numpy as np

#: int = fixed value; (lo, hi) = inclusive uniform range per request
Span = Union[int, tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.

    ``arrival`` is in scheduler *steps* (virtual time): the request
    becomes admissible once the engine's step clock reaches it.
    ``max_new_tokens`` counts the prefill's first token, so a value of 1
    completes at admission without any decode step.
    """

    rid: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    arrival: float = 0.0

    def __post_init__(self) -> None:
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1 "
                f"(got {self.max_new_tokens})")
        if self.arrival < 0:
            raise ValueError(f"request {self.rid}: negative arrival time")


@dataclasses.dataclass(frozen=True)
class Completion:
    """A served request: generated ids + step/wall-clock provenance.

    ``tokens`` are the generated ids (length ``max_new_tokens``);
    ``admitted_step``/``done_step`` are virtual-clock stamps (replay-
    deterministic), the ``t_*`` fields are ``time.perf_counter`` stamps
    (``t_ready`` = entered the ready queue, ``t_first`` = first token,
    ``t_done`` = last token).
    """

    rid: int
    prompt_len: int
    tokens: tuple[int, ...]
    arrival: float
    admitted_step: int
    done_step: int
    t_ready: float
    t_first: float
    t_done: float


def _draw(rng: np.random.Generator, span: Span) -> int:
    if isinstance(span, int):
        return span
    lo, hi = span
    return int(rng.integers(lo, hi + 1))


def synthetic_trace(
    n_requests: int,
    vocab: int,
    *,
    prompt_len: Span = 32,
    gen: Span = 8,
    arrival_rate: float = 0.0,
    seed: int = 0,
) -> list[Request]:
    """Deterministic sustained-load trace.

    ``arrival_rate`` is the mean inter-arrival gap in decode steps
    (exponential gaps; 0 = every request arrives at t=0 — the full-queue
    burst).  ``prompt_len``/``gen`` accept a fixed int or an inclusive
    ``(lo, hi)`` range drawn per request.
    """
    rng = np.random.default_rng(seed)
    out: list[Request] = []
    t = 0.0
    for i in range(n_requests):
        p = _draw(rng, prompt_len)
        g = _draw(rng, gen)
        prompt = tuple(int(x) for x in rng.integers(0, vocab, size=p))
        out.append(Request(rid=i, prompt=prompt, max_new_tokens=g, arrival=t))
        if arrival_rate > 0:
            t += float(rng.exponential(arrival_rate))
    return out


def save_trace(path: str, requests: Sequence[Request]) -> None:
    """Write a trace JSON (prompts inlined: fully self-contained), the
    reference's bytes; :func:`load_trace` reads it back."""
    rows = [
        {"arrival": r.arrival, "prompt": list(r.prompt),
         "gen": r.max_new_tokens}
        for r in requests
    ]
    with open(path, "w") as f:
        json.dump(rows, f, indent=2)
        f.write("\n")


def load_trace(path: str, vocab: int, *, seed: int = 0) -> list[Request]:
    """Load a request-trace JSON.

    Each row: ``{"arrival": float, "gen": int, "prompt": [ids...]}`` or
    ``{"arrival": ..., "gen": ..., "prompt_len": int}`` — when only the
    length is given, token ids are drawn deterministically from
    ``(seed, row index)`` so a length-only trace still replays
    bit-identically.
    """
    with open(path) as f:
        rows = json.load(f)
    if not isinstance(rows, list):
        raise ValueError(f"{path}: trace must be a JSON list of requests")
    out: list[Request] = []
    for i, row in enumerate(rows):
        prompt: Optional[Sequence[int]] = row.get("prompt")
        if prompt is None:
            p = int(row["prompt_len"])
            rng = np.random.default_rng((seed, i))
            prompt = [int(x) for x in rng.integers(0, vocab, size=p)]
        out.append(Request(
            rid=i,
            prompt=tuple(int(t) for t in prompt),
            max_new_tokens=int(row.get("gen", 8)),
            arrival=float(row.get("arrival", 0.0)),
        ))
    return out
