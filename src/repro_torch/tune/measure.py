"""Measurement harness for kernel variants.

Port of ``src/repro/tune/measure.py`` (PyTorch, no JAX).  The analytic
simulator predicts; this module *measures*, on the device the caller
names (``cuda`` unless it asks for the CPU):

- **on a CUDA device** the timed region is the card's own time, the
  counterpart of the reference's jitted call: ``warmup`` untimed calls on
  a side stream (they absorb the nvcc build and the K1/K5 program
  compilation), then :data:`GRAPH_CALLS` calls captured in one CUDA graph,
  replayed ``repeats`` times between CUDA events; the median replay over
  :data:`GRAPH_CALLS` is the seconds per call.  A blocking wall-clock call
  would time the Python wrappers (tens of microseconds of host enqueue
  against a few of kernel), so every tiling would tie inside the noise.  A
  call that cannot be captured raises: nothing falls back to the wall
  clock, which would put a second regime under the same cache key;
- **on the CPU** the wrappers run the kernels' plain versions and the
  reference's protocol is kept: ``warmup`` untimed calls, then the median
  ``time.perf_counter`` seconds of ``repeats`` calls.

The cache keys every measurement by device kind and ``interpret`` flag
(``repro_torch.tune.cache``); ``interpret`` keeps the reference's meaning,
"the plain version ran, not the compiled kernel", and is true exactly on
the CPU, so CPU numbers never answer a CUDA lookup.

Inputs are synthesized deterministically with NumPy (the reference's seeds,
:func:`_seed_for`) and moved to the device once, outside the timed region,
so two tuning runs of the same shape time the same arithmetic.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.tensor_network import TensorNetwork
from repro_torch.kernels import ops
from repro_torch.plan.executor import as_candidate_path

#: defaults for the median-of-k protocol
WARMUP = 1
REPEATS = 5
#: calls captured in one CUDA graph: one replay is one sample
GRAPH_CALLS = 20


def _device(device) -> torch.device:
    """``device`` as a torch device (default ``cuda``); a CUDA device with
    no card present raises ``ValueError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"measurements run on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(
            "no CUDA device is available for the measurements (pass "
            "--device cpu to time the plain versions)")
    return dev


def device_kind(device="cuda") -> str:
    """A cache-key-safe identity of the device measurements run on: the
    card's name with spaces made ``_``, or ``"cpu"``."""
    dev = _device(device)
    if dev.type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(dev).replace(" ", "_")


def default_interpret(device="cuda") -> bool:
    """Whether measurements on ``device`` time the plain versions (the
    CPU) rather than the compiled kernels."""
    return torch.device("cuda" if device is None else device).type == "cpu"


def _checked(device, interpret) -> torch.device:
    """The device of one measurement.  Its faults raise ``RuntimeError``,
    never ``ValueError``, which ``Autotuner.tune_streaming`` reads as "the
    kernel cannot run this network" and answers with the heuristic."""
    try:
        dev = _device(device)
    except ValueError as e:
        raise RuntimeError(str(e)) from None
    if interpret is not None and bool(interpret) != default_interpret(dev):
        raise RuntimeError(
            f"interpret={interpret} on {dev}: the device decides which "
            "version runs (the plain versions exactly on the CPU)")
    return dev


def measure_callable(
    fn: Callable[[], torch.Tensor],
    *,
    warmup: int = WARMUP,
    repeats: int = REPEATS,
    device="cuda",
) -> float:
    """Median seconds per call of ``fn``, whose tensors sit on ``device``:
    CUDA-graph replay on a card, ``perf_counter`` on the CPU (see the
    module docstring)."""
    dev = _device(device)
    if dev.type == "cpu":
        for _ in range(max(1, warmup)):
            fn()
        times = []
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(statistics.median(times))
    return _graph_seconds(fn, warmup, repeats, dev)


def _graph_seconds(fn, warmup: int, repeats: int, dev: torch.device) -> float:
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev), torch.cuda.stream(side):
        for _ in range(max(1, warmup)):
            fn()
        side.synchronize()
        # capture_begin/capture_end rather than ``torch.cuda.graph``, whose
        # entry collects garbage and empties the allocator's cache every
        # time: a sweep makes one graph per variant
        failure = None
        graph.capture_begin(capture_error_mode="relaxed")
        try:
            for _ in range(GRAPH_CALLS):
                fn()
        except Exception as e:
            failure = e
        try:
            graph.capture_end()
        except Exception as e:
            failure = failure or e
    if failure is not None:
        raise RuntimeError(
            "measure: the call could not be captured in a CUDA graph "
            f"({type(failure).__name__}: {failure}); it is not timed another "
            "way") from failure
    torch.cuda.current_stream(dev).wait_stream(side)
    try:
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(max(1, repeats)):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3 / GRAPH_CALLS)
    finally:
        torch.cuda.synchronize(dev)
        graph.reset()
    return float(statistics.median(times))


def _seed_for(*dims: int) -> int:
    return abs(hash(tuple(int(d) for d in dims))) % (2**31)


def _normal(rng: np.random.Generator, shape, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(dev)


def measure_gemm(
    M: int, K: int, N: int,
    dataflow: str,
    blocks: tuple[int, int, int],
    *,
    interpret: bool | None = None,
    warmup: int = WARMUP,
    repeats: int = REPEATS,
    device="cuda",
) -> float:
    """Median seconds of one ``ops.gemm`` call at the given tiling."""
    dev = _checked(device, interpret)
    rng = np.random.default_rng(_seed_for(M, K, N))
    a = _normal(rng, (M, K), dev)
    b = _normal(rng, (K, N), dev)
    bm, bk, bn = (int(v) for v in blocks)

    def run():
        return ops.gemm(a, b, dataflow=dataflow, block_m=bm, block_k=bk,
                        block_n=bn)

    with torch.no_grad():
        return measure_callable(run, warmup=warmup, repeats=repeats,
                                device=dev)


def synthesize_tensors(
    tn: TensorNetwork, device="cpu"
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Deterministic (streamed operand, cores) for a layer network.

    The streamed node (``kind == "input"``) becomes a 2-d
    ``(batch, prod(inner modes))`` operand; every other node becomes a
    random core of its literal dims, in node order — the operand layout
    ``ops.tt_linear`` / the streaming kernel expect.
    """
    dev = torch.device(device)
    stream = next(n for n in tn.nodes if n.kind == "input")
    rng = np.random.default_rng(_seed_for(*stream.dims))
    inner = 1
    for d in stream.dims[1:]:
        inner *= d
    x = _normal(rng, (stream.dims[0], inner), dev)
    cores = [_normal(rng, n.dims, dev) for n in tn.nodes if n.kind != "input"]
    return x, cores


def synthesize_network_tensors(tn: TensorNetwork,
                               device="cpu") -> dict[str, torch.Tensor]:
    """Deterministic full-dims tensors for every node of a network."""
    dev = torch.device(device)
    return {n.name: _normal(np.random.default_rng(_seed_for(*n.dims)),
                            n.dims, dev)
            for n in tn.nodes}


def measure_fused(
    tn: TensorNetwork,
    steps: Sequence[tuple[int, int]],
    segments: Sequence[tuple[int, int]],
    block_tokens: int,
    *,
    block_k: int = 128,
    interpret: bool | None = None,
    warmup: int = WARMUP,
    repeats: int = REPEATS,
    device="cuda",
) -> float:
    """Median seconds of the fused-segment route over one layer network.

    ``tn`` is the layer network at the streamed token count; multi-step
    segments run through ``ops.fused_segment`` (K5: one pack and one chain
    launch), singletons through the per-step GEMM (K2) — the same walk
    ``plan/executor._execute_segmented`` performs, minus the provenance
    records.
    """
    dev = _checked(device, interpret)
    steps = tuple(tuple(s) for s in steps)
    segments = tuple((int(s), int(e)) for s, e in segments)
    tensors = synthesize_network_tensors(tn, dev)
    contract = ops.gemm_contract()

    def run():
        work: list = [(n.edges, tensors[n.name]) for n in tn.nodes]
        for s, e in segments:
            if e - s >= 2:
                ec, val = ops.fused_segment(
                    work, steps[s:e], block_tokens=block_tokens,
                    block_k=block_k)
                for i, j in steps[s:e]:
                    work = [w for k, w in enumerate(work) if k not in (i, j)]
                    work.append(None)
                work[-1] = (ec, val)
            else:
                i, j = steps[s]
                (ea, ta), (eb, tb) = work[i], work[j]
                shared = [x for x in ea if x in eb]
                val = contract(ta, tb,
                               (tuple(ea.index(x) for x in shared),
                                tuple(eb.index(x) for x in shared)))
                ec = tuple(x for x in ea if x not in shared) + tuple(
                    x for x in eb if x not in shared)
                work = [w for k, w in enumerate(work) if k not in (i, j)]
                work.append((ec, val))
        return work[-1][1]

    with torch.no_grad():
        return measure_callable(run, warmup=warmup, repeats=repeats,
                                device=dev)


def measure_per_step(
    tn: TensorNetwork,
    steps: Sequence[tuple[int, int]],
    *,
    interpret: bool | None = None,
    warmup: int = WARMUP,
    repeats: int = REPEATS,
    device="cuda",
) -> float:
    """Median seconds of the spill-always per-step route (one GEMM launch
    per path step) — the baseline the fused variant is judged against,
    over the same synthesized tensors."""
    from repro_torch.core.contraction import execute_path

    dev = _checked(device, interpret)
    steps = tuple(tuple(s) for s in steps)
    tensors = synthesize_network_tensors(tn, dev)
    contract = ops.gemm_contract()

    def run():
        return execute_path(tn, steps, tensors, contract_fn=contract)

    with torch.no_grad():
        return measure_callable(run, warmup=warmup, repeats=repeats,
                                device=dev)


def measure_streaming(
    tn_block: TensorNetwork,
    steps: Sequence[tuple[int, int]],
    tokens: int,
    block_tokens: int,
    *,
    interpret: bool | None = None,
    warmup: int = WARMUP,
    repeats: int = REPEATS,
    device="cuda",
) -> float:
    """Median seconds of one streaming TT call (K1) at ``block_tokens``.

    ``tn_block`` must be the layer network rebatched to ``block_tokens``
    (the per-block network the kernel contracts); ``tokens`` streamed
    rows are synthesized as at serve time.
    """
    dev = _checked(device, interpret)
    path = as_candidate_path(tn_block, steps)
    x_full, cores = synthesize_tensors(tn_block, dev)
    inner = x_full.shape[1]
    rng = np.random.default_rng(_seed_for(tokens, inner))
    x = _normal(rng, (tokens, inner), dev)

    def run():
        return ops.tt_linear(x, cores, tn_block, path,
                             block_tokens=block_tokens)

    with torch.no_grad():
        return measure_callable(run, warmup=warmup, repeats=repeats,
                                device=dev)
