"""Planned execution: route a TT contraction through its LayerPlan backend.

Port of the forward half of ``src/repro/plan/executor.py``.  Entry point
is :func:`planned_tt_linear`, called by ``repro_torch.nn.linear`` when a
plan entry with a kernel backend is installed for the projection.
Backends (the plan's wire names):

- ``jnp``          the plain PyTorch executor (``kernels/ref.py``) along the
                   plan's path steps: the numerical ground truth;
- ``streaming_tt`` the streaming CUDA kernel (``kernels/streaming_tt.py``);
- ``tt_gemm``      every pairwise step of the path lowered to the dataflow
                   GEMM kernel (``kernels/tt_gemm.py``) with the plan's
                   OS/WS/IS dataflow and <T_M, T_K, T_N> blocks.

Execution log.  Every planned call appends one record.  JAX appended one
per *trace*; this eager port appends one per *call*, so a long serving
run fills the ring of :data:`_EXEC_LOG_MAX` records within a few hundred
decode steps and the dropped counter says how many aged out.  Compare
runs by their set of distinct records, not by counts.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, Sequence

import torch

from repro_torch.core.contraction import core_tensors, execute_path
from repro_torch.core.paths import CandidatePath
from repro_torch.core.tensor_network import TensorNetwork, tt_linear_network
from repro_torch.kernels import ops, ref

from .schema import LayerPlan

# ---------------------------------------------------------------------------
# execution log
# ---------------------------------------------------------------------------

#: ring capacity: the newest records are kept, the drop counter
#: (:func:`execution_log_dropped`) counts the ones that aged out
_EXEC_LOG_MAX = 4096

_EXEC_LOG: list[dict] = []
_EXEC_DROPPED = 0

#: serving-stream tag stack (:func:`execution_stream`)
_STREAM: list[str] = []


def reset_execution_log() -> None:
    global _EXEC_DROPPED
    _EXEC_LOG.clear()
    _EXEC_DROPPED = 0


def execution_log() -> tuple[dict, ...]:
    """Records of planned executions since the last reset (newest
    :data:`_EXEC_LOG_MAX` at most)."""
    return tuple(_EXEC_LOG)


def execution_log_dropped() -> int:
    """Records evicted from the ring since the last reset."""
    return _EXEC_DROPPED


@contextlib.contextmanager
def execution_stream(name: str) -> Iterator[None]:
    """Tag every execution record appended inside with ``stream=name``.

    The serve engine wraps each prefill/decode call in
    ``execution_stream("prefill"/"decode")``, so the log shows which
    serving stream (and therefore which plan of a pair) ran each call.
    """
    _STREAM.append(str(name))
    try:
        yield
    finally:
        _STREAM.pop()


def record_execution(lp: LayerPlan, tokens: int) -> None:
    """Append one planned-execution record (one per call).

    Field for field the reference's forward record: ``phase`` is always
    ``"fwd"`` (the backward half is not ported) and ``mesh``/``shard_shape``
    are the single-device values.
    """
    global _EXEC_DROPPED
    rec = {
        "name": lp.name,
        "backend": lp.backend,
        "dataflow": lp.dataflow,
        "path_index": lp.path_index,
        "path_steps": lp.path_steps,
        "tokens": tokens,
        "phase": "fwd",
        "stream": _STREAM[-1] if _STREAM else "",
        "mesh": "",
        "shard_shape": None,
        "tiling": lp.tiling.to_json(),
    }
    if len(_EXEC_LOG) >= _EXEC_LOG_MAX:
        del _EXEC_LOG[0]
        _EXEC_DROPPED += 1
    _EXEC_LOG.append(rec)


# ---------------------------------------------------------------------------
# path plumbing
# ---------------------------------------------------------------------------

def as_candidate_path(tn: TensorNetwork, steps) -> CandidatePath:
    """Reconstruct a CandidatePath (with GEMM shapes) from raw plan steps."""
    steps = tuple(tuple(s) for s in steps)
    gemms = tuple(tn.gemm_sequence(steps))
    return CandidatePath(steps, sum(g.macs for g in gemms), gemms)


@functools.lru_cache(maxsize=1024)
def _network_and_path(batch: int, in_modes: tuple[int, ...],
                      out_modes: tuple[int, ...], ranks: tuple[int, ...],
                      steps) -> tuple[TensorNetwork, CandidatePath]:
    """The layer network at ``batch`` tokens and the plan's path over it,
    built once per shape (the eager counterpart of JAX's trace-time work)."""
    tn = tt_linear_network(batch, in_modes, out_modes, ranks)
    return tn, as_candidate_path(tn, steps)


def _has_fused_segments(lp: LayerPlan) -> bool:
    return lp.segments is not None and any(e - s >= 2 for s, e in lp.segments)


def _forward_planned(
    lp: LayerPlan,
    x2d: torch.Tensor,
    cores: Sequence[torch.Tensor],
    in_modes: tuple[int, ...],
    out_modes: tuple[int, ...],
    ranks: tuple[int, ...],
) -> torch.Tensor:
    """The plan's forward contraction: ``(tokens, d_in) -> (tokens, d_out)``."""
    tokens = x2d.shape[0]
    if lp.backend == "streaming_tt":
        bt = ops.clamp_block(lp.tiling.block_tokens, tokens)
        tn_block, path = _network_and_path(bt, in_modes, out_modes, ranks,
                                           lp.path_steps)
        return ops.tt_linear(x2d, list(cores), tn_block, path, block_tokens=bt)

    tn, path = _network_and_path(tokens, in_modes, out_modes, ranks,
                                 lp.path_steps)
    if lp.backend == "tt_gemm":
        tensors = {"X": x2d.reshape((tokens,) + tuple(in_modes))}
        tensors.update(core_tensors(tn, list(cores)))
        out_edges = ("b",) + tuple(f"i{t + 1}" for t in range(len(out_modes)))
        contract = ops.gemm_contract(
            dataflow=lp.dataflow, block_m=lp.tiling.block_m,
            block_k=lp.tiling.block_k, block_n=lp.tiling.block_n)
        y = execute_path(tn, path, tensors, out_edges=out_edges,
                         contract_fn=contract)
        return y.reshape(tokens, -1)

    # "jnp": the plain executor along the planned steps
    return ref.tt_linear_ref(x2d, list(cores), tn, path)


def planned_tt_linear(
    lp: LayerPlan,
    x2d: torch.Tensor,
    cores: Sequence[torch.Tensor],
    in_modes: tuple[int, ...],
    out_modes: tuple[int, ...],
    ranks: tuple[int, ...],
) -> torch.Tensor:
    """Apply one planned TT projection to ``x2d: (tokens, d_in)``.

    Returns ``(tokens, d_out)``.  The plan's ``path_steps`` are replayed
    verbatim; the backend decides how each step runs.  Forward only: the
    backward half (training) is not ported yet.  A layer whose plan fuses
    path steps into ``segments`` raises ``NotImplementedError``: the fused
    kernel (``kernels/fused_path.py``) is not ported, and running the steps
    one by one instead would hide that the plan's kernel never ran.
    """
    if _has_fused_segments(lp):
        raise NotImplementedError(
            f"{lp.name}: the plan fuses path steps into segments "
            f"{[list(s) for s in lp.segments]}; the fused-segment kernel "
            "(src/repro/kernels/fused_path.py) is not ported yet "
            "(ROADMAP.md, Queue B item 5 / Queue A item 8)")
    tokens = x2d.shape[0]
    record_execution(lp, tokens)
    return _forward_planned(lp, x2d.contiguous(), cores, tuple(in_modes),
                            tuple(out_modes), tuple(ranks))
