"""Execute a searched contraction path as a chain of ``torch.tensordot``.

Port of ``src/repro/core/contraction.py``.  The path (static Python data)
is unrolled eagerly; edge bookkeeping mirrors
``TensorNetwork.contract_pair``: result axes are A's free edges followed
by B's free edges, and the merged node is appended to the working list.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch

from .paths import CandidatePath
from .tensor_network import TensorNetwork


def execute_path(
    tn: TensorNetwork,
    path: CandidatePath | Sequence[tuple[int, int]],
    tensors: Mapping[str, torch.Tensor],
    out_edges: Sequence[str] | None = None,
    preferred_dtype: Optional[torch.dtype] = None,
    contract_fn=None,
) -> torch.Tensor:
    """Contract ``tn`` along ``path`` using ``tensors[name]`` per node.

    ``out_edges`` fixes the axis order of the result (defaults to the
    order the last contraction leaves).  ``preferred_dtype`` casts both
    operands of every step up to that dtype first (fp32 accumulation of a
    narrower model dtype).  ``contract_fn``, if given, replaces the
    per-step ``torch.tensordot``: it is called as
    ``contract_fn(ta, tb, (ax_a, ax_b))`` and returns the tensordot-ordered
    result (A's free axes then B's free axes); the plan executor uses it to
    lower each step to the dataflow GEMM kernel.
    """
    steps = path.steps if isinstance(path, CandidatePath) else tuple(path)
    work: list[tuple[tuple[str, ...], torch.Tensor]] = []
    for node in tn.nodes:
        t = tensors[node.name]
        if tuple(t.shape) != node.dims:
            raise ValueError(
                f"tensor {node.name}: shape {tuple(t.shape)} != declared {node.dims}"
            )
        work.append((node.edges, t))

    for (i, j) in steps:
        (ea, ta) = work[i]
        (eb, tb) = work[j]
        shared = [e for e in ea if e in eb]
        ax_a = [ea.index(e) for e in shared]
        ax_b = [eb.index(e) for e in shared]
        if contract_fn is not None:
            tc = contract_fn(ta, tb, (ax_a, ax_b))
        else:
            if preferred_dtype is not None:
                ta, tb = ta.to(preferred_dtype), tb.to(preferred_dtype)
            tc = torch.tensordot(ta, tb, dims=(ax_a, ax_b))
        ec = tuple(e for e in ea if e not in shared) + tuple(
            e for e in eb if e not in shared
        )
        work = [w for s, w in enumerate(work) if s not in (i, j)]
        work.append((ec, tc))

    if len(work) != 1:
        raise ValueError("path did not fully contract the network")
    edges, result = work[0]
    if out_edges is not None:
        perm = [edges.index(e) for e in out_edges]
        result = result.permute(perm)
    return result


def core_tensors(
    tn: TensorNetwork, arrays: Sequence[torch.Tensor], input_name: str = "X"
) -> dict[str, torch.Tensor]:
    """Zip weight-core arrays (in node order, skipping the input node)."""
    names = [n.name for n in tn.nodes if n.name != input_name]
    if len(names) != len(arrays):
        raise ValueError(f"{len(names)} core nodes vs {len(arrays)} arrays")
    return dict(zip(names, arrays))
