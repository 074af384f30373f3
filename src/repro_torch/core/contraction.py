"""Execute a searched contraction path as a chain of ``torch.tensordot``.

Port of ``src/repro/core/contraction.py``.  The path (static Python data)
is unrolled eagerly; edge bookkeeping mirrors
``TensorNetwork.contract_pair``: result axes are A's free edges followed
by B's free edges, and the merged node is appended to the working list.
"""

from __future__ import annotations

import math
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
    ``contract_fn(ta, tb, (ax_a, ax_b), lead=lead)`` and returns the
    tensordot-ordered result (A's free axes then B's free axes); the plan
    executor uses it to lower each step to the dataflow GEMM kernel.

    Tensors with one axis more than their node's dims carry a leading
    batch axis (the experts' stacked axis, the reference's ``jax.vmap``),
    and so does the result: every step is one batched product over it
    (``lead=1``, the axes counted over the node dims).
    """
    steps = path.steps if isinstance(path, CandidatePath) else tuple(path)
    lead = tensors[tn.nodes[0].name].dim() - len(tn.nodes[0].dims)
    work: list[tuple[tuple[str, ...], torch.Tensor]] = []
    for node in tn.nodes:
        t = tensors[node.name]
        if lead not in (0, 1) or tuple(t.shape[lead:]) != node.dims:
            raise ValueError(
                f"tensor {node.name}: shape {tuple(t.shape)} != declared "
                f"{node.dims}" + (" behind one batch axis" if lead else ""))
        work.append((node.edges, t))

    for (i, j) in steps:
        (ea, ta) = work[i]
        (eb, tb) = work[j]
        shared = [e for e in ea if e in eb]
        ax_a = [ea.index(e) for e in shared]
        ax_b = [eb.index(e) for e in shared]
        if contract_fn is not None:
            tc = contract_fn(ta, tb, (ax_a, ax_b), lead=lead)
        else:
            if preferred_dtype is not None:
                ta, tb = ta.to(preferred_dtype), tb.to(preferred_dtype)
            if lead:
                a3, b3, shape = as_matrices(ta, tb, (ax_a, ax_b), lead)
                tc = torch.bmm(a3, b3).reshape(shape)
            else:
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
        perm = [lead + edges.index(e) for e in out_edges]
        result = result.permute(list(range(lead)) + perm)
    return result


def as_matrices(ta: torch.Tensor, tb: torch.Tensor, axes,
                lead: int = 0) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """One pairwise step as a matrix product: A permuted to (free...,
    contracted...) and flattened to ``(M, K)``, B to ``(K, N)``, both
    contiguous and behind their ``lead`` shared batch axes, and the
    tensordot-ordered shape of the result (the batch axes, A's free axes,
    then B's).  ``axes`` count over the dims behind the batch axes."""
    ax_a, ax_b = (list(a) for a in axes)
    a_free = [i for i in range(ta.dim() - lead) if i not in ax_a]
    b_free = [i for i in range(tb.dim() - lead) if i not in ax_b]
    a_dims = tuple(ta.shape[lead + i] for i in a_free)
    b_dims = tuple(tb.shape[lead + i] for i in b_free)
    k = math.prod(ta.shape[lead + i] for i in ax_a)
    batch = tuple(ta.shape[:lead])
    keep = list(range(lead))
    a2 = ta.permute(keep + [lead + i for i in a_free + ax_a]).reshape(
        batch + (math.prod(a_dims), k)).contiguous()
    b2 = tb.permute(keep + [lead + i for i in ax_b + b_free]).reshape(
        batch + (k, math.prod(b_dims))).contiguous()
    return a2, b2, batch + a_dims + b_dims


def core_tensors(
    tn: TensorNetwork, arrays: Sequence[torch.Tensor], input_name: str = "X"
) -> dict[str, torch.Tensor]:
    """Zip weight-core arrays (in node order, skipping the input node)."""
    names = [n.name for n in tn.nodes if n.name != input_name]
    if len(names) != len(arrays):
        raise ValueError(f"{len(names)} core nodes vs {len(arrays)} arrays")
    return dict(zip(names, arrays))
