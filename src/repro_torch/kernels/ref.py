"""Plain PyTorch ground truth for the kernels (port of ``kernels/ref.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.contraction import execute_path
from repro_torch.core.paths import CandidatePath
from repro_torch.core.tensor_network import Node, TensorNetwork


def _with_batch(tn: TensorNetwork, tokens: int) -> TensorNetwork:
    """Rebind the X node's batch dim (paths are batch-size agnostic)."""
    return TensorNetwork([
        Node(n.name, n.edges, (tokens,) + n.dims[1:], n.kind)
        if n.name == "X" else n
        for n in tn.nodes
    ])


def gemm_ref(a: torch.Tensor, b: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """fp32-accumulated matmul reference."""
    out_dtype = out_dtype or a.dtype
    return (a.to(torch.float32) @ b.to(torch.float32)).to(out_dtype)


def tt_linear_ref(
    x: torch.Tensor,
    cores: Sequence[torch.Tensor],
    tn: TensorNetwork,
    path: CandidatePath,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """TT-linear forward along ``path`` on the whole batch at once."""
    out_dtype = out_dtype or x.dtype
    in_modes = tuple(
        d for n in tn.nodes if n.name == "X"
        for e, d in zip(n.edges, n.dims) if e != "b"
    )
    tokens = x.shape[0]
    tn = _with_batch(tn, tokens)
    tensors = {"X": x.reshape((tokens,) + in_modes)}
    names = [n.name for n in tn.nodes if n.name != "X"]
    tensors.update(zip(names, cores))
    n_out_edges = len(tn.free_edges) - 1
    out_edges = ("b",) + tuple(f"i{t + 1}" for t in range(n_out_edges))
    y = execute_path(tn, path, tensors, out_edges=out_edges,
                     preferred_dtype=torch.float32)
    return y.reshape(tokens, -1).to(out_dtype)
