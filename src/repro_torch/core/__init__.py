"""Tensor networks, MAC-guided path search and the torch path executor."""

from .tensor_network import (
    GemmShape,
    Node,
    TensorNetwork,
    factorize,
    tt_linear_network,
)
from .paths import CandidatePath, find_topk_paths
from .contraction import core_tensors, execute_path

__all__ = [
    "GemmShape", "Node", "TensorNetwork", "factorize", "tt_linear_network",
    "CandidatePath", "find_topk_paths",
    "core_tensors", "execute_path",
]
