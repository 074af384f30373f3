"""Backward-pass contraction networks of a TT layer (training).

Port of the executor-side half of ``src/repro/core/backward.py``: the
gradient networks that ``plan/executor.py`` contracts.  The DSE side
(``layer_backward``, ``update_seconds``, ``memoised_layer_backwards``)
stays with the planning stack (ROADMAP.md, Queue A item 9).

The forward pass of a TT layer is one tensor network; its backward pass is
one network per gradient:

  * ``dL/dX``   replaces the input node by the output gradient ``dY``
    (which carries the forward network's free edges) and contracts it
    against the unchanged cores; the result has dX's shape.
  * ``dL/dG_k`` removes core ``G_k`` and adds ``dY``; the batch edges are
    then shared between ``X`` and ``dY`` (the sum over the batch) and the
    free edges are exactly ``G_k``'s.
"""

from __future__ import annotations

from .tensor_network import Node, TensorNetwork

#: name of the output-gradient node injected into backward networks
GRAD_NODE = "dY"


def _input_node(tn: TensorNetwork) -> Node:
    inputs = [n for n in tn.nodes if n.kind == "input"]
    if len(inputs) != 1:
        raise ValueError(
            f"backward derivation needs exactly one input node, found "
            f"{[n.name for n in inputs]}")
    return inputs[0]


def _grad_output_node(tn: TensorNetwork) -> Node:
    """The ``dY`` node: batch edges first, then the cores' free edges in
    node order (the row-major layout of the forward output)."""
    x = _input_node(tn)
    free = set(tn.free_edges)
    batch = [(e, d) for e, d in zip(x.edges, x.dims) if e in free]
    out = [
        (e, d)
        for n in tn.nodes if n.kind != "input"
        for e, d in zip(n.edges, n.dims) if e in free
    ]
    edges = tuple(e for e, _ in batch + out)
    dims = tuple(d for _, d in batch + out)
    return Node(GRAD_NODE, edges, dims, kind="input")


def grad_input_network(tn: TensorNetwork) -> TensorNetwork:
    """The ``dL/dX`` network: weight cores + ``dY``."""
    cores = [n for n in tn.nodes if n.kind != "input"]
    return TensorNetwork(cores + [_grad_output_node(tn)])


def grad_core_network(tn: TensorNetwork, core_name: str) -> TensorNetwork:
    """The ``dL/dG_k`` network: all nodes except ``G_k``, plus ``dY``."""
    keep = [n for n in tn.nodes if n.name != core_name]
    if len(keep) == len(tn.nodes):
        raise ValueError(f"no node named {core_name!r} in {tn!r}")
    return TensorNetwork(keep + [_grad_output_node(tn)])


def backward_networks(tn: TensorNetwork) -> list[tuple[str, TensorNetwork]]:
    """``[("dx", net), (core_name, net), ...]``: the activation gradient
    first, then one weight gradient per core in node order."""
    out: list[tuple[str, TensorNetwork]] = [("dx", grad_input_network(tn))]
    for n in tn.nodes:
        if n.kind != "input":
            out.append((n.name, grad_core_network(tn, n.name)))
    return out
