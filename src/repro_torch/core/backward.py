"""Backward-pass contraction networks for tensorized layers (training DSE).

Framework-neutral copy of ``src/repro/core/backward.py`` (the port never imports
the JAX package).

The forward pass of a TT layer is one tensor network; its backward pass is
a *family* of tensor networks, one per gradient (FETTA, arXiv 2504.06474):

  * ``dL/dX``   — replace the input node by the output gradient ``dY``
    (which carries the forward network's free edges) and contract against
    the unchanged weight cores.  The free edges of this network are
    exactly the input node's edges, so the result has dX's shape.
  * ``dL/dG_k`` — remove core ``G_k`` and add ``dY``; the batch edges are
    now shared between ``X`` and ``dY`` (the sum over the batch that
    weight gradients perform), and the free edges are exactly ``G_k``'s
    edges.

Each backward network has its own candidate contraction paths and its own
latency-optimal dataflow/path — generally *different* from the forward's
(the asymmetry the training DSE exploits).  No activation stashing is
modelled: gradients contract directly from ``X``, ``dY`` and the cores,
which is both how the executor computes them (``repro_torch.plan.executor``)
and what keeps the cost model path-independent of the forward choice.

The grad-update term models the optimizer's elementwise parameter update
as a DRAM-bound streaming pass over the parameter state.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .paths import CandidatePath, find_topk_paths
from .simulator import HardwareConfig
from .tensor_network import Node, TensorNetwork

#: name of the output-gradient node injected into backward networks
GRAD_NODE = "dY"

#: DRAM words moved per parameter by one AdamW-style update step:
#: read {param, grad, m, v}, write {param, m, v} — 7 words, +1 headroom
#: for the scheduler/padding slop of a real streaming update kernel.
UPDATE_WORDS_PER_PARAM = 8.0


def _input_node(tn: TensorNetwork) -> Node:
    inputs = [n for n in tn.nodes if n.kind == "input"]
    if len(inputs) != 1:
        raise ValueError(
            f"backward derivation needs exactly one input node, found "
            f"{[n.name for n in inputs]}")
    return inputs[0]


def _grad_output_node(tn: TensorNetwork) -> Node:
    """The ``dY`` node: carries the forward network's free edges.

    Edge order is batch edges (the input node's free edges) first, then
    the weight-core free edges in node order — matching the row-major
    layout of the forward output ``(tokens, d_out)``.
    """
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
    """The ``dL/dX`` network: weight cores + ``dY``.

    Free edges are exactly the forward input node's edges, so contracting
    this network yields a tensor of dX's shape.
    """
    cores = [n for n in tn.nodes if n.kind != "input"]
    return TensorNetwork(cores + [_grad_output_node(tn)])


def grad_core_network(tn: TensorNetwork, core_name: str) -> TensorNetwork:
    """The ``dL/dG_k`` network: all nodes except ``G_k``, plus ``dY``.

    The batch edges become shared (``X``–``dY``) — the weight gradient's
    sum over the batch — and the free edges are exactly ``G_k``'s edges.
    """
    keep = [n for n in tn.nodes if n.name != core_name]
    if len(keep) == len(tn.nodes):
        raise ValueError(f"no node named {core_name!r} in {tn!r}")
    return TensorNetwork(keep + [_grad_output_node(tn)])


def backward_networks(tn: TensorNetwork) -> list[tuple[str, TensorNetwork]]:
    """All backward problems of a layer: ``[("dx", net), (core_name, net)...]``.

    ``"dx"`` is the activation gradient (the only one that propagates to
    the previous layer); the remaining entries are the per-core weight
    gradients, keyed by the forward network's node names.
    """
    out: list[tuple[str, TensorNetwork]] = [("dx", grad_input_network(tn))]
    for n in tn.nodes:
        if n.kind != "input":
            out.append((n.name, grad_core_network(tn, n.name)))
    return out


# ---------------------------------------------------------------------------
# per-layer backward DSE problem
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BackwardProblem:
    """One gradient's contraction problem with its candidate paths."""

    wrt: str                                  # "dx" | core node name
    network: TensorNetwork
    paths: tuple[CandidatePath, ...]


@dataclasses.dataclass(frozen=True)
class LayerBackward:
    """All backward problems of one layer + its update-cost parameters."""

    problems: tuple[BackwardProblem, ...]
    n_params: int                             # total weight-core elements

    @property
    def dx(self) -> BackwardProblem:
        return self.problems[0]


def layer_backward(tn: TensorNetwork, k: int = 4) -> LayerBackward:
    """Derive a layer's full backward DSE problem (top-``k`` paths each)."""
    problems = tuple(
        BackwardProblem(wrt, net, tuple(find_topk_paths(net, k=k)))
        for wrt, net in backward_networks(tn)
    )
    n_params = sum(n.size for n in tn.nodes if n.kind != "input")
    return LayerBackward(problems, n_params)


def update_seconds(n_params: int, hw: HardwareConfig,
                   words_per_param: float = UPDATE_WORDS_PER_PARAM) -> float:
    """Optimizer-update latency: a DRAM-bound elementwise streaming pass."""
    cycles = n_params * words_per_param / hw.dram_words_per_cycle
    return cycles / hw.freq_hz


@dataclasses.dataclass(frozen=True)
class TrainCostWeights:
    """Relative weights of the train-latency decomposition (paper's
    ``T_train = w_f * T_fwd + w_b * T_bwd + w_u * T_update``).

    Defaults weight all three at 1 (one fwd + one bwd + one update per
    step); gradient-accumulation or multi-micro-batch schedules rescale.
    """

    fwd: float = 1.0
    bwd: float = 1.0
    update: float = 1.0


def memoised_layer_backwards(
    networks: Sequence[TensorNetwork], k: int = 4
) -> list[LayerBackward]:
    """``layer_backward`` over a model, deduping identical layer networks
    (transformer stacks repeat the same projection geometry L times)."""
    memo: dict[tuple, LayerBackward] = {}
    out = []
    for tn in networks:
        key = tuple((n.edges, n.dims, n.kind) for n in tn.nodes)
        if key not in memo:
            memo[key] = layer_backward(tn, k=k)
        out.append(memo[key])
    return out
