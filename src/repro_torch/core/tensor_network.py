"""Tensor-network representation of tensorized (TT) layers.

Framework-neutral copy of ``src/repro/core/tensor_network.py`` (the port never imports
the JAX package).

A tensorized layer's forward pass is a tensor network: TT cores + the input
activation tensor, joined by labelled edges.  A *contraction path* is a
sequence of pairwise contractions that reduces the network to the output
tensor.  Each pairwise contraction is a GEMM whose (M, K, N) shape is
derived from the edge dimensions — this GEMM view is what the latency
simulator (``repro_torch.core.simulator``) consumes.

Graph semantics follow Fig. 1 of the paper: a node with d edges is a d-way
tensor; an edge shared by two nodes is contracted; edges appearing on a
single node are *free* and survive into the output.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence


@dataclasses.dataclass(frozen=True)
class Node:
    """One tensor in the network.

    ``edges`` are string labels, one per axis; ``dims`` the matching sizes.
    ``kind`` distinguishes weight cores (resident, small) from the streamed
    activation tensor — the simulator uses this to decide which operand is a
    candidate for the *stationary* role of a dataflow.
    """

    name: str
    edges: tuple[str, ...]
    dims: tuple[int, ...]
    kind: str = "core"  # "core" | "input"

    def __post_init__(self) -> None:
        if len(self.edges) != len(self.dims):
            raise ValueError(
                f"node {self.name}: {len(self.edges)} edges vs {len(self.dims)} dims"
            )
        if len(set(self.edges)) != len(self.edges):
            raise ValueError(f"node {self.name}: repeated edge label")

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def dim_of(self, edge: str) -> int:
        return self.dims[self.edges.index(edge)]


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """GEMM view of one pairwise contraction: (M x K) @ (K x N).

    ``a_is_input`` / ``b_is_input`` record whether either operand descends
    from the streamed activation tensor (vs. resident weight cores); the
    simulator's IS/WS dataflows care about this distinction.
    """

    M: int
    K: int
    N: int
    a_is_input: bool = False
    b_is_input: bool = False

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N

    @property
    def flops(self) -> int:
        return 2 * self.M * self.K * self.N

    def as_tuple(self) -> tuple[int, int, int]:
        return (self.M, self.K, self.N)


class TensorNetwork:
    """An immutable set of nodes with shared-edge contraction semantics."""

    def __init__(self, nodes: Sequence[Node]):
        self.nodes: tuple[Node, ...] = tuple(nodes)
        self._check()

    def _check(self) -> None:
        count: dict[str, list[int]] = {}
        for idx, n in enumerate(self.nodes):
            for e, d in zip(n.edges, n.dims):
                count.setdefault(e, []).append(d)
        for e, ds in count.items():
            if len(ds) > 2:
                raise ValueError(f"edge {e} shared by >2 nodes (hyper-edges unsupported)")
            if len(ds) == 2 and ds[0] != ds[1]:
                raise ValueError(f"edge {e}: dim mismatch {ds}")
        self._edge_count = {e: len(ds) for e, ds in count.items()}

    # -- structural queries ------------------------------------------------
    @property
    def free_edges(self) -> tuple[str, ...]:
        return tuple(e for e, c in self._edge_count.items() if c == 1)

    def output_dims(self) -> dict[str, int]:
        out = {}
        for n in self.nodes:
            for e, d in zip(n.edges, n.dims):
                if self._edge_count[e] == 1:
                    out[e] = d
        return out

    def shared_edges(self, i: int, j: int) -> tuple[str, ...]:
        a, b = self.nodes[i], self.nodes[j]
        return tuple(e for e in a.edges if e in b.edges)

    def total_macs(self, path: Sequence[tuple[int, int]]) -> int:
        return sum(g.macs for g in self.gemm_sequence(path))

    # -- contraction -------------------------------------------------------
    def contract_pair(self, i: int, j: int) -> tuple["TensorNetwork", GemmShape]:
        """Contract nodes i and j; returns the reduced network + GEMM shape.

        The result node keeps A's free edges then B's free edges (A = node i).
        """
        if i == j:
            raise ValueError("cannot contract a node with itself")
        a, b = self.nodes[i], self.nodes[j]
        shared = set(a.edges) & set(b.edges)
        a_free = [(e, d) for e, d in zip(a.edges, a.dims) if e not in shared]
        b_free = [(e, d) for e, d in zip(b.edges, b.dims) if e not in shared]
        m = math.prod(d for _, d in a_free)
        n = math.prod(d for _, d in b_free)
        k = math.prod(a.dim_of(e) for e in shared) if shared else 1
        gemm = GemmShape(
            M=m, K=k, N=n,
            a_is_input=(a.kind == "input"),
            b_is_input=(b.kind == "input"),
        )
        new_kind = "input" if (a.kind == "input" or b.kind == "input") else "core"
        merged = Node(
            name=f"({a.name}*{b.name})",
            edges=tuple(e for e, _ in a_free) + tuple(e for e, _ in b_free),
            dims=tuple(d for _, d in a_free) + tuple(d for _, d in b_free),
            kind=new_kind,
        )
        rest = [nd for t, nd in enumerate(self.nodes) if t not in (i, j)]
        return TensorNetwork(rest + [merged]), gemm

    def gemm_sequence(self, path: Sequence[tuple[int, int]]) -> list[GemmShape]:
        """GEMM shapes produced by executing ``path`` (list of index pairs).

        Path indices refer to the *current* node list at each step (the merged
        node is appended at the end), matching ``contract_pair`` semantics.
        """
        tn: TensorNetwork = self
        shapes = []
        for (i, j) in path:
            tn, g = tn.contract_pair(i, j)
            shapes.append(g)
        if len(tn.nodes) != 1:
            raise ValueError("path does not fully contract the network")
        return shapes

    # -- canonical state key for redundancy pruning ------------------------
    def state_key(self) -> frozenset:
        """Order-independent signature of the current node set.

        Two partial contraction orders that produce the same set of
        intermediate tensors (same edge sets) are *computationally
        equivalent* going forward — the DFS prunes revisits (paper §3.2).
        """
        return frozenset(frozenset(n.edges) for n in self.nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    def __repr__(self) -> str:
        return "TN[" + ", ".join(f"{n.name}{n.dims}" for n in self.nodes) + "]"


# ---------------------------------------------------------------------------
# Builders for the paper's layer families
# ---------------------------------------------------------------------------

def tt_linear_network(
    batch: int | Sequence[int],
    in_modes: Sequence[int],
    out_modes: Sequence[int],
    ranks: Sequence[int],
) -> TensorNetwork:
    """TT-format linear layer (paper eq. 2 / Fig. 1e).

    Cores G_1..G_d carry output modes ``m_k``; G_{d+1}..G_{2d} carry input
    modes ``n_k``; consecutive cores share rank edges.  Boundary ranks
    (r_0 = r_2d = 1) are dropped.  ``ranks`` has length 2d-1.

    ``batch`` may be a tuple — the input then keeps multiple leading batch
    edges (``b0``, ``b1``, ...).  Contraction paths and MACs are identical
    to the flattened form; the distributed executor uses the split form so
    (batch, seq) shardings survive without relayout.
    """
    d_out, d_in = len(out_modes), len(in_modes)
    n_cores = d_out + d_in
    if len(ranks) != n_cores - 1:
        raise ValueError(f"need {n_cores - 1} interior ranks, got {len(ranks)}")
    nodes = []
    for k in range(n_cores):
        edges: list[str] = []
        dims: list[int] = []
        if k > 0:
            edges.append(f"r{k}")
            dims.append(ranks[k - 1])
        if k < d_out:
            edges.append(f"i{k + 1}")
            dims.append(out_modes[k])
        else:
            edges.append(f"j{k - d_out + 1}")
            dims.append(in_modes[k - d_out])
        if k < n_cores - 1:
            edges.append(f"r{k + 1}")
            dims.append(ranks[k])
        nodes.append(Node(f"G{k + 1}", tuple(edges), tuple(dims), kind="core"))
    if isinstance(batch, (tuple, list)):
        b_edges = tuple(f"b{t}" for t in range(len(batch)))
        b_dims = tuple(batch)
    else:
        b_edges, b_dims = ("b",), (batch,)
    x_edges = b_edges + tuple(f"j{t + 1}" for t in range(d_in))
    x_dims = b_dims + tuple(in_modes)
    nodes.append(Node("X", x_edges, x_dims, kind="input"))
    return TensorNetwork(nodes)


def tt_conv_network(
    patches: int,
    in_modes: tuple[int, int],
    out_modes: tuple[int, int],
    kernel: int,
    ranks: Sequence[int],
) -> TensorNetwork:
    """TT-format convolution (paper eq. 3-4 / Fig. 1f), im2col view.

    Five cores: G1 (O1), G2 (O2), G3 (I1), G4 (I2), G5 (K=Kh*Kw); the
    unfolded input X_unf has edges (I1, I2, K, L) with L = spatial patches
    x batch.  ``ranks`` = (r1, r2, r3, r4).
    """
    (o1, o2), (i1, i2) = out_modes, in_modes
    r1, r2, r3, r4 = ranks
    nodes = [
        Node("G1", ("o1", "r1"), (o1, r1)),
        Node("G2", ("r1", "o2", "r2"), (r1, o2, r2)),
        Node("G3", ("r2", "i1", "r3"), (r2, i1, r3)),
        Node("G4", ("r3", "i2", "r4"), (r3, i2, r4)),
        Node("G5", ("r4", "k"), (r4, kernel)),
        Node("X", ("i1", "i2", "k", "l"), (i1, i2, kernel, patches), kind="input"),
    ]
    return TensorNetwork(nodes)


def dense_linear_network(batch: int, n_in: int, n_out: int) -> TensorNetwork:
    """Uncompressed baseline: one weight node, one GEMM."""
    return TensorNetwork(
        [
            Node("W", ("j", "i"), (n_in, n_out)),
            Node("X", ("b", "j"), (batch, n_in), kind="input"),
        ]
    )


def factorize(n: int, d: int) -> tuple[int, ...]:
    """Balanced d-way factorization of n (largest factors first).

    Greedy: repeatedly peel the largest prime factor onto the currently
    smallest bucket.  Guarantees prod == n; buckets as equal as possible.
    """
    if d <= 0:
        raise ValueError("d must be positive")
    if d == 1:
        return (n,)
    primes: list[int] = []
    m = n
    p = 2
    while p * p <= m:
        while m % p == 0:
            primes.append(p)
            m //= p
        p += 1
    if m > 1:
        primes.append(m)
    buckets = [1] * d
    for f in sorted(primes, reverse=True):
        buckets[buckets.index(min(buckets))] *= f
    return tuple(sorted(buckets, reverse=True))
