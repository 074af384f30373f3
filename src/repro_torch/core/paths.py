"""MAC-guided contraction-path search (paper 3.2).

Framework-neutral copy of ``src/repro/core/paths.py`` (the port never imports
the JAX package).

Depth-first search over pairwise contraction orders of a tensor network,
keeping the top-K lowest-MAC complete paths.  Two prunes make this
tractable (the paper's "redundancy-pruning strategy"):

  1. *Canonical-state memoisation* — two partial orders that reach the same
     set of intermediate tensors are equivalent going forward.  For top-K
     search we keep up to K distinct arrival costs per state: a revisit is
     pruned only if it duplicates a recorded arrival cost or is no better
     than the K-th cheapest recorded arrival (arriving costlier than K
     cheaper prefixes cannot contribute a top-K completion).
  2. *Branch-and-bound* — a partial path whose accumulated MACs already
     meet or exceed the current K-th best complete cost is abandoned.

Additionally, complete paths whose multiset of GEMM shapes matches an
already-kept candidate are dropped as *computationally equivalent*,
keeping the candidate set diverse (distinct hardware behaviours).
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import Optional, Sequence

from .tensor_network import GemmShape, TensorNetwork


@dataclasses.dataclass(frozen=True)
class CandidatePath:
    """A complete contraction path with its cost summary."""

    steps: tuple[tuple[int, int], ...]  # pairwise (i, j) in current-index space
    macs: int
    gemms: tuple[GemmShape, ...]

    @property
    def signature(self) -> frozenset:
        """Multiset of GEMM shapes — equivalence class for diversity pruning."""
        counted: dict[tuple[int, int, int], int] = {}
        for g in self.gemms:
            counted[g.as_tuple()] = counted.get(g.as_tuple(), 0) + 1
        return frozenset(counted.items())


def find_topk_paths(
    tn: TensorNetwork,
    k: int = 4,
    max_states: int = 200_000,
    connected_only: bool = True,
) -> list[CandidatePath]:
    """Return up to ``k`` lowest-MAC contraction paths, ascending by MACs.

    ``connected_only`` restricts to pairs sharing at least one edge; for
    non-degenerate TT ranks (>= 2) the connected space contains the MAC
    optimum (property-tested against exhaustive enumeration), and outer
    products blow up the search space.  Known limitation: with rank-1
    interior edges the chain is effectively disconnected and an outer
    product can be marginally cheaper.  ``max_states`` caps DFS work.
    """
    if len(tn) < 2:
        raise ValueError("network must contain at least two nodes")

    # heap of (-macs, counter, CandidatePath): max-heap on cost, size <= k
    best: list[tuple[int, int, CandidatePath]] = []
    seen_signatures: set[frozenset] = set()
    visited: dict[frozenset, list[int]] = {}  # state -> sorted arrival costs (<= k)
    counter = [0]
    states = [0]

    def kth_cost() -> Optional[int]:
        if len(best) < k:
            return None
        return -best[0][0]

    def offer(cand: CandidatePath) -> None:
        if cand.signature in seen_signatures:
            # computationally equivalent to a kept candidate -> redundant
            return
        counter[0] += 1
        heapq.heappush(best, (-cand.macs, counter[0], cand))
        seen_signatures.add(cand.signature)
        if len(best) > k:
            _, _, dropped = heapq.heappop(best)
            seen_signatures.discard(dropped.signature)

    def dfs(
        cur: TensorNetwork,
        acc_macs: int,
        steps: list[tuple[int, int]],
        gemms: list[GemmShape],
    ) -> None:
        if states[0] > max_states:
            return
        states[0] += 1
        bound = kth_cost()
        if bound is not None and acc_macs >= bound:
            return  # branch-and-bound
        key = cur.state_key()
        arrivals = visited.setdefault(key, [])
        if acc_macs in arrivals:
            return  # identical-cost prefix to this state already explored
        if len(arrivals) >= k and acc_macs >= arrivals[k - 1]:
            return  # k cheaper prefixes already reached this state
        bisect.insort(arrivals, acc_macs)
        del arrivals[k:]
        n = len(cur)
        if n == 1:
            offer(CandidatePath(tuple(steps), acc_macs, tuple(gemms)))
            return
        pairs = []
        for i in range(n):
            for j in range(i + 1, n):
                shared = cur.shared_edges(i, j)
                if connected_only and not shared:
                    continue
                pairs.append((i, j))
        if not pairs:  # disconnected network: allow one outer product
            pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        # visit cheapest-GEMM pairs first so the bound tightens early
        scored = []
        for (i, j) in pairs:
            nxt, g = cur.contract_pair(i, j)
            scored.append((g.macs, i, j, nxt, g))
        scored.sort(key=lambda t: t[0])
        for macs, i, j, nxt, g in scored:
            bound = kth_cost()
            if bound is not None and acc_macs + macs >= bound:
                continue
            steps.append((i, j))
            gemms.append(g)
            dfs(nxt, acc_macs + macs, steps, gemms)
            steps.pop()
            gemms.pop()

    dfs(tn, 0, [], [])
    out = sorted((c for _, _, c in best), key=lambda c: c.macs)
    return out


def greedy_path(tn: TensorNetwork) -> CandidatePath:
    """Cheapest-pair-first greedy path (baseline; not necessarily optimal)."""
    cur = tn
    steps: list[tuple[int, int]] = []
    gemms: list[GemmShape] = []
    macs = 0
    while len(cur) > 1:
        n = len(cur)
        options = []
        for i in range(n):
            for j in range(i + 1, n):
                if not cur.shared_edges(i, j):
                    continue
                nxt, g = cur.contract_pair(i, j)
                options.append((g.macs, i, j, nxt, g))
        if not options:
            for i in range(n):
                for j in range(i + 1, n):
                    nxt, g = cur.contract_pair(i, j)
                    options.append((g.macs, i, j, nxt, g))
        options.sort(key=lambda t: t[0])
        c, i, j, cur, g = options[0]
        steps.append((i, j))
        gemms.append(g)
        macs += c
    return CandidatePath(tuple(steps), macs, tuple(gemms))


def reconstruction_path(tn: TensorNetwork) -> CandidatePath:
    """The naive 'reconstruct W then multiply' order (paper Fig. 3 left).

    Contracts all weight cores together first (materialising the full
    weight), then applies the input — the strawman baseline.
    """
    cur = tn
    steps: list[tuple[int, int]] = []
    gemms: list[GemmShape] = []
    macs = 0
    while len(cur) > 1:
        n = len(cur)
        core_idx = [t for t in range(n) if cur.nodes[t].kind == "core"]
        if len(core_idx) >= 2:
            # contract the first adjacent core pair (chain order)
            pair = None
            for a in core_idx:
                for b in core_idx:
                    if a < b and cur.shared_edges(a, b):
                        pair = (a, b)
                        break
                if pair:
                    break
            if pair is None:
                pair = (core_idx[0], core_idx[1])
            i, j = pair
        else:
            i, j = 0, 1
            if n > 2:
                raise AssertionError("unexpected network shape")
        cur, g = cur.contract_pair(i, j)
        steps.append((i, j))
        gemms.append(g)
        macs += g.macs
    return CandidatePath(tuple(steps), macs, tuple(gemms))
