"""Parameter trees: nested dicts, lists and NamedTuples of tensors.

The reference keeps its parameters and optimizer state as JAX pytrees;
the port keeps the same trees of torch tensors.  :func:`leaves` walks them
in JAX's order (dict keys sorted, sequences and NamedTuple fields in
order), so a loop over leaves (the global gradient norm, the optimizer)
visits them as the reference does.
"""

from __future__ import annotations

from typing import Any, Callable


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def is_layer_stack(tree: Any) -> bool:
    """A list of per-layer dicts: one tree of leaves stacked on a leading
    layer axis in the reference (``params["blocks"]``)."""
    return isinstance(tree, (list, tuple)) and not is_namedtuple(tree) \
        and len(tree) > 0 and all(isinstance(t, dict) for t in tree)


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in JAX's flattening order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in leaves(item)]
    return [tree]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if is_namedtuple(tree):
        return type(tree)(*(map_tree(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def map_indexed(fn: Callable, tree: Any) -> Any:
    """``fn(i, leaf)`` over the leaves of ``tree``, ``i`` the leaf's place
    in :func:`leaves`' order; the result keeps ``tree``'s structure."""
    count = iter(range(len(leaves(tree))))

    def walk(t):
        if isinstance(t, dict):
            done = {k: walk(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if is_namedtuple(t):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return fn(next(count), t)

    return walk(tree)
