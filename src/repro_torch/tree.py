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
