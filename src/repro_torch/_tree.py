"""Nested dicts / lists of tensors: the port's stand-in for a JAX pytree.

Containers are dicts, lists and plain tuples; a tuple subclass (a
`parallel.sharding.PartitionSpec`, a `Layout`) is a leaf, as JAX treats a
PartitionSpec."""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def _is_seq(tree: Any) -> bool:
    return isinstance(tree, list) or type(tree) is tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise; ``rest`` trees must have ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_seq(tree):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_stack(n: int, make: Callable) -> Any:
    """The ``n`` trees that ``make()`` returns in turn, stacked leafwise
    along a new leading axis.  Each tree is copied into the stack as it is
    made, so no more than one lives beside it (a layer of dbrx-132b's
    experts is 6.3 GB)."""
    first = make()
    out = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    tree_map(lambda o, t: o[0].copy_(t), out, first)
    del first
    for i in range(1, n):
        tree_map(lambda o, t: o[i].copy_(t), out, make())
    return out


def tree_map_with_path(fn: Callable, tree: Any, sep: str = ".", prefix: str = "") -> Any:
    """``fn(leaf path, leaf)`` leafwise, the path as `tree_items` gives it."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, sep, f"{prefix}{k}{sep}") for k, v in tree.items()}
    if _is_seq(tree):
        return [tree_map_with_path(fn, v, sep, f"{prefix}{i}{sep}") for i, v in enumerate(tree)]
    return fn(prefix[:-len(sep)], tree)


def tree_items(tree: Any, sep: str = ".", prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(leaf path, leaf) pairs in sorted-key order, as
    `jax.tree_util.tree_flatten_with_path` orders a dict; the path's keys
    and list positions are joined by ``sep``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], sep, f"{prefix}{k}{sep}")
    elif _is_seq(tree):
        for i, v in enumerate(tree):
            yield from tree_items(v, sep, f"{prefix}{i}{sep}")
    else:
        yield prefix[:-len(sep)], tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_items(tree)]
