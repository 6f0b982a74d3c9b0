"""Nested dicts / lists of tensors: the port's stand-in for a JAX pytree."""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise; ``rest`` trees must have ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted leaf path, leaf) pairs in sorted-key order, as
    `jax.tree_util.tree_flatten_with_path` orders a dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_items(tree)]
