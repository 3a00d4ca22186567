"""Nested dict / list trees (of tensors, numpy arrays or leaf specs),
walked in the JAX package's leaf order: a dict's keys sorted, a list's
items in order -- the order of ``jax.tree.leaves``, which the
optimizer's global norm sums in and the checkpoint's key paths follow.
Anything but a dict or a list is a leaf (a tuple too: ``weights``' leaf
specs are tuples)."""
from __future__ import annotations

from typing import Callable, Iterator, Tuple


def items(tree, path: tuple = ()) -> Iterator[Tuple[tuple, object]]:
    """(path, leaf) of every leaf of ``tree`` in JAX's order; a path is
    the dict keys and list indices from the root."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from items(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def key(path: tuple) -> str:
    """A path as the reference checkpoint names it: its parts joined by
    ``/`` (``repro.checkpoint.manager._flatten``)."""
    return "/".join(str(p) for p in path)


def get(tree, path: tuple):
    for p in path:
        tree = tree[p]
    return tree


def map_tree(fn: Callable, tree, path: tuple = ()):
    """A tree of ``tree``'s structure with ``fn(path, leaf)`` at each
    leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def unflatten(like, new_leaves: list):
    """A tree of ``like``'s structure holding ``new_leaves`` in the order
    ``items(like)`` walks it."""
    at = {path: i for i, (path, _) in enumerate(items(like))}
    return map_tree(lambda path, _: new_leaves[at[path]], like)
