"""Nested dicts / lists of tensors (the port's stand-in for JAX pytrees)."""
from __future__ import annotations


def map_with_path(fn, tree, *rest, path=()):
    """Apply ``fn(path, leaf, *other_leaves)`` over parallel trees; ``path``
    is the tuple of dict keys and list indices leading to the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out
