"""Nested dicts of tensors, walked in JAX's pytree order.

The training path (``optim``, ``checkpoint.manager``, ``launch.steps``)
treats parameters and optimizer state as JAX treats its pytrees: a dict's
children in sorted key order, a NamedTuple's (``AdamWState``) in field
order; anything else is a leaf. The order matters twice: `apply_updates`
sums the global norm over the leaves in it, and a checkpoint names each
leaf by its path, as ``jax.tree_util.tree_flatten_with_path`` does (a
dict key, a NamedTuple field's name).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] in JAX's order; a path is a tuple of strings."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_path(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [item for name in tree._fields
                for item in flatten_with_path(getattr(tree, name),
                                              prefix + (name,))]
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, values) -> Any:
    """`like`'s structure with its leaves replaced, in order, by `values`."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}          # keep the caller's order
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, n)) for n in t._fields))
        return next(it)

    return build(like)


def map(fn: Callable, tree, *rest) -> Any:  # noqa: A001 (jax.tree.map)
    """``jax.tree.map``: fn over the leaves of `tree` and of each tree in
    `rest` (the same structure, matched by key and field); the result keeps
    `tree`'s key order."""
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map(fn, getattr(tree, n),
                                *(getattr(r, n) for r in rest))
                            for n in tree._fields))
    return fn(tree, *rest)
