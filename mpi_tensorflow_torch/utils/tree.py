"""Nested trees of tensors: parameters, the optimizer's per-leaf state and
a model's BatchNorm statistics.

A tree is dicts and lists nested to any depth; anything else is a leaf
(a tensor, an array, a shape tuple).  Every function here walks one
order: depth first, a dict's keys in insertion order, a list's items by
index.  A model builds each of its trees in one fixed order
(``param_tree()``, ``init_state()`` and the new state its forward
returns), so two trees of one model line up leaf for leaf: a parameter
with its gradient and its velocity, a statistic with its update.  A tree
built elsewhere (the JAX package's ``tree_util`` rebuilds dicts with
their keys sorted) is put in a model's order by mapping over the
model's tree and taking each leaf from it ``at`` the same path.
"""

from __future__ import annotations


def leaves_with_path(tree, path=()):
    """``(path, leaf)`` pairs in tree order; a path is the tuple of dict
    keys and list indices from the root."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def leaf_name(path) -> str:
    """A leaf's name: the last dict key on its path ('' when none)."""
    return next((k for k in reversed(path) if isinstance(k, str)), "")


def named_leaves(tree) -> list:
    """``(leaf name, leaf)`` pairs in tree order."""
    return [(leaf_name(p), leaf) for p, leaf in leaves_with_path(tree)]


def map_leaves(fn, tree, path=()):
    """``tree``'s nesting with ``fn(path, leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def unflatten(like, new_leaves):
    """``like``'s nesting with ``new_leaves``, in tree order, at its
    leaves."""
    new_leaves = list(new_leaves)
    if len(new_leaves) != len(leaves(like)):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of "
                         f"{len(leaves(like))}")
    it = iter(new_leaves)
    return map_leaves(lambda _, __: next(it), like)


def at(tree, path):
    """The node of ``tree`` at ``path``."""
    for key in path:
        tree = tree[key]
    return tree
