"""Nested-structure utilities over dict/list/tuple trees of tensors.

The counterpart of :mod:`moolib_tpu.utils.nest` for torch tensors and
numpy arrays, written without a tree library. Dicts, lists and tuples
(namedtuples included) are interior nodes, ``None`` is an empty subtree,
everything else is a leaf. Dict leaves are visited in sorted key order,
the order the reference's flatten uses.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np
import torch

__all__ = [
    "map_structure",
    "flatten",
    "unflatten_as",
    "zip_structures",
    "stack_fields",
    "unstack_fields",
    "cat_fields",
    "squeeze_fields",
    "unsqueeze_fields",
    "slice_fields",
]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_structure(fn: Callable, *trees: Any) -> Any:
    """Apply ``fn`` leaf-wise over one or more trees with identical
    structure."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        for t in trees[1:]:
            if not isinstance(t, dict) or set(t) != set(first):
                raise ValueError("dict trees have different keys")
        return {
            k: map_structure(fn, *(t[k] for t in trees)) for k in first
        }
    if isinstance(first, (list, tuple)):
        for t in trees[1:]:
            if type(t) is not type(first) or len(t) != len(first):
                raise ValueError("sequence trees differ in type or length")
        items = [map_structure(fn, *xs) for xs in zip(*trees)]
        if _is_namedtuple(first):
            return type(first)(*items)
        return type(first)(items)
    return fn(*trees)


def flatten(tree: Any) -> list:
    """The leaves of ``tree`` in order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in flatten(x)]
    return [tree]


def unflatten_as(structure: Any, leaves: Iterable) -> Any:
    """A tree shaped like ``structure`` with ``leaves`` in
    :func:`flatten`'s order; the inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            items = [build(x) for x in node]
            if _is_namedtuple(node):
                return type(node)(*items)
            return type(node)(items)
        return next(it)

    out = build(structure)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


_END = object()


def zip_structures(*trees: Any) -> Any:
    """Zip N same-shaped trees into one tree whose leaves are tuples."""
    return map_structure(lambda *xs: tuple(xs), *trees)


def stack_fields(trees: Iterable[Any], axis: int = 0) -> Any:
    """Stack a sequence of same-structure trees into one tree of batched
    leaves (torch leaves with :func:`torch.stack`, others with numpy)."""
    trees = list(trees)
    if not trees:
        raise ValueError("stack_fields requires at least one tree")

    def _stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs, dim=axis)
        return np.stack(xs, axis=axis)

    return map_structure(_stack, *trees)


def cat_fields(trees: Iterable[Any], axis: int = 0) -> Any:
    """Concatenate same-structure trees leaf-wise along ``axis`` (torch
    leaves with :func:`torch.cat`, on their own device and without a
    host sync; others with numpy). A tree may mix the two kinds, as a
    learn unroll does (host frames, the LSTM state on the card); each
    leaf position must hold one kind across the trees."""
    trees = list(trees)
    if not trees:
        raise ValueError("cat_fields requires at least one tree")

    def _cat(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(xs, dim=axis)
        return np.concatenate(xs, axis=axis)

    return map_structure(_cat, *trees)


def unstack_fields(tree: Any, batch_size: int | None = None,
                   axis: int = 0) -> list:
    """Split a batched tree back into its unbatched trees; the inverse of
    :func:`stack_fields`. Passing ``batch_size`` asserts the leaves'
    ``axis`` length."""
    leaves = flatten(tree)
    if not leaves:
        raise ValueError("unstack_fields requires a tree with leaves")
    n = leaves[0].shape[axis]
    for leaf in leaves:
        if leaf.shape[axis] != n:
            raise ValueError(
                f"inconsistent batch axis: {leaf.shape[axis]} != {n}"
            )
    if batch_size is not None and batch_size != n:
        raise ValueError(f"batch_size {batch_size} != leaf axis length {n}")

    def _pick(x, i):  # a view of row i along axis
        return x[(slice(None),) * (axis % x.ndim) + (i,)]

    return [
        map_structure(lambda x, i=i: _pick(x, i), tree) for i in range(n)
    ]


def squeeze_fields(tree: Any, axis: int = 0) -> Any:
    return map_structure(
        lambda x: x.squeeze(axis) if isinstance(x, torch.Tensor)
        else np.squeeze(x, axis=axis), tree)


def unsqueeze_fields(tree: Any, axis: int = 0) -> Any:
    return map_structure(
        lambda x: x.unsqueeze(axis) if isinstance(x, torch.Tensor)
        else np.expand_dims(x, axis=axis), tree)


def slice_fields(tree: Any, start: int, stop: int, axis: int = 0) -> Any:
    """Slice every leaf along ``axis``."""

    def _sl(x):
        index = [slice(None)] * x.ndim
        index[axis] = slice(start, stop)
        return x[tuple(index)]

    return map_structure(_sl, tree)
