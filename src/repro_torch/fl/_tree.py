"""Parameter trees: the FL layer's walk over nested dicts of tensors.

A model's params are a tree of dicts (and lists or tuples) whose leaves are
tensors: the MLP's flat ``{"w1": ..., "b1": ...}`` or an LM's
``{"embed", "final_norm", "layers": {...}, "lm_head"}``.  Leaves are visited
in the reference's order, ``jax.tree.leaves`` on dicts: keys sorted,
recursively.  ``torch.utils._pytree`` keeps insertion order, so it is not
used here.  Everything that draws or concatenates leaf by leaf (Gaussian
noise, Krum's flatten, the label axis of the last leaf) follows this order;
:func:`tree_map` keeps the first tree's own key order in its output.
:func:`tree_map_with_path` and :func:`tree_leaves_with_path` also walk named
tuples (a decode state's caches) and hand each leaf its key path.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Mapping, Sequence, Tuple

import torch

Tree = Any


def _is_seq(t) -> bool:
    return type(t) in (list, tuple)


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves in the reference's order: dict keys sorted, recursively;
    list and tuple items in order."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if _is_seq(tree):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_iter(tree: Tree) -> Iterator[Any]:
    """The leaves in storage order (dict insertion order): for reductions
    whose summation order must stay the one the flat code used."""
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from tree_iter(v)
    elif _is_seq(tree):
        for v in tree:
            yield from tree_iter(v)
    else:
        yield tree


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf over trees of one structure; the output
    has ``tree``'s structure and key order."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_seq(tree):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                       is_leaf: Callable[[Any], bool] = lambda x: False,
                       path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, named tuples, lists and
    tuples; ``path`` holds the dict keys, the named tuples' field names and
    ``"[i]"`` for sequence items, as the reference's key paths print them.
    ``None`` stays ``None`` (an empty subtree)."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, is_leaf, path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), is_leaf, path + (f,))
                            for f in tree._fields))
    if type(tree) in (list, tuple):
        return type(tree)(tree_map_with_path(fn, v, is_leaf, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves_with_path(tree: Any, is_leaf: Callable[[Any], bool] = lambda x: False
                          ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in the reference's leaf order: dict keys sorted,
    named-tuple fields and sequence items in order."""
    out: List[Tuple[Tuple[str, ...], Any]] = []

    def walk(t, path):
        if t is None:
            return
        if is_leaf(t):
            out.append((path, t))
        elif isinstance(t, Mapping):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif _is_namedtuple(t):
            for f in t._fields:
                walk(getattr(t, f), path + (f,))
        elif type(t) in (list, tuple):
            for i, v in enumerate(t):
                walk(v, path + (f"[{i}]",))
        else:
            out.append((path, t))

    walk(tree, ())
    return out


def tree_unflatten(like: Tree, leaves: Sequence[Any]) -> Tree:
    """A tree of ``like``'s structure and key order whose leaves are
    ``leaves``, given in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, Mapping):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_seq(t):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_stack(trees: Sequence[Tree]) -> Tree:
    """Trees of one structure -> one tree whose leaves carry a leading axis
    over them (``torch.stack``)."""
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def tree_index(stacked: Tree, j: int) -> Tree:
    """Entry ``j`` of the leading axis of every leaf (views, no copies)."""
    return tree_map(lambda a: a[j], stacked)


def tree_device(tree: Tree) -> torch.device:
    """The device of the tree's first leaf."""
    return tree_leaves(tree)[0].device
