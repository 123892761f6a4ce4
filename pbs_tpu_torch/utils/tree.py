"""Parameter and state trees: nested dicts, lists and tuples of leaves.

The port's counterpart of the ``jax.tree_util`` calls the reference's
checkpoint, paging and sharing code makes. A leaf is anything that is
not a dict, list, tuple or None: a tensor, a numpy array, a Python
scalar, a paged-leaf marker. The order is ``jax.tree_util``'s, so a
state flattens to the same leaf sequence in both packages: dict keys
sorted, sequences in order, None an empty subtree with no leaf.
Rebuilding keeps each dict's own key order, so a restored tree iterates
exactly like the one it was built from.
"""

from __future__ import annotations

from typing import Any


class TreeDef:
    """The structure of a tree with its leaves taken out."""

    __slots__ = ("_skeleton",)

    def __init__(self, skeleton: Any):
        self._skeleton = skeleton

    def __str__(self) -> str:
        return f"PyTreeDef({_describe(self._skeleton)})"

    __repr__ = __str__


class _Leaf:
    """Where a leaf stood in a :class:`TreeDef`'s skeleton."""


_LEAF = _Leaf()


def _sorted_keys(d: dict) -> list:
    return sorted(d)


def _describe(node: Any) -> str:
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(node[k])}"
                               for k in _sorted_keys(node)) + "}"
    if isinstance(node, list):
        return "[" + ", ".join(_describe(v) for v in node) + "]"
    if isinstance(node, tuple):
        inner = ", ".join(_describe(v) for v in node)
        return f"({inner},)" if len(node) == 1 else f"({inner})"
    if node is None:
        return "None"
    return "*"


# The walks below are module-level functions, not nested closures: a
# recursive closure is a reference cycle (the function holds its own
# cell), and everything it closes over (the leaf list) would then live
# until the garbage collector runs, pinning device memory a caller
# believes freed.


def _walk(node: Any, path: tuple, out: list) -> None:
    if isinstance(node, dict):
        for k in _sorted_keys(node):
            _walk(node[k], path + (("d", k),), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, path + (("s", i),), out)
    elif node is not None:
        out.append((path, node))


def flatten_with_path(tree: Any) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in flatten order; a path is a tuple of
    ``("d", key)`` (dict entry) and ``("s", index)`` (list or tuple
    position) steps."""
    out: list[tuple[tuple, Any]] = []
    _walk(tree, (), out)
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _skeleton(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _skeleton(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_skeleton(v) for v in node]
    if isinstance(node, tuple):
        return tuple(_skeleton(v) for v in node)
    return None if node is None else _LEAF


def tree_flatten(tree: Any) -> tuple[list, TreeDef]:
    return tree_leaves(tree), TreeDef(_skeleton(tree))


def _build(node: Any, path: tuple, placed: dict) -> Any:
    if isinstance(node, dict):
        return {k: _build(v, path + (("d", k),), placed)
                for k, v in node.items()}
    if isinstance(node, list):
        return [_build(v, path + (("s", i),), placed)
                for i, v in enumerate(node)]
    if isinstance(node, tuple):
        return tuple(_build(v, path + (("s", i),), placed)
                     for i, v in enumerate(node))
    return None if node is None else placed[path]


def tree_unflatten(treedef: TreeDef, leaves: list) -> Any:
    """Put ``leaves`` (in flatten order) back into ``treedef``'s
    structure."""
    paths = [p for p, _ in flatten_with_path(treedef._skeleton)]
    if len(paths) != len(leaves):
        raise ValueError(f"tree has {len(paths)} leaves, got {len(leaves)}")
    return _build(treedef._skeleton, (), dict(zip(paths, leaves)))

