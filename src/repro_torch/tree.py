"""Nested containers of tensors flattened in ``jax.tree_util``'s order.

The reference's checkpoints number their leaves in the order
``jax.tree_util.tree_flatten`` visits them: a dict's keys sorted, a
NamedTuple's fields in order, ``None`` an empty subtree, anything else
(here) a leaf.  So ``{"params": ..., "opt": OptState(step, m,
v)}`` flattens as opt.step, opt.m's leaves, opt.v's leaves, then
params.  The port's optimizer and checkpoints walk their trees here, so
a checkpoint either package writes restores in the other.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Tuple[str, Any, list]:
    """(kind, aux, children) of a container node; kind "leaf" for a
    leaf, "none" for None."""
    if node is None:
        return "none", None, []
    if isinstance(node, dict):
        keys = sorted(node)
        return "dict", keys, [node[k] for k in keys]
    if _is_namedtuple(node):
        return "namedtuple", type(node), list(node)
    return "leaf", None, []


class TreeDef:
    """The structure of a flattened tree: rebuilds it from its leaves."""

    def __init__(self, kind: str, aux, children: List["TreeDef"]):
        self.kind, self.aux, self.children = kind, aux, children
        self.num_leaves = 1 if kind == "leaf" else \
            sum(c.num_leaves for c in children)

    def unflatten(self, leaves):
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError(f"more than {self.num_leaves} leaves given")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            leaf = next(it, _END)
            if leaf is _END:
                raise ValueError(f"fewer than {self.num_leaves} leaves "
                                 "given")
            return leaf
        if self.kind == "none":
            return None
        kids = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.aux, kids))
        return self.aux(*kids)

    def __repr__(self) -> str:
        """``str(treedef)`` of ``jax.tree_util``, so a checkpoint's
        manifest names the tree as the reference's does."""
        return f"PyTreeDef({self._body()})"

    def _body(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        kids = [c._body() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in
                                   zip(self.aux, kids)) + "}"
        return (f"CustomNode(namedtuple[{self.aux.__name__}], ["
                + ", ".join(kids) + "])")


_END = object()


def tree_paths(tree, path: str = "") -> List[str]:
    """Each leaf's "/"-joined path (dict keys, NamedTuple field names)
    in :func:`tree_flatten`'s order."""
    kind, aux, kids = _children(tree)
    if kind == "leaf":
        return [path]
    names = aux if kind == "dict" else getattr(aux, "_fields", ())
    return [q for k, c in zip(names, kids)
            for q in tree_paths(c, f"{path}/{k}" if path else str(k))]


def tree_flatten(tree) -> Tuple[list, TreeDef]:
    leaves: list = []

    def walk(node) -> TreeDef:
        kind, aux, kids = _children(node)
        if kind == "leaf":
            leaves.append(node)
        return TreeDef(kind, aux, [walk(k) for k in kids])

    return leaves, walk(tree)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, in a tree of its structure."""
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([fn(x) for x in leaves])
