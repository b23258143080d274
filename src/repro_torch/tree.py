"""Trees of tensors in the reference's leaf order.

`jax.tree.flatten` visits a dict's keys sorted, tuples, lists and
NamedTuples in order, and None as a node with no leaves.  That order can
be observed: the optimizer's float32 norm sums leaf by leaf, the
checkpoint names its files `leaf-NNNNN` by it, and the gradient wire runs
its leaves in it.  `models.params.tree_leaves` keeps insertion order
instead (the order `materialize` draws the weights in), so the training
path flattens here.  `unflatten` rebuilds each dict with its keys in
their original order; only the leaf order is sorted.
"""
from __future__ import annotations


class TreeDef:
    """The structure of a tree with its leaves taken out."""

    def __init__(self, node):
        self._node = node

    def __repr__(self):
        return f"TreeDef({self._node!r})"

    @property
    def num_leaves(self) -> int:
        return _count(self._node)


def _skeleton(tree, out: list):
    """The tree's skeleton (nested tuples), its leaves appended to out in
    the reference's order."""
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        subs = {k: _skeleton(tree[k], out) for k in sorted(tree)}
        return ("dict", tuple((k, subs[k]) for k in tree))
    if isinstance(tree, (list, tuple)):
        return ("seq", type(tree), tuple(_skeleton(t, out) for t in tree))
    out.append(tree)
    return ("leaf",)


def _count(node) -> int:
    if node[0] == "leaf":
        return 1
    if node[0] == "none":
        return 0
    if node[0] == "dict":
        return sum(_count(s) for _, s in node[1])
    return sum(_count(s) for s in node[2])


def _build(node, it):
    kind = node[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        built = {k: _build(s, it) for k, s in sorted(node[1],
                                                       key=lambda e: e[0])}
        return {k: built[k] for k, _ in node[1]}
    typ, subs = node[1], [_build(s, it) for s in node[2]]
    return typ(*subs) if _is_namedtuple_type(typ) else typ(subs)


def _is_namedtuple_type(typ) -> bool:
    return issubclass(typ, tuple) and hasattr(typ, "_fields")


def flatten(tree) -> tuple[list, TreeDef]:
    """(leaves in the reference's order, the tree's structure)."""
    leaves: list = []
    return leaves, TreeDef(_skeleton(tree, leaves))


def unflatten(treedef: TreeDef, leaves) -> object:
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"the tree has {treedef.num_leaves} leaves, "
                         f"{len(leaves)} were given")
    return _build(treedef._node, iter(leaves))


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree):
    """fn over the leaves of tree, the structure kept."""
    flat, tdef = flatten(tree)
    return unflatten(tdef, [fn(x) for x in flat])
