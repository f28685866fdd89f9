"""Nested containers of tensors, flattened in ``jax.tree`` order.

The port's counterpart of the few ``jax.tree`` functions the reference
uses.  The order is the reference's: dict keys SORTED at every level
(``embed, final_norm, stack``; inside a super-block ``"0", "1", "10",
"11", "2", ...``; inside attention ``bk, bq, bv, wk, wo, wq, wv``), lists
and tuples in their own order.  Python's insertion order differs, and
``core/fabric.py::BucketLayout`` assigns leaves to buckets in this order,
so the buckets, their padding, the compression blocks and ``wire_bytes``
match the reference only through this module.  Anything that is not a
dict, list or tuple is a leaf; ``None`` is a leaf too (the reference's
trees hold none on the ported paths).
"""

from __future__ import annotations


def _flatten(x, leaves):
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return (dict, keys, tuple(_flatten(x[k], leaves) for k in keys))
    if isinstance(x, (list, tuple)):
        return (type(x), len(x), tuple(_flatten(v, leaves) for v in x))
    leaves.append(x)
    return None


def flatten(tree):
    """``(leaves, treedef)``: the leaves in ``jax.tree`` order and what
    ``unflatten`` needs to rebuild the containers.  The recursion is a
    module-level function, not a closure that calls itself: such a
    closure is a reference cycle that would keep every leaf alive until
    the cyclic garbage collector runs."""
    leaves = []
    return leaves, _flatten(tree, leaves)


def _unflatten(node, it):
    if node is None:
        return next(it)
    kind, keys, children = node
    if kind is dict:
        return {k: _unflatten(c, it) for k, c in zip(keys, children)}
    return kind(_unflatten(c, it) for c in children)


def unflatten(treedef, leaves):
    """Inverse of ``flatten``."""
    it = iter(leaves)
    out = _unflatten(treedef, it)
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"unflatten: {rest} leaves left over")
    return out


def leaves(tree):
    return flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (which share its structure)."""
    flat, tdef = flatten(tree)
    others = [leaves(t) for t in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"tree_map: {len(o)} leaves vs {len(flat)}")
    return unflatten(tdef, [fn(*xs) for xs in zip(flat, *others)])
