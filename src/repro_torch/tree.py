"""Trees of tensors in the order `jax.tree_util` gives them.

A tree is nested dicts, tuples, NamedTuples, lists and quantized weights
(`QTensor`, whose children are ``(q, scale)`` in that order, as the JAX
package registers it); anything else is a leaf. Dict keys are walked
sorted at every level and sequence fields in order, so a port tree and the
JAX package's tree of the same structure (a `TrainState(params,
opt=AdamWState(step, m, v))` or a quantized parameter tree included) number
their leaves alike. `torch.utils._pytree` keeps dict insertion order and
would number them differently.
"""

from __future__ import annotations

from typing import Callable, Iterator

from repro_torch.models.quant import QTensor


def flatten(tree) -> list:
    """The leaves of `tree`, in `jax.tree_util`'s order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in flatten(child)]
    if isinstance(tree, QTensor):
        return flatten(tree.q) + flatten(tree.scale)
    return [tree]


def unflatten(template, leaves: Iterator):
    """`template`'s structure, its leaves taken in `flatten` order from the
    iterator `leaves`. Each dict keeps the template's key order; a
    NamedTuple is rebuilt as ``type(template)(*fields)``."""
    if isinstance(template, dict):
        filled = {k: unflatten(template[k], leaves) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, (tuple, list)):
        children = [unflatten(child, leaves) for child in template]
        if hasattr(template, "_fields"):
            return type(template)(*children)
        return type(template)(children)
    if isinstance(template, QTensor):
        q = unflatten(template.q, leaves)
        return QTensor(q, unflatten(template.scale, leaves))
    return next(leaves)


def map_leaves(fn: Callable, tree, *rest):
    """`fn` applied leaf by leaf across trees of one structure; the result
    has the structure of `tree`."""
    columns = zip(flatten(tree), *(flatten(t) for t in rest))
    return unflatten(tree, iter([fn(*leaves) for leaves in columns]))
