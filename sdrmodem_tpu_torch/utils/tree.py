"""``jax.tree.flatten`` and ``unflatten`` for the port's states: NamedTuples,
tuples and lists of tensors, walked in field order, depth first, ``None``
leaves skipped as JAX skips them."""

from __future__ import annotations

import torch


def flatten(tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree if v is not None for t in flatten(v)]


def unflatten(template, leaves):
    """``template``'s structure with its tensors taken from ``leaves`` in
    order."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return next(it)
        parts = [build(v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)

    return build(template)
