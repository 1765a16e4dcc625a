"""Models and states as trees of tensors.

A model is one tensor (the GLMs' ``[d]``, Kalman's ``[T, d]``) or a dict
of them (LMF's ``{"L", "R"}``, CRF's ``{"E", "T"}``); a UDA state is a
NamedTuple holding one. These helpers map over such trees and ravel them
to one flat vector and back.

Dicts are walked in **sorted-key order**, as JAX walks them, whatever
their insertion order (``torch.utils._pytree`` walks insertion order).
The shared-memory simulator draws one read version and one kept-write
flag per component of the raveled model, so the order decides which
component gets which draw. A lone tensor is its own single leaf: mapping
``f`` over it is ``f(tensor)``, and raveling a 1-D tensor returns it as
it is.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(f: Callable, tree, *rest):
    """``f`` applied leaf by leaf over ``tree`` and the trees of the same
    structure in ``rest``; dicts come back with their keys sorted."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(f, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, *xs) for xs in zip(tree, *rest))
    return f(tree, *rest)


def leaves(tree) -> List:
    """The leaves of ``tree`` in sorted-key order."""
    out = []
    tree_map(out.append, tree)
    return out


def size(tree) -> int:
    """Elements in all of ``tree``'s tensors: the raveled length."""
    return sum(x.numel() for x in leaves(tree))


def ravel(tree) -> Tuple[torch.Tensor, Callable]:
    """``(flat, unravel)``: the leaves reshaped to 1-D and concatenated in
    sorted-key order (``jax.flatten_util.ravel_pytree``'s order), and the
    function that cuts a vector of that length back into ``tree``'s
    structure and shapes (as views of it)."""
    parts = leaves(tree)
    shapes = [p.shape for p in parts]
    sizes = [p.numel() for p in parts]

    def unravel(flat: torch.Tensor):
        pieces, dims = iter(torch.split(flat, sizes)), iter(shapes)
        return tree_map(lambda _: next(pieces).view(next(dims)), tree)

    if len(parts) == 1:
        return parts[0].reshape(-1), unravel
    return torch.cat([p.reshape(-1) for p in parts]), unravel
