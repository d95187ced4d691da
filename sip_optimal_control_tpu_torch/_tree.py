"""Structure maps over the port's containers.

The JAX package maps functions over pytrees; here the containers are
NamedTuples and frozen dataclasses of tensors (possibly nested, possibly
holding None), and these two helpers walk them.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise to ``tree`` and the same-shaped ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, a, *[r[i] for r in rest])
                            for i, a in enumerate(tree)])
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, a, *[r[i] for r in rest])
                          for i, a in enumerate(tree))
    raise TypeError(f"tree_map: unsupported node {type(tree).__name__}")


def tree_leaves(tree):
    """The tensors of ``tree`` in field order."""
    out = []
    tree_map(lambda t: out.append(t), tree)
    return out


def lane_view(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a per-scenario tensor whose dims are the leading dims of
    ``like`` ([B] against [B, *event], [chunk, B] against
    [chunk, B, *event]) so it broadcasts over the event dims."""
    if not isinstance(v, torch.Tensor) or v.dim() == 0:
        return v
    extra = like.dim() - v.dim()
    return v.reshape(v.shape + (1,) * extra) if extra > 0 else v


def tree_select(keep: torch.Tensor, a, b):
    """Per-scenario select: ``a`` where ``keep`` [B], else ``b``."""
    return tree_map(lambda x, y: torch.where(lane_view(keep, x), x, y), a, b)
