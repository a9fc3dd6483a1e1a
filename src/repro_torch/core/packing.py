"""Flat-buffer packing of gradient trees for the consensus hot path.

A tree here is nested dicts, lists and tuples with tensors at the leaves
(the port's stand-in for a JAX pytree; dict keys are visited in sorted
order, as `jax.tree.flatten` visits them). Packing flattens the tree ONCE
into contiguous ``[*lead, D]`` buffers (one per dtype, so packing is
dtype-preserving) with a static leaf-segment map, so every averaging mode
runs its mixing operator once per step on one buffer, and per-leaf
reductions (consensus error, per-leaf compressor statistics) become single
segment-reduced passes over the buffer.

Column ``j`` of group ``g``'s buffer belongs to leaf
``spec.groups[g][spec.segment_ids(g)[j]]``. Leading axes (the node axis;
none for the DMB parameter vector) are preserved, so a `PackSpec` built from
one tree repacks trees of any node count.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tree = Any


def _flatten(tree: Tree, leaves: List[torch.Tensor]):
    """Append `tree`'s leaves to `leaves` in order; return its structure."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys),
                tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, None,
                tuple(_flatten(t, leaves) for t in tree))
    if tree is None:
        return ("none", None, ())
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"tree leaves must be tensors, got {type(tree)}")
    leaves.append(tree)
    return ("leaf", None, ())


def _unflatten(treedef, leaves) -> Tree:
    kind, keys, children = treedef
    if kind == "leaf":
        return next(leaves)
    if kind == "none":
        return None
    built = [_unflatten(c, leaves) for c in children]
    if kind == "dict":
        return dict(zip(keys, built))
    return tuple(built) if kind == "tuple" else built


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of `tree`, in its order (the default packing order)."""
    leaves: List[torch.Tensor] = []
    _flatten(tree, leaves)
    return leaves


def tree_map(fn, tree: Tree) -> Tree:
    """`tree` with `fn` applied to every leaf."""
    leaves: List[torch.Tensor] = []
    treedef = _flatten(tree, leaves)
    return _unflatten(treedef, iter([fn(x) for x in leaves]))


def map_tensors(fn: Callable, tree: Tree) -> Tree:
    """`fn` on every tensor of a tree of NamedTuples, dicts, lists and
    tuples; other leaves (a Python round counter) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, x) for x in tree))
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, x) for x in tree)
    return tree


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static description of a packed tree.

    treedef:   the tree structure (for unflattening).
    trailing:  per-leaf shape AFTER the shared leading axes, in leaf order.
    dtypes:    per-leaf dtype name, in leaf order.
    lead:      number of shared leading axes preserved by packing (0 or more).
    groups:    per-buffer tuple of leaf indices; one buffer per distinct dtype,
               leaves in first-appearance order (of the packing order), so
               single-dtype trees pack into exactly one ``[*lead, D]``
               buffer.
    """

    treedef: Any
    trailing: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    lead: int
    groups: Tuple[Tuple[int, ...], ...]

    def leaf_width(self, i: int) -> int:
        return int(np.prod(self.trailing[i], dtype=np.int64)) if self.trailing[i] else 1

    def group_width(self, g: int) -> int:
        return sum(self.leaf_width(i) for i in self.groups[g])

    def segment_ids(self, g: int) -> np.ndarray:
        """int32 [D_g]: position-within-group of the leaf owning each column."""
        widths = [self.leaf_width(i) for i in self.groups[g]]
        return np.repeat(np.arange(len(widths)), widths).astype(np.int32)


def pack_spec(tree: Tree, *, lead: int = 1,
              order: Optional[Sequence[int]] = None) -> PackSpec:
    """Build the static segment map for `tree`. All leaves must share their
    first `lead` axis sizes (the node axis). `order` (a permutation of the
    leaf indices) is the order the leaves are packed in, and the groups
    formed in; by default the tree's own."""
    leaves: List[torch.Tensor] = []
    treedef = _flatten(tree, leaves)
    trailing, dtypes = [], []
    lead_shape = None
    for x in leaves:
        if x.dim() < lead:
            raise ValueError(f"leaf rank {x.dim()} < lead={lead}")
        if lead_shape is None:
            lead_shape = tuple(x.shape[:lead])
        elif tuple(x.shape[:lead]) != lead_shape:
            raise ValueError(f"leaves disagree on leading axes: "
                             f"{tuple(x.shape[:lead])} vs {lead_shape}")
        trailing.append(tuple(x.shape[lead:]))
        dtypes.append(_dtype_name(x.dtype))
    groups: dict = {}
    for i in (range(len(dtypes)) if order is None else order):
        groups.setdefault(dtypes[i], []).append(i)
    return PackSpec(treedef, tuple(trailing), tuple(dtypes), lead,
                    tuple(tuple(g) for g in groups.values()))


def pack_tree(tree: Tree, spec: Optional[PackSpec] = None, *,
              lead: int = 1, order: Optional[Sequence[int]] = None
              ) -> Tuple[Tuple[torch.Tensor, ...], PackSpec]:
    """Flatten `tree` into one contiguous ``[*lead, D]`` buffer per dtype,
    its leaves in `order` (`pack_spec`).

    Returns ``(buffers, spec)``. Pass a previously built `spec` to reuse its
    segment map — the tree must match its structure and trailing shapes;
    leading axis sizes may differ."""
    if spec is None:
        spec = pack_spec(tree, lead=lead, order=order)
    leaves = tree_leaves(tree)
    if len(leaves) != len(spec.trailing):
        raise ValueError("tree does not match PackSpec leaf count")
    bufs = []
    for group in spec.groups:
        parts = []
        for i in group:
            x = leaves[i]
            if tuple(x.shape[spec.lead:]) != spec.trailing[i]:
                raise ValueError(
                    f"leaf {i} trailing shape {tuple(x.shape[spec.lead:])} "
                    f"!= spec {spec.trailing[i]}")
            parts.append(x.reshape(*x.shape[:spec.lead],
                                   math.prod(x.shape[spec.lead:])))
        bufs.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1))
    return tuple(bufs), spec


def segment_sums(v: torch.Tensor, widths) -> torch.Tensor:
    """Exact per-segment sums over the last axis of `v` for contiguous
    segments of static `widths`: one slice + contiguous reduce per segment,
    stacked to [..., S]. Not differences of a running sum, which cancel
    catastrophically for small segments after large ones."""
    widths = np.asarray(widths, np.int64)
    if widths.size == 0:
        return v.new_zeros(tuple(v.shape[:-1]) + (0,))
    parts = torch.split(v, widths.tolist(), dim=-1)
    return torch.stack([p.sum(-1) if p.shape[-1] else v.new_zeros(v.shape[:-1])
                        for p in parts], dim=-1)


def unpack_tree(bufs: Tuple[torch.Tensor, ...], spec: PackSpec) -> Tree:
    """Inverse of `pack_tree`: split each buffer at the segment boundaries
    and restore every leaf's shape and position."""
    leaves: list = [None] * len(spec.trailing)
    for g, buf in enumerate(bufs):
        off = 0
        for i in spec.groups[g]:
            w = spec.leaf_width(i)
            piece = buf[..., off:off + w]
            leaves[i] = piece.reshape(tuple(buf.shape[:-1]) + spec.trailing[i])
            off += w
    return _unflatten(spec.treedef, iter(leaves))
