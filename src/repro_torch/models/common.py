"""Parameter initializers of the port's models, drawing from an explicit
`torch.Generator` on the device where the parameters live, or from
`MetaGenerator` for a shape-only init on the meta device (the planner's,
`launch/dryrun.py`); and the executing mesh of a model axis.

The reference's `mesh_rules` installs a mesh and its logical activation
rules, and `pshard` constrains each named activation to its rule, for
GSPMD to place. The port runs SPMD by hand: `mesh_rules(mesh)` installs
the mesh whose model axis the layers execute, and each rank's parameters
are its blocks (`launch/sharding.py` `shard_tree`), so an activation's
placement follows from the weights it is computed with and no `pshard` is
needed. Under an installed model axis the layers
(`models/layers.py`) hold their columns of wq, wk, wv, w_gate and w_up,
their rows of wo and w_down, and their vocab rows, and cross the axis only
through the three pairs below: `copy_to_model` where a replicated
activation enters a column split, `reduce_from_model` where a row split's
partial sums leave it, and `gather_from_model` where a column split cut a
head that a rank needs whole (the pieces joined forward, their gradients
summed back to their owners).
`stack_init` is not ported: the port keeps one parameter dict per layer
instead of stacked super-blocks (`models/transformer.py`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from repro_torch import dist as rdist


class MetaGenerator:
    """Stands for a `torch.Generator` in a shape-only init: every draw is an
    empty tensor on the meta device, which has no generator. The CPU and
    card draws do not change."""

    device = torch.device("meta")


def _draw(gen, shape) -> torch.Tensor:
    """N(0, 1) in f32 of `shape` from `gen`, on its device."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, shape, dtype, scale: float = 1.0,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, (scale / sqrt(fan_in))^2) drawn in f32, then cast; fan_in
    defaults to shape[-2] (the `in` axis of an [in, out] weight)."""
    fi = fan_in if fan_in is not None else (
        shape[-2] if len(shape) >= 2 else shape[-1])
    std = scale / math.sqrt(fi)
    return _draw(gen, shape).mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return _draw(gen, shape).mul_(0.02).to(dtype)


def ones_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# the executing model axis
# ---------------------------------------------------------------------------

_MESH = [None]  # the mesh `mesh_rules` installed, when its model axis > 1


@contextlib.contextmanager
def mesh_rules(mesh):
    """Run the layers under `mesh`'s model axis (nothing changes on a mesh
    without one, or with None); the previous mesh is restored on exit."""
    prev = _MESH[0]
    _MESH[0] = mesh if rdist.model_extent(mesh) > 1 else None
    try:
        yield
    finally:
        _MESH[0] = prev


def current_mesh():
    """The installed mesh with a model axis above 1, else None."""
    return _MESH[0]


def _model_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of x over the mesh's model group, in an f32 copy (each
    rank's partial once, cast once by the caller)."""
    return rdist.all_reduce_(x.to(torch.float32, memory_format=torch.
                                  contiguous_format, copy=True),
                             mesh, axis="model")


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group
    backward: a replicated activation that feeds a column split."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g, ctx.mesh).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward, in f32; identity backward: a
    row split's partial sums."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _model_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The columns of every rank of this rank's block of g model indices
    forward (`dist.block_all_gather`); backward, each rank's gradient of
    them summed back to the rank that owns them, in f32 and cast once
    (`dist.block_reduce_scatter`): pieces of a head that a column split
    cut, joined on each rank that uses the head."""

    @staticmethod
    def forward(ctx, x, mesh, g):
        ctx.mesh, ctx.g = mesh, g
        flat = x.reshape(-1, x.shape[-1])
        return rdist.block_all_gather(flat, mesh, g).reshape(
            *x.shape[:-1], g * x.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        flat = grad.reshape(-1, grad.shape[-1])
        out = rdist.block_reduce_scatter(flat, ctx.mesh, ctx.g)
        return (out.to(grad.dtype).reshape(*grad.shape[:-1], -1), None,
                None)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    mesh = current_mesh()
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """x summed over the model group, in f32 (x itself, in its dtype,
    without a model axis)."""
    mesh = current_mesh()
    return x if mesh is None else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, g: int) -> torch.Tensor:
    """x [..., c], this rank's columns -> [..., g * c], the columns of its
    block of g model indices in their order (x itself where g is 1)."""
    mesh = current_mesh()
    return x if mesh is None or g == 1 else _GatherFromModel.apply(x, mesh, g)
