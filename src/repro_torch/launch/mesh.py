"""A device mesh over the ranks of a `torch.distributed` process group, with
the reference's axis names ("pod", "data", "model"): the constructors.

The mesh itself (`repro_torch.dist.Mesh`), the rows of the node axis each
rank holds and the messages between the ranks live in `repro_torch.dist`,
which the kernels and the trainer use; this module builds a mesh over an
initialised group and re-exports the reference's `data_axes` and
`n_data_nodes`.

A model axis of extent above 1 (tensor-parallel and ZeRO-1 layouts) is not
ported yet (ROADMAP.md queue 1 item 3): every constructor refuses it with
NotImplementedError.

Constructors are functions, so importing this module never touches
`torch.distributed` state: `make_mesh` and friends need an initialised
process group (`init_process_group`) for more than one rank.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist

# data_axes and n_data_nodes are the reference's names in this module
from repro_torch.dist import Mesh, check_mesh, data_axes, n_data_nodes


def _world(group=None) -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


def make_mesh(shape: tuple, axes: tuple, *, group=None) -> Mesh:
    """A mesh of `shape` over the ranks of `group` (None: the default group,
    or this one process when none is initialised). Raises unless the shape
    covers every rank, and (NotImplementedError) on a model extent above
    1."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    world, rank = _world(group)
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    mesh = Mesh(shape, axes, rank, group)
    check_mesh(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, group=None) -> Mesh:
    """The reference's production mesh: data 16 x model 16, or pod 2 x data
    16 x model 16. It needs 256 (512) ranks, as the reference needs that
    many devices, and its model axis waits for queue 1 item 3."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, group=group)


def make_host_mesh(model: int = 1, *, group=None) -> Mesh:
    """Every rank of the group: (world / model, model) over ("data",
    "model")."""
    world, _ = _world(group)
    if world % model:
        raise ValueError(f"{world} ranks do not split into model extent "
                         f"{model}")
    return make_mesh((world // model, model), ("data", "model"), group=group)
