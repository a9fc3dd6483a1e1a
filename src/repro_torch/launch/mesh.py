"""A device mesh over the ranks of a `torch.distributed` process group, with
the reference's axis names ("pod", "data", "model"): the constructors.

The mesh itself (`repro_torch.dist.Mesh`), the rows of the node axis each
rank holds and the messages between the ranks live in `repro_torch.dist`,
which the kernels and the trainer use; this module builds a mesh over an
initialised group and re-exports the reference's `data_axes` and
`n_data_nodes`.

Over a model axis of extent above 1, `make_mesh` also builds the model
and data subgroups (`repro_torch.dist`), on which the LM trainer executes
its tensor-parallel and ZeRO-1 layouts. `abstract_mesh` names any grid,
the reference's 16 x 16 and 2 x 16 x 16 production meshes included, for
the planner (`launch/sharding.py`, `launch/dryrun.py`), which reads only
its shape and axis names and traces on the meta device, where every
collective is a shape-only no-op.

Constructors are functions, so importing this module never touches
`torch.distributed` state: `make_mesh` and friends need an initialised
process group (`init_process_group`) for more than one rank.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist

# data_axes and n_data_nodes are the reference's names in this module
from repro_torch.dist import Mesh, data_axes, n_data_nodes


def _world(group=None) -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


def make_mesh(shape: tuple, axes: tuple, *, group=None) -> Mesh:
    """A mesh of `shape` over the ranks of `group` (None: the default group,
    or this one process when none is initialised). Raises unless the shape
    covers every rank. With a model extent above 1 it builds the model and
    data subgroups, and with a "pod" extent above 1 the pod and lane
    subgroups (`dist.new_group`, which every rank of the default group
    enters, in the same order: call it on every rank)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    world, rank = _world(group)
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    extent = dict(zip(axes, shape))
    model, pods = extent.get("model", 1), extent.get("pod", 1)
    if model == 1 and pods == 1:
        return Mesh(shape, axes, rank, group)
    ranks = [r if group is None else dist.get_global_rank(group, r)
             for r in range(world)]
    shards = world // model
    groups = {}
    if model > 1:
        model_groups = [dist.new_group([ranks[i * model + j]
                                        for j in range(model)])
                        for i in range(shards)]
        data_groups = [dist.new_group([ranks[i * model + j]
                                       for i in range(shards)])
                       for j in range(model)]
        groups.update(model_group=model_groups[rank // model],
                      data_group=data_groups[rank % model])
    if pods > 1:
        # node shard i = p * lanes + j is pod p's lane j
        lanes = shards // pods
        at = lambda p, j, k: ranks[(p * lanes + j) * model + k]
        pod_groups = {(p, k): dist.new_group([at(p, j, k)
                                              for j in range(lanes)])
                      for p in range(pods) for k in range(model)}
        lane_groups = {(j, k): dist.new_group([at(p, j, k)
                                               for p in range(pods)])
                       for j in range(lanes) for k in range(model)}
        shard, k = divmod(rank, model)
        groups.update(pod_group=pod_groups[shard // lanes, k],
                      lane_group=lane_groups[shard % lanes, k])
    return Mesh(shape, axes, rank, group, **groups)


def abstract_mesh(shape: tuple, axes: tuple) -> Mesh:
    """A mesh of `shape` over `axes` that no process group backs, for
    planning: the sharding rules and the dry-run read its `.shape` and
    `.axis_names`, and nothing executes on it. A model extent above 1 is
    allowed here: the planner traces on the meta device, where the
    collectives are no-ops."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    return Mesh(shape, axes)


def production_shape(multi_pod: bool = False) -> Tuple[tuple, tuple]:
    """(shape, axes) of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, group=None) -> Mesh:
    """The reference's production mesh: data 16 x model 16, or pod 2 x data
    16 x model 16. It needs 256 (512) ranks, as the reference needs that
    many devices (the planner takes `abstract_mesh(*production_shape(...))`
    without them)."""
    return make_mesh(*production_shape(multi_pod), group=group)


def make_host_mesh(model: int = 1, *, group=None) -> Mesh:
    """Every rank of the group: (world / model, model) over ("data",
    "model")."""
    world, _ = _world(group)
    if world % model:
        raise ValueError(f"{world} ranks do not split into model extent "
                         f"{model}")
    return make_mesh((world // model, model), ("data", "model"), group=group)
