"""The mesh of the ranks of a `torch.distributed` process group, this
rank's rows of a node axis split over it, and the messages between its
ranks.

The reference's mesh is a grid of devices that one program spans (GSPMD).
The port runs one process per rank (SPMD by hand): a `Mesh` names the grid
that the group's ranks form, row-major over the reference's axis names
("pod", "data", "model"), and the rank this process is. The paper's N nodes
are a leading node axis split over the node axes ("pod", "data") in
contiguous runs of rows, the port's form of the reference's
`P(("pod", "data"))`: rank i holds rows `node_rows(mesh, n)`.

A model axis of extent m above 1 splits the mesh's ranks two ways: the m
ranks of one node shard form its *model group* (they hold the model
shards of the same nodes), and the ranks of one model index form its
*data group* (they hold the same model shard of every node shard).
`launch/mesh.py` builds both with `dist.new_group`. Every message names
the axis it crosses: a node-axis message (halo rows, node means, the
ZeRO-1 gathers and reduce-scatters) goes over the data group, a
tensor-parallel reduction over the model group, and so do the pieces of
a head that a column split cuts (`block_all_gather`,
`block_reduce_scatter`: messages between the ranks of a block that
share heads); `stats` counts the two axes apart. A "pod" axis of extent
P above 1 splits the node shards two ways too: the D node shards of one
pod form its *pod group*, and the P node shards of one data index its
*lane group* (`lane_mesh`), which the hierarchical mode's
reduce-scatter, all-gather and gossip between the pods use; their
messages count as node-axis ones. The LM trainer executes a model axis
for every family (`train/trainer.py`, `models/common.py`); `check_mesh`
refuses one on the paths that do not (the PCA and convex drivers).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

NODE_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The grid of `sizes` (row-major over `axis_names`) that the ranks of
    `group` form (None: the default group), and this process's `rank` in
    it."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int = 0
    group: Any = None
    # over a model axis of extent above 1: this rank's model group (the
    # ranks of its node shard) and data group (the ranks of its model
    # index), `launch/mesh.py` `make_mesh`
    model_group: Any = None
    data_group: Any = None
    # over a "pod" axis of extent above 1: this rank's pod group (the ranks
    # of its pod, one a data index) and lane group (the ranks of its data
    # index, one a pod), at its model index, `launch/mesh.py` `make_mesh`
    pod_group: Any = None
    lane_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> extent, as the reference's `mesh.shape`."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def check_mesh(mesh: Mesh, what: str) -> None:
    """Refuse a model axis of extent above 1 on `what`, a path that does
    not execute one: only the LM trainer does (tensor parallelism and
    ZeRO-1, `train/trainer.py`); the PCA and convex paths hold no leaf
    that the reference's placements split over it."""
    model = model_extent(mesh)
    if model > 1:
        raise NotImplementedError(
            f"a model axis of extent {model} on {what}: planned, not "
            f"executed there; the sharded model layouts execute in the LM "
            f"trainer only (ROADMAP.md, the model axis's deviations)")


def model_extent(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get("model", 1)


def model_index(mesh) -> int:
    """This rank's position along the model axis."""
    return 0 if mesh is None else mesh.rank % model_extent(mesh)


def multi_rank(mesh) -> bool:
    """Whether the mesh spans more than one rank (a split node axis, a
    model axis, or both): its ranks then plan and step in lockstep."""
    return mesh is not None and mesh.size > 1


def data_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in NODE_AXES)


def n_data_nodes(mesh: Mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def is_sharded(mesh) -> bool:
    """Whether the node axis is split over more than one rank."""
    return mesh is not None and n_data_nodes(mesh) > 1


def node_index(mesh: Mesh) -> int:
    """This rank's position along the node axes (row-major over "pod",
    "data"), its node shard."""
    return mesh.rank // model_extent(mesh)


def row_range(mesh: Mesh, n: int, index: int = None) -> Tuple[int, int]:
    """[start, stop) of the node rows that shard `index` (default: this
    rank's) holds of an n-row node axis: contiguous runs, the first n % E
    shards one row longer (E = n_data_nodes)."""
    E = n_data_nodes(mesh)
    i = node_index(mesh) if index is None else index
    q, r = divmod(n, E)
    start = i * q + min(i, r)
    return start, start + q + (1 if i < r else 0)


RowTable = Tuple[Tuple[int, int], ...]


def row_table(mesh: Mesh, n: int) -> RowTable:
    """[start, stop) of every node shard's rows of an n-row node axis, in
    shard order (`row_range` of each)."""
    return tuple(row_range(mesh, n, i) for i in range(n_data_nodes(mesh)))


def cohort_rows(mesh: Mesh, membership) -> RowTable:
    """The cohort rows that every node shard holds of a membership's m
    active nodes (a `core.mixing.Membership`), in shard order. The cohort
    is the active ids in ascending order, so shard i's active nodes are
    the contiguous cohort rows [a_i, b_i), a_i the number of active ids
    below its first node row; a shard whose nodes are all out holds
    (a_i, a_i). The full membership gives `row_table`."""
    out, pos = [], 0
    for lo, hi in row_table(mesh, membership.n):
        k = sum(membership.active[lo:hi])
        out.append((pos, pos + k))
        pos += k
    return tuple(out)


def local_ids(mesh, membership) -> Tuple[int, ...]:
    """This rank's active nodes of a membership, as indices into its own
    node rows (the active ids themselves without a split node axis)."""
    rows = node_rows(mesh, membership.n)
    return tuple(i - rows.start for i in membership.active_ids
                 if rows.start <= i < rows.stop)


def node_rows(mesh, n: int) -> slice:
    """This rank's rows of an n-row node axis (every row without a
    sharded mesh)."""
    if not is_sharded(mesh):
        return slice(0, n)
    return slice(*row_range(mesh, n))


def n_local(mesh, n: int) -> int:
    rows = node_rows(mesh, n)
    return rows.stop - rows.start


def node_leaf(leaf) -> bool:
    """Whether a leaf of a decentralized state on a split node axis holds
    the rank's rows of the node axis: every tensor of rank >= 1 and every
    tuple of per-node ints does, since the state is the rank's rows of
    every leaf (`train.trainer.replicate_for_nodes`,
    `core.krasulina.init_krasulina_state`); a 0-dim tensor or an int does
    not. The rule the split checkpoint, the split publication and their
    plans share: a leaf's local shape cannot tell one row of the node axis
    from a replicated [1, ...] leaf."""
    return ((isinstance(leaf, torch.Tensor) and leaf.dim() > 0)
            or isinstance(leaf, tuple))


# ---------------------------------------------------------------------------
# Messages between the ranks of a mesh, over its process groups
#
# The ranks of one card share it in a gloo group (NCCL refuses two ranks on
# one device), and gloo moves host memory: a CUDA tensor is staged
# explicitly, device to a pinned host buffer, the message, then host to
# device, on the rank's current stream with a sync before the send. Staging
# goes in chunks of at most STAGE_BYTES per message, so the pinned memory
# stays bounded at any width (one row of an 8B-class model is 1.27 GB in
# bf16). A CPU tensor is sent as it is. Every staged byte is counted in
# `stats` (device to host and host to device both), so the cost of the
# staging stays visible: it is never a silent stand-in for a device path.
#
# Where every rank has a card of its own the group is nccl, which moves
# device memory itself: CUDA tensors then go as they are, unstaged (that
# path cannot be checked on a one-card machine; ROADMAP.md keeps it open).
#
# Every message of one exchange is posted in one `batch_isend_irecv` with a
# tag of its own, so two ranks that are each other's up and down neighbours
# never deadlock; a collective that hangs fails at the group's `timeout`.
#
# On the meta device (the planner's trace, `launch/dryrun.py`) every
# collective is a shape-only no-op that counts the messages and bytes it
# would move on the card, chunks and staging included.
# ---------------------------------------------------------------------------


STAGE_BYTES = 64 << 20  # the most bytes one staged message chunk holds
AXES = ("model", "data")
# since the last `reset_stats()`: bytes staged (device to host plus host to
# device), the same count of the messages' payloads on any device (out plus
# in: what staging moves on a card) and messages sent, in all and per axis
# ("model_messages", "data_wire_bytes", ...)
stats: Dict[str, int] = {}
# (axis, kind) -> [messages, wire bytes], the reference's kind names
log: Dict[Tuple[str, str], List[int]] = {}
# pinned host buffers, reused across calls: (role, slot) -> uint8 buffer
_pinned: Dict[Tuple[str, int], torch.Tensor] = {}


def reset_stats() -> None:
    stats.clear()
    for k in ("staged_bytes", "wire_bytes", "messages"):
        stats[k] = 0
        for a in AXES:
            stats[f"{a}_{k}"] = 0
    log.clear()


reset_stats()


def _count(axis: str, kind: str, messages: int, wire: int,
           staged: int) -> None:
    # the pod and lane groups carry node-axis messages: counted as "data"
    counted = "model" if axis == "model" else "data"
    for prefix in ("", counted + "_"):
        stats[prefix + "messages"] += messages
        stats[prefix + "wire_bytes"] += wire
        stats[prefix + "staged_bytes"] += staged
    entry = log.setdefault((axis, kind), [0, 0])
    entry[0] += messages
    entry[1] += wire


def n_pods(mesh) -> int:
    """The mesh's "pod" extent (1 without one)."""
    return 1 if mesh is None else mesh.shape.get("pod", 1)


def pod_index(mesh: Mesh) -> int:
    """This rank's pod (its position along the "pod" axis)."""
    return node_index(mesh) // (n_data_nodes(mesh) // n_pods(mesh))


def axis_extent(mesh: Mesh, axis: str) -> int:
    """The ranks a message over `axis` reaches: "model", "data" (every node
    shard), "pod" (the node shards of this rank's pod) or "lane" (one node
    shard a pod, at this rank's data index)."""
    if axis == "model":
        return model_extent(mesh)
    if axis == "lane":
        return n_pods(mesh)
    if axis == "pod":
        return n_data_nodes(mesh) // n_pods(mesh)
    return n_data_nodes(mesh)


def axis_group(mesh: Mesh, axis: str):
    """The process group of this rank's `axis` ("model": its node shard's
    ranks; "data": its model index's ranks, every rank without a model
    axis; "pod" and "lane": its pod's and its lane's ranks, the data group
    where the mesh has one pod)."""
    if axis in ("pod", "lane") and n_pods(mesh) > 1:
        return mesh.pod_group if axis == "pod" else mesh.lane_group
    if model_extent(mesh) == 1:
        return mesh.group
    return mesh.model_group if axis == "model" else mesh.data_group


def lane_mesh(mesh: Mesh) -> Mesh:
    """A one-axis mesh over this rank's lane group: the pods as its node
    shards, one row each (the hierarchical mode's gossip between pods,
    `core.averaging`)."""
    return Mesh((n_pods(mesh),), ("data",), pod_index(mesh),
                axis_group(mesh, "lane"))


def _buffer(role: str, slot: int, nbytes: int) -> torch.Tensor:
    buf = _pinned.get((role, slot))
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        _pinned[(role, slot)] = buf
    return buf


def _view(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    nbytes = like.numel() * like.element_size()
    return buf[:nbytes].view(like.dtype).view(like.shape)


def _peer(mesh: Mesh, shard: int) -> int:
    """The global rank of node shard `shard` at this rank's model index."""
    return _global(mesh, shard * model_extent(mesh) + model_index(mesh))


def _model_peer(mesh: Mesh, index: int) -> int:
    """The global rank of model index `index` in this rank's node shard."""
    return _global(mesh, node_index(mesh) * model_extent(mesh) + index)


def _global(mesh: Mesh, r: int) -> int:
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether `t` goes through pinned host buffers: a CUDA tensor on a
    group that moves host memory (every backend but nccl)."""
    return (t.device.type == "cuda"
            and dist.get_backend(group) != dist.Backend.NCCL)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def column_chunks(d: int, rows: int, elem: int,
                  multiple: int = 1) -> List[Tuple[int, int]]:
    """[c0, c1) column ranges of a [rows, d] buffer, each at most
    STAGE_BYTES (rounded down to a multiple of `multiple` columns, at least
    one multiple)."""
    width = max(STAGE_BYTES // max(rows * elem, 1), 1)
    width = max(width // multiple, 1) * multiple
    return [(c, min(c + width, d)) for c in range(0, d, width)]


def exchange(sends: Sequence[Tuple[int, torch.Tensor, int]],
             recvs: Sequence[Tuple[int, torch.Tensor, int]],
             mesh: Mesh, axis: str = "data",
             kind: str = "collective-permute") -> None:
    """Post every send (peer, [rows, d] tensor, tag) and receive (peer,
    [rows, d] output, tag) in one batch and wait for all of them; the peers
    are node shards (their ranks at this rank's model index) over the
    "data" axis, model indices (their ranks in this rank's node shard) over
    the "model" axis, and the messages count as `kind` over `axis`. The
    tensors share d and a device; on CUDA each is staged through its own
    pinned buffer, column chunk by column chunk."""
    tensors = [t for _, t, _ in sends] + [t for _, t, _ in recvs]
    if not tensors:
        return
    d = tensors[0].shape[1]
    if d == 0:
        return
    meta = tensors[0].device.type == "meta"
    cuda = meta or _staged(mesh.group, tensors[0])
    rows = max(t.shape[0] for t in tensors)
    elem = tensors[0].element_size()
    stream = (torch.cuda.current_stream(tensors[0].device)
              if cuda and not meta else None)
    peer = _model_peer if axis == "model" else _peer
    for c0, c1 in column_chunks(d, rows, elem):
        wire = sum(t.shape[0] * (c1 - c0) * elem for t in tensors)
        if meta:
            _count(axis, kind, len(sends), wire, wire)
            continue
        if cuda:
            out_bufs = []
            for j, (_, t, _) in enumerate(sends):
                part = t[:, c0:c1]
                buf = _view(_buffer("send", j, _nbytes(part)), part)
                buf.copy_(part, non_blocking=True)
                out_bufs.append(buf)
            in_bufs = [_view(_buffer("recv", j, t[:, c0:c1].numel() *
                                     t.element_size()), t[:, c0:c1])
                       for j, (_, t, _) in enumerate(recvs)]
            # the sends' copies have landed, and the last chunk's copies out
            # of the receive buffers are done before they are refilled
            stream.synchronize()
        else:
            out_bufs = [t[:, c0:c1].contiguous() for _, t, _ in sends]
            in_bufs = [torch.empty_like(t[:, c0:c1]) for _, t, _ in recvs]
        ops = ([dist.P2POp(dist.isend, b, peer(mesh, p), mesh.group, tag)
                for (p, _, tag), b in zip(sends, out_bufs)] +
               [dist.P2POp(dist.irecv, b, peer(mesh, p), mesh.group, tag)
                for (p, _, tag), b in zip(recvs, in_bufs)])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        _count(axis, kind, len(sends), wire, wire if cuda else 0)
        for (_, t, _), b in zip(recvs, in_bufs):
            t[:, c0:c1].copy_(b, non_blocking=cuda)


def model_block(mesh: Mesh, g: int) -> range:
    """The model indices of this rank's block of `g` consecutive ones (g
    divides the model extent): the ranks that share a head whose columns
    the model axis splits over g ranks (`block_all_gather`)."""
    j0 = model_index(mesh) // g * g
    return range(j0, j0 + g)


def block_all_gather(x: torch.Tensor, mesh: Mesh, g: int) -> torch.Tensor:
    """[rows, g * c]: the [rows, c] columns x of every rank of this rank's
    block of g model indices (`model_block`), in their order: an
    all-gather over the block, sent as messages between its ranks over the
    model group."""
    block, me = model_block(mesh, g), model_index(mesh)
    out = x.new_empty((x.shape[0], g, x.shape[1]))
    out[:, me - block.start] = x
    exchange([(j, x, 0) for j in block if j != me],
             [(j, out[:, j - block.start], 0) for j in block if j != me],
             mesh, "model", "all-gather")
    return out.reshape(x.shape[0], g * x.shape[1])


def block_reduce_scatter(x: torch.Tensor, mesh: Mesh,
                         g: int) -> torch.Tensor:
    """The inverse of `block_all_gather` for its gradient: x [rows, g * c]
    holds this rank's addends for the columns of every rank of its block;
    returns the f32 [rows, c] sum of every rank's addends for this rank's
    columns, added in the block's order (a reduce-scatter over the block,
    sent as messages between its ranks)."""
    block, me = model_block(mesh, g), model_index(mesh)
    rows, c = x.shape[0], x.shape[1] // g
    parts = x.reshape(rows, g, c)
    inbox = x.new_empty((g, rows, c))
    exchange([(j, parts[:, j - block.start], 0) for j in block if j != me],
             [(j, inbox[j - block.start], 0) for j in block if j != me],
             mesh, "model", "reduce-scatter")
    acc = torch.zeros((rows, c), dtype=torch.float32, device=x.device)
    for j in block:
        acc.add_(parts[:, j - block.start] if j == me
                 else inbox[j - block.start])
    return acc


def all_reduce_(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM,
                axis: str = "data", kind: str = "all-reduce") -> torch.Tensor:
    """In-place all-reduce of `t` over this rank's `axis` group ("data":
    the node axis; "model": the model axis), staged in chunks on CUDA,
    logged as `kind` (the quantized wires' slot statistics log theirs as
    "slot all-reduce", `core.quantize.complete_slots`). Returns `t`; no
    message where the axis has one rank."""
    if not t.is_contiguous():
        raise ValueError("all_reduce_ takes a contiguous tensor")
    if axis_extent(mesh, axis) == 1:
        return t
    nbytes = _nbytes(t)
    if t.device.type == "meta":
        _count(axis, kind, max(1, -(-nbytes // STAGE_BYTES)),
               2 * nbytes, 2 * nbytes)
        return t
    group = axis_group(mesh, axis)
    if not _staged(group, t):
        dist.all_reduce(t, op=op, group=group)
        _count(axis, kind, 1, 2 * nbytes, 0)
        return t
    flat = t.view(-1)
    step = max(STAGE_BYTES // t.element_size(), 1)
    stream = torch.cuda.current_stream(t.device)
    for c0 in range(0, flat.numel(), step):
        part = flat[c0:c0 + step]
        buf = _view(_buffer("reduce", 0, _nbytes(part)), part)
        buf.copy_(part, non_blocking=True)
        stream.synchronize()
        dist.all_reduce(buf, op=op, group=group)
        part.copy_(buf)  # synchronous: the buffer is refilled next chunk
        _count(axis, kind, 1, 2 * _nbytes(part), 2 * _nbytes(part))
    return t


def all_gather_rows(x: torch.Tensor, mesh: Mesh, n: int,
                    rows: RowTable = None) -> torch.Tensor:
    """The full [n, ...] node axis from every node shard's rows of it
    (contiguous runs: `rows`, default `row_table`; a cohort's table,
    `cohort_rows`, may give a shard no row), on x's device."""
    E = n_data_nodes(mesh)
    ranges = list(rows or row_table(mesh, n))
    top = max(b - a for a, b in ranges)
    flat = x.reshape(x.shape[0], math.prod(x.shape[1:]))
    d = flat.shape[1]
    full = flat.new_empty((n, d))
    elem = x.element_size()
    meta = x.device.type == "meta"
    group = axis_group(mesh, "data")
    cuda = meta or _staged(group, x)
    padded = None if meta else flat.new_zeros((top, d))
    if padded is not None:
        padded[:flat.shape[0]] = flat
    for c0, c1 in column_chunks(d, top, elem):
        wire = (top + n) * (c1 - c0) * elem
        if meta:
            _count("data", "all-gather", 1, wire, wire)
            continue
        part = padded[:, c0:c1].contiguous()
        if cuda:
            src = _view(_buffer("send", 0, _nbytes(part)), part)
            src.copy_(part)
        else:
            src = part
        outs = [torch.empty_like(src) for _ in range(E)]
        dist.all_gather(outs, src, group=group)
        _count("data", "all-gather", 1, wire, wire if cuda else 0)
        for (a, b), o in zip(ranges, outs):
            full[a:b, c0:c1].copy_(o[:b - a])
    return full.reshape(n, *x.shape[1:])


def all_gather_dim(t: torch.Tensor, mesh: Mesh, dim: int,
                   axis: str = "data") -> torch.Tensor:
    """The blocks of every rank of this rank's `axis` group, joined along
    `dim` in the group's order (the ZeRO-1 all-gather of a parameter: its
    data-axis blocks; a model-split leaf's blocks). Returns `t` where the
    axis has one rank."""
    E = axis_extent(mesh, axis)
    if E == 1:
        return t
    flat = t.reshape(-1)
    n = flat.numel()
    out = t.new_empty((E, n))
    elem = t.element_size()
    meta = t.device.type == "meta"
    group = axis_group(mesh, axis)
    cuda = meta or _staged(group, t)
    for c0, c1 in column_chunks(n, E, elem):
        wire = (1 + E) * (c1 - c0) * elem  # the block out, E blocks in
        if meta:
            _count(axis, "all-gather", 1, wire, wire)
            continue
        part = flat[c0:c1]
        if cuda:
            src = _view(_buffer("send", 0, _nbytes(part)), part)
            src.copy_(part)
            dst = _view(_buffer("recv", 0, E * _nbytes(part)),
                        out[:, c0:c1])
        else:
            src, dst = part.contiguous(), out.new_empty((E, c1 - c0))
        dist.all_gather(list(dst.unbind(0)), src, group=group)
        out[:, c0:c1].copy_(dst)
        _count(axis, "all-gather", 1, wire, wire if cuda else 0)
    shape = list(t.shape)
    full = out.reshape(E, *shape).movedim(0, dim)
    shape[dim] *= E
    return full.reshape(shape)


def gather_dim_to_first(t: torch.Tensor, mesh: Mesh, dim: int,
                        axis: str = "data") -> Optional[torch.Tensor]:
    """`all_gather_dim` to one rank: the blocks of every rank of this
    rank's `axis` group ("data" or "model") joined along `dim` in the
    group's order on its first rank (index 0 along the axis), which
    receives them as messages (`exchange`, counted as a "gather"); None on
    the others, which send it theirs. Returns `t` where the axis has one
    rank."""
    E = axis_extent(mesh, axis)
    if E == 1:
        return t
    index = model_index(mesh) if axis == "model" else node_index(mesh)
    flat = t.reshape(1, -1)
    if index:
        exchange([(0, flat, 0)], [], mesh, axis, "gather")
        return None
    out = t.new_empty((E, flat.shape[1]))
    out[0] = flat[0]
    exchange([], [(j, out[j:j + 1], 0) for j in range(1, E)], mesh, axis,
             "gather")
    shape = list(t.shape)
    full = out.reshape(E, *shape).movedim(0, dim)
    shape[dim] *= E
    return full.reshape(shape)


def reduce_scatter_dim(t: torch.Tensor, mesh: Mesh, dim: int,
                       axis: str = "data") -> torch.Tensor:
    """This rank's block (the group's order, along `dim`) of the sum of
    every rank of its `axis` group's `t`: the ZeRO-1 reduce-scatter of a
    gradient. An all-to-all sends block j to rank j, and each rank sums the
    blocks it receives in the group's order. Returns `t` where the axis has
    one rank."""
    E = axis_extent(mesh, axis)
    if E == 1:
        return t
    shape = list(t.shape)
    if shape[dim] % E:
        raise ValueError(f"dim {dim} of {tuple(shape)} does not split over "
                         f"{E} ranks")
    shape[dim] //= E
    blocks = t.reshape(*shape[:dim], E, *shape[dim:]).movedim(dim, 0)
    rows = blocks.reshape(E, -1)
    n = rows.shape[1]
    out = t.new_empty(n)
    elem = t.element_size()
    meta = t.device.type == "meta"
    group = axis_group(mesh, axis)
    cuda = meta or _staged(group, t)
    for c0, c1 in column_chunks(n, E, elem):
        wire = 2 * E * (c1 - c0) * elem  # E blocks out, E in
        if meta:
            _count(axis, "reduce-scatter", 1, wire, wire)
            continue
        if cuda:
            src = _view(_buffer("send", 0, E * (c1 - c0) * elem),
                        rows[:, c0:c1])
            src.copy_(rows[:, c0:c1])
            dst = _view(_buffer("recv", 0, E * (c1 - c0) * elem), src)
        else:
            src = rows[:, c0:c1].contiguous()
            dst = torch.empty_like(src)
        dist.all_to_all_single(dst, src, group=group)
        out[c0:c1] = dst.to(t.device).sum(0)
        _count(axis, "reduce-scatter", 1, wire, wire if cuda else 0)
    return out.reshape(shape)


def row_sum(rows: torch.Tensor) -> torch.Tensor:
    """The f32 sum of rows [m, ...] over dim 0, added one row at a time in
    row order: elementwise adds in a fixed order, so equal rows give equal
    bits on any device and any split of them (`reduce_scatter_rows`)."""
    acc = rows[0].to(torch.float32, copy=True)
    for r in rows[1:]:
        acc.add_(r)
    return acc


def reduce_scatter_rows(x: torch.Tensor, mesh: Mesh,
                        axis: str = "data") -> torch.Tensor:
    """This rank's block (the group's order) of the f32 sum of every row of
    every rank's x [k, E * w] in its `axis` group: [w]. An all-to-all sends
    block j of each row to rank j, in x's dtype, and each rank adds the
    E * k rows it receives with `row_sum`, in the group's order and each
    rank's row order: one process's `row_sum` of the same rows, bit for
    bit, on any split. `row_sum(x)` where the axis has one rank."""
    E = axis_extent(mesh, axis)
    if E == 1:
        return row_sum(x)
    k, d = x.shape
    if d % E:
        raise ValueError(f"{d} columns do not split over {E} ranks")
    w = d // E
    blocks = x.reshape(k, E, w).transpose(0, 1)  # [E, k, w]
    out = torch.empty(w, dtype=torch.float32, device=x.device)
    elem = x.element_size()
    meta = x.device.type == "meta"
    group = axis_group(mesh, axis)
    cuda = meta or _staged(group, x)
    for c0, c1 in column_chunks(w, E * k, elem):
        wire = 2 * E * k * (c1 - c0) * elem  # E blocks out, E in
        if meta:
            _count(axis, "reduce-scatter", 1, wire, wire)
            continue
        part = blocks[:, :, c0:c1]
        if cuda:
            src = _view(_buffer("send", 0, _nbytes(part)), part)
            src.copy_(part)
            dst = _view(_buffer("recv", 0, _nbytes(part)), src)
        else:
            src = part.contiguous()
            dst = torch.empty_like(src)
        dist.all_to_all_single(dst, src, group=group)
        out[c0:c1] = row_sum(dst.to(x.device).reshape(E * k, c1 - c0))
        _count(axis, "reduce-scatter", 1, wire, wire if cuda else 0)
    return out


def broadcast_object(obj, mesh: Mesh, src: int = 0):
    """`obj` as rank `src` of the mesh holds it, on every rank."""
    box = [obj]
    root = src if mesh.group is None else dist.get_global_rank(mesh.group,
                                                               src)
    dist.broadcast_object_list(box, src=root, group=mesh.group)
    stats["messages"] += 1
    return box[0]
