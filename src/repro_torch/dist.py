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

The kernels, the core algorithms, the data pipeline and the trainer take a
`Mesh` from here; `launch/mesh.py` builds one over a process group. A
model axis of extent above 1 (tensor-parallel and ZeRO-1 layouts) is
planned, not executed: the planner (`launch/dryrun.py`) takes one on a
mesh that no group backs (`launch/mesh.py` `abstract_mesh`), and
`check_mesh` refuses it wherever a mesh executes (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

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

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> extent, as the reference's `mesh.shape`."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def check_mesh(mesh: Mesh) -> None:
    """Refuse a model axis of extent above 1 where a mesh executes: the
    sharded model layouts are planned (`launch/dryrun.py`), not
    executed."""
    model = mesh.shape.get("model", 1)
    if model > 1:
        raise NotImplementedError(
            f"a model axis of extent {model}: the sharded model layouts "
            f"(tensor parallelism, ZeRO-1) are planned, not executed yet "
            f"(ROADMAP.md queue 1 item 3); the port shards the node axis "
            f"only")


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
    "data"): with no model axis to split, the rank itself."""
    return mesh.rank // mesh.shape.get("model", 1)


def row_range(mesh: Mesh, n: int, index: int = None) -> Tuple[int, int]:
    """[start, stop) of the node rows that shard `index` (default: this
    rank's) holds of an n-row node axis: contiguous runs, the first n % E
    shards one row longer (E = n_data_nodes)."""
    E = n_data_nodes(mesh)
    i = node_index(mesh) if index is None else index
    q, r = divmod(n, E)
    start = i * q + min(i, r)
    return start, start + q + (1 if i < r else 0)


def node_rows(mesh, n: int) -> slice:
    """This rank's rows of an n-row node axis (every row without a
    sharded mesh)."""
    if not is_sharded(mesh):
        return slice(0, n)
    return slice(*row_range(mesh, n))


def n_local(mesh, n: int) -> int:
    rows = node_rows(mesh, n)
    return rows.stop - rows.start


# ---------------------------------------------------------------------------
# Messages between the ranks of a mesh, over its process group
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
# ---------------------------------------------------------------------------


STAGE_BYTES = 64 << 20  # the most bytes one staged message chunk holds
# bytes staged (device to host plus host to device), the same count of the
# messages' payloads on any device (out plus in: what staging moves on a
# card), and messages sent, since the last `reset_stats()`
stats: Dict[str, int] = {"staged_bytes": 0, "wire_bytes": 0, "messages": 0}
# pinned host buffers, reused across calls: (role, slot) -> uint8 buffer
_pinned: Dict[Tuple[str, int], torch.Tensor] = {}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


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
    """The global rank of node shard `shard` (a rank of mesh.group)."""
    if mesh.group is None:
        return shard
    return dist.get_global_rank(mesh.group, shard)


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    """Whether `t` goes through pinned host buffers: a CUDA tensor on a
    group that moves host memory (every backend but nccl)."""
    return (t.device.type == "cuda"
            and dist.get_backend(mesh.group) != dist.Backend.NCCL)


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
             mesh: Mesh) -> None:
    """Post every send (node shard, [rows, d] tensor, tag) and receive
    (node shard, [rows, d] output, tag) in one batch and wait for all of
    them. The tensors share d and a device; on CUDA each is staged through
    its own pinned buffer, column chunk by column chunk."""
    tensors = [t for _, t, _ in sends] + [t for _, t, _ in recvs]
    if not tensors:
        return
    d = tensors[0].shape[1]
    if d == 0:
        return
    cuda = _staged(mesh, tensors[0])
    rows = max(t.shape[0] for t in tensors)
    stream = torch.cuda.current_stream(tensors[0].device) if cuda else None
    for c0, c1 in column_chunks(d, rows, tensors[0].element_size()):
        if cuda:
            out_bufs = []
            for j, (_, t, _) in enumerate(sends):
                part = t[:, c0:c1]
                buf = _view(_buffer("send", j, part.numel() *
                                    part.element_size()), part)
                buf.copy_(part, non_blocking=True)
                out_bufs.append(buf)
                stats["staged_bytes"] += part.numel() * part.element_size()
            in_bufs = [_view(_buffer("recv", j, t[:, c0:c1].numel() *
                                     t.element_size()), t[:, c0:c1])
                       for j, (_, t, _) in enumerate(recvs)]
            # the sends' copies have landed, and the last chunk's copies out
            # of the receive buffers are done before they are refilled
            stream.synchronize()
        else:
            out_bufs = [t[:, c0:c1].contiguous() for _, t, _ in sends]
            in_bufs = [torch.empty_like(t[:, c0:c1]) for _, t, _ in recvs]
        ops = ([dist.P2POp(dist.isend, b, _peer(mesh, p), mesh.group, tag)
                for (p, _, tag), b in zip(sends, out_bufs)] +
               [dist.P2POp(dist.irecv, b, _peer(mesh, p), mesh.group, tag)
                for (p, _, tag), b in zip(recvs, in_bufs)])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        stats["messages"] += len(sends)
        stats["wire_bytes"] += sum(b.numel() * b.element_size()
                                   for b in out_bufs + in_bufs)
        for (_, t, _), b in zip(recvs, in_bufs):
            t[:, c0:c1].copy_(b, non_blocking=cuda)
            if cuda:
                stats["staged_bytes"] += b.numel() * b.element_size()


def all_reduce_(t: torch.Tensor, mesh: Mesh,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `t` over the mesh's ranks (staged in chunks
    on CUDA). Returns `t`."""
    if not t.is_contiguous():
        raise ValueError("all_reduce_ takes a contiguous tensor")
    stats["wire_bytes"] += 2 * t.numel() * t.element_size()
    if not _staged(mesh, t):
        dist.all_reduce(t, op=op, group=mesh.group)
        stats["messages"] += 1
        return t
    flat = t.view(-1)
    step = max(STAGE_BYTES // t.element_size(), 1)
    stream = torch.cuda.current_stream(t.device)
    for c0 in range(0, flat.numel(), step):
        part = flat[c0:c0 + step]
        buf = _view(_buffer("reduce", 0, part.numel() * part.element_size()),
                    part)
        buf.copy_(part, non_blocking=True)
        stream.synchronize()
        dist.all_reduce(buf, op=op, group=mesh.group)
        part.copy_(buf)  # synchronous: the buffer is refilled next chunk
        stats["staged_bytes"] += 2 * part.numel() * part.element_size()
        stats["messages"] += 1
    return t


def all_gather_rows(x: torch.Tensor, mesh: Mesh, n: int) -> torch.Tensor:
    """The full [n, ...] node axis from every rank's rows of it (contiguous
    runs, `row_range`), on x's device."""
    E = n_data_nodes(mesh)
    ranges = [row_range(mesh, n, i) for i in range(E)]
    top = max(b - a for a, b in ranges)
    flat = x.reshape(x.shape[0], -1)
    d = flat.shape[1]
    full = flat.new_empty((n, d))
    padded = flat.new_zeros((top, d))
    padded[:flat.shape[0]] = flat
    cuda = _staged(mesh, x)
    for c0, c1 in column_chunks(d, top, x.element_size()):
        part = padded[:, c0:c1].contiguous()
        if cuda:
            src = _view(_buffer("send", 0, part.numel() *
                                part.element_size()), part)
            src.copy_(part)
            stats["staged_bytes"] += part.numel() * part.element_size()
        else:
            src = part
        outs = [torch.empty_like(src) for _ in range(E)]
        dist.all_gather(outs, src, group=mesh.group)
        stats["messages"] += 1
        stats["wire_bytes"] += part.numel() * part.element_size() + sum(
            (b - a) * o.shape[1] * o.element_size()
            for (a, b), o in zip(ranges, outs))
        for (a, b), o in zip(ranges, outs):
            full[a:b, c0:c1].copy_(o[:b - a])
            if cuda:
                stats["staged_bytes"] += (b - a) * o.shape[1] * o.element_size()
    return full.reshape(n, *x.shape[1:])


def broadcast_object(obj, mesh: Mesh, src: int = 0):
    """`obj` as node shard `src` holds it, on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=_peer(mesh, src), group=mesh.group)
    stats["messages"] += 1
    return box[0]
