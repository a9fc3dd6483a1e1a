"""Dependency-free checkpointing of the port: a state -> a directory with one
.npy per leaf plus a JSON manifest (paths, dtypes, CRC32 checksums, the
step, a metadata echo), in the JAX package's layout, so a checkpoint written
by either package restores in the other.

* **Leaf names** are JAX's tree paths: `.field` for a NamedTuple field, the
  dict key, the sequence index, joined by `::` (`/` becomes `_` in file
  names). A Python int in a state (`KrasulinaState.t`, an optimizer step) is
  an int32 leaf: 0-d, or `[N]` for the per-node steps of a state with the
  decentralized node axis, as the reference stores its int32 arrays.
* **The LM layout.** The port keeps one parameter leaf per layer
  (`params["blocks"][l]`); the reference stacks layer r * period + i into
  leaf `layers::i` at index r (after the node axis), the rest in `tail`.
  With `model=` (the state's `ModelConfig`), a tree whose parameter dicts
  hold "blocks" is written and read through the reference's stacking (the
  plan of `models.transformer.build_plan`, as `convert.lm_tree` uses it).
* **bf16** has no numpy dtype here (no `ml_dtypes`): a bf16 leaf is written
  as raw 2-byte records with the `<V2` descr the reference's `np.save`
  gives, manifest dtype "bfloat16", and read back as a uint16 view
  reinterpreted by the manifest's dtype. The CRC32 runs over the same bytes
  in both packages.

On top of the single-directory save/restore, this module provides the
multi-checkpoint layout the async snapshot subsystem (`train.snapshot`)
uses: step-numbered subdirectories (`step_00000042/`), `newest_valid`
scanning that skips torn or corrupt checkpoints, and `prune` retention of
the last k.

**A node axis split over ranks** (`repro_torch/dist.py`; every rank
calls, with the same `mesh`). The checkpoint is the same directory, byte
for byte, as one process writes for the whole state, so it restores on
one process, on another split, or in the JAX package. Rank 0 writes each
node-axis leaf's `.npy` header for the full [N, ...] shape and sizes the
file, and writes the leaves without a node axis; then every rank writes
its own rows at their offset (no rank stages another's rows) and takes
the CRC32 of its bytes; rank 0 chains the ranks' CRCs in row order
(`crc32_combine`) and writes the manifest last. The node-axis leaves are
those of a decentralized state (`n_nodes` given) that `dist.node_leaf`
names: every tensor and per-node tuple, since such a state is the rank's
rows of every leaf; a leaf whose rows are not the rank's raises. A
restore reads each rank's rows of a node-axis leaf and the whole of the
others, and the ranks agree on the CRCs the same way before any leaf
lands. The messages go over `group` (a
process group of the mesh's ranks: the snapshot writer passes its own),
default the mesh's.

**A model axis** (a mesh whose model extent is above 1; `specs`, the
placements of the rank's state, `train.trainer.state_placements`). The
checkpoint is still the one-process file of the gathered state, byte for
byte. Leaf by leaf, the ranks send their blocks to the rank that writes
them (`launch/sharding.py` `gather_to_first`): a node-axis leaf's over
the model group to model index 0, which writes its node shard's rows of
the whole leaf at their offset, as above (a model block's columns are
strided in the row-major file, its rows are not); a leaf without a node
axis (the exact mode's, ZeRO-1 blocks too) to rank 0, over each group
that splits it in turn, and rank 0 writes it. No other rank builds a
whole leaf, and a writer frees each once written, so it holds a few
leaves whole at a time, never the state. A restore reads each rank's rows (or the
whole leaf) and cuts its blocks out of them (`local_block`), onto any
split: the one it was written on, another model extent, or one process.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import dist as rdist
from repro_torch.launch import sharding as shlib

Tree = Any

_SEP = "::"
# files a rank of a split checkpoint reads or writes at a time: one stream
# leaves a network or host-mediated filesystem idle between requests
IO_THREADS = 4
_STEP_DIR_RE = re.compile(r"^step_(\d{8})$")

# a port path element: ("f", name) NamedTuple field, ("k", key) dict key,
# ("i", index) sequence index
Path = Tuple[Tuple[str, Any], ...]


class _Entry(NamedTuple):
    """One checkpoint leaf: the port leaves it holds (stacked along `axis`
    in that order, or the one leaf when `axis` is None)."""

    paths: Tuple[Path, ...]
    axis: Optional[int]


def _int_seq(x) -> bool:
    return (isinstance(x, (tuple, list)) and len(x) > 0
            and all(isinstance(v, (int, np.integer))
                    and not isinstance(v, bool) for v in x))


def _walk(tree: Tree, path: Path, out: Dict[Path, Any]) -> None:
    """The leaves of a port state by path: tensors, ints, and tuples of ints
    (the per-node optimizer steps) as one leaf each."""
    if isinstance(tree, torch.Tensor):
        out[path] = tree
    elif isinstance(tree, (int, np.integer)) and not isinstance(tree, bool):
        out[path] = int(tree)
    elif _int_seq(tree):
        out[path] = tuple(int(v) for v in tree)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            _walk(getattr(tree, f), path + (("f", f),), out)
    elif isinstance(tree, dict):
        for k in tree:
            _walk(tree[k], path + (("k", k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, path + (("i", i),), out)
    elif tree is not None:
        raise TypeError(f"checkpoint leaves must be tensors or ints, got "
                        f"{type(tree).__name__} at {path}")


def _node_axis_of(tree: Tree, path: Path) -> bool:
    """Whether the parameter dict at `path` carries the node axis (its
    embedding is [N, V, D])."""
    for kind, k in path:
        tree = getattr(tree, k) if kind == "f" else tree[k]
    emb = tree.get("embed") if isinstance(tree, dict) else None
    return emb is not None and emb.dim() == 3


def _layout(tree: Tree, model=None) -> Tuple[Dict[str, _Entry],
                                               Dict[Path, Any]]:
    """The checkpoint leaves of `tree` in the reference's order (NamedTuple
    fields in order, dict keys sorted, indices ascending), by key, and the
    port's leaves by path."""
    leaves: Dict[Path, Any] = {}
    _walk(tree, (), leaves)
    plan = None
    if any(("k", "blocks") in p for p in leaves):
        if model is None:
            raise ValueError("an LM state is checkpointed in the reference's "
                             "stacked layout: pass its model config "
                             "(model=...)")
        from repro_torch.models.transformer import build_plan

        period, n_rep, _ = build_plan(model)
        plan = (len(period), n_rep)
    fields: Dict[Path, Tuple[str, ...]] = {}

    def field_index(parent: Path, name: str) -> int:
        if parent not in fields:
            node = tree
            for kind, k in parent:
                node = getattr(node, k) if kind == "f" else node[k]
            fields[parent] = node._fields
        return fields[parent].index(name)

    grouped: Dict[str, Tuple[tuple, Dict[int, Path], Optional[int]]] = {}
    node_axis: Dict[Path, bool] = {}
    for path, _ in leaves.items():
        ref, sort, stack, axis = [], [], None, None
        j = 0
        while j < len(path):
            kind, k = path[j]
            if (kind == "k" and k == "blocks" and plan is not None
                    and j + 1 < len(path)):
                P, n_rep = plan
                layer = path[j + 1][1]
                parent = path[:j]
                if parent not in node_axis:
                    node_axis[parent] = _node_axis_of(tree, parent)
                if layer < P * n_rep:
                    ref += ["layers", str(layer % P)]
                    sort += [(1, "layers"), (0, layer % P)]
                    stack, axis = layer // P, 1 if node_axis[parent] else 0
                else:
                    ref += ["tail", str(layer - P * n_rep)]
                    sort += [(1, "tail"), (0, layer - P * n_rep)]
                j += 2
                continue
            if kind == "f":
                ref.append("." + k)
                sort.append((0, field_index(path[:j], k)))
            elif kind == "k":
                ref.append(str(k))
                sort.append((1, str(k)))
            else:
                ref.append(str(k))
                sort.append((0, k))
            j += 1
        key = _SEP.join(ref)
        if key not in grouped:
            grouped[key] = (tuple(sort), {}, axis)
        grouped[key][1][0 if stack is None else stack] = path
    out = {}
    for key, (_, parts, axis) in sorted(grouped.items(),
                                        key=lambda kv: kv[1][0]):
        out[key] = _Entry(tuple(parts[r] for r in sorted(parts)), axis)
    return out, leaves


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array and its manifest dtype (bf16 as a uint16
    view of its bytes; ints as int32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf, np.int32)
    return a, str(a.dtype)


def _entry_array(entry: _Entry, leaves: Dict[Path, Any]
                 ) -> Tuple[np.ndarray, str]:
    if entry.axis is None:
        return _host(leaves[entry.paths[0]])
    parts = [_host(leaves[p]) for p in entry.paths]
    return np.stack([a for a, _ in parts], axis=entry.axis), parts[0][1]


def _crc32(arr: np.ndarray) -> int:
    """Content checksum of a leaf: CRC32 over the raw array bytes (C order),
    the bytes written after the .npy header, so a torn write, a bit-rotted
    block, or a truncated file fails verification on restore."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _write(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    # the reference's np.save of a bf16 array: descr '<V2', raw records
    with open(path, "wb") as f:
        _header(f, arr, dtype, arr.shape)
        f.write(np.ascontiguousarray(arr).tobytes())


def _header(f, arr: np.ndarray, dtype: str, shape) -> int:
    """Write the .npy (1.0) header `np.save` writes for a C-order array of
    arr's dtype (bf16: '<V2') and `shape`; returns its length."""
    descr = ("<V2" if dtype == "bfloat16"
             else np.lib.format.dtype_to_descr(arr.dtype))
    np.lib.format.write_array_header_1_0(
        f, {"descr": descr, "fortran_order": False, "shape": tuple(shape)})
    return f.tell()


def _gf2_times(mat: List[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: List[int]) -> List[int]:
    return [_gf2_times(mat, m) for m in mat]


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC32 of A + B from crc1 = CRC32(A), crc2 = CRC32(B) and B's
    length in bytes (zlib's `crc32_combine`: crc1 run through len2 zero
    bytes by repeated squaring of the one-bit shift operator over GF(2))."""
    if len2 <= 0:
        return crc1
    odd = [0xEDB88320] + [1 << i for i in range(31)]  # one zero bit
    even = _gf2_square(odd)  # two
    odd = _gf2_square(even)  # four
    while True:
        even = _gf2_square(odd)  # one zero byte, then 4, 16, ...
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


def _save_leaf(path: str, arr: np.ndarray, dtype: str, *, retries: int = 0,
               backoff_s: float = 0.05) -> None:
    """Write one leaf with retry-with-backoff for transient OSErrors (full
    disk being drained, an NFS blip): up to `retries` retries with
    exponential backoff, then the last error propagates. A partial file from
    a failed attempt is overwritten by the retry."""
    _retrying(lambda: _write(path, arr, dtype), retries, backoff_s)


def _retrying(write: Callable[[], None], retries: int,
              backoff_s: float) -> None:
    attempt = 0
    while True:
        try:
            write()
            return
        except OSError:
            if attempt >= retries:
                raise
            time.sleep(backoff_s * (2 ** attempt))
            attempt += 1


def _live_files(path: str) -> set:
    """Leaf files the current durable manifest references (empty if none).
    A re-save must never write over these: they back the checkpoint that
    stays restorable if the new save crashes partway."""
    try:
        return {ent["file"] for ent in load_manifest(path)["leaves"].values()}
    except Exception:
        return set()


def save(path: str, tree: Tree, *, step: int = 0, meta: Optional[dict] = None,
         retries: int = 0, backoff_s: float = 0.05, model=None,
         mesh=None, n_nodes: Optional[int] = None, group=None,
         specs: Tree = None) -> None:
    """Crash-safe save: every leaf .npy is written BEFORE the manifest, and
    the manifest lands via temp file, `fsync` and atomic `os.replace`, so a
    checkpoint directory either has a manifest whose leaves are all complete
    on disk, or no (new) manifest at all. Leaf files are step-versioned and
    never reuse a name the live manifest references (the `.gN` suffixes), so
    an in-place re-save cannot clobber the previous checkpoint's data
    mid-write. Once the new manifest is durable, leaf files it does not
    reference are deleted.

    Each leaf entry carries a CRC32 of the array bytes; `restore` verifies
    them. Tensors on the card are copied to the host leaf by leaf; `model`
    is the `ModelConfig` of an LM state (see the module docstring).

    On a `mesh` that splits the node axis over ranks, `tree` is this
    rank's: its leaves with the node axis (`n_nodes` rows in all; None
    where no leaf has one, as an exact run's replicas) hold its rows, and
    the ranks write one checkpoint together (the module docstring). Over
    a model axis `specs` gives the placements of the rank's blocks."""
    if rdist.multi_rank(mesh):
        return _save_split(path, tree, step, meta, retries, backoff_s,
                           model, mesh, n_nodes, group,
                           _placements(mesh, specs))
    os.makedirs(path, exist_ok=True)
    layout, leaves = _layout(tree, model)
    live = _live_files(path)
    manifest = {"step": step, "meta": meta or {}, "leaves": {}}
    for key, entry in layout.items():
        arr, dtype = _entry_array(entry, leaves)
        fname = _file_name(key, step, live)
        _save_leaf(os.path.join(path, fname), arr, dtype, retries=retries,
                   backoff_s=backoff_s)
        manifest["leaves"][key] = {"file": fname, "dtype": dtype,
                                   "shape": list(arr.shape),
                                   "crc32": _crc32(arr)}
    _write_manifest(path, manifest)


def _file_name(key: str, step: int, live: set) -> str:
    """A step-versioned leaf file name that the live manifest does not
    reference."""
    base = key.replace("/", "_") + f".{step:08d}"
    fname = base + ".npy"
    g = 0
    while fname in live:
        g += 1
        fname = f"{base}.g{g}.npy"
    return fname


def _write_manifest(path: str, manifest: dict) -> None:
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, "manifest.json"))
    _clean_orphans(path, manifest)


# ---------------------------------------------------------------------------
# A node axis split over ranks
# ---------------------------------------------------------------------------


def _placements(mesh, specs: Tree) -> Optional[Callable[[Path], tuple]]:
    """path -> the placement of the rank's leaf there, over a model axis
    (`specs`: a tree shaped as the state), else None."""
    if rdist.model_extent(mesh) == 1:
        return None
    if specs is None:
        raise ValueError("a state split over a model axis is checkpointed "
                         "by its placements: pass specs= "
                         "(train.trainer.state_placements)")

    def at(path: Path) -> tuple:
        node = specs
        for kind, k in path:
            node = getattr(node, k) if kind == "f" else node[k]
        return node

    return at


def _whole_shape(shape, spec, mesh) -> List[int]:
    """The shape of a leaf whose rank's block is `shape` under `spec`,
    the node axis's rows aside (the inverse of `local_shape`)."""
    dims = tuple(spec) + (None,) * (len(shape) - len(spec))
    return [s if d is None else s * shlib._axis_size(mesh, d)
            for s, d in zip(shape, dims)]


def _root(group) -> int:
    return 0 if group is None else dist.get_global_rank(group, 0)


def _bcast(obj, group):
    """`obj` as the group's rank 0 holds it, on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=_root(group), group=group)
    return box[0]


def _gather(obj, group) -> list:
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _combined(parts) -> Tuple[int, int]:
    """(CRC32, bytes) of the concatenation of (first row, CRC32, bytes)
    parts, in row order."""
    crc, total = 0, 0
    for _, c, nbytes in sorted(parts):
        crc = crc32_combine(crc, c, nbytes) if total else c
        total += nbytes
    return crc, total


def _write_rows(fpath: str, offset: int, data, retries: int,
                backoff_s: float) -> None:
    """Write `data` at `offset` of an existing file, retried as
    `_save_leaf` retries."""
    def write():
        with open(fpath, "r+b") as f:
            f.seek(offset)
            f.write(data)

    _retrying(write, retries, backoff_s)


def _save_split(path, tree, step, meta, retries, backoff_s, model, mesh,
                n_nodes, group, spec_at) -> None:
    group = mesh.group if group is None else group
    lead = dist.get_rank(group) == 0
    # the rank that writes its node shard's rows: model index 0
    writer = rdist.model_index(mesh) == 0
    layout, leaves = _layout(tree, model)
    rows = rdist.node_rows(mesh, n_nodes) if n_nodes else None
    local = None if rows is None else rows.stop - rows.start

    def joined(entry: _Entry) -> Dict[Path, Any]:
        """The entry's leaves with their model (and ZeRO-1) blocks
        gathered to the first rank of their groups, None on the others:
        messages every rank takes part in, in the layout's order."""
        if spec_at is None:
            return leaves
        return {p: (shlib.gather_to_first(leaves[p], spec_at(p), mesh)
                    if isinstance(leaves[p], torch.Tensor) else leaves[p])
                for p in entry.paths}

    def node(key: str, count: int) -> bool:
        """Whether leaf `key` (`count` rows) holds this rank's rows
        (`dist.node_leaf`); raises where their count is not the rank's."""
        if local is None or not rdist.node_leaf(leaves[layout[key].paths[0]]):
            return False
        if count != local:
            raise ValueError(f"leaf {key!r} has {count} rows where "
                             f"this rank holds {local} of the node axis's "
                             f"{n_nodes}")
        return True

    error = None
    # rank 0: the file names, and the node-axis leaves' headers and sizes
    plan = {}
    if lead:
        try:
            os.makedirs(path, exist_ok=True)
            live = _live_files(path)
            for key, entry in layout.items():
                fname = _file_name(key, step, live)
                first = leaves[entry.paths[0]]
                # the dtype from one entry (a model block is not whole)
                head_arr, dtype = _host(first.reshape(-1)[:1]
                                        if isinstance(first, torch.Tensor)
                                        else first)
                shape = (list(first.shape) if isinstance(first, torch.Tensor)
                         else list(np.shape(head_arr)))
                if spec_at is not None and isinstance(first, torch.Tensor):
                    shape = _whole_shape(shape, spec_at(entry.paths[0]),
                                         mesh)
                # the stacked shape, without stacking the node-axis leaves
                if entry.axis is not None:
                    shape.insert(entry.axis, len(entry.paths))
                head = None
                if shape and node(key, shape[0]):
                    shape[0] = n_nodes
                    with open(os.path.join(path, fname), "wb") as f:
                        head = _header(f, head_arr, dtype, shape)
                        f.truncate(head + head_arr.itemsize
                                   * math.prod(shape))
                plan[key] = (fname, dtype, shape, head)
        except Exception as e:
            error = f"rank 0: {type(e).__name__}: {e}"
    plan, error = _bcast((plan, error), group)

    # every rank, leaf by leaf: the model blocks gathered to the ranks that
    # write them (messages), then the writers' rows of the node-axis leaves
    # at their offsets and rank 0's leaves without a node axis, IO_THREADS
    # files at a time
    def write_rows(key, arr):
        fname, _, _, head = plan[key]
        node(key, arr.shape[0])
        data = _bytes(arr)
        row_bytes = data.nbytes // max(local, 1)
        _write_rows(os.path.join(path, fname),
                    head + rows.start * row_bytes, data, retries, backoff_s)
        return rows.start, zlib.crc32(data) & 0xFFFFFFFF, data.nbytes

    def write_whole(key, arr):
        fname, dtype = plan[key][:2]
        _save_leaf(os.path.join(path, fname), arr, dtype, retries=retries,
                   backoff_s=backoff_s)
        return _crc32(arr)

    crcs, whole, pending = {}, {}, []

    def settle(n: int) -> None:
        """Wait for all but the newest n writes; record their results."""
        nonlocal error
        while len(pending) > n:
            key, fut = pending.pop(0)
            try:
                (crcs if plan[key][3] is not None else whole)[key] = \
                    fut.result()
            except Exception as e:
                error = error or f"rank {mesh.rank}: {type(e).__name__}: {e}"

    if error is None:
        with ThreadPoolExecutor(IO_THREADS) as pool:
            for key, entry in layout.items():
                rowed = plan[key][3] is not None
                try:
                    got = joined(entry)
                    if error is not None or not (writer if rowed else lead):
                        continue
                    arr, _ = _entry_array(entry, got)
                except Exception as e:
                    error = error or (f"rank {mesh.rank}: "
                                      f"{type(e).__name__}: {e}")
                    continue
                pending.append((key, pool.submit(
                    write_rows if rowed else write_whole, key, arr)))
                del arr, got
                settle(IO_THREADS)
            settle(0)
    parts = _gather((crcs, error), group)
    errors = [e for _, e in parts if e is not None]
    if lead and not errors:
        try:
            manifest = {"step": step, "meta": meta or {}, "leaves": {}}
            for key in layout:
                fname, dtype, shape, head = plan[key]
                crc = (whole[key] if head is None else
                       _combined(c[key] for c, _ in parts if key in c)[0])
                manifest["leaves"][key] = {"file": fname, "dtype": dtype,
                                           "shape": shape, "crc32": crc}
            _write_manifest(path, manifest)
        except Exception as e:
            errors.append(f"rank 0: {type(e).__name__}: {e}")
    errors = _bcast(errors, group)
    if errors:
        raise OSError(f"split checkpoint save at {path!r} failed: "
                      f"{'; '.join(errors)}")


def _read_split(path: str, layout, leaves, mesh, group, n_nodes,
                verify: bool, take: Callable) -> List[str]:
    """Hand this rank's part of each leaf (its rows of a node-axis leaf,
    the whole of the others) to `take(key, CPU tensor of its manifest
    dtype)`, leaf by leaf, and return the keys that failed to load or
    their CRC32 (the ranks' parts chained): the same list on every rank.
    With `verify` every part is read and checked first, and nothing is
    handed over unless every leaf passes on every rank; the parts are
    then read again to land them (as one process's `newest_valid` and
    `restore` read a checkpoint twice)."""
    manifest = load_manifest(path)
    rows = rdist.node_rows(mesh, n_nodes) if n_nodes else None

    def read(key) -> Tuple[np.ndarray, Optional[int]]:
        """The rank's part of leaf `key` and its first row (None: the
        whole leaf)."""
        ent = manifest["leaves"][key]
        fpath = os.path.join(path, ent["file"])
        if rows is None or not rdist.node_leaf(leaves[layout[key].paths[0]]):
            return np.load(fpath), None
        if ent["shape"][:1] != [n_nodes]:
            raise ValueError(f"{key!r} has no {n_nodes}-row node axis")
        return _read_rows(fpath, rows.start, rows.stop), rows.start

    def check(key):
        """(first row, CRC32, bytes) of the rank's rows, or whether the
        whole leaf failed, its CRC32 taken on the reading thread."""
        try:
            arr, start = read(key)
        except Exception:
            return None, True
        if start is not None:
            data = _bytes(arr)
            return (start, zlib.crc32(data) & 0xFFFFFFFF, data.nbytes), False
        ent = manifest["leaves"][key]
        return None, "crc32" in ent and _crc32(arr) != ent["crc32"]

    def agree(crcs, bad) -> List[str]:
        parts = _gather((crcs, bad), group)
        bad = {k for _, b in parts for k in b}
        for key in crcs:
            # the ranks of a model group read the same rows: once each
            got = _combined({c[key] for c, _ in parts if key in c})
            want = manifest["leaves"][key]
            if got != (want.get("crc32", got[0]), _entry_nbytes(want)):
                bad.add(key)
        # every rank computes the same list from the gathered parts
        return sorted(bad)

    with ThreadPoolExecutor(IO_THREADS) as pool:
        if verify:
            crcs, bad = {}, []
            for key, (crc, failed) in zip(layout, pool.map(check, layout)):
                if crc is not None:
                    crcs[key] = crc
                if failed:
                    bad.append(key)
            bad = agree(crcs, bad)
            if bad:
                return bad
        bad = []

        def load(key):
            try:
                return read(key)[0]
            except Exception:
                return None

        # the reads run ahead of the landing, IO_THREADS files at a time
        for key, arr in zip(layout, pool.map(load, layout)):
            if arr is None:
                bad.append(key)
            else:
                take(key, _tensor(arr, manifest["leaves"][key]["dtype"]))
            del arr
    return sorted({k for b in _gather(bad, group) for k in b})


def _bytes(arr: np.ndarray) -> memoryview:
    """The bytes of a C-order array, without a copy where it is one."""
    return memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B")


def _read_rows(fpath: str, start: int, stop: int) -> np.ndarray:
    """Rows [start, stop) of the .npy array at `fpath`: one read at their
    offset (a memory map pages them in over the filesystem a page at a
    time)."""
    with open(fpath, "rb") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        if fortran:
            raise ValueError(f"{fpath}: a Fortran-order array")
        out = np.empty((stop - start,) + tuple(shape[1:]), dtype)
        row = out[0].nbytes if len(out) else 0
        f.seek(f.tell() + start * row)
        if f.readinto(_bytes(out)) != out.nbytes:
            raise ValueError(f"{fpath}: rows {start}-{stop} are cut short")
    return out


def _entry_nbytes(ent: dict) -> int:
    item = 2 if ent["dtype"] == "bfloat16" else np.dtype(ent["dtype"]).itemsize
    return item * int(np.prod(ent["shape"], dtype=np.int64))


def _clean_orphans(path: str, manifest: dict) -> None:
    """Delete leaf files the durable manifest does not reference (debris of
    a crashed save). Runs only after a successful manifest replace, so
    everything removed is unreachable; removal errors are ignored."""
    referenced = {ent["file"] for ent in manifest["leaves"].values()}
    try:
        entries = os.listdir(path)
    except OSError:
        return
    for fname in entries:
        if fname.endswith(".npy") and fname not in referenced:
            try:
                os.remove(os.path.join(path, fname))
            except OSError:
                pass


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded leaf as a CPU tensor of its manifest dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _land(value: torch.Tensor, like, into: bool):
    """`value` as `like`'s leaf: on its device and dtype (into its tensor
    with `into`), or a Python int / tuple of ints."""
    if isinstance(like, torch.Tensor):
        if into:
            like.copy_(value)
            return like
        return value.to(device=like.device, dtype=like.dtype, copy=True)
    if isinstance(like, tuple):
        return tuple(int(v) for v in value.reshape(-1).tolist())
    return int(value.item())


def _rebuild(tree: Tree, values: Dict[Path, Any], path: Path = ()) -> Tree:
    if path in values:
        return values[path]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), values,
                                     path + (("f", f),))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (("k", k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path + (("i", i),))
                          for i, v in enumerate(tree))
    return tree


def restore(path: str, like: Tree, *, put: Optional[Callable] = None,
            verify: bool = True, model=None, into: bool = False,
            mesh=None, n_nodes: Optional[int] = None, group=None,
            specs: Tree = None) -> Tree:
    """Restore into the structure of `like`. Each leaf lands on the device
    and dtype of `like`'s leaf (Python ints stay ints); with `into`, the
    tensors of `like` receive the values in place and the returned tree
    shares them. `put(key, tensor)` may transform each checkpoint leaf first
    (a CPU tensor of its manifest dtype, stacked as on disk).

    A structure mismatch between `like` and the checkpoint raises ValueError
    naming the missing and extra leaf keys. With `verify` (default), each
    loaded leaf is checked against its manifest CRC32: a torn or bit-rotted
    file raises ValueError naming the leaf.

    On a `mesh` that splits the node axis over ranks (every rank calls),
    `like` is this rank's state (`n_nodes` as in `save`): each rank reads
    its rows of the node-axis leaves and the whole of the others, and the
    ranks agree on the CRC32s over `group` (default the mesh's) before any
    leaf lands, so a failure raises on every rank and leaves `like` as it
    was. Over a model axis each rank cuts its blocks (placed by `specs`,
    as in `save`) out of what it reads."""
    manifest = load_manifest(path)
    layout, leaves = _layout(like, model)
    want, have = set(layout), set(manifest["leaves"])
    if want != have:
        missing = sorted(want - have)
        extra = sorted(have - want)
        raise ValueError(
            f"checkpoint at {path!r} does not match the restore target: "
            f"missing from checkpoint: {missing or 'none'}; "
            f"present in checkpoint but not in target: {extra or 'none'}")
    values: Dict[Path, Any] = {}
    spec_at = _placements(mesh, specs) if rdist.multi_rank(mesh) else None

    def block(p: Path, value: torch.Tensor) -> torch.Tensor:
        """The rank's block of a leaf it read whole (its node rows)."""
        if spec_at is None or not isinstance(leaves[p], torch.Tensor):
            return value
        return shlib.local_block(value, spec_at(p), mesh)

    def land(key: str, value: torch.Tensor) -> None:
        entry = layout[key]
        if put is not None:
            value = put(key, value)
        if entry.axis is None:
            p = entry.paths[0]
            values[p] = _land(block(p, value), leaves[p], into)
        else:
            for r, p in enumerate(entry.paths):
                values[p] = _land(block(p, value.select(entry.axis, r)),
                                  leaves[p], into)

    if rdist.multi_rank(mesh):
        bad = _read_split(path, layout, leaves, mesh,
                          mesh.group if group is None else group, n_nodes,
                          verify, land)
        if bad:
            raise ValueError(
                f"checkpoint leaves {bad} at {path!r} are unreadable or "
                f"failed their CRC32 check: the files are torn or corrupt")
        return _rebuild(like, values)
    for key, entry in layout.items():
        ent = manifest["leaves"][key]
        fpath = os.path.join(path, ent["file"])
        try:
            arr = np.load(fpath)
        except Exception as e:
            raise ValueError(
                f"checkpoint leaf {key!r} ({ent['file']}) at {path!r} is "
                f"unreadable: {e}") from e
        if verify and "crc32" in ent and _crc32(arr) != ent["crc32"]:
            raise ValueError(
                f"checkpoint leaf {key!r} ({ent['file']}) at {path!r} failed "
                f"its CRC32 check: the file is torn or corrupt")
        land(key, _tensor(arr, ent["dtype"]))
    return _rebuild(like, values)


def loaded_step(path: str) -> int:
    return load_manifest(path)["step"]


# ---------------------------------------------------------------------------
# Multi-checkpoint layout (used by train.snapshot)
# ---------------------------------------------------------------------------


def step_dir(root: str, step: int) -> str:
    """The step-numbered checkpoint subdirectory for a snapshot at `step`."""
    return os.path.join(root, f"step_{step:08d}")


def list_steps(root: str) -> List[int]:
    """Ascending snapshot steps present under `root` (manifest or not)."""
    try:
        entries = os.listdir(root)
    except OSError:
        return []
    steps = []
    for e in entries:
        m = _STEP_DIR_RE.match(e)
        if m and os.path.isdir(os.path.join(root, e)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def is_valid(path: str) -> bool:
    """A checkpoint directory is valid iff its manifest parses and every
    referenced leaf file passes its CRC32 check, so a SIGKILL mid-save can
    never be selected."""
    try:
        manifest = load_manifest(path)
        for ent in manifest["leaves"].values():
            arr = np.load(os.path.join(path, ent["file"]))
            if "crc32" in ent and _crc32(arr) != ent["crc32"]:
                return False
    except Exception:
        return False
    return True


def newest_valid(root: str) -> Optional[str]:
    """The newest *valid* checkpoint directory under `root`, or None. A torn
    newest checkpoint (killed mid-save: missing manifest, or corrupt leaves)
    falls back to the next-newest valid one."""
    for step in reversed(list_steps(root)):
        path = step_dir(root, step)
        if is_valid(path):
            return path
    return None


def prune(root: str, keep_last: int) -> List[str]:
    """Retention: delete all but the newest `keep_last` step directories.
    Returns the removed paths. Never removes the newest valid checkpoint
    (even if older than `keep_last` invalid ones sit above it)."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1: {keep_last}")
    steps = list_steps(root)
    if len(steps) <= keep_last:
        return []
    keep = set(steps[-keep_last:])
    newest = newest_valid(root)
    removed = []
    for step in steps:
        path = step_dir(root, step)
        if step in keep or path == newest:
            continue
        try:
            shutil.rmtree(path)
            removed.append(path)
        except OSError:
            pass
    return removed
