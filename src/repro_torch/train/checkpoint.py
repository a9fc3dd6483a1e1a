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
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tree = Any

_SEP = "::"
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
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


def _save_leaf(path: str, arr: np.ndarray, dtype: str, *, retries: int = 0,
               backoff_s: float = 0.05) -> None:
    """Write one leaf with retry-with-backoff for transient OSErrors (full
    disk being drained, an NFS blip): up to `retries` retries with
    exponential backoff, then the last error propagates. A partial file from
    a failed attempt is overwritten by the retry."""
    attempt = 0
    while True:
        try:
            _write(path, arr, dtype)
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
         retries: int = 0, backoff_s: float = 0.05, model=None) -> None:
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
    is the `ModelConfig` of an LM state (see the module docstring)."""
    os.makedirs(path, exist_ok=True)
    layout, leaves = _layout(tree, model)
    live = _live_files(path)
    manifest = {"step": step, "meta": meta or {}, "leaves": {}}
    for key, entry in layout.items():
        arr, dtype = _entry_array(entry, leaves)
        base = key.replace("/", "_") + f".{step:08d}"
        fname = base + ".npy"
        g = 0
        while fname in live:
            g += 1
            fname = f"{base}.g{g}.npy"
        _save_leaf(os.path.join(path, fname), arr, dtype, retries=retries,
                   backoff_s=backoff_s)
        manifest["leaves"][key] = {"file": fname, "dtype": dtype,
                                   "shape": list(arr.shape),
                                   "crc32": _crc32(arr)}
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, "manifest.json"))
    _clean_orphans(path, manifest)


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
            verify: bool = True, model=None, into: bool = False) -> Tree:
    """Restore into the structure of `like`. Each leaf lands on the device
    and dtype of `like`'s leaf (Python ints stay ints); with `into`, the
    tensors of `like` receive the values in place and the returned tree
    shares them. `put(key, tensor)` may transform each checkpoint leaf first
    (a CPU tensor of its manifest dtype, stacked as on disk).

    A structure mismatch between `like` and the checkpoint raises ValueError
    naming the missing and extra leaf keys. With `verify` (default), each
    loaded leaf is checked against its manifest CRC32: a torn or bit-rotted
    file raises ValueError naming the leaf."""
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
        value = _tensor(arr, ent["dtype"])
        if put is not None:
            value = put(key, value)
        if entry.axis is None:
            values[entry.paths[0]] = _land(value, leaves[entry.paths[0]],
                                           into)
        else:
            for r, p in enumerate(entry.paths):
                values[p] = _land(value.select(entry.axis, r), leaves[p], into)
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
