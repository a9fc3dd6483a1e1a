"""Sharding rules of the port: parameter placements by name, activation and
KV rules, and batch and cache placements per input shape, from
`repro.launch.sharding`.

A placement is a tuple with one entry per dim: None (replicated), an axis
name, or a tuple of axis names (the dim split over their product): the
port's form of the reference's `PartitionSpec`. The rules read only a
mesh's `.shape` (axis name -> extent) and `.axis_names`, so they plan
meshes that no process group backs (`launch/mesh.py` `abstract_mesh`).
The planner (`launch/dryrun.py`) turns the placements into the block of
each leaf that one rank holds (`local_shape`, `local_bytes`); on a mesh
over a process group `shard_tree` cuts those blocks out of whole leaves
(the trainer's state at rest, `train/trainer.py`) and `gather_tree` joins
them again on every rank (`gather_to_first`: on one rank, a leaf at a
time, as a split checkpoint writes it).

Layout: the port keeps one parameter dict per layer (`models/transformer.py`)
where the reference stacks the layers of each period position into one
leaf with a leading [n_rep] dim and pads its spec on the left. A per-layer
leaf takes the reference's placement with that leading None dropped, and
a rank holds the same bytes, with one exception: the reference's ZeRO rule
(`zero1_specs`) puts the data axes on the stack dim of a stacked leaf of 2
dims when its other dim does not divide, and a per-layer leaf has no stack
dim, so it stays replicated over the data axes here (ROADMAP.md queue 1,
deviations; `tests/test_torch_sharding.py` pins the cases).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import data_axes

Tree = Any
Placement = Tuple[Any, ...]

M = "model"

# base placements over each parameter's own (per-layer) dims
_NAME_SPECS: Dict[str, Tuple] = {
    # embeddings
    "embed": (M, None),
    "unembed": (M, None),
    "frontend_proj": (None, M),
    # attention
    "wq": (None, M), "wk": (None, M), "wv": (None, M), "wo": (M, None),
    # MLA
    "wq_a": (None, None), "wq_b": (None, M),
    "wkv_a": (None, None), "wkv_b": (None, M),
    "norm_kv": (None,),
    # dense/shared FFN
    "w_gate": (None, M), "w_up": (None, M), "w_down": (M, None),
    # MoE (expert-parallel over the model axis)
    "router": (None, None),
    "we_gate": (M, None, None), "we_up": (M, None, None),
    "we_down": (M, None, None),
    # SSD (mamba2)
    "w_in": (None, M), "conv_w": (None, M), "conv_b": (M,),
    "A_log": (None,), "D": (None,), "dt_bias": (None,),
    "norm_scale": (M,), "w_out": (M, None),
    # RG-LRU
    "w_gate_in": (None, M), "w_main_in": (None, M),
    "w_rec_gate": (None, M), "w_inp_gate": (None, M), "lam": (M,),
    # norms
    "scale": (None,), "bias": (None,),
}

# fallbacks where a base placement's dims do not divide the mesh axis
# (vocab 50280 % 16 -> the d_model dim; 60 experts % 16 -> within experts)
_ALT_SPECS: Dict[str, Tuple[Tuple, ...]] = {
    "embed": ((None, M),),
    "unembed": ((None, M),),
    "we_gate": ((None, None, M),),
    "we_up": ((None, None, M),),
    "we_down": ((None, M, None),),
}


# ---------------------------------------------------------------------------
# trees: dicts, lists, tuples and NamedTuples; a leaf is anything else
# ---------------------------------------------------------------------------


def map_with_path(fn: Callable, tree: Tree, *rest: Tree, path=()) -> Tree:
    """fn(path, leaf, *matching leaves of `rest`) over `tree` (path: the
    dict keys and list indices down to the leaf), keeping its structure."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, x, *(r[i] for r in rest),
                                          path=path + (f,))
                            for i, (f, x) in enumerate(zip(tree._fields,
                                                           tree))))
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, x, *(r[i] for r in rest),
                                        path=path + (i,))
                          for i, x in enumerate(tree))
    return fn(path, tree, *rest)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------


def _axis_size(mesh, d) -> int:
    axes = d if isinstance(d, tuple) else (d,)
    return math.prod(mesh.shape[a] for a in axes)


def _fits(dims: Tuple, shape: Tuple[int, ...], mesh) -> bool:
    return all(d is None or s % _axis_size(mesh, d) == 0
               for d, s in zip(dims, shape))


def _sanitize(dims: Tuple, shape: Tuple[int, ...], mesh) -> Placement:
    return tuple(d if (d is None or shape[i] % _axis_size(mesh, d) == 0)
                 else None for i, d in enumerate(dims))


def _resolve(name: str, shape: Tuple[int, ...], mesh, lead: Tuple) -> Placement:
    base = _NAME_SPECS.get(name, ())
    pad = len(shape) - len(base) - len(lead)
    assert pad >= 0, f"{name}: shape {shape} < spec {base}"
    for cand in (base,) + _ALT_SPECS.get(name, ()):
        dims = lead + (None,) * pad + tuple(cand)
        if _fits(dims, shape, mesh):
            return dims
    return _sanitize(lead + (None,) * pad + tuple(base), shape, mesh)


def param_specs(params: Tree, mesh=None, *,
                node_axes: Optional[Tuple[str, ...]] = None) -> Tree:
    """Placements of a parameter tree. With `node_axes`, every leaf carries
    a leading decentralized-node dim split over those mesh axes. A leaf
    without a shape (an optimizer's step) gets ()."""
    def spec(path, leaf):
        if not hasattr(leaf, "shape"):
            return ()
        name = _leaf_name(path)
        lead = (node_axes,) if node_axes else ()
        shape = tuple(leaf.shape)
        if mesh is not None:
            return _resolve(name, shape, mesh, lead)
        base = _NAME_SPECS.get(name, ())
        pad = len(shape) - len(base) - len(lead)
        assert pad >= 0, f"{name}: ndim {len(shape)} < spec {base}"
        return lead + (None,) * pad + tuple(base)

    return map_with_path(spec, params)


def stacked_layers(cfg, window_override: int = 0) -> int:
    """How many leading entries of a decoder-only tree's "blocks" list the
    reference stacks into its period leaves (the rest is its unstacked
    tail)."""
    from repro_torch.models.transformer import build_plan
    period, n_rep, _ = build_plan(cfg, window_override)
    return len(period) * n_rep


def _stacked(path, n_stacked: Optional[int]) -> bool:
    """Whether the reference holds this per-layer leaf in a stacked leaf:
    a layer of the "encoder" or "decoder" list, or of the first
    `n_stacked` (None: all) of "blocks"."""
    for j, key in enumerate(path[:-1]):
        if key in ("encoder", "decoder") and isinstance(path[j + 1], int):
            return True
        if key == "blocks" and isinstance(path[j + 1], int):
            return n_stacked is None or path[j + 1] < n_stacked
    return False


def zero1_specs(params: Tree, mesh, *,
                node_axes: Optional[Tuple[str, ...]] = None,
                n_stacked: Optional[int] = None) -> Tree:
    """ZeRO-1 placements for optimizer moments: the parameter's placement
    plus the data axes on the first still-replicated dim that they divide,
    in the reference's order: dims 1.. first, then dim 0 for a leaf of
    fewer than 3 dims; a layer's leaf that the reference stacks takes the
    stacked leaf's order over its own dims, and the stack dim it may fall
    back to has no counterpart (`n_stacked`: as in `_stacked`; pass
    `stacked_layers(cfg)` where a config has an unstacked tail)."""
    dp = data_axes(mesh)
    ndp = math.prod(mesh.shape[a] for a in dp)
    base = param_specs(params, mesh, node_axes=node_axes)

    def add_dp(path, leaf, spec):
        if node_axes or not hasattr(leaf, "shape"):
            return spec  # the node axis already takes the data axes
        shape = tuple(leaf.shape)
        dims = list(spec) + [None] * (len(shape) - len(spec))
        if _stacked(path, n_stacked):
            order = list(range(len(shape)))
        else:
            order = (list(range(1, len(shape)))
                     + ([0] if len(shape) < 3 else []))
        for i in order:
            if dims[i] is None and shape[i] % ndp == 0 and shape[i] > 0:
                dims[i] = dp
                return tuple(dims)
        return spec

    return map_with_path(add_dp, params, base)


def train_state_specs(state, mesh, *, node_axes: Optional[Tuple[str, ...]] = None,
                      n_stacked: Optional[int] = None):
    """The reference's train-state placements (`repro.train.trainer.
    _state_specs`) of a `train.trainer.TrainState` of whole leaves: FSDP
    parameters and ZeRO-1 moments and masters in the exact mode; the node
    axis over `node_axes` in the decentralized mode."""
    z = lambda tree: (zero1_specs(tree, mesh, node_axes=node_axes,
                                  n_stacked=n_stacked)
                      if tree != () else ())
    opt = state.opt
    step = tuple(() for _ in opt.step) if isinstance(opt.step, tuple) else ()
    return type(state)(z(state.params), opt._replace(
        step=step, m=z(opt.m), v=z(opt.v), master=z(opt.master),
        ef_residual=z(opt.ef_residual)))


def activation_rules(mesh, shape: ShapeConfig,
                     node_axis: bool = False) -> Dict[str, Placement]:
    """The reference's logical activation rules (its `pshard` names). The
    port executes none of them yet: the planner reads them."""
    dp = data_axes(mesh)
    if node_axis:
        return {}
    if shape.mode == "decode" and shape.global_batch < mesh.shape["data"]:
        # long-context decode: the batch is too small to split; heads and
        # features over the model axis (the cache is split by sequence)
        return {
            "act_dmodel": (None, None, None),
            "act_resid": (None, None, None),
            "act_ff": (None, None, M),
            "act_heads": (None, None, M, None),
            "act_scores": (None, M, None, None),
            "act_vocab": (None, None, M),
            "emb_vocab": (M, None),
            "emb_replicated": (None, None),
            "moe_expert": (M, None, None, None),
            "act_ssm_l": (None, None, M, None, None),
            "act_ssm_y": (None, None, None, M, None),
            "act_ssm_state": (None, None, M, None, None),
        }
    return {
        "act_dmodel": (dp, None, None),
        "act_resid": (dp, None, M),
        "act_ff": (dp, None, M),
        "act_heads": (dp, None, M, None),
        "act_scores": (dp, M, None, None),
        "act_vocab": (dp, None, M),
        "emb_vocab": (M, None),
        "emb_replicated": (None, None),
        "moe_expert": (M, dp, None, None),
        "act_ssm_l": (dp, None, M, None, None),
        "act_ssm_y": (dp, None, None, M, None),
        "act_ssm_state": (dp, None, M, None, None),
    }


def kv_rules(mesh, shape: ShapeConfig, kv_heads: int) -> Dict[str, Placement]:
    """Rules for fresh K/V ("act_kv") and the updated cache
    ("act_cache_kv"), matched to `cache_specs`' layout."""
    dp = data_axes(mesh)
    msize = mesh.shape[M]
    seq_parallel = shape.global_batch < mesh.shape["data"]
    heads_ok = kv_heads > 0 and kv_heads % msize == 0
    if seq_parallel:
        cache = (None, dp, M, None) if heads_ok else (None, dp, None, M)
        fresh = (None, None, M, None) if heads_ok else (None, None, None, M)
    elif heads_ok:
        cache = fresh = (dp, None, M, None)
    else:
        cache = fresh = (dp, M, None, None)
    return {"act_cache_kv": cache, "act_kv": fresh}


def batch_specs(batch_shapes: Tree, mesh, shape: ShapeConfig,
                node_axis: bool = False) -> Tree:
    """The leading (batch, or node) dim over the data axes, unless the
    global batch is smaller than the data extent."""
    dp = data_axes(mesh)
    small = shape.global_batch < mesh.shape["data"]

    def spec(path, leaf):
        n = _ndim(leaf)
        if small or n == 0:
            return (None,) * n
        return (dp,) + (None,) * (n - 1)

    return map_with_path(spec, batch_shapes)


def cache_specs(cache: Tree, mesh, shape: ShapeConfig) -> Tree:
    """KV and recurrent-state placements: decode_32k splits the cache batch
    over the data axes and KV heads (or latents) over the model axis;
    long_500k (batch 1) splits the sequence over the data axes. The port's
    cache is per layer, so no leaf has the reference's stack dim."""
    dp = data_axes(mesh)
    seq_parallel = shape.global_batch < mesh.shape["data"]

    def spec(path, leaf):
        name = _leaf_name(path)
        n = _ndim(leaf)
        nb = (None,) if seq_parallel else (dp,)
        seq = (dp,) if seq_parallel else (None,)
        if name in ("k", "v"):  # [B, S, KH, hd]
            body = nb + seq + (M, None)
            if not _fits(body, tuple(leaf.shape), mesh):  # KH < model
                body = nb + (M, None, None) if not seq_parallel else \
                    nb + (dp, None, M)
        elif name == "ckv":  # [B, S, rank]
            body = nb + seq + (M,)
        elif name == "krope":  # [B, S, 1, rope]
            body = nb + seq + (None, None)
        elif name == "h":  # ssd [B, H, P, N] / rglru [B, w]
            body = nb + (M,) + (None,) * (n - 2)
        elif name == "conv":  # [B, W-1, convdim]
            body = nb + (None, M)
        elif name == "memory":  # enc-dec memory [B, S_enc, D]
            body = nb + (None, None)
        else:
            body = (None,) * n
        assert len(body) == n, f"{name}: {n} vs {body}"
        return _sanitize(body, tuple(leaf.shape), mesh)

    return map_with_path(spec, cache)


# ---------------------------------------------------------------------------
# what one rank holds
# ---------------------------------------------------------------------------


def local_shape(shape, spec: Placement, mesh) -> Tuple[int, ...]:
    """The block of a `shape` leaf placed by `spec` that one rank holds
    (each split dim divided by its axes' extent, rounded up)."""
    dims = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(s if d is None else -(-s // _axis_size(mesh, d))
                 for s, d in zip(shape, dims))


def local_bytes(tree: Tree, specs: Tree, mesh) -> int:
    """The bytes of `tree`'s tensors that one rank holds under `specs`."""
    total = [0]

    def add(path, leaf, spec):
        if hasattr(leaf, "shape") and hasattr(leaf, "element_size"):
            total[0] += math.prod(local_shape(tuple(leaf.shape), spec,
                                              mesh)) * leaf.element_size()
        return None

    map_with_path(add, tree, specs)
    return total[0]


def leaf_specs(tree: Tree, specs: Tree) -> list:
    """The placements of `tree`'s tensors, in packing order
    (`core.packing.tree_leaves`: dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, sp in zip(tree, specs) for x in leaf_specs(t, sp)]
    return [specs]


def _axis_index(mesh, d) -> int:
    """This rank's index along the axes of placement entry `d`
    (row-major over them, as the mesh's ranks are)."""
    coords, r = {}, mesh.rank
    for a, size in reversed(tuple(zip(mesh.axis_names, mesh.sizes))):
        coords[a] = r % size
        r //= size
    idx = 0
    for a in (d if isinstance(d, tuple) else (d,)):
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def local_block(leaf, spec: Placement, mesh):
    """This rank's block of a whole `leaf` placed by `spec` (a view): each
    split dim's slice at the rank's index along its axes."""
    for dim, d in enumerate(spec):
        if d is None:
            continue
        n = _axis_size(mesh, d)
        if leaf.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not "
                             f"split over {d} ({n} ranks)")
        size = leaf.shape[dim] // n
        leaf = leaf.narrow(dim, _axis_index(mesh, d) * size, size)
    return leaf


def shard_tree(tree: Tree, specs: Tree, mesh) -> Tree:
    """This rank's blocks of a tree of whole leaves (`local_block`), each a
    copy of its own, so the whole tree can be freed."""
    return map_with_path(
        lambda path, leaf, spec: (local_block(leaf, spec, mesh).clone()
                                  if hasattr(leaf, "shape") else leaf),
        tree, specs)


def gather_tree(tree: Tree, specs: Tree, mesh) -> Tree:
    """The inverse of `shard_tree` on every rank: each split dim's blocks
    all-gathered over its axis (the model group for the model axis, the
    data group for the data axes)."""
    from repro_torch.dist import all_gather_dim

    def gather(path, leaf, spec):
        if not hasattr(leaf, "shape"):
            return leaf
        for dim, d in enumerate(spec):
            if d is not None:
                leaf = all_gather_dim(leaf, mesh, dim,
                                      "model" if d == M else "data")
        return leaf

    return map_with_path(gather, tree, specs)


def gather_to_first(leaf, spec: Placement, mesh):
    """The whole leaf of this rank's block `leaf` placed by `spec`, joined
    on the first rank of each group it is split over (index 0 along every
    axis of `spec`) and None on the others: each split dim's blocks
    gathered to its axis's first rank (`dist.gather_dim_to_first`), one
    dim after another, by the ranks that still hold a part. A leaf that
    `spec` does not split comes back as it is, on every rank."""
    from repro_torch.dist import gather_dim_to_first

    for dim, d in enumerate(spec):
        if d is not None and leaf is not None:
            leaf = gather_dim_to_first(leaf, mesh, dim,
                                       "model" if d == M else "data")
    return leaf
