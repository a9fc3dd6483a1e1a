"""Gradient-averaging operators — the paper's technique as a first-class
feature.

The N compute nodes are a leading *node axis* on the gradient tree (nested
dicts, lists and tuples of tensors, `core.packing`), so averaging modes are
plain tensor programs:

* exact        -- mean over the node axis (DMB, Section IV)
* gossip       -- R rounds of circulant consensus (Section V, eq. 17), executed
                  through `core.mixing.CirculantMixOp`: with quantization off
                  the R-round operator is precomputed once and applied in a
                  single pass (weighted `torch.roll`s / one circulant matmul /
                  the CUDA kernel on the card)
* hierarchical -- exact within pod, gossip across pods in reduce-scatter form
                  (each intra-pod lane gossips one chunk of the pod mean, then
                  the pod all-gathers)

With `AveragingConfig.packed` (the default) the gossip and hierarchical modes
flatten the tree into one contiguous [N, D] buffer per dtype
(`core.packing`), so the mixing operator — and the consensus-error
diagnostic — runs ONCE per step instead of once per leaf.

Optional message quantization (Section VI) compresses each round's messages;
quantized configs keep the per-round loop (the compressor is nonlinear).
`AveragingConfig.quant_stats` picks the statistic granularity: "global" pins
the exact per-leaf oracle semantics (never packed), "segment" reproduces
per-leaf scales on the packed buffer in one pass, "tile" takes the
`gossip_mix_quant` kernel.

Error feedback (`ef_average_and_error`) instead compresses ONCE per step
outside the operator and mixes the compressed buffer linearly (the
`gossip_mix` kernel on the card), carrying the compression error as a
residual. A time-varying `core.mixing.ScheduledMixOp` (scenario harness)
takes the round counter `t` wherever a static op takes its key
(`_mix_call`).

Over a mesh that splits the node axis across ranks (`repro_torch/dist.py`),
each rank holds its rows [n_local, ...] of every leaf: the gossip op
(built with the mesh) mixes them with the shard rules, and the exact
average, the consensus error and the node means reduce across ranks with
all-reduces over the data group (`repro_torch/dist.py`). An elastic run's
cohort is such a split too (`dist.cohort_rows`): `n_nodes` is then the
cohort's size m, the reductions run over the active rows of every rank and
divide by m, and a rank with no active row adds nothing. Over a model
axis each rank holds its model shard's block of every leaf: the mixing is
linear per column, so each model index mixes its own columns over the node
axis (unpacked, as the reference's "auto" is there), and the consensus
error sums each leaf's squares over the model group, a leaf replicated
over the model axis counted once. Error feedback runs there on each rank's
rows (`ef_average_and_error`), and the hierarchical mode puts its pods on
the mesh's "pod" axis: the pod mean reduce-scattered over a pod's ranks,
each lane's block gossiped between the pods, the pod all-gathering the
result (`_hmix_shard`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
from torch.distributed import ReduceOp

from repro_torch import dist as rdist
from repro_torch.configs.base import AveragingConfig
from repro_torch.core import packing
from repro_torch.core.mixing import (CirculantMixOp, ScheduledMixOp,
                                     circulant_mix_op, schedule)
from repro_torch.core.quantize import (STOCHASTIC, Slots, block_maps,
                                       complete_slots, fold_in,
                                       slot_compress, slot_partials,
                                       slot_scales, tile_compress)
from repro_torch.device import DeviceLike
from repro_torch.dist import is_sharded, model_extent

Tree = Any
# the consensus engine: a static CirculantMixOp or a time-varying
# ScheduledMixOp (scenario harness), both called through `_mix_call`
MixOp = Any
# groups of leaf indices (in the tree's order) that the consensus error
# treats as one leaf each (`packed_consensus_error`); the packed buffers
# take the leaves in the pools' order (`pack`)
Pools = Tuple[Tuple[int, ...], ...]
# per leaf (in the tree's order): the whole leaf's shape without the node
# axis, and the dim a model axis splits (None: kept whole over it), as
# `train.trainer` reads them from the reference's placements; None: every
# leaf whole, of its own shape
Layout = Optional[Tuple[Tuple[Tuple[int, ...], Optional[int]], ...]]


def pack(tree: Tree, pools: Optional[Pools]):
    """`packing.pack_tree` of `tree`, its leaves in the pools' order where
    pools are given (the reference's leaf order, `train.trainer.layer_pools`:
    the quantized wire's tiles then hold the reference's entries)."""
    order = None if pools is None else [i for pool in pools for i in pool]
    return packing.pack_tree(tree, order=order)


def make_gossip_mix(cfg: AveragingConfig, n_nodes: int, *,
                    impl: str = "auto", device: DeviceLike = None,
                    mesh: Any = None, rows=None) -> CirculantMixOp:
    """Build the consensus engine for a config — once, outside the step loop.
    For `mode="hierarchical"` pass the pod count as `n_nodes`.

    `impl="auto"` resolves per device (`core.mixing.resolve_auto_impl`): the
    CUDA kernel on the card, the dense circulant matmul on the CPU. The
    quantization, its statistics and tile width come from `cfg`; with error
    feedback on, the per-round compressor is dropped (`ef_average_and_error`
    compresses once per step outside the operator, and the rounds are exact
    and linear). Pass the `mesh` the op runs under: on a sharded node axis
    it takes each rank's rows, and "auto" picks the shard rule; `rows` is
    the split of an elastic run's cohort (`dist.cohort_rows`, n_nodes the
    cohort's size)."""
    sched = schedule(cfg.topology, n_nodes, cfg.self_weight)
    quantization = "none" if cfg.error_feedback != "off" else cfg.quantization
    return circulant_mix_op(sched, n_nodes, cfg.rounds,
                            quantization=quantization, impl=impl,
                            stats=cfg.quant_stats, block_d=cfg.quant_block_d,
                            device=device, mesh=mesh, rows=rows)


def resolve_packed(cfg: AveragingConfig, mesh: Any = None) -> bool:
    """Resolve the tri-state `AveragingConfig.packed`. "auto" packs
    everywhere except meshes that split leaves over a model axis, as the
    reference's does."""
    if cfg.packed == "auto":
        return model_extent(mesh) == 1
    return bool(cfg.packed)


def _packable(mix: MixOp) -> bool:
    """Quantized global-stats configs pin per-leaf statistics (the oracle),
    so they keep the per-leaf dispatch; everything else packs."""
    return not (mix.quantization != "none" and mix.stats == "global")


def _mix_call(mix: MixOp, x: torch.Tensor, *, key: Optional[int] = None,
              t=None, **kw) -> torch.Tensor:
    """Uniform call: a scheduled (time-varying) op takes the round counter
    `t` to pick its phase; a static op takes the compressor key."""
    if isinstance(mix, ScheduledMixOp):
        return mix(x, t=t, **kw)
    return mix(x, key=key, **kw)


def _segments(spec: packing.PackSpec, g: int,
              pools: Optional[Pools]) -> Tuple[int, ...]:
    """Per leaf of group g (in its order): its reference leaf's index
    within the group, the pool it belongs to (each leaf its own without
    pools). The packed buffer holds a pool's leaves side by side, so the
    reference's leaf segments are the pools' runs."""
    pool_of = ({i: p for p, pool in enumerate(pools) for i in pool}
               if pools is not None else {})
    seg, last = [], None
    for i in spec.groups[g]:
        p = pool_of.get(i, ("leaf", i))
        if p != last:
            seg.append(len(seg) and seg[-1] + 1)
        else:
            seg.append(seg[-1])
        last = p
    return tuple(seg)


def _apply_mix(mix: MixOp, spec: packing.PackSpec, g: int,
               buf: torch.Tensor, key: Optional[int] = None,
               t=None, pools: Optional[Pools] = None) -> torch.Tensor:
    if mix.quantization != "none" and mix.stats == "segment":
        # one width per reference leaf: a pool's leaves make one segment
        seg = _segments(spec, g, pools)
        widths = [0] * (seg[-1] + 1 if seg else 0)
        for s, i in zip(seg, spec.groups[g]):
            widths[s] += spec.leaf_width(i)
        return _mix_call(mix, buf, key=key, t=t, seg_widths=tuple(widths))
    return _mix_call(mix, buf, key=key, t=t)


def quant_slot_mix(xs, idxs, mix: MixOp, *, layout: Layout = None,
                   mesh: Any = None, key: Optional[int] = None,
                   seg: Optional[Tuple[int, ...]] = None,
                   width: Optional[int] = None,
                   valid: Optional[int] = None):
    """The per-round quantized wire of `mix` on tensors that hold, side by
    side, the entries of one reference leaf or packed buffer: xs[j]
    ([rows, entries]: this rank's rows and model block of leaf idxs[j],
    whose shape and split `layout` gives) in the reference's order. Each
    round takes the statistics of the round's iterate at the reference's
    positions (`core.quantize.Slots`: the slots a rank's blocks share over
    its model group completed by one f32 all-reduce) and mixes as the
    reference's per-round chain does. `seg` gives each leaf its slot for
    per-leaf statistics ("global": all 0; "segment": its reference leaf);
    `width` and `valid` the reference row's entries and its valid ones
    (default: the leaves' sum, all valid; the hierarchical mode pads its
    pod means).

    Routes: a leaf whose local tiles are the reference's slots
    (`Slots.aligned`, "tile" or "node") runs the plain tile wire on its
    own, the `gossip_mix_quant` kernel on the card for sign and int8
    "tile"; the rest of "tile" sign and int8 runs round by round through
    `kernels.ops.quant_slot_stats` and `quant_slot_round` (the card's two
    entry points of that kernel's file); "node", int8_stoch, "global" and
    "segment" take the plain chain on every device, as the reference
    fuses none of them. A node axis split over ranks is gathered first
    (over the data group, as the split axis's quantized wires gather it)
    and the rank keeps its rows. int8_stoch draws leaf by leaf, a split
    leaf's key folding in the model index: deterministic, and the
    reference's only in distribution."""
    from repro_torch import dist as rdist
    from repro_torch.kernels import ops

    if mix.rounds == 0 or mix.n == 1:
        return list(xs)
    node_mesh, node_rows, n = mix.mesh, mix.rows, mix.n
    gathered = node_mesh is not None
    if gathered:
        xs = [rdist.all_gather_rows(x, node_mesh, n, node_rows).reshape(
            n, -1) for x in xs]
    M = rdist.model_extent(mesh)
    m = rdist.model_index(mesh)
    maps = block_maps([layout[i] for i in idxs] if layout is not None
                      else [(tuple(x.shape[1:]), None) for x in xs], M, m)
    total = sum(bm.span for bm in maps)
    width = total if width is None else width
    valid = total if valid is None else valid
    per_leaf = mix.stats in ("global", "segment")
    bd = min(mix.block_d, width) if not per_leaf else 0
    slots = Slots(maps, bd, width, valid,
                  seg=(seg or (0,) * len(maps)) if per_leaf else None,
                  index=m)
    name, per_node = mix.quantization, mix.stats == "node"
    key0 = mix._key0(key)
    rows = xs[0].shape[0] if xs else 0

    def leaf_key(k, j):
        k = fold_in(k, j)
        return k if maps[j].whole else fold_in(k, 1 + m)

    outs: list = [None] * len(xs)
    rest = []
    for j, x in enumerate(xs):
        if slots.aligned[j] and not per_leaf:
            outs[j] = ops.quant_gossip_mix(
                x.contiguous(), mix.sched, mix.rounds, name, block_d=bd,
                key=None if key0 is None else leaf_key(key0, j),
                per_node=per_node)
        else:
            rest.append(j)
    if rest:
        fused = not per_node and name in ("sign", "int8") and not per_leaf
        stat = "sum" if name == "sign" else "max"
        h = {j: xs[j].to(torch.float32, memory_format=torch.contiguous_format,
                         copy=True) for j in rest}
        for r in range(mix.rounds):
            if fused:
                partial = torch.zeros((1, slots.n_slots), dtype=torch.float64,
                                      device=xs[rest[0]].device)
                for j in rest:
                    ops.quant_slot_stats(h[j], slots, j, partial, name)
            else:
                partial = slot_partials([h.get(j) for j in range(len(xs))],
                                        slots, stat, per_node=per_node)
            scale = slot_scales(complete_slots(partial, slots, stat, mesh),
                                slots, name, 1 if per_node else rows)
            kr = fold_in(key0, r) if key0 is not None else None
            for j in rest:
                if fused:
                    h[j] = ops.quant_slot_round(h[j], slots, j, scale,
                                                mix.sched, name)
                    continue
                q = slot_compress(h[j], slots, j, scale, name,
                                  key=None if kr is None else leaf_key(kr, j))
                out = None
                for shift, w in mix.sched:
                    term = w * (h[j] if shift == 0
                                else torch.roll(q, shift, 0))
                    out = term if out is None else out + term
                h[j] = out
        for j in rest:
            outs[j] = h[j].to(xs[j].dtype)
    if gathered:
        from repro_torch.core.mixing import _own_rows
        a, b = _own_rows(node_mesh, n, node_rows)
        outs = [o[a:b] for o in outs]
    return outs


def _straddles(xs, mix: MixOp) -> bool:
    """Whether a statistic slot of the reference's leaf that the layers xs
    ([rows, entries] each, one process) join into spans two of them: the
    leaf's statistic for "global" and "segment", a tile that a layer's
    size does not end ("tile", "node")."""
    if len(xs) < 2:
        return False
    if mix.stats in ("global", "segment"):
        return True
    width = sum(x.shape[-1] for x in xs)
    maps = block_maps([(tuple(x.shape[1:]), None) for x in xs])
    return not all(Slots(maps, min(mix.block_d, width), width,
                         width).aligned)


def _leaf_views(buf: torch.Tensor, spec: packing.PackSpec, g: int):
    """The [rows, entries] column views of group g's leaves in `buf`."""
    out, off = [], 0
    for i in spec.groups[g]:
        w = spec.leaf_width(i)
        out.append(buf[..., off:off + w])
        off += w
    return out


def _pool_groups(leaves, pools: Optional[Pools]):
    """The leaf indices of each reference leaf: the pools (every leaf its
    own without them)."""
    return pools if pools is not None else tuple((i,) for i in
                                                 range(len(leaves)))


def _model_axis(mesh: Any) -> bool:
    return mesh is not None and model_extent(mesh) > 1


def _pooled(tree: Tree, pools: Optional[Pools], fn) -> Tree:
    """`fn` on each reference leaf of `tree`: a pool's leaves [N, ...]
    joined row by row in stack order ([N, sum of their entries], the
    reference's stacked leaf), then split back."""
    leaves = packing.tree_leaves(tree)
    out = list(leaves)
    for pool in _pool_groups(leaves, pools):
        parts = [leaves[i].reshape(leaves[i].shape[0], -1) for i in pool]
        joined = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
        mixed = fn(joined, pool)
        off = 0
        for i, p in zip(pool, parts):
            out[i] = mixed[:, off:off + p.shape[1]].reshape(leaves[i].shape)
            off += p.shape[1]
    it = iter(out)
    return packing.tree_map(lambda _: next(it), tree)


def gossip_average(tree: Tree, n_nodes: int, cfg: AveragingConfig,
                   mix: Optional[MixOp] = None, *,
                   key: Optional[int] = None, t=None,
                   device: DeviceLike = None, pools: Optional[Pools] = None,
                   layout: Layout = None, mesh: Any = None) -> Tree:
    """R rounds of doubly-stochastic consensus over the leading node axis —
    one packed pass per dtype group by default, per-leaf when `cfg.packed`
    is off or the quantized global-stats oracle is selected. `key`
    (optional) is the per-step integer stochastic compressors fold into the
    op's seed — see `CirculantMixOp._quantized`; `t` (optional) is the round
    counter a `ScheduledMixOp` picks its phase by.

    A quantized wire takes its statistics over the reference's leaves:
    with `pools` each pool's leaves are one leaf (the reference's stacked
    layers), and over `mesh`'s model axis (its blocks placed as `layout`
    says) a rank's blocks are placed in whole leaves (`quant_slot_mix`)."""
    if mix is None:
        mix = make_gossip_mix(cfg, n_nodes, device=device)
    quantized = mix.quantization != "none"
    if not (cfg.packed and _packable(mix)):
        if quantized and (pools is not None or _model_axis(mesh)):
            leaves = packing.tree_leaves(tree)
            out = list(leaves)
            for pool in _pool_groups(leaves, pools):
                xs = [leaves[i].reshape(leaves[i].shape[0], -1)
                      for i in pool]
                if _model_axis(mesh) or _straddles(xs, mix):
                    mixed = quant_slot_mix(xs, pool, mix, layout=layout,
                                           mesh=mesh, key=key)
                else:  # each leaf's slots its own (the shard rules too)
                    mixed = [_mix_call(mix, x, key=key, t=t) for x in xs]
                for i, x in zip(pool, mixed):
                    out[i] = x.reshape(leaves[i].shape)
            it = iter(out)
            return packing.tree_map(lambda _: next(it), tree)
        return packing.tree_map(lambda g: _mix_call(mix, g, key=key, t=t),
                                tree)
    bufs, spec = packing.pack_tree(tree)
    outs = tuple(_apply_mix(mix, spec, g, b, key, t)
                 for g, b in enumerate(bufs))
    return packing.unpack_tree(outs, spec)


def _node_sum(g: torch.Tensor, mesh: Any) -> torch.Tensor:
    """The f32 sum over every node's row of g (this rank's rows [n_local,
    ...]), all-reduced over the mesh's data group: [1, ...]."""
    total = g.float().sum(0, keepdim=True)
    return rdist.all_reduce_(total, mesh)


def exact_average(tree: Tree, mesh: Any = None,
                  n_nodes: Optional[int] = None) -> Tree:
    """The mean over the node axis, broadcast back to it. On a sharded
    `mesh` each rank holds its rows of the `n_nodes`-node axis and the mean
    is an all-reduce (in f32, cast to the leaf's dtype)."""
    if not is_sharded(mesh):
        return packing.tree_map(
            lambda g: torch.mean(g, dim=0, keepdim=True).expand(g.shape),
            tree)
    return packing.tree_map(
        lambda g: (_node_sum(g, mesh) / n_nodes).to(g.dtype).expand(g.shape),
        tree)


def pod_mix_mesh(mesh: Any) -> Any:
    """The mesh the hierarchical mode's gossip between pods runs on: this
    rank's lane of a node axis split over ranks (`dist.lane_mesh`), None
    on one process."""
    return rdist.lane_mesh(mesh) if is_sharded(mesh) else None


def _hmix_buffer(g: torch.Tensor, pods: int, per_pod: int,
                 mix: MixOp, key: Optional[int] = None, t=None,
                 mesh: Any = None, cols=None) -> torch.Tensor:
    """Reduce-scatter hierarchical consensus on one [N, ...] buffer/leaf
    (on a sharded `mesh`, this rank's rows of it: `_hmix_shard`). The pod
    mean is the f32 sum of the pod's rows, added in node order
    (`dist.row_sum`, which any split of the rows reproduces bit for bit),
    over per_pod, in the buffer's dtype."""
    if is_sharded(mesh):
        return _hmix_shard(g, pods, per_pod, mix, key, t, mesh, cols)
    shp = g.shape
    flat = g.reshape(pods, per_pod, -1)  # [P, M, F]
    pod_mean = rdist.row_sum(flat.transpose(0, 1)).div_(per_pod).to(
        g.dtype)  # reduce ...
    f = pod_mean.shape[-1]
    chunk = -(-f // per_pod)
    pad = chunk * per_pod - f
    if pad:
        pod_mean = torch.nn.functional.pad(pod_mean, (0, pad))
    scattered = pod_mean.reshape(pods, per_pod, chunk)  # ... scatter
    # cross-pod gossip, one chunk per lane; pad columns sit at the tail of
    # the flattened layout and are masked out of compressor statistics
    mixed = _mix_call(mix, scattered, valid_d=f if pad else None, key=key,
                      t=t)
    gathered = mixed.reshape(pods, 1, chunk * per_pod)[..., :f]  # all-gather
    return gathered.expand(pods, per_pod, f).reshape(shp)


def _hmix_shard(g: torch.Tensor, pods: int, per_pod: int, mix: MixOp,
                key: Optional[int], t, mesh: Any, cols=None) -> torch.Tensor:
    """`_hmix_buffer` on this rank's k rows [k, ...] of a node axis split
    over a mesh whose "pod" axis holds the pods: pod p's per_pod nodes are
    the rows of its D lanes (node shards p * D .. p * D + D - 1), k a lane.

    The pod mean is reduce-scattered over the pod's ranks: lane j holds
    columns [j * k * chunk, (j + 1) * k * chunk) of the zero-padded pod
    mean, the reference's chunks j * k .. j * k + k - 1, summed from the
    pod's rows in node order (`dist.reduce_scatter_rows`, the rows in the
    buffer's dtype on the wire), as one process sums them. Each lane gossips
    its block between the pods over its lane group (`mix`, built on
    `pod_mix_mesh`: the shard rule, or a gather of the lane's P rows),
    masked by its share of `valid_d`, and the pod all-gathers the mixed
    blocks. A quantized wire whose statistic tiles do not lie inside the
    lanes' blocks (a block width that is not a multiple of the tile, the
    global and segment statistics, or a stochastic compressor, whose draws
    span the whole buffer) gathers every lane's block instead: each rank
    then holds the scattered pod means of every pod and mixes them as one
    process does.

    Over a model axis g holds the rank's model blocks of the leaves that
    `cols` names ((leaf indices, layout, model mesh): the columns of one
    reference leaf, or of a packed buffer, in order); the gossip between
    pods is linear per column, and a quantized wire gathers every lane's
    block and takes the pod means' statistics at their positions in the
    reference's padded pod-mean row (`quant_slot_mix`)."""
    k = g.shape[0]
    lanes = rdist.axis_extent(mesh, "pod")
    if rdist.n_pods(mesh) != pods or per_pod != lanes * k:
        raise ValueError(
            f"the hierarchical mode on a split node axis puts its {pods} "
            f"pods on the mesh's \"pod\" axis (extent "
            f"{rdist.n_pods(mesh)}) and each pod's {per_pod} nodes on its "
            f"{lanes} lanes, {k} a rank: they do not match")
    shp = g.shape
    flat = g.reshape(k, -1)
    f = flat.shape[1]
    chunk = -(-f // per_pod)
    width = k * chunk  # this lane's block of the padded pod mean
    if chunk * per_pod > f:
        flat = torch.nn.functional.pad(flat, (0, chunk * per_pod - f))
    block = rdist.reduce_scatter_rows(flat, mesh, axis="pod")
    block = block.div_(per_pod).to(g.dtype)  # ... scatter
    quantized = mix.quantization != "none"
    d = chunk * per_pod
    if quantized and cols is not None:
        full = rdist.all_gather_rows(block[None], mesh,
                                     rdist.n_data_nodes(mesh))
        means = full.reshape(pods, d)[:, :f]
        idxs, layout, model_mesh = cols
        maps = block_maps([layout[i] for i in idxs],
                          model_extent(model_mesh),
                          rdist.model_index(model_mesh))
        views, off = [], 0
        for bm in maps:
            views.append(means[:, off:off + bm.size])
            off += bm.size
        F = sum(bm.span for bm in maps)
        whole = dataclasses.replace(mix, mesh=None, rows=None)
        outs = quant_slot_mix(views, idxs, whole, layout=layout,
                              mesh=model_mesh, key=key,
                              seg=(0,) * len(idxs),
                              width=-(-F // per_pod) * per_pod, valid=F)
        mean = torch.cat(outs, 1)[rdist.pod_index(mesh)]
        return mean.expand(k, f).reshape(shp)
    if quantized and not (mix.stats in ("tile", "node")
                          and mix.quantization not in STOCHASTIC
                          and width % min(mix.block_d, d) == 0):
        full = rdist.all_gather_rows(block[None], mesh,
                                     rdist.n_data_nodes(mesh))
        whole = dataclasses.replace(mix, mesh=None, rows=None)
        mixed = _mix_call(whole, full.reshape(pods, per_pod, chunk),
                          valid_d=f if d > f else None, key=key, t=t)
        mean = mixed[rdist.pod_index(mesh)].reshape(-1)[:f]
    else:
        lo = (rdist.node_index(mesh) % lanes) * width
        valid = min(max(f - lo, 0), width)
        mixed = _mix_call(mix, block[None],
                          valid_d=valid if valid < width else None,
                          key=key, t=t)  # cross-pod gossip of the block
        mean = rdist.all_gather_dim(mixed[0], mesh, 0, axis="pod")[:f]
    return mean.expand(k, f).reshape(shp)


def hierarchical_average(tree: Tree, pods: int, per_pod: int,
                         cfg: AveragingConfig,
                         mix: Optional[MixOp] = None, *,
                         key: Optional[int] = None, t=None,
                         device: DeviceLike = None,
                         mesh: Any = None, pools: Optional[Pools] = None,
                         layout: Layout = None) -> Tree:
    """Exact averaging within each pod, gossip across pods — in
    reduce-scatter form: lane j of each pod owns chunk j of the pod mean,
    the cross-pod gossip mixes only that chunk, and an intra-pod all-gather
    reassembles the mixed mean. Feature dims are zero-padded up to a
    multiple of per_pod; the pad columns are masked out of quantized
    compressor statistics (`valid_d`, which reaches the `gossip_mix_quant`
    kernel on the card). Quantized segment statistics do not survive the
    chunk-scatter relayout; they degrade to global (masked) statistics
    over the scattered pod means here. On a sharded `mesh` the leaves are
    this rank's rows and the pods lie on its "pod" axis (`_hmix_shard`).
    A quantized wire takes its statistics over the reference's leaves: a
    pool's leaves (`pools`) are joined into one, and over a model axis the
    rank's blocks are placed as `layout` says."""
    if mix is None:
        mix = make_gossip_mix(cfg, pods, device=device,
                              mesh=pod_mix_mesh(mesh))
    quantized = mix.quantization != "none"
    model = mesh if _model_axis(mesh) else None

    def hmix(g, idxs=None):
        cols = (idxs, layout, model) if quantized and model and idxs else None
        return _hmix_buffer(g, pods, per_pod, mix, key, t, mesh, cols)

    if not (cfg.packed and _packable(mix)):
        if quantized and (pools is not None or model is not None):
            return _pooled(tree, pools, hmix)
        return packing.tree_map(hmix, tree)
    bufs, spec = pack(tree, pools)
    return packing.unpack_tree(tuple(hmix(b, spec.groups[g])
                                     for g, b in enumerate(bufs)), spec)


def average_gradients(tree: Tree, cfg: AveragingConfig, *, n_nodes: int,
                      pods: int = 1, mix: Optional[MixOp] = None,
                      key: Optional[int] = None, t=None,
                      device: DeviceLike = None, mesh: Any = None,
                      pools: Optional[Pools] = None,
                      layout: Layout = None) -> Tree:
    """Dispatch on the paper's averaging mode. `tree` leaves: [n_nodes, ...]
    (on a sharded `mesh`, this rank's rows of them).

    `mix` is the prebuilt consensus engine (gossip: over `n_nodes`, built
    with the mesh; hierarchical: over `pods`, built on `pod_mix_mesh`);
    built from `cfg` on `device` when omitted. `t` is the round counter of
    a time-varying `ScheduledMixOp`. `pools` and `layout` place a
    quantized wire's statistics (`gossip_average`)."""
    if cfg.mode == "exact":
        return exact_average(tree, mesh, n_nodes)
    if cfg.mode == "gossip":
        if mix is None:
            mix = make_gossip_mix(cfg, n_nodes, device=device,
                                  mesh=mesh if is_sharded(mesh) else None)
        return gossip_average(tree, n_nodes, cfg, mix, key=key, t=t,
                              device=device, pools=pools, layout=layout,
                              mesh=mesh)
    if cfg.mode == "hierarchical":
        if n_nodes % pods:
            raise ValueError(f"{n_nodes} nodes do not split into {pods} pods")
        return hierarchical_average(tree, pods, n_nodes // pods, cfg, mix,
                                    key=key, t=t, device=device, mesh=mesh,
                                    pools=pools, layout=layout)
    raise ValueError(f"unknown averaging mode {cfg.mode!r}")


def average_and_error(tree: Tree, cfg: AveragingConfig, *, n_nodes: int,
                      pods: int = 1, mix: Optional[MixOp] = None,
                      key: Optional[int] = None, t=None,
                      device: DeviceLike = None,
                      pools: Optional[Pools] = None, mesh: Any = None,
                      model_split: Optional[Tuple[bool, ...]] = None,
                      layout: Layout = None
                      ) -> Tuple[Tree, torch.Tensor]:
    """Averaging plus the epsilon-consensus diagnostic with ONE pack: the
    mixed packed buffers feed both the unpack and the error reduction.
    `pools` groups leaves for the diagnostic (`packed_consensus_error`),
    orders the packed buffers and makes the reference's leaves of a
    quantized wire's statistics. On a sharded `mesh` the leaves are this
    rank's rows, `mix` is built with the mesh, and the diagnostic reduces
    across ranks; over a model axis they are its model shard's blocks,
    `model_split` says which leaves (in the tree's order) the model axis
    splits, and `layout` where their blocks lie in the whole leaves."""
    if mesh is not None and not is_sharded(mesh) and model_extent(mesh) == 1:
        mesh = None
    err_kw = dict(mesh=mesh, n_nodes=n_nodes, model_split=model_split)
    if cfg.mode == "exact":
        mixed = exact_average(tree, mesh, n_nodes)
        return mixed, consensus_error(mixed, pools, **err_kw)
    if cfg.mode not in ("gossip", "hierarchical"):
        raise ValueError(f"unknown averaging mode {cfg.mode!r}")
    if mix is None:
        mix = (make_gossip_mix(cfg, pods, device=device,
                               mesh=pod_mix_mesh(mesh))
               if cfg.mode == "hierarchical" else
               make_gossip_mix(cfg, n_nodes, device=device, mesh=mesh))
    if not (cfg.packed and _packable(mix)):
        mixed = average_gradients(tree, cfg, n_nodes=n_nodes, pods=pods,
                                  mix=mix, key=key, t=t, mesh=mesh,
                                  pools=pools, layout=layout)
        return mixed, consensus_error(mixed, pools, **err_kw)
    bufs, spec = pack(tree, pools)
    quantized = mix.quantization != "none"
    model = mesh if _model_axis(mesh) else None
    if cfg.mode == "gossip" and quantized and model is not None:
        outs = tuple(torch.cat(quant_slot_mix(
            _leaf_views(b, spec, g), spec.groups[g], mix, layout=layout,
            mesh=model, key=key, seg=_segments(spec, g, pools)), -1)
            for g, b in enumerate(bufs))
    elif cfg.mode == "gossip":
        outs = tuple(_apply_mix(mix, spec, g, b, key, t, pools)
                     for g, b in enumerate(bufs))
    else:
        if n_nodes % pods:
            raise ValueError(f"{n_nodes} nodes do not split into {pods} pods")
        outs = tuple(_hmix_buffer(
            b, pods, n_nodes // pods, mix, key, t, mesh,
            (spec.groups[g], layout, model) if quantized and model else None)
            for g, b in enumerate(bufs))
    err = packed_consensus_error(outs, spec, pools, mesh, n_nodes,
                                  model_split)
    return packing.unpack_tree(outs, spec), err


# f32 temporaries of error feedback: at most this many entries each
# (256 MiB; at 2^28 entries the 8B-class trainer peaked at 77 GB of 80)
EF_CHUNK_ENTRIES = 1 << 26


def ef_chunk_width(n: int, d: int, block_d: int) -> int:
    """Columns of the packed [n, d] buffer that `ef_average_and_error`
    treats at a time: a multiple of `block_d` (so every statistic tile lies
    inside one chunk and the result does not depend on the chunking), as
    wide as keeps an f32 [n, width] temporary within EF_CHUNK_ENTRIES."""
    width = max(block_d, EF_CHUNK_ENTRIES // max(n, 1) // block_d * block_d)
    return min(width, max(d, 1))


class _EFSlots:
    """Error feedback's per-node tile statistics over a model axis, for
    one packed group (`ef_average_and_error`): the rank's packed buffer
    holds its blocks of the group's `leaves`, in order, placed in the
    reference's packed buffer as `layout` says."""

    def __init__(self, leaves, layout: Layout, mesh: Any,
                 cfg: AveragingConfig, key: Optional[int], rows):
        from repro_torch import dist as rdist

        self.m = rdist.model_index(mesh)
        self.maps = block_maps([layout[i] for i in leaves],
                               model_extent(mesh), self.m)
        self.width = sum(bm.span for bm in self.maps)
        self.bd = min(cfg.quant_block_d, self.width)
        self.slots = Slots(self.maps, self.bd, self.width, self.width,
                           index=self.m)
        self.starts = [0]
        for bm in self.maps:
            self.starts.append(self.starts[-1] + bm.size)
        self.mesh, self.cfg, self.key, self.rows = mesh, cfg, key, rows

    def local(self, p: int) -> int:
        """The rank's packed columns whose reference position is below p."""
        return sum(bm.before(p) for bm in self.maps)

    def chunks(self, n: int):
        """(first, last + 1 local column, reference columns) of each chunk,
        cut every `ef_chunk_width` reference columns."""
        width = ef_chunk_width(n, self.width, self.cfg.quant_block_d)
        return [(self.local(a), self.local(min(a + width, self.width)),
                 (a, min(a + width, self.width)))
                for a in range(0, self.width, width)]

    def _segments(self, lo: int, hi: int):
        """(leaf, first local entry, chunk column, entries) of the leaves
        in the rank's packed columns [lo, hi)."""
        for i in range(len(self.maps)):
            a = max(lo, self.starts[i])
            b = min(hi, self.starts[i + 1])
            if b > a:
                yield i, a - self.starts[i], a - lo, b - a

    def compress(self, v: torch.Tensor, lo: int, ref_cols) -> torch.Tensor:
        """The chunk v (the rank's packed columns from `lo`) compressed
        with the per-node statistics of the reference's tiles."""
        slots, name = self.slots, self.cfg.quantization
        stat = "sum" if name == "sign" else "max"
        window = (ref_cols[0] // self.bd, -(-ref_cols[1] // self.bd))
        segs = list(self._segments(lo, lo + v.shape[1]))
        xs = [None] * len(self.maps)
        starts = [0] * len(self.maps)
        for i, l0, c0, cnt in segs:
            xs[i], starts[i] = v[:, c0:c0 + cnt], l0
        partial = slot_partials(xs, slots, stat, per_node=True,
                                starts=starts, window=window)
        scale = slot_scales(complete_slots(partial, slots, stat, self.mesh,
                                           window), slots, name, 1, window)
        q = torch.empty_like(v)
        for i, l0, c0, cnt in segs:
            k = None
            if self.key is not None:
                k = fold_in(self.key, i)
                if not self.maps[i].whole:
                    k = fold_in(k, 1 + self.m)
                if self.rows is not None:
                    k = fold_in(k, 1 + self.rows[0])
            q[:, c0:c0 + cnt] = slot_compress(
                xs[i], slots, i, scale, name, key=k, start=l0,
                window_lo=window[0])
        return q

    def counted(self, x: torch.Tensor, lo: int) -> torch.Tensor:
        """The columns of the chunk x (from `lo`) this rank counts in the
        model group's sums: on a rank other than the group's first, not
        those of leaves kept whole."""
        if self.m == 0:
            return x
        keep = [x[:, c0:c0 + cnt] for i, _, c0, cnt
                in self._segments(lo, lo + x.shape[1])
                if not self.maps[i].whole]
        return torch.cat(keep, 1) if keep else x[:, :0]


def ef_average_and_error(tree: Tree, ef: Tree, cfg: AveragingConfig, *,
                         n_nodes: int, mix: Optional[MixOp] = None,
                         key: Optional[int] = None, t=None,
                         device: DeviceLike = None,
                         pools: Optional[Pools] = None, mesh: Any = None,
                         model_split: Optional[Tuple[bool, ...]] = None,
                         layout: Layout = None
                         ) -> Tuple[Tree, Tree, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Error-feedback compressed gossip: ONE pack, ONE compression, exact
    linear consensus rounds.

    Per step, on the packed [N, D] buffers: v = g + e (the residual-corrected
    gradient, f32), q = C(v) with sender-local per-node tile statistics
    (`quantize.tile_compress(per_node=True)`), mixed = the R-round LINEAR
    consensus of q (on the card the `gossip_mix` kernel), e' = v - q. The
    buffers are treated `ef_chunk_width` columns at a time, so the f32
    temporaries stay within 256 MiB each at any width (at an 8B-class
    model's width one f32 [4, D] copy alone would be 10 GB); a chunk starts
    on a tile boundary, so the statistics, and the result, are those of the
    whole buffer. The new residual is written into the packed residual
    buffer, in `ef`'s dtype.

    With `cfg.quantization == "none"` the wire is exact: q = v, e' stays
    zero, and the result equals plain packed linear gossip of g + e.

    Returns (mixed, new_ef, consensus_err, ef_norm, ef_rel): `ef_norm` is
    the global L2 norm of the new residual, `ef_rel` its ratio to ||v||.
    `key` seeds the stochastic compressor (folded with the buffer index);
    `pools` groups leaves for the consensus error and orders the packed
    buffers.

    On a sharded `mesh` the trees are this rank's rows of the
    `n_nodes`-node axis (split as `mix.rows` says: an elastic run's cohort,
    `dist.cohort_rows`, possibly none), `mix` is built with the mesh, and
    the rank compresses its rows (per-node statistics need no message; a
    stochastic compressor draws its rows' uniforms of the whole axis,
    `tile_compress(rows=...)`), mixes them through the shard rule or the
    gather, and keeps its residual rows: bit for bit the one process's
    rows where the mixes are. The chunks are cut from n_nodes, so every
    rank walks the same columns and its halo messages pair up; ||e'||^2
    and ||v||^2 are summed over the ranks in one f32 all-reduce.

    Over a model axis the trees are the rank's blocks (placed as `layout`
    says; `model_split` marks the split leaves for the consensus error),
    packed in the pools' order: the reference's packed buffer holds the
    whole leaves in that order. Each chunk is cut on the reference's
    columns (`ef_chunk_width` of its width), so every rank of a model
    group walks the same slots; the rank takes the per-node tile
    statistics of its entries at their reference positions and completes
    the tiles it shares with the group's other ranks by one f32 all-reduce
    (`core.quantize.Slots`), compresses, mixes linearly and keeps its
    residual blocks. ||e'||^2 and ||v||^2 sum over the model group too, a
    leaf kept whole counted once (on the group's first rank)."""
    sharded = is_sharded(mesh)
    if mix is None:
        mix = make_gossip_mix(cfg, n_nodes, device=device,
                              mesh=mesh if sharded else None)
    if getattr(mix, "quantization", "none") != "none":
        raise ValueError(
            "error feedback needs a LINEAR consensus operator — build it via "
            "make_gossip_mix, which drops the per-round compressor when "
            "cfg.error_feedback is on")
    bufs, spec = pack(tree, pools)
    ebufs, espec = pack(ef, pools)
    # the new residual is written into the packed residual buffer: a copy,
    # unless the group holds a single leaf, which the pack only reshapes
    ebufs = tuple(e.clone() if len(espec.groups[g]) == 1 else e
                  for g, e in enumerate(ebufs))
    rows = None  # (this rank's first row, n_nodes) on a sharded mesh
    if sharded:
        table = getattr(mix, "rows", None) or rdist.row_table(mesh, n_nodes)
        rows = (table[rdist.node_index(mesh)][0], n_nodes)
    model = mesh if _model_axis(mesh) else None
    outs = []
    v2 = e2 = None
    for g, (b, e) in enumerate(zip(bufs, ebufs)):
        out = torch.empty_like(b)
        d = b.shape[-1]
        k = fold_in(key, g) if key is not None else None
        if model is None:
            width = ef_chunk_width(n_nodes if sharded else b.shape[0], d,
                                   cfg.quant_block_d)
            cuts = [(a, min(a + width, d), None) for a in range(0, d, width)]
        else:
            ef_slots = _EFSlots(spec.groups[g], layout, model, cfg, k, rows)
            cuts = ef_slots.chunks(n_nodes if sharded else b.shape[0])
        for lo, hi, ref_cols in cuts:
            cols = slice(lo, hi)
            v = b[:, cols].to(torch.float32, copy=True)
            v.add_(e[:, cols].float())
            if cfg.quantization == "none":
                q = v
            elif model is not None:
                q = ef_slots.compress(v, lo, ref_cols)
            else:
                q = tile_compress(v, cfg.quantization, cfg.quant_block_d,
                                  key=k, per_node=True, rows=rows)
            # (a ragged last tile leaves tile_compress's output a strided
            # view; the kernel takes contiguous rows)
            out[:, cols] = _mix_call(mix, q.contiguous(), t=t)
            count = (lambda x: x) if model is None else \
                (lambda x, lo=lo: ef_slots.counted(x, lo))
            vv = count(v).square().sum()
            v2 = vv if v2 is None else v2 + vv
            if q is not v:
                v.sub_(q)  # v is now the residual e' = v - q
            else:
                v.zero_()
            e[:, cols] = v
            del v, q
            # of the stored residual
            rr = count(e[:, cols].float()).square().sum()
            e2 = rr if e2 is None else e2 + rr
        outs.append(out)
    dev = bufs[0].device if bufs else None
    zero = torch.zeros((), device=dev)
    e2 = zero if e2 is None else e2
    v2 = zero if v2 is None else v2
    if sharded or model is not None:
        both = torch.stack([e2, v2]).float()
        if model is not None:
            rdist.all_reduce_(both, mesh, axis="model")
        if sharded:
            rdist.all_reduce_(both, mesh)
        e2, v2 = both.unbind()
    ef_norm = torch.sqrt(e2)
    ef_rel = ef_norm / (torch.sqrt(v2) + 1e-30)
    err = packed_consensus_error(tuple(outs), spec, pools,
                                 mesh if sharded or model is not None
                                 else None, n_nodes, model_split)
    return (packing.unpack_tree(tuple(outs), spec),
            packing.unpack_tree(tuple(ebufs), espec), err, ef_norm, ef_rel)


def packed_consensus_error(bufs: Tuple[torch.Tensor, ...],
                            spec: packing.PackSpec,
                            pools: Optional[Pools] = None, mesh: Any = None,
                            n_nodes: Optional[int] = None,
                            model_split: Optional[Tuple[bool, ...]] = None
                            ) -> torch.Tensor:
    """max_leaf max_n ||v_n - v_bar|| / ||v_bar|| on the packed buffers, one
    leaf segment at a time: the f32 temporaries are the size of one leaf,
    not of the buffer (an f32 copy of an 8B-class model's [4, D] gradient
    buffer alone would be 10 GB). `pools` (tuples of leaf indices) makes
    each pool of leaves count as one leaf, its squares summed over the pool;
    by default every leaf is its own pool. On a sharded `mesh` the buffers
    are this rank's rows of the `n_nodes`-node axis: each leaf's mean is an
    all-reduce, and the max over nodes one more (over the pools' values).
    Over a model axis the leaves that `model_split` marks sum their squares
    over the model group (one all-reduce)."""
    def segments():
        for g, buf in enumerate(bufs):
            off = 0
            for i in spec.groups[g]:
                w = spec.leaf_width(i)
                yield i, buf[..., off:off + w]
                off += w

    return _consensus_of(segments(), pools, mesh, n_nodes, model_split)


def _consensus_of(segments, pools: Optional[Pools], mesh: Any,
                  n_nodes: Optional[int],
                  model_split: Optional[Tuple[bool, ...]]) -> torch.Tensor:
    """The consensus error of (leaf index, [n_local, w] rows) segments."""
    sharded = is_sharded(mesh)
    d2: dict = {}  # leaf index -> (squared deviations [N], squared mean)
    for i, rows in segments:
        if rows.shape[-1] == 0:
            continue
        seg = rows.to(torch.float32, copy=True)
        if sharded:
            bar = _node_sum(seg, mesh).div_(n_nodes)
        else:
            bar = torch.mean(seg, dim=0, keepdim=True)
        d2[i] = (seg.sub_(bar).square_().sum(-1), bar.square().sum())
    split = [i for i in sorted(d2) if model_split and model_split[i]]
    if split and model_extent(mesh) > 1:
        # the split leaves' squares, summed over the model group at once
        flat = rdist.all_reduce_(torch.cat(
            [torch.cat([d2[i][0], d2[i][1].reshape(1)]) for i in split]),
            mesh, axis="model")
        off = 0
        for i in split:
            n = d2[i][0].numel()
            d2[i] = (flat[off:off + n], flat[off + n])
            off += n + 1
    errs = []
    for pool in (pools if pools is not None else [(i,) for i in sorted(d2)]):
        parts = [d2[i] for i in pool if i in d2]
        if not parts:
            continue
        num = torch.sqrt(sum(p[0] for p in parts))
        # a rank of a split node axis whose cohort rows are all out holds
        # no deviation: it adds 0 to the max over ranks
        num = num.amax() if num.numel() else num.new_zeros(())
        den = torch.sqrt(sum(p[1] for p in parts)) + 1e-30
        errs.append(num / den)
    if not errs:
        return torch.zeros(())
    errs = torch.stack(errs)
    if sharded:
        rdist.all_reduce_(errs, mesh, ReduceOp.MAX)
    return errs.amax()


def consensus_error(tree: Tree, pools: Optional[Pools] = None, *,
                    mesh: Any = None, n_nodes: Optional[int] = None,
                    model_split: Optional[Tuple[bool, ...]] = None
                    ) -> torch.Tensor:
    """max_n ||v_n - v_bar|| / ||v_bar|| across the tree — the paper's
    epsilon-accuracy diagnostic for inexact averaging, leaf by leaf in
    packing order (`consensus_error_per_leaf` is the per-leaf oracle);
    `pools` as in `packed_consensus_error`; on a sharded `mesh` the leaves
    are this rank's rows of the `n_nodes`-node axis, and over a model axis
    its blocks (`model_split` as in `average_and_error`)."""
    leaves = packing.tree_leaves(tree)
    return _consensus_of(((i, x.reshape(x.shape[0],
                                        math.prod(x.shape[1:])))
                          for i, x in enumerate(leaves)), pools, mesh,
                         n_nodes, model_split)


def consensus_error_per_leaf(tree: Tree) -> torch.Tensor:
    """Per-leaf oracle form of `consensus_error` (one reduction chain per
    leaf)."""
    def err(g):
        g = g.float()
        bar = torch.mean(g, dim=0, keepdim=True)
        num = torch.sqrt(((g - bar) ** 2).reshape(g.shape[0], -1)
                         .sum(1)).amax()
        den = torch.sqrt((bar ** 2).sum()) + 1e-30
        return num / den
    errs = [err(g) for g in packing.tree_leaves(tree)]
    return torch.stack(errs).amax() if errs else torch.zeros(())
