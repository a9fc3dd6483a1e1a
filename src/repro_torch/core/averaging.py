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
from repro_torch.core.quantize import STOCHASTIC, fold_in, tile_compress
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


def _apply_mix(mix: MixOp, spec: packing.PackSpec, g: int,
               buf: torch.Tensor, key: Optional[int] = None,
               t=None) -> torch.Tensor:
    if mix.quantization != "none" and mix.stats == "segment":
        widths = tuple(spec.leaf_width(i) for i in spec.groups[g])
        return _mix_call(mix, buf, key=key, t=t, seg_widths=widths)
    return _mix_call(mix, buf, key=key, t=t)


def gossip_average(tree: Tree, n_nodes: int, cfg: AveragingConfig,
                   mix: Optional[MixOp] = None, *,
                   key: Optional[int] = None, t=None,
                   device: DeviceLike = None) -> Tree:
    """R rounds of doubly-stochastic consensus over the leading node axis —
    one packed pass per dtype group by default, per-leaf when `cfg.packed`
    is off or the quantized global-stats oracle is selected. `key`
    (optional) is the per-step integer stochastic compressors fold into the
    op's seed — see `CirculantMixOp._quantized`; `t` (optional) is the round
    counter a `ScheduledMixOp` picks its phase by."""
    if mix is None:
        mix = make_gossip_mix(cfg, n_nodes, device=device)
    if not (cfg.packed and _packable(mix)):
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
                 mesh: Any = None) -> torch.Tensor:
    """Reduce-scatter hierarchical consensus on one [N, ...] buffer/leaf
    (on a sharded `mesh`, this rank's rows of it: `_hmix_shard`). The pod
    mean is the f32 sum of the pod's rows, added in node order
    (`dist.row_sum`, which any split of the rows reproduces bit for bit),
    over per_pod, in the buffer's dtype."""
    if is_sharded(mesh):
        return _hmix_shard(g, pods, per_pod, mix, key, t, mesh)
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
                key: Optional[int], t, mesh: Any) -> torch.Tensor:
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
    process does."""
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
                         mesh: Any = None) -> Tree:
    """Exact averaging within each pod, gossip across pods — in
    reduce-scatter form: lane j of each pod owns chunk j of the pod mean,
    the cross-pod gossip mixes only that chunk, and an intra-pod all-gather
    reassembles the mixed mean. Feature dims are zero-padded up to a
    multiple of per_pod; the pad columns are masked out of quantized
    compressor statistics (`valid_d`, which reaches the `gossip_mix_quant`
    kernel on the card). Quantized segment statistics do not survive the
    chunk-scatter relayout; they degrade to global (masked) statistics
    over the scattered pod means here. On a sharded `mesh` the leaves are
    this rank's rows and the pods lie on its "pod" axis (`_hmix_shard`)."""
    if mix is None:
        mix = make_gossip_mix(cfg, pods, device=device,
                              mesh=pod_mix_mesh(mesh))

    def hmix(g):
        return _hmix_buffer(g, pods, per_pod, mix, key, t, mesh)

    if not (cfg.packed and _packable(mix)):
        return packing.tree_map(hmix, tree)
    bufs, spec = packing.pack_tree(tree)
    return packing.unpack_tree(tuple(hmix(b) for b in bufs), spec)


def average_gradients(tree: Tree, cfg: AveragingConfig, *, n_nodes: int,
                      pods: int = 1, mix: Optional[MixOp] = None,
                      key: Optional[int] = None, t=None,
                      device: DeviceLike = None, mesh: Any = None) -> Tree:
    """Dispatch on the paper's averaging mode. `tree` leaves: [n_nodes, ...]
    (on a sharded `mesh`, this rank's rows of them).

    `mix` is the prebuilt consensus engine (gossip: over `n_nodes`, built
    with the mesh; hierarchical: over `pods`, built on `pod_mix_mesh`);
    built from `cfg` on `device` when omitted. `t` is the round counter of
    a time-varying `ScheduledMixOp`."""
    if cfg.mode == "exact":
        return exact_average(tree, mesh, n_nodes)
    if cfg.mode == "gossip":
        if mix is None:
            mix = make_gossip_mix(cfg, n_nodes, device=device,
                                  mesh=mesh if is_sharded(mesh) else None)
        return gossip_average(tree, n_nodes, cfg, mix, key=key, t=t,
                              device=device)
    if cfg.mode == "hierarchical":
        if n_nodes % pods:
            raise ValueError(f"{n_nodes} nodes do not split into {pods} pods")
        return hierarchical_average(tree, pods, n_nodes // pods, cfg, mix,
                                    key=key, t=t, device=device, mesh=mesh)
    raise ValueError(f"unknown averaging mode {cfg.mode!r}")


def average_and_error(tree: Tree, cfg: AveragingConfig, *, n_nodes: int,
                      pods: int = 1, mix: Optional[MixOp] = None,
                      key: Optional[int] = None, t=None,
                      device: DeviceLike = None,
                      pools: Optional[Pools] = None, mesh: Any = None,
                      model_split: Optional[Tuple[bool, ...]] = None
                      ) -> Tuple[Tree, torch.Tensor]:
    """Averaging plus the epsilon-consensus diagnostic with ONE pack: the
    mixed packed buffers feed both the unpack and the error reduction.
    `pools` groups leaves for the diagnostic (`packed_consensus_error`)
    and orders the packed buffers. On a sharded `mesh` the leaves are this
    rank's rows, `mix` is built with the mesh, and the diagnostic reduces
    across ranks; over a model axis they are its model shard's blocks, and
    `model_split` says which leaves (in the tree's order) the model axis
    splits."""
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
                                  mix=mix, key=key, t=t, mesh=mesh)
        return mixed, consensus_error(mixed, pools, **err_kw)
    bufs, spec = pack(tree, pools)
    if cfg.mode == "gossip":
        outs = tuple(_apply_mix(mix, spec, g, b, key, t)
                     for g, b in enumerate(bufs))
    else:
        if n_nodes % pods:
            raise ValueError(f"{n_nodes} nodes do not split into {pods} pods")
        outs = tuple(_hmix_buffer(b, pods, n_nodes // pods, mix, key, t,
                                  mesh) for b in bufs)
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


def ef_average_and_error(tree: Tree, ef: Tree, cfg: AveragingConfig, *,
                         n_nodes: int, mix: Optional[MixOp] = None,
                         key: Optional[int] = None, t=None,
                         device: DeviceLike = None,
                         pools: Optional[Pools] = None, mesh: Any = None
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
    and ||v||^2 are summed over the ranks in one f32 all-reduce."""
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
    outs = []
    v2 = e2 = None
    for g, (b, e) in enumerate(zip(bufs, ebufs)):
        out = torch.empty_like(b)
        d = b.shape[-1]
        k = fold_in(key, g) if key is not None else None
        width = ef_chunk_width(n_nodes if sharded else b.shape[0], d,
                               cfg.quant_block_d)
        for a in range(0, d, width):
            cols = slice(a, min(a + width, d))
            v = b[:, cols].to(torch.float32, copy=True)
            v.add_(e[:, cols].float())
            if cfg.quantization == "none":
                q = v
            else:
                q = tile_compress(v, cfg.quantization, cfg.quant_block_d,
                                  key=k, per_node=True, rows=rows)
            # (a ragged last tile leaves tile_compress's output a strided
            # view; the kernel takes contiguous rows)
            out[:, cols] = _mix_call(mix, q.contiguous(), t=t)
            vv = v.square().sum()
            v2 = vv if v2 is None else v2 + vv
            if q is not v:
                v.sub_(q)  # v is now the residual e' = v - q
            else:
                v.zero_()
            e[:, cols] = v
            del v, q
            rr = e[:, cols].float().square().sum()  # of the stored residual
            e2 = rr if e2 is None else e2 + rr
        outs.append(out)
    dev = bufs[0].device if bufs else None
    zero = torch.zeros((), device=dev)
    e2 = zero if e2 is None else e2
    v2 = zero if v2 is None else v2
    if sharded:
        e2, v2 = rdist.all_reduce_(torch.stack([e2, v2]).float(),
                                   mesh).unbind()
    ef_norm = torch.sqrt(e2)
    ef_rel = ef_norm / (torch.sqrt(v2) + 1e-30)
    err = packed_consensus_error(tuple(outs), spec, pools,
                                 mesh if sharded else None, n_nodes)
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
