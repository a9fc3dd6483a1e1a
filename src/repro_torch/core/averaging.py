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

Error-feedback compression (`ef_average_and_error`) comes with the port's
elastic and error-feedback slice.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import AveragingConfig
from repro_torch.core import packing
from repro_torch.core.mixing import CirculantMixOp, circulant_mix_op, schedule
from repro_torch.device import DeviceLike

Tree = Any
# groups of leaf indices (in packing order) that the consensus error treats
# as one leaf each; see `_packed_consensus_error`
Pools = Tuple[Tuple[int, ...], ...]


def make_gossip_mix(cfg: AveragingConfig, n_nodes: int, *,
                    impl: str = "auto",
                    device: DeviceLike = None) -> CirculantMixOp:
    """Build the consensus engine for a config — once, outside the step loop.
    For `mode="hierarchical"` pass the pod count as `n_nodes`.

    `impl="auto"` resolves per device (`core.mixing.resolve_auto_impl`): the
    CUDA kernel on the card, the dense circulant matmul on the CPU. The
    quantization, its statistics and tile width come from `cfg`. Error
    feedback belongs to a later slice and raises."""
    if cfg.error_feedback != "off":
        raise NotImplementedError(
            "error-feedback compressed gossip comes with the port's elastic "
            "and error-feedback slice")
    sched = schedule(cfg.topology, n_nodes, cfg.self_weight)
    return circulant_mix_op(sched, n_nodes, cfg.rounds,
                            quantization=cfg.quantization, impl=impl,
                            stats=cfg.quant_stats, block_d=cfg.quant_block_d,
                            device=device)


def resolve_packed(cfg: AveragingConfig) -> bool:
    """Resolve the tri-state `AveragingConfig.packed`. The reference's "auto"
    packs everywhere except meshes that shard leaves over a model axis; the
    port runs on one device, where "auto" always packs."""
    return True if cfg.packed == "auto" else bool(cfg.packed)


def _packable(mix: CirculantMixOp) -> bool:
    """Quantized global-stats configs pin per-leaf statistics (the oracle),
    so they keep the per-leaf dispatch; everything else packs."""
    return not (mix.quantization != "none" and mix.stats == "global")


def _apply_mix(mix: CirculantMixOp, spec: packing.PackSpec, g: int,
               buf: torch.Tensor, key: Optional[int] = None) -> torch.Tensor:
    if mix.quantization != "none" and mix.stats == "segment":
        widths = tuple(spec.leaf_width(i) for i in spec.groups[g])
        return mix(buf, key=key, seg_widths=widths)
    return mix(buf, key=key)


def gossip_average(tree: Tree, n_nodes: int, cfg: AveragingConfig,
                   mix: Optional[CirculantMixOp] = None, *,
                   key: Optional[int] = None,
                   device: DeviceLike = None) -> Tree:
    """R rounds of doubly-stochastic consensus over the leading node axis —
    one packed pass per dtype group by default, per-leaf when `cfg.packed`
    is off or the quantized global-stats oracle is selected. `key`
    (optional) is the per-step integer stochastic compressors fold into the
    op's seed — see `CirculantMixOp._quantized`."""
    if mix is None:
        mix = make_gossip_mix(cfg, n_nodes, device=device)
    if not (cfg.packed and _packable(mix)):
        return packing.tree_map(lambda g: mix(g, key=key), tree)
    bufs, spec = packing.pack_tree(tree)
    outs = tuple(_apply_mix(mix, spec, g, b, key) for g, b in enumerate(bufs))
    return packing.unpack_tree(outs, spec)


def exact_average(tree: Tree) -> Tree:
    return packing.tree_map(
        lambda g: torch.mean(g, dim=0, keepdim=True).expand(g.shape), tree)


def _hmix_buffer(g: torch.Tensor, pods: int, per_pod: int,
                 mix: CirculantMixOp, key: Optional[int] = None
                 ) -> torch.Tensor:
    """Reduce-scatter hierarchical consensus on one [N, ...] buffer/leaf."""
    shp = g.shape
    flat = g.reshape(pods, per_pod, -1)  # [P, M, F]
    pod_mean = torch.mean(flat, dim=1)  # reduce ...
    f = pod_mean.shape[-1]
    chunk = -(-f // per_pod)
    pad = chunk * per_pod - f
    if pad:
        pod_mean = torch.nn.functional.pad(pod_mean, (0, pad))
    scattered = pod_mean.reshape(pods, per_pod, chunk)  # ... scatter
    # cross-pod gossip, one chunk per lane; pad columns sit at the tail of
    # the flattened layout and are masked out of compressor statistics
    mixed = mix(scattered, valid_d=f if pad else None, key=key)
    gathered = mixed.reshape(pods, 1, chunk * per_pod)[..., :f]  # all-gather
    return gathered.expand(pods, per_pod, f).reshape(shp)


def hierarchical_average(tree: Tree, pods: int, per_pod: int,
                         cfg: AveragingConfig,
                         mix: Optional[CirculantMixOp] = None, *,
                         key: Optional[int] = None,
                         device: DeviceLike = None) -> Tree:
    """Exact averaging within each pod, gossip across pods — in
    reduce-scatter form: lane j of each pod owns chunk j of the pod mean,
    the cross-pod gossip mixes only that chunk, and an intra-pod all-gather
    reassembles the mixed mean. Feature dims are zero-padded up to a
    multiple of per_pod; the pad columns are masked out of quantized
    compressor statistics (`valid_d`, which reaches the `gossip_mix_quant`
    kernel on the card). Quantized segment statistics do not survive the
    chunk-scatter relayout; they degrade to global (masked) statistics
    over the scattered pod means here."""
    if mix is None:
        mix = make_gossip_mix(cfg, pods, device=device)

    def hmix(g):
        return _hmix_buffer(g, pods, per_pod, mix, key)

    if not (cfg.packed and _packable(mix)):
        return packing.tree_map(hmix, tree)
    bufs, spec = packing.pack_tree(tree)
    return packing.unpack_tree(tuple(hmix(b) for b in bufs), spec)


def average_gradients(tree: Tree, cfg: AveragingConfig, *, n_nodes: int,
                      pods: int = 1, mix: Optional[CirculantMixOp] = None,
                      key: Optional[int] = None,
                      device: DeviceLike = None) -> Tree:
    """Dispatch on the paper's averaging mode. `tree` leaves: [n_nodes, ...].

    `mix` is the prebuilt consensus engine (gossip: over `n_nodes`;
    hierarchical: over `pods`); built from `cfg` on `device` when omitted."""
    if cfg.mode == "exact":
        return exact_average(tree)
    if cfg.mode == "gossip":
        return gossip_average(tree, n_nodes, cfg, mix, key=key, device=device)
    if cfg.mode == "hierarchical":
        if n_nodes % pods:
            raise ValueError(f"{n_nodes} nodes do not split into {pods} pods")
        return hierarchical_average(tree, pods, n_nodes // pods, cfg, mix,
                                    key=key, device=device)
    raise ValueError(f"unknown averaging mode {cfg.mode!r}")


def average_and_error(tree: Tree, cfg: AveragingConfig, *, n_nodes: int,
                      pods: int = 1, mix: Optional[CirculantMixOp] = None,
                      key: Optional[int] = None, device: DeviceLike = None,
                      pools: Optional[Pools] = None
                      ) -> Tuple[Tree, torch.Tensor]:
    """Averaging plus the epsilon-consensus diagnostic with ONE pack: the
    mixed packed buffers feed both the unpack and the error reduction.
    `pools` groups leaves for the diagnostic (`_packed_consensus_error`)."""
    if cfg.mode == "exact":
        mixed = exact_average(tree)
        return mixed, consensus_error(mixed, pools)
    if cfg.mode not in ("gossip", "hierarchical"):
        raise ValueError(f"unknown averaging mode {cfg.mode!r}")
    if mix is None:
        mix = make_gossip_mix(cfg, pods if cfg.mode == "hierarchical"
                              else n_nodes, device=device)
    if not (cfg.packed and _packable(mix)):
        mixed = average_gradients(tree, cfg, n_nodes=n_nodes, pods=pods,
                                  mix=mix, key=key)
        return mixed, consensus_error(mixed, pools)
    bufs, spec = packing.pack_tree(tree)
    if cfg.mode == "gossip":
        outs = tuple(_apply_mix(mix, spec, g, b, key)
                     for g, b in enumerate(bufs))
    else:
        if n_nodes % pods:
            raise ValueError(f"{n_nodes} nodes do not split into {pods} pods")
        outs = tuple(_hmix_buffer(b, pods, n_nodes // pods, mix, key)
                     for b in bufs)
    err = _packed_consensus_error(outs, spec, pools)
    return packing.unpack_tree(outs, spec), err


def ef_average_and_error(*args, **kwargs):
    """Error-feedback compressed gossip: comes with the port's elastic and
    error-feedback slice."""
    raise NotImplementedError(
        "error-feedback compressed gossip comes with the port's elastic and "
        "error-feedback slice")


def _packed_consensus_error(bufs: Tuple[torch.Tensor, ...],
                            spec: packing.PackSpec,
                            pools: Optional[Pools] = None) -> torch.Tensor:
    """max_leaf max_n ||v_n - v_bar|| / ||v_bar|| on the packed buffers, one
    leaf segment at a time: the f32 temporaries are the size of one leaf,
    not of the buffer (an f32 copy of an 8B-class model's [4, D] gradient
    buffer alone would be 10 GB). `pools` (tuples of leaf indices) makes
    each pool of leaves count as one leaf, its squares summed over the pool;
    by default every leaf is its own pool."""
    d2: dict = {}  # leaf index -> (squared deviations [N], squared mean)
    for g, buf in enumerate(bufs):
        off = 0
        for i in spec.groups[g]:
            w = spec.leaf_width(i)
            seg = buf[..., off:off + w].to(torch.float32, copy=True)
            off += w
            if w == 0:
                continue
            bar = torch.mean(seg, dim=0, keepdim=True)
            d2[i] = (seg.sub_(bar).square_().sum(-1), bar.square().sum())
    errs = []
    for pool in (pools if pools is not None else [(i,) for i in sorted(d2)]):
        parts = [d2[i] for i in pool if i in d2]
        if not parts:
            continue
        num = torch.sqrt(sum(p[0] for p in parts)).amax()
        den = torch.sqrt(sum(p[1] for p in parts)) + 1e-30
        errs.append(num / den)
    return torch.stack(errs).amax() if errs else torch.zeros(())


def consensus_error(tree: Tree, pools: Optional[Pools] = None
                    ) -> torch.Tensor:
    """max_n ||v_n - v_bar|| / ||v_bar|| across the tree — the paper's
    epsilon-accuracy diagnostic for inexact averaging. Computed on the packed
    flat buffer (`consensus_error_per_leaf` is the per-leaf oracle); `pools`
    as in `_packed_consensus_error`."""
    bufs, spec = packing.pack_tree(tree)
    return _packed_consensus_error(bufs, spec, pools)


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
