"""Public wrappers for the Hopper kernels, dispatched by the tensor's device.

A CPU tensor takes the kernel's plain PyTorch version (`kernels/ref.py`); a
CUDA tensor launches the hand-written kernel, or the call raises — there is
no fallback from a failed build or launch to the plain version. Each wrapper
adds one to `launches[name]` where it launches its kernel and nowhere else,
so a run can show that it went through the kernels.

A meta tensor (the planner's trace, `launch/dryrun.py`, which stands for
the card) takes the kernel's footprint: an empty meta tensor of the
kernel's output shape and dtype. It computes nothing and counts no launch;
it hands the kernel's operation count to every function in `meta_hooks`,
because the trace cannot see inside a kernel.

On a node axis split over the ranks of a mesh, the shard rules
(`sharded_gossip_mix`, `sharded_quant_gossip_mix`,
`sharded_krasulina_xi_gossip`) take the node-axis kernels' place, as in the
reference: halo messages between ranks and a plain slice sum per round;
`sharded_krasulina_xi_gossip` runs each rank's xi through `krasulina_xi`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import torch

from repro_torch.dist import data_axes, n_data_nodes, node_index, row_table
from repro_torch.kernels import ref
from repro_torch.kernels.consensus import (GOSSIP_DESIGNS, QUANT_CLUSTERS,
                                           gossip_design, gossip_mix_cuda,
                                           gossip_mix_quant_cuda,
                                           gossip_mix_quant_shard,
                                           gossip_mix_shard,
                                           quant_cluster_size, quant_route,
                                           quant_tile_of, shard_compatible)
from repro_torch.kernels.flash_attention import (VARIANTS,
                                                 flash_attention_cuda, route)
from repro_torch.kernels.krasulina_update import (XI_DESIGNS,
                                                  XI_GOSSIP_DESIGNS,
                                                  krasulina_xi_cuda,
                                                  krasulina_xi_gossip_cuda,
                                                  krasulina_xi_gossip_shard,
                                                  xi_gossip_route, xi_route)

# kernel launches since the last `reset_launches()`, by kernel name
launches: Dict[str, int] = {"krasulina_xi": 0, "krasulina_xi_gossip": 0,
                            "gossip_mix": 0, "gossip_mix_quant": 0,
                            "flash_attention": 0}
# flash_attention launches by kernel (`flash_attention.flash_variant`); they
# add up to launches["flash_attention"]
flash_launches: Dict[str, int] = {v: 0 for v in VARIANTS}
# krasulina_xi launches by design (`xi_route`), krasulina_xi_gossip
# launches by design (`xi_gossip_route`), gossip_mix launches by design
# (`gossip_design`), and gossip_mix_quant launches by blocks per statistic
# tile of the cluster-tile kernel (`quant_cluster_size`) or under
# "resident-tile" (`quant_route`); each adds up to its kernel's count in
# `launches`
xi_launches: Dict[str, int] = {v: 0 for v in XI_DESIGNS}
xi_gossip_launches: Dict[str, int] = {v: 0 for v in XI_GOSSIP_DESIGNS}
gossip_launches: Dict[str, int] = {v: 0 for v in GOSSIP_DESIGNS}
quant_launches: Dict[Union[int, str], int] = {
    **{c: 0 for c in QUANT_CLUSTERS}, "resident-tile": 0}
# the node-axis kernels' launches by node count (groups for krasulina_xi:
# 1 for an unbatched call), as an elastic run's cohorts change it; each
# adds up to its kernel's count in `launches`
node_launches: Dict[str, Dict[int, int]] = {
    k: {} for k in ("krasulina_xi", "krasulina_xi_gossip", "gossip_mix",
                    "gossip_mix_quant")}


# called as hook(kernel name, operations) by a wrapper given meta tensors
meta_hooks: List[Callable[[str, float], None]] = []


def reset_launches() -> None:
    for counts in (launches, flash_launches, xi_launches, xi_gossip_launches,
                   gossip_launches, quant_launches):
        for name in counts:
            counts[name] = 0
    for counts in node_launches.values():
        counts.clear()


def _count_nodes(name: str, n: int) -> None:
    counts = node_launches[name]
    counts[n] = counts.get(n, 0) + 1


def _on_meta(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the meta device (mixed devices go on
    to `_on_cuda`, which refuses them)."""
    return all(t.device.type == "meta" for t in tensors)


def _footprint(name: str, flops: float, shape, dtype) -> torch.Tensor:
    """The kernel's output for a meta input: empty, and no launch counted;
    `flops` goes to `meta_hooks`."""
    for hook in meta_hooks:
        hook(name, float(flops))
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _mix_flops(x: torch.Tensor, sched, rounds: int) -> float:
    """A multiply and an add per schedule term, entry and round."""
    return 2.0 * rounds * len(tuple(sched)) * x.numel()


def attention_pairs(Sq: int, Sk: int, *, causal: bool = True,
                    window: int = 0, chunk: int = 0) -> int:
    """The (query, key) pairs that `attention`'s mask keeps (positions from
    0, as `ref.attention_ref` masks them)."""
    i = torch.arange(Sq, dtype=torch.int64)
    hi = torch.minimum(i, torch.tensor(Sk - 1)) if causal else torch.full_like(
        i, Sk - 1)
    lo = (i - window + 1).clamp_min(0) if window else torch.zeros_like(i)
    if chunk:
        start = (i // chunk) * chunk
        lo = torch.maximum(lo, start)
        hi = torch.minimum(hi, start + chunk - 1)
    return int((hi - lo + 1).clamp_min(0).sum())


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one lies
    on the CPU; anything else is refused."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: the kernels take "
                     f"all-CUDA (kernel) or all-CPU (plain version) inputs")


def node_shard_info(mesh, n: int, sched=None, rows=None):
    """(node_axes, ring_axis) when the shard rules cover mixing an [n, ...]
    node axis on this mesh, else None: the node axes ("pod"/"data") split
    it with exactly one nontrivial axis (the ring), in the contiguous runs
    of `rows` (`dist.RowTable`, default `dist.row_table(mesh, n)`; uneven,
    or a cohort's, `dist.cohort_rows`), and, when `sched` is given, with a
    one-round halo reach that the other shards can serve
    (`consensus.shard_compatible`)."""
    if mesh is None:
        return None
    node_axes = data_axes(mesh)
    sizes = [int(mesh.shape[a]) for a in node_axes]
    live = [a for a, s in zip(node_axes, sizes) if s > 1]
    if len(live) != 1:
        return None  # unsharded, or a ring spanning two mesh axes
    rows = rows or row_table(mesh, n)
    if sched is not None and not shard_compatible(sched, rows):
        return None
    return node_axes, live[0]


def _covered(x: torch.Tensor, sched, mesh, rows) -> None:
    """Raise unless the shard rules cover this rank's rows x of a node axis
    split over `mesh` as `rows` says (default evenly; `node_shard_info`);
    `core.mixing`'s op gathers the layouts they do not cover."""
    rows = rows or row_table(mesh, x.shape[0] * n_data_nodes(mesh))
    n = rows[-1][1]
    if node_shard_info(mesh, n, tuple(sched), rows) is None:
        raise ValueError(f"the shard rules do not cover mixing {n} nodes in "
                         f"rows {list(rows)} over a {mesh.sizes} mesh "
                         f"with the schedule {tuple(sched)}")
    a, b = rows[node_index(mesh)]
    if x.shape[0] != b - a:
        raise ValueError(f"this rank holds rows [{a}, {b}) of the table, "
                         f"not {x.shape[0]}")


def sharded_gossip_mix(x: torch.Tensor, sched, rounds: int,
                       mesh, rows=None) -> torch.Tensor:
    """R rounds of gossip on a node axis split over `mesh` as `rows` says
    (default evenly; where `node_shard_info` covers it, else ValueError;
    the ring runs over every rank): per-round halo messages and a slice sum
    on this rank's rows x, the reference's shard_map rule
    (`consensus.gossip_mix_shard`). Bit for bit the plain per-round path's
    rows."""
    _covered(x, sched, mesh, rows)
    return gossip_mix_shard(x, sched, rounds, mesh, rows)


def sharded_quant_gossip_mix(x: torch.Tensor, sched, rounds: int,
                             quantization: str, mesh, *, block_d: int = 512,
                             valid_d: Optional[int] = None,
                             key: Optional[int] = None,
                             rows=None) -> torch.Tensor:
    """Quantized gossip on a sharded node axis with per-node tile
    statistics (`stats="node"`, sender-local scales: the only granularity
    that does not depend on the split), where `node_shard_info` covers the
    layout (`rows` as in `sharded_gossip_mix`). Equals
    `ref.gossip_mix_quant_ref(..., per_node=True)` on this rank's rows."""
    _covered(x, sched, mesh, rows)
    return gossip_mix_quant_shard(x, sched, rounds, quantization, mesh,
                                  block_d=block_d, valid_d=valid_d, key=key,
                                  rows=rows)


def sharded_krasulina_xi_gossip(w: torch.Tensor, z: torch.Tensor, sched,
                                rounds: int, mesh, rows=None) -> torch.Tensor:
    """xi + R-round gossip on a sharded node axis, where `node_shard_info`
    covers the layout (`rows` as in `sharded_gossip_mix`): xi node-local on
    each rank (`krasulina_xi`, the kernel on the card), only the consensus
    rounds communicate. Equals `gossip_mix_ref(krasulina_xi_ref(w, z), ...)`
    on this rank's rows to f32 round-off."""
    _covered(w, sched, mesh, rows)
    return krasulina_xi_gossip_shard(w, z, sched, rounds, mesh, rows)


def gossip_mix(x: torch.Tensor, sched, rounds: int) -> torch.Tensor:
    """R rounds of circulant gossip consensus over axis 0 (eq. 17), one HBM
    read and one write on the card, the design following the node count
    (`gossip_design`). `sched`: ((shift, weight), ...) one-round schedule."""
    if _on_meta(x):
        return _footprint("gossip_mix", _mix_flops(x, sched, rounds),
                          x.shape, x.dtype)
    if not _on_cuda(x):
        return ref.gossip_mix_ref(x, sched, rounds)
    out = gossip_mix_cuda(x, sched, rounds)
    launches["gossip_mix"] += 1
    gossip_launches[gossip_design(x.shape[0])] += 1
    _count_nodes("gossip_mix", x.shape[0])
    return out


def quant_gossip_mix(x: torch.Tensor, sched, rounds: int, quantization: str,
                     *, block_d: int = 512, valid_d: Optional[int] = None,
                     key: Optional[int] = None,
                     per_node: bool = False) -> torch.Tensor:
    """R rounds of QUANTIZED gossip with per-[n, block_d]-tile compressor
    statistics (the `stats="tile"` path), one HBM read and one write on the
    card for sign and int8.

    The stochastic int8 compressor and `per_node=True` (sender-local
    row-tile statistics, `stats="node"`) take the plain tile chain
    (`ref.gossip_mix_quant_ref`) on every device: the reference never fuses
    them either (its `quant_gossip_mix` and `gossip_mix_quant_pallas`), so
    this is the reference's design, not a fallback. `key` seeds the
    stochastic compressor's rounds."""
    if _on_meta(x):
        return _footprint("gossip_mix_quant", _mix_flops(x, sched, rounds),
                          x.shape, x.dtype)
    if per_node or quantization == "int8_stoch" or not _on_cuda(x):
        return ref.gossip_mix_quant_ref(x, sched, rounds, quantization,
                                        block_d=block_d, valid_d=valid_d,
                                        key=key, per_node=per_node)
    out = gossip_mix_quant_cuda(x, sched, rounds, quantization,
                                block_d=block_d, valid_d=valid_d)
    launches["gossip_mix_quant"] += 1
    design = quant_route(x, block_d)
    quant_launches[quant_cluster_size(quant_tile_of(x, block_d))
                   if design == "cluster-tile" else design] += 1
    _count_nodes("gossip_mix_quant", x.shape[0])
    return out


def krasulina_xi(w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Mini-batch Krasulina pseudo-gradient (Alg. 2 steps 3-5). w: [d], z:
    [B, d] -> [d]; or batched, w [G, d] (or a shared [d]), z [G, B, d] ->
    [G, d]. On the card the design follows the shape (`xi_route`)."""
    if _on_meta(w, z):
        shape = z.shape[:-2] + z.shape[-1:]
        return _footprint("krasulina_xi", 4.0 * z.numel(), shape, w.dtype)
    if not _on_cuda(w, z):
        return ref.krasulina_xi_ref(w, z)
    if z.dim() == 3 and z.shape[0] == 0:
        # no group: a rank of a split node axis whose cohort rows are all
        # out (a grid of no blocks is no launch)
        return w.new_empty((0, z.shape[-1]))
    out = krasulina_xi_cuda(w, z)
    launches["krasulina_xi"] += 1
    xi_launches[xi_route(w, z)] += 1
    _count_nodes("krasulina_xi", z.shape[0] if z.dim() == 3 else 1)
    return out


def krasulina_xi_gossip(w: torch.Tensor, z: torch.Tensor, sched,
                        rounds: int) -> torch.Tensor:
    """Fused D-Krasulina hot path: per-node pseudo-gradients (Alg. 2 steps
    3-5) + ALL R gossip rounds (eq. 17). w: [N, d]; z: [N, Bn, d]. On the
    card the design follows the shape (`xi_gossip_route`); the one-read
    kernel and the plain version both apply the composed R-round schedule
    in one pass."""
    if _on_meta(w, z):
        return _footprint("krasulina_xi_gossip",
                          4.0 * z.numel() + _mix_flops(w, sched, rounds),
                          w.shape, w.dtype)
    if not _on_cuda(w, z):
        return ref.krasulina_xi_gossip_ref(w, z, sched, rounds)
    out = krasulina_xi_gossip_cuda(w, z, sched, rounds)
    launches["krasulina_xi_gossip"] += 1
    xi_gossip_launches[xi_gossip_route(w, z)] += 1
    _count_nodes("krasulina_xi_gossip", z.shape[0])
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              chunk: int = 0) -> torch.Tensor:
    """Masked attention, q: [B, H, Sq, D], k/v: [B, H, Sk, D] (GQA heads
    repeated), scale 1/sqrt(D), query and key positions counted from 0;
    fully masked rows are 0. Any Sk is taken with any mask, on every device
    (the reference's Pallas kernel refuses unmasked attention unless Sk is
    a multiple of min(128, Sk), because it pads keys; the port masks them).

    The flash kernel has no backward (the reference's has none either), so
    on the card a call that autograd would have to differentiate raises:
    training takes `models.layers.blockwise_attention`
    (`apply_attention(..., train=True)`)."""
    meta = _on_meta(q, k, v)
    if not meta and not _on_cuda(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "ops.attention: the flash kernel has no backward, and its output "
            "would carry no gradient to q, k or v; differentiate attention "
            "through models.layers.blockwise_attention "
            "(apply_attention(..., train=True), as loss_fn does)")
    if meta:
        B, H, Sq, D = q.shape
        pairs = attention_pairs(Sq, k.shape[2], causal=causal,
                                window=window, chunk=chunk)
        return _footprint("flash_attention", 4.0 * B * H * D * pairs,
                          q.shape[:3] + v.shape[3:], v.dtype)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               chunk=chunk)
    launches["flash_attention"] += 1
    flash_launches[route(q, k, v)] += 1
    return out
