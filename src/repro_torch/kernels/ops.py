"""Public wrappers for the Hopper kernels, dispatched by the tensor's device.

A CPU tensor takes the kernel's plain PyTorch version (`kernels/ref.py`); a
CUDA tensor launches the hand-written kernel, or the call raises — there is
no fallback from a failed build or launch to the plain version. Each wrapper
adds one to `launches[name]` where it launches its kernel and nowhere else,
so a run can show that it went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.consensus import (GOSSIP_DESIGNS, QUANT_CLUSTERS,
                                           gossip_design, gossip_mix_cuda,
                                           gossip_mix_quant_cuda,
                                           quant_cluster_size, quant_route,
                                           quant_tile_of)
from repro_torch.kernels.flash_attention import (VARIANTS,
                                                 flash_attention_cuda, route)
from repro_torch.kernels.krasulina_update import (XI_DESIGNS,
                                                  XI_GOSSIP_DESIGNS,
                                                  krasulina_xi_cuda,
                                                  krasulina_xi_gossip_cuda,
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


def gossip_mix(x: torch.Tensor, sched, rounds: int) -> torch.Tensor:
    """R rounds of circulant gossip consensus over axis 0 (eq. 17), one HBM
    read and one write on the card, the design following the node count
    (`gossip_design`). `sched`: ((shift, weight), ...) one-round schedule."""
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
    if not _on_cuda(w, z):
        return ref.krasulina_xi_ref(w, z)
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
    if not _on_cuda(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "ops.attention: the flash kernel has no backward, and its output "
            "would carry no gradient to q, k or v; differentiate attention "
            "through models.layers.blockwise_attention "
            "(apply_attention(..., train=True), as loss_fn does)")
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               chunk=chunk)
    launches["flash_attention"] += 1
    flash_launches[route(q, k, v)] += 1
    return out
