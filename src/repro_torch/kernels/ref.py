"""Plain PyTorch versions of the Hopper kernels: the CPU execution path, and
the oracle `chip_smoke.py` holds each kernel against on the card. Nothing on
the main path calls them when a card is present (`kernels/ops.py` dispatches
by the tensor's device).

Roll convention: `torch.roll(x, s, 0)[i] == x[(i - s) % n]`, the same as
`jnp.roll`, so a schedule means the same thing in both packages.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def krasulina_xi_ref(w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Mini-batch Krasulina pseudo-gradient (Alg. 2 step 4, batch-averaged).

    w: [d]; z: [B, d]. xi = (1/B) Z^T (Z w) - (mean((Zw)^2) / ||w||^2) w.
    Leading batch dims are mapped over (the port's stand-in for `jax.vmap`):
    w [G, d] or a shared [d], z [G, B, d] -> xi [G, d]."""
    zf, wf = z.float(), w.float()
    zw = (zf @ wf.unsqueeze(-1)).squeeze(-1)  # [..., B]
    nrm2 = (wf * wf).sum(-1).clamp_min(1e-30)
    zts = (zf.transpose(-1, -2) @ zw.unsqueeze(-1)).squeeze(-1)  # [..., d]
    coeff = (zw * zw).mean(-1) / nrm2
    xi = zts / z.shape[-2] - coeff.unsqueeze(-1) * wf
    return xi.to(w.dtype)


def krasulina_xi_gossip_ref(w: torch.Tensor, z: torch.Tensor, sched,
                            rounds: int) -> torch.Tensor:
    """Fused D-Krasulina consensus step: per-node pseudo-gradients followed by
    R rounds of circulant gossip, as ONE pass — xi via `krasulina_xi_ref` and
    the R-round schedule collapsed by `core.mixing.compose_schedule` (the
    consensus is linear, so the composition is exact up to f32 reassociation).
    w: [N, d]; z: [N, Bn, d]. The strict per-round form is
    `gossip_mix_ref(krasulina_xi_ref(w, z), sched, rounds)`."""
    from repro_torch.core.mixing import compose_schedule

    xi = krasulina_xi_ref(w, z)
    if rounds == 0 or w.shape[0] == 1:
        return xi
    fused = compose_schedule(sched, rounds, w.shape[0])
    return gossip_mix_ref(xi, fused, 1)


def gossip_mix_ref(x: torch.Tensor, sched, rounds: int) -> torch.Tensor:
    """R sequential rounds of weighted circular shifts over axis 0 — the
    uncompressed gossip oracle the consensus kernel is held against."""
    for _ in range(rounds):
        out = None
        for shift, w in sched:
            term = w * (x if shift == 0 else torch.roll(x, shift, 0))
            out = term if out is None else out + term
        x = out
    return x


def gossip_mix_quant_ref(x: torch.Tensor, sched, rounds: int, quant: str, *,
                         block_d: int = 512, valid_d: Optional[int] = None,
                         key: Optional[int] = None,
                         per_node: bool = False) -> torch.Tensor:
    """R rounds of quantized gossip with per-[n, block_d]-tile compressor
    statistics — the plain version of `gossip_mix_quant_cuda`, plus the
    keyed stochastic variant the kernel does not run. Per-round
    nonlinearity is kept (no operator collapsing); the arithmetic is f32
    and the result is cast to x's dtype once, at the end.

    Compress-once-broadcast: tile scales are roll-invariant (the roll permutes
    rows, the stats reduce over them), so each round quantizes the buffer
    ONCE and rolls the compressed copy; the self term stays uncompressed.
    Round r of a stochastic compressor draws from `fold_in(key, r)`.

    `per_node=True` selects per-[1, block_d] row-tile statistics
    (sender-local scales, `stats="node"`)."""
    from repro_torch.core.quantize import fold_in, tile_compress

    n = x.shape[0]
    h = x.reshape(n, -1).float()
    for r in range(rounds):
        k = fold_in(key, r) if key is not None else None
        q = tile_compress(h, quant, block_d, valid_d=valid_d, key=k,
                          per_node=per_node)
        out = None
        for shift, w in sched:
            term = w * (h if shift == 0 else torch.roll(q, shift, 0))
            out = term if out is None else out + term
        h = out
    return h.reshape(x.shape).to(x.dtype)


def quant_slot_stats_ref(h: torch.Tensor, offset: int, w: int, L: int,
                         m: int, bd: int, lo: int, hi: int,
                         partial: torch.Tensor, quant: str) -> torch.Tensor:
    """The plain version of `quant_slot_stats_cuda`: the sum of |h| in f64
    (sign) or its max (int8) over every row of h [n, size] (a block whose
    local entry l lies at reference position
    offset + (l // w) * L + m * w + l % w), per slot = position // bd,
    for the slots in [lo, hi), combined into `partial` ([1, slots] f64,
    added or maxed) in place."""
    l = torch.arange(h.shape[1], device=h.device)
    slot = (offset + (l // w) * L + m * w + l % w) // bd
    keep = (slot >= lo) & (slot < hi)
    a = h.abs()
    vals = a.double().sum(0) if quant == "sign" else a.amax(0).double()
    part = torch.zeros_like(partial[0]).scatter_reduce_(
        0, torch.where(keep, slot, 0), torch.where(keep, vals, 0),
        "sum" if quant == "sign" else "amax")
    if quant == "sign":
        partial[0].add_(part)
    else:
        torch.maximum(partial[0], part, out=partial[0])
    return partial


def quant_slot_round_ref(h: torch.Tensor, offset: int, w: int, L: int,
                         m: int, bd: int, scale: torch.Tensor, sched,
                         quant: str) -> torch.Tensor:
    """The plain version of `quant_slot_round_cuda`: one round of quantized
    gossip on h [n, size] (f32), each non-self message compressed with the
    f32 scale of its entry's slot (`scale` [1, slots]; the map as in
    `quant_slot_stats_ref`)."""
    l = torch.arange(h.shape[1], device=h.device)
    s = scale[0, (offset + (l // w) * L + m * w + l % w) // bd]
    if quant == "sign":
        q = torch.sign(h) * s
    else:
        q = torch.clamp(torch.round(h / s), -127, 127) * s
    out = None
    for shift, wt in sched:
        term = wt * (h if shift == 0 else torch.roll(q, shift, 0))
        out = term if out is None else out + term
    return out


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, chunk: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Dense masked attention in f32 — the plain version of
    `flash_attention_cuda`. q: [B, H, Sq, D]; k, v: [B, H, Sk, D] (same head
    count). Query and key positions both count from 0; fully masked rows are
    0. Returns v's dtype."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    if chunk:
        mask &= (kp // chunk) == (qp // chunk)
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(v.dtype)
