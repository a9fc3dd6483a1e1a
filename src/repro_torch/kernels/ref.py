"""Plain PyTorch versions of the Hopper kernels: the CPU execution path, and
the oracle `chip_smoke.py` holds each kernel against on the card. Nothing on
the main path calls them when a card is present (`kernels/ops.py` dispatches
by the tensor's device).

Roll convention: `torch.roll(x, s, 0)[i] == x[(i - s) % n]`, the same as
`jnp.roll`, so a schedule means the same thing in both packages.
"""
from __future__ import annotations

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
