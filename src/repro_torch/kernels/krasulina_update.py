"""CUDA kernels for the mini-batch Krasulina pseudo-gradient, per node and —
for the decentralized D-Krasulina track — fused with the R-round gossip
consensus that follows it.

* `krasulina_xi_cuda` (`csrc/krasulina_xi.cu`) replaces the Pallas
  `krasulina_xi_pallas`: s = Z w, then xi = Z^T s / B - (mean(s^2) /
  ||w||^2) w, for G groups at once (the port's stand-in for `jax.vmap`).
* `krasulina_xi_gossip_cuda` (`csrc/krasulina_xi_gossip.cu`) replaces
  `krasulina_xi_gossip_pallas`: per-node xi, then every gossip round on the
  shared-memory tile before the one write-back.

Both are two launches (the row dots s, then the column tiles), because xi
needs a reduction over all of d before any column of it can be formed and
Hopper blocks carry nothing across a grid; each source file says why and
what that costs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda


def krasulina_xi_cuda(w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """w: [d]; z: [B, d] -> xi [d]. Batched: w [G, d] (or a shared [d]) and
    z [G, B, d] -> xi [G, d]. f32 or bf16, w and z of one dtype; the
    output has w's dtype, the arithmetic is f32 and the mean uses the true
    B."""
    if z.dim() not in (2, 3):
        raise ValueError(f"krasulina_xi: z must be [B, d] or [G, B, d], got "
                         f"{tuple(z.shape)}")
    single = z.dim() == 2
    G, B, d = (1, *z.shape) if single else z.shape
    _cuda.check("krasulina_xi z", z, tuple(z.shape))
    shared_w = w.dim() == 1
    _cuda.check("krasulina_xi w", w, (d,) if shared_w else (G, d))
    if w.dtype != z.dtype:
        raise TypeError(f"krasulina_xi: w is {w.dtype} but z is {z.dtype}")
    s = torch.empty((G, B), dtype=torch.float32, device=z.device)
    nrm2 = torch.empty((G,), dtype=torch.float32, device=z.device)
    out = torch.empty((G, d), dtype=w.dtype, device=z.device)
    with torch.cuda.device(z.device):
        _cuda.call("krasulina_xi", w.data_ptr(), 0 if shared_w else d,
                   z.data_ptr(), G, B, d, s.data_ptr(), nrm2.data_ptr(),
                   out.data_ptr(), _cuda.DTYPE_CODES[z.dtype],
                   _cuda.stream_of(z))
    return out[0] if single else out


def krasulina_xi_gossip_cuda(w: torch.Tensor, z: torch.Tensor, sched,
                             rounds: int) -> torch.Tensor:
    """w: [N, d] per-node iterates; z: [N, Bn, d] per-node mini-batches ->
    [N, d] gossip-mixed pseudo-gradients: R rounds of
    `sum_s w_s * roll(xi, s, axis=0)` applied to xi_n = krasulina_xi(w_n,
    z_n), every round on the resident tile. R = 0 is the plain xi."""
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if z.dim() != 3:
        raise ValueError(f"krasulina_xi_gossip: z must be [N, Bn, d], got "
                         f"{tuple(z.shape)}")
    n, bn, d = z.shape
    _cuda.check("krasulina_xi_gossip z", z, (n, bn, d))
    _cuda.check("krasulina_xi_gossip w", w, (n, d))
    if w.dtype != z.dtype:
        raise TypeError(f"krasulina_xi_gossip: w is {w.dtype} but z is "
                        f"{z.dtype}")
    n_terms, shifts, weights = _cuda.schedule_args(sched, n)
    # s [N, Bn] and the per-node coefficients share the block's shared memory
    bd = _cuda.tile_width(n, d, fixed_bytes=4 * (n * bn + n))
    s = torch.empty((n, bn), dtype=torch.float32, device=z.device)
    nrm2 = torch.empty((n,), dtype=torch.float32, device=z.device)
    out = torch.empty((n, d), dtype=w.dtype, device=z.device)
    with torch.cuda.device(z.device):
        _cuda.call("krasulina_xi_gossip", w.data_ptr(), z.data_ptr(), n, bn,
                   d, bd, s.data_ptr(), nrm2.data_ptr(), out.data_ptr(),
                   _cuda.DTYPE_CODES[z.dtype], rounds, n_terms, shifts,
                   weights, _cuda.stream_of(z))
    return out
