"""Public wrappers for the Hopper kernels, dispatched by the tensor's device.

A CPU tensor takes the kernel's plain PyTorch version (`kernels/ref.py`); a
CUDA tensor launches the hand-written kernel, or the call raises — there is
no fallback from a failed build or launch to the plain version. Each wrapper
adds one to `launches[name]` where it launches its kernel and nowhere else,
so a run can show that it went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.consensus import gossip_mix_cuda
from repro_torch.kernels.krasulina_update import (krasulina_xi_cuda,
                                                  krasulina_xi_gossip_cuda)

# kernel launches since the last `reset_launches()`, by kernel name
launches: Dict[str, int] = {"krasulina_xi": 0, "krasulina_xi_gossip": 0,
                            "gossip_mix": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
    read and one write on the card. `sched`: ((shift, weight), ...) one-round
    schedule."""
    if not _on_cuda(x):
        return ref.gossip_mix_ref(x, sched, rounds)
    out = gossip_mix_cuda(x, sched, rounds)
    launches["gossip_mix"] += 1
    return out


def krasulina_xi(w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Mini-batch Krasulina pseudo-gradient (Alg. 2 steps 3-5). w: [d], z:
    [B, d] -> [d]; or batched, w [G, d] (or a shared [d]), z [G, B, d] ->
    [G, d]."""
    if not _on_cuda(w, z):
        return ref.krasulina_xi_ref(w, z)
    out = krasulina_xi_cuda(w, z)
    launches["krasulina_xi"] += 1
    return out


def krasulina_xi_gossip(w: torch.Tensor, z: torch.Tensor, sched,
                        rounds: int) -> torch.Tensor:
    """Fused D-Krasulina hot path: per-node pseudo-gradients (Alg. 2 steps
    3-5) + ALL R gossip rounds (eq. 17). w: [N, d]; z: [N, Bn, d]. On the
    card every round runs on the resident tile; on the CPU the plain version
    applies the composed R-round schedule in one pass."""
    if not _on_cuda(w, z):
        return ref.krasulina_xi_gossip_ref(w, z, sched, rounds)
    out = krasulina_xi_gossip_cuda(w, z, sched, rounds)
    launches["krasulina_xi_gossip"] += 1
    return out
