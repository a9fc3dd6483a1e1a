"""Doubly-stochastic mixing schedules for averaging consensus (paper eq. 17
and Section V), plus the fused circulant consensus engine (`CirculantMixOp`)
— the static, unquantized part of `repro.core.mixing`.

`CirculantMixOp` makes R rounds of eq. 17 cost about one: the R-round
operator is linear, so it is precomputed once outside the step loop (the
R-fold convolution of the shift schedule) and applied in one pass, or the
R rounds run inside one kernel on a shared-memory tile (`impl="kernel"`).

Message quantization (Section VI) and the sharded node axis come with later
slices of the port; asking for them raises `NotImplementedError` rather than
running something else. Dense operators (`DenseMixOp`), `ScheduledMixOp`
and the masked (elastic) forms wait for their slices too; `Membership`
is here because `core.rates.Plan` carries it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Schedule = Tuple[Tuple[int, float], ...]  # ((shift, weight), ...) includes shift 0


# ---------------------------------------------------------------------------
# Circulant schedules (device path)
# ---------------------------------------------------------------------------


def schedule(topology: str, n: int, self_weight: float = 0.0) -> Schedule:
    """Doubly-stochastic circulant mixing schedule over `n` nodes."""
    if n == 1:
        return ((0, 1.0),)
    if topology == "ring":
        shifts = [-1, 1] if n > 2 else [1]
    elif topology == "circulant2":  # degree-4 circulant expander
        shifts = [s for s in (-2, -1, 1, 2) if abs(s) < n]
    elif topology == "torus":  # 2D torus on a near-square factorization
        a = int(np.sqrt(n))
        while n % a:
            a -= 1
        b = n // a
        shifts = sorted({s % n for s in (-1, 1, -b, b) if (s % n) != 0})
        shifts = [s if s <= n // 2 else s - n for s in shifts]
    else:
        raise ValueError(f"unknown topology {topology!r}")
    deg = len(shifts)
    w_self = self_weight if self_weight > 0 else 1.0 / (deg + 1)
    w = (1.0 - w_self) / deg
    return tuple([(0, float(w_self))] + [(s, float(w)) for s in shifts])


def schedule_matrix(sched: Schedule, n: int) -> np.ndarray:
    """Dense matrix equivalent of a circulant schedule (for tests/analysis)."""
    A = np.zeros((n, n))
    for shift, w in sched:
        for i in range(n):
            # roll(x, shift)[i] = x[(i - shift) % n]
            A[i, (i - shift) % n] += w
    return A


# ---------------------------------------------------------------------------
# Elastic membership (docs/DESIGN.md §Elastic membership)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Membership:
    """Which of the `n` node slots participate in mixing this superstep.

    The node axis keeps its full extent `n` end-to-end (state arrays never
    change shape); a dropped slot simply stops sending and receiving — its
    mixing row degrades to self-weight 1 — while the active cohort mixes
    over a recomposed operator that is doubly stochastic over the cohort.
    Hashable so it can key superstep registries; equality is by value, so
    rejoining to full membership compares equal to the never-left mask.
    This slice carries it for `core.rates.Plan`; the cohort paths come with
    the elastic slice.
    """

    n: int
    active: Tuple[bool, ...]

    def __post_init__(self):
        if self.n < 1 or len(self.active) != self.n:
            raise ValueError(f"bad membership: n={self.n} "
                             f"mask length {len(self.active)}")
        if not any(self.active):
            raise ValueError("membership needs at least one active node")

    @classmethod
    def full(cls, n: int) -> "Membership":
        return cls(n, (True,) * n)

    def drop(self, *ids: int) -> "Membership":
        mask = list(self.active)
        for i in ids:
            mask[i] = False
        return Membership(self.n, tuple(mask))

    def rejoin(self, *ids: int) -> "Membership":
        mask = list(self.active)
        for i in ids:
            mask[i] = True
        return Membership(self.n, tuple(mask))

    @property
    def n_active(self) -> int:
        return sum(self.active)

    @property
    def active_ids(self) -> Tuple[int, ...]:
        return tuple(i for i, a in enumerate(self.active) if a)

    @property
    def is_full(self) -> bool:
        return all(self.active)

    def to_json(self) -> dict:
        """JSON form for checkpoint manifests."""
        return {"n": self.n, "active": [bool(a) for a in self.active]}

    @classmethod
    def from_json(cls, state: dict) -> "Membership":
        return cls(int(state["n"]), tuple(bool(a) for a in state["active"]))


# ---------------------------------------------------------------------------
# Dense matrices (analysis)
# ---------------------------------------------------------------------------


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings doubly-stochastic weights for an undirected graph."""
    n = adj.shape[0]
    deg = adj.sum(1)
    A = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j and adj[i, j]:
                A[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        A[i, i] = 1.0 - A[i].sum()
    return A


def _circulant_regular(n: int, deg: int) -> np.ndarray:
    """Deterministic connected `deg`-regular circulant graph."""
    adj = np.zeros((n, n), dtype=bool)
    offsets = list(range(1, deg // 2 + 1))
    for i in range(n):
        for o in offsets:
            adj[i, (i + o) % n] = adj[(i + o) % n, i] = True
        if deg % 2:  # odd degree needs the antipodal matching (n must be even)
            if n % 2:
                raise ValueError("odd-degree regular graph needs even n")
            adj[i, (i + n // 2) % n] = adj[(i + n // 2) % n, i] = True
    return adj


def lambda2(A: np.ndarray) -> float:
    """Second-largest eigenvalue magnitude — the consensus contraction rate."""
    ev = np.sort(np.abs(np.linalg.eigvals(A)))[::-1]
    return float(ev[1]) if len(ev) > 1 else 0.0


def is_doubly_stochastic(A: np.ndarray, tol: float = 1e-8) -> bool:
    return (
        bool(np.all(A >= -tol))
        and np.allclose(A.sum(0), 1.0, atol=1e-6)
        and np.allclose(A.sum(1), 1.0, atol=1e-6)
    )


# ---------------------------------------------------------------------------
# Fused consensus engine (MixOp)
# ---------------------------------------------------------------------------


def roll_mix(x: torch.Tensor, sched: Schedule) -> torch.Tensor:
    """One consensus round over axis 0 of x via weighted circular shifts
    (unquantized: the reference's `compress` is the identity here)."""
    out = None
    for shift, w in sched:
        term = w * (x if shift == 0 else torch.roll(x, shift, 0))
        out = term if out is None else out + term
    return out


def compose_schedule(sched: Schedule, rounds: int, n: int) -> Schedule:
    """The effective one-pass schedule of `rounds` consensus rounds: the R-fold
    circular convolution of the shift schedule (shifts add mod n, weights
    multiply). Exactly the circulant form of `schedule_matrix(sched, n)**R`.

    The result has at most n terms, so even for large R a single pass costs no
    more than one full circulant application."""
    cur = {0: 1.0}
    for _ in range(rounds):
        nxt: dict = {}
        for s1, w1 in cur.items():
            for s2, w2 in sched:
                k = (s1 + s2) % n
                nxt[k] = nxt.get(k, 0.0) + w1 * w2
        cur = nxt
    # canonical form: shifts in (-n/2, n/2], self term first, then ascending
    out = []
    for s, w in cur.items():
        s = s if s <= n // 2 else s - n
        out.append((int(s), float(w)))
    out.sort(key=lambda sw: (sw[0] != 0, sw[0]))
    return tuple(out)


_LATER = {
    "quantization": "quantized gossip (Section VI) comes with the port's "
                    "quantized-consensus slice (core/quantize.py and the "
                    "gossip_mix_quant kernel)",
    "shard": "the sharded node axis comes with the port's sharded slice",
}


@dataclasses.dataclass(frozen=True)
class CirculantMixOp:
    """Precomputed R-round circulant consensus operator (device gossip path).

    `impl` selects the execution strategy:

    * "roll"   — one weighted `torch.roll` pass over `fused_sched` (the R-fold
                 convolution of the one-round schedule).
    * "matmul" — the dense circulant `A_eff` [n, n] as one matmul over the
                 flattened node axis (the fast CPU path).
    * "kernel" — the hand-written CUDA kernel (`kernels.ops.gossip_mix`): the
                 node block is tiled into shared memory once and all R rounds
                 run there, round by round (one HBM read+write per buffer). On
                 a CPU tensor it runs the kernel's plain per-round version.
    * "auto"   — resolved at build time by `circulant_mix_op` via
                 `resolve_auto_impl(device)`: "kernel" on CUDA, "matmul" on
                 the CPU.

    `fused_sched=None` keeps the per-round loop (the `fuse=False` oracle).
    """

    sched: Schedule  # one-round schedule (per-round / kernel path)
    fused_sched: Optional[Schedule]  # R-round schedule; None = per-round loop
    A_eff: Optional[torch.Tensor]  # [n, n] f32 dense fused_sched (matmul impl)
    n: int
    rounds: int
    impl: str = "roll"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.n:
            raise ValueError(f"MixOp built for n={self.n} applied to node "
                             f"axis {x.shape[0]}")
        if self.rounds == 0 or self.n == 1:
            return x
        if self.fused_sched is None:  # fuse=False: per-round oracle loop
            for _ in range(self.rounds):
                x = roll_mix(x, self.sched)
            return x
        if self.impl == "kernel":
            from repro_torch.kernels.ops import gossip_mix
            return gossip_mix(x, self.sched, self.rounds)
        if self.impl == "matmul":
            flat = x.reshape(self.n, -1)
            A = self.A_eff.to(device=x.device, dtype=x.dtype)
            return (A @ flat).reshape(x.shape)
        if self.impl != "roll":
            raise ValueError(f"unknown MixOp impl {self.impl!r}")
        return roll_mix(x, self.fused_sched)


def resolve_auto_impl(device: DeviceLike = None) -> str:
    """Pick the fastest execution strategy for `impl="auto"` on a single
    device: the fused CUDA kernel on the card, the dense circulant matmul on
    the CPU. (The reference picks its kernel on TPU only; on the card the
    kernel is the point of the port, so the CUDA branch takes it.)"""
    return "kernel" if resolve_device(device).type == "cuda" else "matmul"


def circulant_mix_op(sched: Schedule, n: int, rounds: int, *,
                     quantization: str = "none", impl: str = "auto",
                     fuse: bool = True,
                     device: DeviceLike = None) -> CirculantMixOp:
    """Build the circulant-path MixOp from a one-round schedule.

    The R-round operator is precomputed here, once, so the per-step cost is
    about one round. `fuse=False` keeps the per-round loop (oracle /
    baseline). `impl="auto"` resolves via `resolve_auto_impl(device)`.
    Quantized configs and `impl="shard"` belong to later slices and
    raise."""
    if quantization != "none":
        raise NotImplementedError(_LATER["quantization"])
    if impl == "shard":
        raise NotImplementedError(_LATER["shard"])
    if impl not in ("auto", "roll", "matmul", "kernel"):
        raise ValueError(f"unknown MixOp impl {impl!r}")
    if impl == "auto":
        impl = resolve_auto_impl(device)
    if not fuse:
        return CirculantMixOp(sched, None, None, n, rounds, impl)
    fused = compose_schedule(sched, rounds, n) if rounds > 0 else ((0, 1.0),)
    # the dense [n, n] operator is only needed by the matmul impl
    A_eff = (torch.as_tensor(schedule_matrix(fused, n), dtype=torch.float32)
             if impl == "matmul" else None)
    return CirculantMixOp(sched, fused, A_eff, n, rounds, impl)
