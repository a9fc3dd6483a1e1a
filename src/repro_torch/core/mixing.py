"""Doubly-stochastic mixing matrices / topologies for averaging consensus
(paper eq. 17 and Section V), plus the fused consensus engine (`MixOp`).

Two representations:

* **Dense matrices** (numpy) for the paper-scale experiments — including the
  6-regular random expanders of Fig. 9 — consumed by `core.dsgd` through
  `DenseMixOp` (a matmul over the node axis).
* **Shift schedules** (circulant topologies) for the device gossip path —
  consumed by `core.averaging` / `core.krasulina` through `CirculantMixOp`.

`MixOp` makes R rounds of eq. 17 cost about one: with no message
compression the R-round operator is linear, so it is precomputed once
outside the step loop (`A^R` for dense matrices, the R-fold convolution of
the shift schedule for circulants) and applied in one pass, or the R rounds
run inside one kernel on a shared-memory tile (`impl="kernel"`).

Quantized configs (Section VI) are nonlinear per round, so the operator is
never collapsed; `stats` picks the compressor's statistic granularity:

* "global"  — whole-array scales, the exact per-round loop (the oracle).
* "segment" — per-leaf-segment scales on a packed flat buffer
              (`core.packing`).
* "tile"    — per-[n, block_d]-tile scales: the `gossip_mix_quant` CUDA
              kernel on the card (one HBM read and write per buffer), its
              plain version on the CPU.
* "node"    — sender-local per-[1, block_d] row-tile scales.

Elastic membership degrades the operator to the active cohort
(`masked_schedule` on the circulant path, `masked_matrix` on a dense
matrix), and the scenario harness's time-varying graphs (eq. 17's
B-connected sequences) run through `ScheduledMixOp`: a stack of dense
per-phase operators on the device, the phase picked per round as data.

On a node axis split over the ranks of a mesh (`repro_torch/dist.py`), a
`CirculantMixOp` built with the mesh takes each rank's rows: `impl="shard"`
runs the reference's partitioning rule (`kernels.consensus`: halo messages
and a slice sum per round), and a layout the rule does not cover gathers
the node axis, mixes it and keeps the rank's rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quantize import (COMPRESSORS, STOCHASTIC, fold_in,
                                       make_compressor)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import (all_gather_rows, check_mesh, is_sharded,
                              n_local, node_rows)

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


def masked_schedule(topology: str, membership: Membership,
                    self_weight: float = 0.0) -> Schedule:
    """Circulant schedule over the *relabeled* active cohort.

    The cohort superstep works on a dense [m, ...] block of the active rows,
    so the cohort is itself a circulant ring/expander of size m = n_active
    and the ordinary schedule construction applies verbatim. Full membership
    returns exactly `schedule(topology, n)` — a node that leaves and rejoins
    gets back the operator it had before leaving."""
    return schedule(topology, membership.n_active, self_weight)


def masked_matrix(A: np.ndarray, membership: Membership) -> np.ndarray:
    """Degrade a dense one-round mixing matrix to a membership mask.

    Returns a full [n, n] doubly-stochastic matrix: dropped rows/columns are
    identity (self-weight 1 — the node holds its state, sends and receives
    nothing), and the active block is re-derived by Metropolis reweighting of
    the subgraph that `A`'s off-diagonal support induces on the active cohort.
    Full membership returns `A` unchanged (a rejoin gets the same operator).

    A drop set that *disconnects* the induced subgraph (e.g. every other
    node of a ring) would leave a non-contracting block (lambda_2 = 1); then
    the survivors are relabeled onto their own circulant ring
    (`masked_schedule`'s semantics densified), which is always connected."""
    n = A.shape[0]
    if membership.n != n:
        raise ValueError(f"membership n={membership.n} vs matrix n={n}")
    if membership.is_full:
        return A
    ids = list(membership.active_ids)
    out = np.eye(n, dtype=A.dtype)
    if len(ids) == 1:
        return out
    sub_adj = (np.abs(A[np.ix_(ids, ids)]) > 0).astype(float)
    np.fill_diagonal(sub_adj, 0.0)
    if not _connected(sub_adj > 0):
        block = ring_matrix(len(ids)).astype(A.dtype)
    else:
        block = metropolis_weights(sub_adj)
        if len(ids) > 1 and lambda2(block) >= 1.0 - 1e-9:
            block = ring_matrix(len(ids)).astype(A.dtype)
    out[np.ix_(ids, ids)] = block
    return out


# ---------------------------------------------------------------------------
# Dense matrices (paper experiments)
# ---------------------------------------------------------------------------


def ring_matrix(n: int, self_weight: float = 0.0) -> np.ndarray:
    return schedule_matrix(schedule("ring", n, self_weight), n)


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


def random_regular_expander(n: int, deg: int = 6, seed: int = 0,
                            max_tries: int = 50) -> np.ndarray:
    """Random `deg`-regular graph, Metropolis weights — the paper's Fig. 9
    topology family. Sampled by double-edge-swap randomization of a circulant
    `deg`-regular base graph (keeps the graph simple and regular by
    construction; connectivity is re-checked after mixing). numpy, so the
    same seed gives the reference's matrix."""
    if deg >= n:
        raise ValueError("degree must be < n")
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        adj = _circulant_regular(n, deg)
        edges = [(u, v) for u in range(n) for v in range(u + 1, n) if adj[u, v]]
        for _ in range(20 * len(edges)):
            i, j = rng.integers(len(edges)), rng.integers(len(edges))
            (a, b), (c, d) = edges[i], edges[j]
            if len({a, b, c, d}) < 4:
                continue
            if adj[a, c] or adj[b, d]:
                continue
            adj[a, b] = adj[b, a] = adj[c, d] = adj[d, c] = False
            adj[a, c] = adj[c, a] = adj[b, d] = adj[d, b] = True
            edges[i], edges[j] = (min(a, c), max(a, c)), (min(b, d), max(b, d))
        if _connected(adj):
            return metropolis_weights(adj.astype(float))
    raise RuntimeError("failed to sample a connected regular graph")


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


def random_geometric(n: int, seed: int = 0, radius: Optional[float] = None,
                     max_tries: int = 50) -> np.ndarray:
    """Random geometric graph on the unit square, Metropolis weights — the
    'spatially clustered' topology family. Nodes are uniform points; edges
    connect pairs within `radius` (default: the connectivity threshold
    sqrt(2 ln n / n)). If the sample is disconnected the radius is grown and
    the points resampled — deterministic for a fixed seed."""
    if n == 1:
        return np.ones((1, 1))
    rng = np.random.default_rng(seed)
    r = radius if radius is not None else float(
        np.sqrt(2.0 * np.log(max(n, 2)) / n))
    for _ in range(max_tries):
        pts = rng.random((n, 2))
        d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
        adj = d <= r
        np.fill_diagonal(adj, False)
        if _connected(adj):
            return metropolis_weights(adj.astype(float))
        r *= 1.25
    raise RuntimeError("failed to sample a connected geometric graph")


def _connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = {0}
    frontier = [0]
    while frontier:
        u = frontier.pop()
        for v in np.nonzero(adj[u])[0]:
            if v not in seen:
                seen.add(int(v))
                frontier.append(int(v))
    return len(seen) == n


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


def roll_mix(x: torch.Tensor, sched: Schedule,
             compress: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> torch.Tensor:
    """One consensus round over axis 0 of x via weighted circular shifts.
    `compress` models the wire format: applied to every non-self message
    (None: an exact wire)."""
    out = None
    for shift, w in sched:
        if shift == 0:
            msg = x
        else:
            msg = torch.roll(x, shift, 0)
            if compress is not None:
                msg = compress(msg)
        term = w * msg
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


@dataclasses.dataclass(frozen=True)
class DenseMixOp:
    """Precomputed R-round dense consensus operator (paper eq. 17).

    When `A_eff` is set (the default) the R sequential `A @ h` matmuls
    collapse to the single matmul `A_eff @ h` with `A_eff = A^R` — computed
    once at construction, in f32 as the reference does, outside the step
    loop. With `A_eff=None` the per-round loop is kept (oracle)."""

    A: torch.Tensor  # [N, N] one-round doubly-stochastic matrix, f32
    A_eff: Optional[torch.Tensor]  # [N, N] A^R, or None (per-round loop)
    rounds: int

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        if self.rounds == 0:
            return h
        if self.A_eff is not None:
            return self.A_eff @ h
        for _ in range(self.rounds):
            h = self.A @ h
        return h


def dense_mix_op(A, rounds: int, *, fuse: bool = True,
                 device: DeviceLike = None) -> DenseMixOp:
    """Build the dense-path MixOp on `device`; `fuse=False` keeps the
    per-round loop."""
    A = torch.as_tensor(np.asarray(A, np.float32) if isinstance(A, np.ndarray)
                        else A).to(device=resolve_device(device),
                                   dtype=torch.float32)
    A_eff = None
    if fuse and rounds > 0:
        A_eff = torch.linalg.matrix_power(A, rounds) if rounds > 1 else A
    return DenseMixOp(A, A_eff, rounds)


@dataclasses.dataclass(frozen=True)
class CirculantMixOp:
    """Precomputed R-round circulant consensus operator (device gossip path).

    Quantization off: `impl` selects the execution strategy.

    * "roll"   — one weighted `torch.roll` pass over `fused_sched` (the R-fold
                 convolution of the one-round schedule).
    * "matmul" — the dense circulant `A_eff` [n, n] as one matmul over the
                 flattened node axis (the fast CPU path).
    * "kernel" — the hand-written CUDA kernel (`kernels.ops.gossip_mix`): it
                 composes the R rounds into one circulant of at most n taps
                 (`compose_schedule`, once per schedule) and applies it in one
                 pass over column tiles staged in shared memory (one HBM
                 read+write per buffer). On a CPU tensor it runs the kernel's
                 plain per-round version.
    * "shard"  — the node axis is split over the ranks of `mesh`, and the
                 op takes each rank's rows [n_local, ...]: per round, halo
                 messages carry only the rows the schedule reaches and the
                 local mix is a slice sum (`kernels.ops.sharded_gossip_mix`).
                 PER-ROUND semantics: bit for bit the rows of the fuse=False
                 loop. The builder keeps it only where the rule covers the
                 (n, schedule, split).
    * "auto"   — resolved at build time by `circulant_mix_op` via
                 `resolve_auto_impl(device, mesh)`: "shard" on a sharded
                 node axis, else "kernel" on CUDA, "matmul" on the CPU.

    `fused_sched=None` keeps the per-round loop (the `fuse=False` oracle).

    With a sharded `mesh`, any configuration the shard rules do not run (a
    layout they do not cover, where the builder picks "roll"; quantized
    statistics other than "node") gathers the node axis from every rank,
    applies the op as an unsharded one and keeps the rank's rows: the
    reference's sharding-safe roll, correct on every layout.

    Quantization on: the compressor is nonlinear, so the operator is never
    collapsed and `impl` plays no part. `stats` picks the statistic
    granularity: "global" keeps the exact per-round `roll_mix` loop (the
    oracle); "segment" runs the per-round loop on a packed buffer with
    per-leaf-segment scales (pass `seg_widths` at call time); "tile" runs
    `kernels.ops.quant_gossip_mix` — the `gossip_mix_quant` CUDA kernel on
    the card, its plain tile chain on the CPU; "node" computes sender-local
    per-row-tile scales (the plain tile chain on every device, as in the
    reference); on a sharded mesh with `impl="shard"`, the quantized shard
    rule (`kernels.ops.sharded_quant_gossip_mix`).
    """

    sched: Schedule  # one-round schedule (per-round / kernel path)
    fused_sched: Optional[Schedule]  # R-round schedule; None = per-round loop
    #   (quantized configs, or fuse=False in `circulant_mix_op`)
    A_eff: Optional[torch.Tensor]  # [n, n] f32 dense fused_sched (matmul impl)
    n: int
    rounds: int
    impl: str = "roll"
    quantization: str = "none"
    stats: str = "global"  # quantizer statistics: global | segment | tile | node
    block_d: int = 512  # tile width for stats="tile" / "node"
    seed: int = 0  # base key of stochastic compressors
    mesh: Any = None  # a sharded `dist.Mesh`: x is this rank's rows

    def __call__(self, x: torch.Tensor, *,
                 seg_widths: Optional[Tuple[int, ...]] = None,
                 valid_d: Optional[int] = None,
                 key: Optional[int] = None) -> torch.Tensor:
        rows = n_local(self.mesh, self.n)
        if x.shape[0] != rows:
            raise ValueError(f"MixOp built for n={self.n} ({rows} rows on "
                             f"this rank) applied to node axis {x.shape[0]}")
        if self.rounds == 0 or self.n == 1:
            return x
        if self.mesh is not None:
            return self._sharded(x, seg_widths, valid_d, key)
        if self.quantization != "none":
            return self._quantized(x, seg_widths, valid_d, key)
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

    def _key0(self, key: Optional[int]) -> Optional[int]:
        """The base key of a stochastic compressor for a call with `key`."""
        if self.quantization not in STOCHASTIC:
            return None
        return self.seed if key is None else fold_in(self.seed, key)

    def _sharded(self, x, seg_widths, valid_d, key):
        """This rank's rows x of a node axis split over `mesh`: the shard
        rules where they run, else gather, mix as an unsharded op, and keep
        this rank's rows."""
        from repro_torch.kernels import ops

        if self.impl == "shard" and self.quantization == "none":
            return ops.sharded_gossip_mix(x, self.sched, self.rounds,
                                          self.mesh)
        if self.impl == "shard" and self.stats == "node":
            return ops.sharded_quant_gossip_mix(
                x, self.sched, self.rounds, self.quantization, self.mesh,
                block_d=self.block_d, valid_d=valid_d, key=self._key0(key))
        full = all_gather_rows(x, self.mesh, self.n)
        impl = "roll" if self.impl == "shard" else self.impl
        whole = dataclasses.replace(self, mesh=None, impl=impl)
        out = whole(full, seg_widths=seg_widths, valid_d=valid_d, key=key)
        return out[node_rows(self.mesh, self.n)].contiguous()

    def _quantized(self, x, seg_widths, valid_d, key):
        """Per-round nonlinear consensus. `valid_d` marks trailing flattened
        columns as padding (masked out of compressor statistics — they must
        be zero on input). Stochastic compressors draw round r of a call
        from `fold_in(fold_in(seed, key), r)`: callers in a step loop pass
        the step counter as `key` so the noise is fresh every step; `key=None`
        gives the same noise at every call."""
        key0 = self._key0(key)
        if self.stats in ("tile", "node"):
            from repro_torch.kernels.ops import quant_gossip_mix
            return quant_gossip_mix(x, self.sched, self.rounds,
                                    self.quantization, block_d=self.block_d,
                                    valid_d=valid_d, key=key0,
                                    per_node=self.stats == "node")
        if self.stats == "segment" and seg_widths is not None:
            # compress-once-broadcast: segment scales are invariant under the
            # node-axis roll (it permutes rows, the stats reduce over them),
            # so each round quantizes the buffer ONCE and rolls the
            # compressed copy
            for r in range(self.rounds):
                k = fold_in(key0, r) if key0 is not None else None
                q = make_compressor(self.quantization, key=k,
                                    seg_widths=seg_widths)(x)
                out = None
                for shift, w in self.sched:
                    term = w * (x if shift == 0 else torch.roll(q, shift, 0))
                    out = term if out is None else out + term
                x = out
            return x
        mask = None
        trailing = int(np.prod(x.shape[1:])) if x.dim() > 1 else 1
        if valid_d is not None and valid_d < trailing:
            mask = (torch.arange(trailing, device=x.device)
                    < valid_d).reshape(x.shape[1:])
        for r in range(self.rounds):
            k = fold_in(key0, r) if key0 is not None else None
            compress = make_compressor(self.quantization, key=k, mask=mask)
            x = roll_mix(x, self.sched, compress)
        return x


def resolve_auto_impl(device: DeviceLike = None, mesh: Any = None) -> str:
    """Pick the fastest execution strategy for `impl="auto"`: "shard" (the
    partitioning rule) when `mesh` splits the node axis over more than one
    rank; otherwise, on a single device, the fused CUDA kernel on the card
    and the dense circulant matmul on the CPU. (The reference picks its
    kernel on TPU only; on the card the kernel is the point of the port, so
    the CUDA branch takes it.)"""
    if is_sharded(mesh):
        return "shard"
    return "kernel" if resolve_device(device).type == "cuda" else "matmul"


def circulant_mix_op(sched: Schedule, n: int, rounds: int, *,
                     quantization: str = "none", impl: str = "auto",
                     fuse: bool = True, stats: str = "global",
                     block_d: int = 512, seed: int = 0,
                     device: DeviceLike = None,
                     mesh: Any = None) -> CirculantMixOp:
    """Build the circulant-path MixOp from a one-round schedule.

    The R-round operator is precomputed here, once, so the per-step cost is
    about one round. `fuse=False` keeps the per-round loop (oracle /
    baseline), as does any quantized config (nonlinear compressor —
    collapsing would change it); quantized configs pick their statistic
    granularity via `stats` and the tile width via `block_d`.
    `impl="auto"` resolves via `resolve_auto_impl(device, mesh)`.

    `mesh` (a `repro_torch.dist.Mesh`) splits the node axis over its ranks: the
    op then takes and returns each rank's rows. `impl="shard"` keeps the
    partitioning rule where it covers the (n, schedule, split)
    (`kernels.ops.node_shard_info`) and falls back to "roll" elsewhere (on
    a sharded mesh: gather, roll, keep the rank's rows), as the reference
    does; it keeps per-round semantics, so it carries no fused schedule."""
    if mesh is not None:
        check_mesh(mesh)
        if not is_sharded(mesh):
            mesh = None  # one rank holds every row: the unsharded op
    if impl not in ("auto", "roll", "matmul", "kernel", "shard"):
        raise ValueError(f"unknown MixOp impl {impl!r}")
    if stats not in ("global", "segment", "tile", "node"):
        raise ValueError(f"unknown quantizer stats mode {stats!r}")
    if quantization not in COMPRESSORS:
        raise ValueError(f"unknown quantization {quantization!r}")
    if impl == "auto":
        impl = resolve_auto_impl(device, mesh)
    if impl == "shard":
        from repro_torch.kernels.ops import node_shard_info
        if node_shard_info(mesh, n, sched) is None:
            impl = "roll"  # the rule does not cover this layout
    if quantization != "none" or not fuse or impl == "shard":
        return CirculantMixOp(sched, None, None, n, rounds, impl,
                              quantization, stats, block_d, seed, mesh)
    fused = compose_schedule(sched, rounds, n) if rounds > 0 else ((0, 1.0),)
    # the dense [n, n] operator is only needed by the matmul impl
    A_eff = (torch.as_tensor(schedule_matrix(fused, n), dtype=torch.float32)
             if impl == "matmul" else None)
    return CirculantMixOp(sched, fused, A_eff, n, rounds, impl, quantization,
                          stats, block_d, seed, mesh)


# ---------------------------------------------------------------------------
# Time-varying operators (ScheduledMixOp — scenario harness, eq. 17's
# B-connected graph sequences)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScheduledMixOp:
    """Time-varying R-round consensus operator: a stack of precomputed
    per-phase effective operators plus a round->phase lookup table, both
    tensors on the op's device. The active phase is picked on the device
    (`index_select` of the table, then of the stack), so switching topology
    or a lossy-link realization rebuilds nothing and syncs nothing with the
    host; the product is one `torch.matmul` of the [n, n] operator (in x's
    dtype, as the reference casts it) over the flattened node axis, as the
    reference's plain `jnp` product outside any Pallas kernel.

    `A_stack` [P, n, n] holds each phase's R-round operator, built as the
    static ops build theirs (`schedule_matrix(compose_schedule(...))` for
    circulant phases, `matrix_power` for dense ones); `phase_by_round`
    [period] maps the round counter t (mod period) to a phase.

    Linear only: `quantization` is always "none", and `key`, `seg_widths`
    and `valid_d` are accepted and ignored so the op is call-compatible with
    `CirculantMixOp` in `core.averaging` and `core.krasulina`. Callers pass
    the round counter `t` (the Krasulina carry's round index, or the
    optimizer step on the LM path) as an int or a 0-dim tensor on the op's
    device; `t=None` pins phase 0."""

    A_stack: torch.Tensor  # [P, n, n] f32 per-phase R-round operators
    phase_by_round: torch.Tensor  # [period] int64 round -> phase
    n: int
    rounds: int
    period: int
    quantization: str = "none"
    stats: str = "global"

    def operator(self, t=None, phase=None) -> torch.Tensor:
        """The [n, n] operator of round t (or of `phase`), on the device."""
        if phase is None:
            if t is None:
                return self.A_stack[0]
            if isinstance(t, torch.Tensor):
                idx = torch.remainder(t.reshape(1).long(), self.period)
            else:  # a host int: the slice is a view, no transfer
                idx = int(t) % self.period
                idx = slice(idx, idx + 1)
            phase = self.phase_by_round[idx]
        elif not isinstance(phase, torch.Tensor):
            return self.A_stack[int(phase)]
        return self.A_stack.index_select(0, phase.reshape(1))[0]

    def __call__(self, x: torch.Tensor, *, t=None, phase=None,
                 seg_widths: Optional[Tuple[int, ...]] = None,
                 valid_d: Optional[int] = None, key=None) -> torch.Tensor:
        del seg_widths, valid_d, key  # linear: no compressor statistics
        if x.shape[0] != self.n:
            raise ValueError(f"MixOp built for n={self.n} applied to node "
                             f"axis {x.shape[0]}")
        if self.rounds == 0 or self.n == 1:
            return x
        A = self.operator(t, phase).to(device=x.device, dtype=x.dtype)
        flat = x.reshape(self.n, -1)
        return (A @ flat).reshape(x.shape)

    @property
    def n_phases(self) -> int:
        return int(self.A_stack.shape[0])

    def phase_at(self, t: int) -> int:
        """Host-side phase lookup (tests / observability)."""
        return int(self.phase_by_round[int(t) % self.period])


def scheduled_mix_op(phases, n: int, rounds: int, phase_by_round=None, *,
                     device: DeviceLike = None) -> ScheduledMixOp:
    """Build a time-varying MixOp on `device` from per-phase one-round
    operators. Each entry of `phases` is a circulant `Schedule` (tuple of
    (shift, weight)) or a dense [n, n] doubly-stochastic matrix; its R-round
    operator is precomputed here, once, the way the static factories do
    (`compose_schedule` + `schedule_matrix` in f64 then f32 for circulants,
    f32 `matrix_power` for dense). `phase_by_round` maps round t -> phase
    index, cyclic with its length (default: round-robin over the phases)."""
    if not phases:
        raise ValueError("need at least one phase")
    mats = []
    for p in phases:
        if isinstance(p, tuple):  # circulant schedule
            eff = compose_schedule(p, rounds, n) if rounds > 0 else ((0, 1.0),)
            mats.append(torch.as_tensor(
                np.asarray(schedule_matrix(eff, n), np.float32)))
        else:
            A = torch.as_tensor(np.asarray(p, np.float32))
            if tuple(A.shape) != (n, n):
                raise ValueError(f"phase matrix shape {tuple(A.shape)} != "
                                 f"({n}, {n})")
            mats.append(torch.linalg.matrix_power(A, rounds)
                        if rounds > 1 else A)
    if phase_by_round is None:
        phase_by_round = tuple(range(len(mats)))
    lut = np.asarray(phase_by_round, np.int64)
    if lut.ndim != 1 or lut.size == 0:
        raise ValueError("phase_by_round must be a non-empty 1D sequence")
    if lut.min() < 0 or lut.max() >= len(mats):
        raise ValueError(f"phase ids must be in [0, {len(mats)}); got "
                         f"[{lut.min()}, {lut.max()}]")
    dev = resolve_device(device)
    return ScheduledMixOp(torch.stack(mats).to(dev),
                          torch.as_tensor(lut).to(dev), n, rounds,
                          int(lut.size))
