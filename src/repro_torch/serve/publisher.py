"""Train-to-serve snapshot publication
(docs/DESIGN.md §Train-to-serve publication).

The paper's premise is real-time incorporation of streaming data into the
*inference* model, so the consensus iterate the superstep loop maintains must
reach a serving replica without stalling either side. `SnapshotPublisher`
implements the bridge, as the reference's:

* **Double-buffered copies on the device.** `publish` runs the extract
  (e.g. the consensus mean over the node axis) and gives every published
  leaf its own memory: the extract's results are fresh, and a leaf that
  shares memory with the published tree (an exact run's parameters, passed
  through as they are) is cloned. The trainer updates its tensors in place,
  so the copy must land before the next superstep writes them: it runs on
  the current (training) CUDA stream, which orders it ahead of those
  writes, and `publish` returns once it is enqueued — the host pays the
  dispatch only. Two snapshots are live at any time (the published one and
  its predecessor, the back buffer); a reader that grabbed the old version
  keeps valid tensors for as long as it holds the reference.
* **Atomic version flip.** The published snapshot is swapped under a lock by
  a single reference assignment; `snapshot()` returns a consistent
  `(version, params, superstep, wall)` tuple or the previous one — never a
  mix. Versions are strictly monotone.
* **Publish-rate governor.** Each publish's host-side cost (dispatch wall
  time; the whole copy with `block=True`) feeds an EWMA, and a publish is
  skipped whenever `cost_ewma > overhead_budget x (time since the last
  publish)`. The first call always publishes.

The publisher is driven from `train.driver.StreamingDriver` at superstep
boundaries, outside the governor-timed window.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import dist as rdist
from repro_torch.core.packing import map_tensors

Tree = Any


class Snapshot(NamedTuple):
    """One published param version (immutable; safe to read from any thread)."""

    version: int
    params: Tree
    superstep: int  # trainer superstep the params were captured at
    published_at: float  # publisher clock at the flip


@dataclasses.dataclass
class PublisherStats:
    publishes: int = 0
    skipped_budget: int = 0  # governor verdict: cost would exceed the budget
    skipped_interval: int = 0  # below min_interval_s since the last publish
    cost_ewma_s: Optional[float] = None  # smoothed per-publish host cost
    total_cost_s: float = 0.0  # summed measured publish cost


def _memory(t: torch.Tensor) -> tuple:
    return t.device, t.untyped_storage().data_ptr()


class SnapshotPublisher:
    """Versioned, non-blocking param snapshots from trainer to server.

    `extract` maps the published tree (e.g. a TrainState) to the served
    params, its cost billed to the publish governor. It may take one
    auxiliary argument (e.g. a membership mask for the consensus mean over
    the node axis) passed through `maybe_publish(..., aux=...)`. Use
    `configure` to install an extract after construction (the driver does
    this when none was given).
    """

    def __init__(self, *, overhead_budget: float = 0.05,
                 min_interval_s: float = 0.0,
                 extract: Optional[Callable] = None,
                 block: bool = False, alpha: float = 0.5,
                 clock: Callable[[], float] = time.perf_counter):
        if overhead_budget < 0:
            raise ValueError(f"overhead_budget must be >= 0: {overhead_budget}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1]: {alpha}")
        self.overhead_budget = overhead_budget
        self.min_interval_s = min_interval_s
        self.block = block
        self.alpha = alpha
        self.clock = clock
        self.stats = PublisherStats()
        self._extract = extract
        self._lock = threading.Lock()
        self._snapshot: Optional[Snapshot] = None
        self._back: Optional[Snapshot] = None  # double buffer: previous version
        self._version = 0
        self._last_publish_t: Optional[float] = None
        self._mesh = None  # a split node axis's mesh (`configure`)

    def reset_stats(self, *, keep_ewma: bool = True) -> None:
        """Zero the counters for a fresh measurement window. The cost EWMA
        is kept by default — it is the governor's steady-state estimate."""
        self.stats = PublisherStats(
            cost_ewma_s=self.stats.cost_ewma_s if keep_ewma else None)

    def configure(self, *, extract: Optional[Callable] = None,
                  mesh: Any = None) -> None:
        """Install an extract fn if none was set (idempotent; the driver calls
        this so a bare `SnapshotPublisher()` publishes the consensus params of
        whatever workload it is attached to). `mesh`: the mesh of a run
        split over ranks, every rank of which runs a publisher; whether to
        publish and the version are then rank 0's, broadcast (the extract
        is collective there, and a rank that decided alone would hang the
        others), and every rank holds the same published params."""
        if extract is not None and self._extract is None:
            self._extract = extract
        if mesh is not None and rdist.multi_rank(mesh):
            self._mesh = mesh

    # ------------------------------------------------------------- publishing

    @torch.no_grad()
    def _copy(self, tree: Tree, *aux) -> Tree:
        out = self._extract(tree, *aux) if self._extract is not None else tree
        # the published leaves must not alias the trainer's state, which
        # the next superstep updates in place
        shared = set()
        map_tensors(lambda a: shared.add(_memory(a)), tree)
        return map_tensors(
            lambda a: a.clone() if _memory(a) in shared else a, out)

    def publish(self, tree: Tree, superstep: int, *, aux: Any = None) -> Snapshot:
        """Unconditional publish: enqueue the copy (non-blocking unless
        `block=True`), flip the snapshot atomically, bump the version."""
        t0 = self.clock()
        args = (tree,) if aux is None else (tree, aux)
        params = self._copy(*args)
        if self.block:
            devices = set()
            map_tensors(lambda a: devices.add(a.device), params)
            for dev in devices:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        cost = self.clock() - t0
        st = self.stats
        st.total_cost_s += cost
        st.cost_ewma_s = cost if st.cost_ewma_s is None else (
            self.alpha * cost + (1.0 - self.alpha) * st.cost_ewma_s)
        now = self.clock()
        with self._lock:
            self._version += 1
            snap = Snapshot(self._version, params, superstep, now)
            self._back = self._snapshot
            self._snapshot = snap
        self._last_publish_t = now
        st.publishes += 1
        return snap

    def maybe_publish(self, tree: Tree, superstep: int, *,
                      aux: Any = None) -> Optional[Snapshot]:
        """Governed publish: skip when the smoothed publish cost would exceed
        `overhead_budget` as a fraction of the wall time since the last
        publish (or when inside `min_interval_s`). Returns the new Snapshot,
        or None if skipped. Over a split mesh (`configure`), rank 0's
        verdict and version."""
        verdict = self._verdict()
        if self._mesh is not None:
            verdict, version = rdist.broadcast_object(
                (verdict, self._version), self._mesh)
            with self._lock:
                self._version = version
        if verdict != "publish":
            setattr(self.stats, "skipped_" + verdict,
                    getattr(self.stats, "skipped_" + verdict) + 1)
            return None
        return self.publish(tree, superstep, aux=aux)

    def _verdict(self) -> str:
        """"publish", or why not: "interval" or "budget"."""
        if self._last_publish_t is not None:
            elapsed = max(self.clock() - self._last_publish_t, 1e-12)
            if elapsed < self.min_interval_s:
                return "interval"
            ewma = self.stats.cost_ewma_s
            if (self.overhead_budget > 0 and ewma is not None
                    and ewma > self.overhead_budget * elapsed):
                return "budget"
        return "publish"

    # ------------------------------------------------------------ persistence

    def state_dict(self) -> dict:
        """JSON-serializable continuity state for checkpoint/restore
        (`train.snapshot`): the version counter and cost EWMA. The snapshot
        tensors are not persisted — served params are re-derived from the
        restored state at the next publish; what must survive a restart is
        version monotonicity."""
        st = self.stats
        return {"version": self._version, "cost_ewma_s": st.cost_ewma_s}

    def load_state_dict(self, state: dict) -> None:
        with self._lock:
            if state["version"] < self._version:
                raise ValueError(
                    f"publisher version would move backwards: "
                    f"{self._version} -> {state['version']}")
            self._version = int(state["version"])
        if state.get("cost_ewma_s") is not None:
            self.stats.cost_ewma_s = float(state["cost_ewma_s"])

    # ---------------------------------------------------------------- readers

    def snapshot(self) -> Optional[Snapshot]:
        """The currently published snapshot (None before the first publish).
        Safe from any thread; the returned tuple is immutable."""
        with self._lock:
            return self._snapshot

    @property
    def version(self) -> int:
        """Monotone version counter (0 before the first publish)."""
        with self._lock:
            return self._version

    def staleness(self, live_superstep: int) -> Optional[dict]:
        """How far the published snapshot lags the live iterate:
        `{"supersteps": ..., "wall_s": ...}` (None before the first
        publish)."""
        snap = self.snapshot()
        if snap is None:
            return None
        return {"supersteps": int(live_superstep) - snap.superstep,
                "wall_s": max(self.clock() - snap.published_at, 0.0)}
