"""Full-loop async checkpoint/restore for the streaming engine
(docs/DESIGN.md §Fault-tolerant streaming).

The stream cannot be replayed — samples not processed within a superstep are
discarded by design (eq. 4's mu) — so a crash without checkpoints loses the
run. `RunSnapshotter` captures the COMPLETE run state at the superstep
boundary, as the reference's:

* the training state (tensors on the card; Python round counters),
* the splitter's exact stream position — `StreamCounters` quad + PRNG
  bit-generator state + the plan that dealt the last *consumed* superstep
  (`GovernedPlanMixin.splitter_state`, threaded through the prefetch ring's
  `meta` hook so staged-but-unconsumed supersteps are re-dealt on resume,
  not skipped),
* the governor: `RoundTimeEstimator` window, `BucketHysteresis` streak,
  per-signature warm-up counts, the live post-replan `Plan`,
* elastic membership: the active `Membership` and `StragglerPolicy`
  per-node EWMAs / debounce verdicts,
* the publisher's version counter (monotone across restart).

**The copy.** The reference snapshots with a jitted `a + 0` on the device,
which needs a second copy of the state there; at the LM trainer's full width
that does not fit beside the state. The writer needs host arrays anyway, so
here `maybe_snapshot` copies every tensor straight into pinned host buffers
with `non_blocking` copies on the current (training) CUDA stream and records
a CUDA event after them. The trainer updates its tensors in place, and the
stream orders the copies ahead of the next superstep's writes; the training
thread pays the dispatch only. The writer thread waits on the event, then
runs `checkpoint.save`. One set of buffers is enough: the depth-1 discipline
never has two snapshots in flight. On the CPU the copy is a plain `clone()`.

The writer does the retried leaf writes, the atomic manifest, and last-k
retention (`train.checkpoint`); a failed save is recorded in
`SnapshotStats` and never propagates into the training thread.

Snapshot cadence is governed twice: a superstep cadence (`every`) and an
EWMA cost governor mirroring the publisher's — the smoothed training-thread
dispatch cost must stay under `overhead_budget` x the wall time since the
last snapshot.

`restore_driver` rebuilds a `StreamingDriver` mid-stream from the newest
*valid* checkpoint (torn saves are skipped — `train.checkpoint.newest_valid`)
with exact counter/plan/cohort continuity: on the deterministic clock in
exact mode the resumed run is bit-identical to the uninterrupted one. The
checkpoint is in the reference's layout, so either package resumes from
the other's.

**A node axis split over ranks.** Every rank runs a snapshotter, bound to
the driver's mesh (`bind`, which the driver calls on every rank at
set-up). Each rank copies its own rows, and the writers save one
checkpoint together (`checkpoint.save(mesh=...)`: each rank writes its
rows, rank 0 the manifest). The writers' messages go over a process group
of their own, made at `bind`: gloo does not order two threads' messages
on one group, and the training thread's go over the mesh's; over a model
axis they also join each leaf's blocks over model and data groups of
their own (`checkpoint.save(specs=...)`). Whether to
snapshot is rank 0's decision (cadence, cost governor, a busy writer),
broadcast to the others, which wait for their own writer where it is
still finishing: a rank that decided alone would leave the others waiting
at the writers' messages. A resume restores every rank's rows in place
and the meta of rank 0's manifest, and needs nothing of the split it was
written on.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch import dist as rdist
from repro_torch.core.mixing import Membership
from repro_torch.core.packing import map_tensors
from repro_torch.core.rates import Plan
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import checkpoint


@dataclasses.dataclass
class SnapshotStats:
    saves: int = 0  # durable manifests written by the writer thread
    dispatches: int = 0  # snapshots handed to the writer
    skipped_cadence: int = 0  # not on the `every` superstep grid
    skipped_budget: int = 0  # EWMA cost would exceed the overhead budget
    skipped_busy: int = 0  # writer still on the previous snapshot
    failures: int = 0  # saves that exhausted retries (training unaffected)
    last_error: Optional[str] = None
    cost_ewma_s: Optional[float] = None  # smoothed training-thread dispatch cost
    total_cost_s: float = 0.0  # summed training-thread dispatch cost
    write_s: float = 0.0  # summed writer time (the wait on the copy included)
    bytes_per_save: int = 0  # tensor bytes copied per snapshot


def capture_meta(driver) -> dict:
    """Everything host-side a resumed driver needs, as one JSON-serializable
    dict (the reference's keys). Captured at the superstep boundary AFTER
    `_observe` (replan) and publication, so the live plan is the post-replan
    one that deals future supersteps, while the splitter snapshot pins the
    stream position of the last consumed superstep."""
    return {
        "supersteps_done": int(driver._supersteps_done),
        "splitter": (driver._last_splitter_state
                     if driver._last_splitter_state is not None
                     else driver.pipeline.splitter_state()),
        "live_plan": driver.pipeline.plan.to_json(),
        "last_round_s": driver._last_round_s,
        "sig_seen": [[int(b), int(m), int(c)]
                     for (b, m), c in sorted(driver._sig_seen.items())],
        "hysteresis": driver._hysteresis.state_dict(),
        "estimator": (driver._estimator.state_dict()
                      if driver._estimator is not None else None),
        "straggler": (driver._straggler.state_dict()
                      if driver._straggler is not None else None),
        "membership": (driver._membership.to_json()
                       if driver._membership is not None else None),
        "publisher": (driver._publisher.state_dict()
                      if driver._publisher is not None else None),
    }


def _model_of(driver):
    """The LM state's model config (its checkpoint layout), or None."""
    return getattr(getattr(driver, "run_cfg", None), "model", None)


def _specs_of(driver):
    """The placements of the driver's state over its mesh's model axis
    (`train.trainer.state_placements`), or None."""
    mesh = getattr(driver, "mesh", None)
    if rdist.model_extent(mesh) == 1:
        return None
    from repro_torch.train.trainer import state_placements

    return state_placements(driver.run_cfg, mesh, driver.state)


def restore_driver(driver, root_or_path: str) -> str:
    """Restore a freshly constructed `StreamingDriver` to the exact point a
    snapshot was taken. `root_or_path` is either a snapshot root (the newest
    valid step directory is selected — torn saves are skipped) or one step
    directory. Returns the path restored from; raises FileNotFoundError when
    no valid checkpoint exists.

    The state's tensors receive the checkpoint in place (on their device
    and dtype). The driver must be constructed with the same config the
    snapshot was taken under (same N, R, buckets, workload); derived objects
    — cohort ladders, built supersteps — are rebuilt lazily, exactly as the
    uninterrupted run built them.

    On a node axis split over ranks every rank calls this (the driver does,
    on every rank), and each restores its rows of the state. The ranks try
    rank 0's step directories newest first: a split restore checks every
    rank's CRC32s before it lands a leaf, so one that fails (on every rank
    alike) leaves the state as it was, and the next older one is tried."""
    mesh = getattr(driver, "mesh", None)
    model = _model_of(driver)
    if rdist.multi_rank(mesh):
        path = _restore_split(driver, root_or_path, model, mesh)
    else:
        if checkpoint.list_steps(root_or_path):
            path = checkpoint.newest_valid(root_or_path)
            if path is None:
                raise FileNotFoundError(
                    f"no valid checkpoint under {root_or_path!r} "
                    f"(every step directory is torn or corrupt)")
        elif checkpoint.is_valid(root_or_path):
            path = root_or_path
        else:
            raise FileNotFoundError(
                f"no valid checkpoint at {root_or_path!r}")
        driver.state = checkpoint.restore(path, driver.state, model=model,
                                          into=True)
    meta = checkpoint.load_manifest(path)["meta"]

    live_plan = Plan.from_json(meta["live_plan"])
    mem = meta.get("membership")
    if mem is not None:
        membership = Membership.from_json(mem)
        driver._membership = membership
        # cohort ladders re-derive from the full-membership base ladder, so a
        # rejoin after resume restores the same buckets (and re-uses the same
        # built supersteps) the uninterrupted run would
        driver.ladder = driver._ladder_for(membership.n_active)
    driver.pipeline.ladder = driver.ladder
    driver.pipeline.load_splitter_state(meta["splitter"], plan=live_plan)

    driver._supersteps_done = int(meta["supersteps_done"])
    driver._last_round_s = meta.get("last_round_s")
    driver._sig_seen = {(int(b), int(m)): int(c)
                        for b, m, c in meta.get("sig_seen", [])}
    driver._last_splitter_state = meta["splitter"]
    driver._hysteresis.load_state_dict(meta["hysteresis"])
    if meta.get("estimator") is not None and driver._estimator is not None:
        driver._estimator.load_state_dict(meta["estimator"])
    if meta.get("straggler") is not None and driver._straggler is not None:
        driver._straggler.load_state_dict(meta["straggler"])
    if meta.get("publisher") is not None and driver._publisher is not None:
        driver._publisher.load_state_dict(meta["publisher"])
    return path


def _restore_split(driver, root_or_path: str, model, mesh) -> str:
    """`restore_driver`'s checkpoint on a split node axis or a model
    axis: the newest of rank 0's step directories under `root_or_path`
    (or that directory) whose restore passes, restored into this rank's
    rows and blocks."""
    steps = rdist.broadcast_object(checkpoint.list_steps(root_or_path), mesh)
    paths = ([checkpoint.step_dir(root_or_path, s) for s in reversed(steps)]
             if steps else [root_or_path])
    n_nodes = driver.n_nodes if driver.decentralized else None
    specs = _specs_of(driver)
    for path in paths:
        try:
            driver.state = checkpoint.restore(path, driver.state, model=model,
                                              into=True, mesh=mesh,
                                              n_nodes=n_nodes, specs=specs)
            return path
        except (OSError, ValueError):  # torn or corrupt, on every rank
            continue
    raise FileNotFoundError(
        f"no valid checkpoint {'under' if steps else 'at'} "
        f"{root_or_path!r}")


class _Flush:
    pass


class RunSnapshotter:
    """Async snapshot writer for `StreamingDriver` (attach via the driver's
    `snapshotter=` argument; `maybe_snapshot` runs at every superstep
    boundary, outside the governor-timed window).

    `every` is the superstep cadence (a snapshot is considered every
    `every`-th superstep); `overhead_budget` caps the smoothed
    training-thread dispatch cost as a fraction of wall time between
    snapshots; `keep_last` is the retention depth (`train.checkpoint.prune`);
    `retries`/`backoff_s` feed the writer's retry-with-backoff around leaf
    writes. `block=True` makes `maybe_snapshot` wait for the durable
    manifest — for deterministic tests, never production."""

    def __init__(self, root: str, *, every: int = 1, keep_last: int = 3,
                 overhead_budget: float = 0.05, retries: int = 3,
                 backoff_s: float = 0.05, block: bool = False,
                 alpha: float = 0.5,
                 clock: Callable[[], float] = time.perf_counter):
        if every < 1:
            raise ValueError(f"snapshot cadence must be >= 1: {every}")
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1: {keep_last}")
        if overhead_budget < 0:
            raise ValueError(f"overhead_budget must be >= 0: {overhead_budget}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1]: {alpha}")
        self.root = root
        self.every = every
        self.keep_last = keep_last
        self.overhead_budget = overhead_budget
        self.retries = retries
        self.backoff_s = backoff_s
        self.block = block
        self.alpha = alpha
        self.clock = clock
        self.stats = SnapshotStats()
        self.mesh = None  # a split node axis's or a model axis's mesh
        self._group = None  # the writers' own process group (`bind`)
        self._wmesh = None  # the mesh the writers save over (`bind`)
        self._pinned: List[torch.Tensor] = []  # host buffers, leaf order
        self._last_dispatch_t: Optional[float] = None
        self._in_flight: Optional[threading.Event] = None  # last save's done
        # depth-1 ring: at most one snapshot in flight; a second arriving
        # while the writer is mid-save is skipped (the next cadence hit
        # takes a fresher one anyway) rather than queueing copies
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="snapshot-writer")
        self._thread.start()

    def bind(self, mesh) -> None:
        """Snapshot a driver whose node axis `mesh` splits over ranks: make
        the writers' process group (`dist.new_group`, which every rank of
        the default group enters: call it on every rank, at set-up, in the
        same order as the other groups). Idempotent; nothing on one
        process."""
        if not rdist.multi_rank(mesh) or self.mesh is not None:
            return
        world = dist.get_world_size(mesh.group)
        self._group = dist.new_group(
            [r if mesh.group is None else dist.get_global_rank(mesh.group, r)
             for r in range(world)])
        # over a model axis the writers join the blocks over model and data
        # groups of their own, beside their own copy of the mesh's
        self._wmesh = (make_mesh(mesh.sizes, mesh.axis_names,
                                 group=self._group)
                       if rdist.model_extent(mesh) > 1 else mesh)
        self.mesh = mesh

    # ------------------------------------------------------------- capture

    def _stage(self, state: Any):
        """The state's tensors copied to the host: into the pinned buffers
        with `non_blocking` copies on the current stream (tensors on the
        card), or cloned (on the CPU). Returns the host tree, the event the
        writer waits on (None without the card) and the bytes copied."""
        counter = [0, 0]
        cuda = []

        def copy(t: torch.Tensor) -> torch.Tensor:
            counter[1] += t.numel() * t.element_size()
            if t.device.type != "cuda":
                return t.detach().clone()
            j = counter[0]
            counter[0] += 1
            if j == len(self._pinned):
                self._pinned.append(torch.empty(t.shape, dtype=t.dtype,
                                                pin_memory=True))
            elif (self._pinned[j].shape != t.shape
                  or self._pinned[j].dtype != t.dtype):
                self._pinned[j] = torch.empty(t.shape, dtype=t.dtype,
                                              pin_memory=True)
            cuda.append(t.device)
            return self._pinned[j].copy_(t.detach(), non_blocking=True)

        host = map_tensors(copy, state)
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(cuda[0]))
        return host, ready, counter[1]

    def maybe_snapshot(self, driver) -> Optional[Dict[str, Any]]:
        """Snapshot the driver if the cadence and the cost governor allow.
        Returns {"step", "path"} when a snapshot was dispatched (with
        `block=True`, when it is durable), else None. Never blocks on disk
        and never raises for I/O trouble — a failed save shows up in
        `stats.failures` and the next cadence hit tries again."""
        step = driver._supersteps_done
        verdict = self._verdict(step)
        if self.mesh is not None:  # rank 0's decision
            verdict = rdist.broadcast_object(verdict, self.mesh)
        if verdict != "snapshot":
            setattr(self.stats, "skipped_" + verdict,
                    getattr(self.stats, "skipped_" + verdict) + 1)
            return None
        if self.mesh is not None and self._in_flight is not None:
            self._in_flight.wait()  # this rank's writer, finishing
        t0 = self.clock()
        host, ready, nbytes = self._stage(driver.state)
        meta = capture_meta(driver)
        done = threading.Event()
        path = checkpoint.step_dir(self.root, step)
        # the node axis's rows in all (a split axis's checkpoint)
        n_nodes = (driver.n_nodes if self.mesh is not None
                   and driver.decentralized else None)
        item = (step, host, ready, meta, _model_of(driver), n_nodes,
                _specs_of(driver), done)
        if self.mesh is not None:  # rank 0 decided: every rank's writer
            self._q.put(item)  # takes part, once its queue has room
        else:
            try:
                self._q.put_nowait(item)
            except queue.Full:  # raced with a straggling writer
                self.stats.skipped_busy += 1
                return None
        self._in_flight = done
        cost = self.clock() - t0
        st = self.stats
        st.dispatches += 1
        st.total_cost_s += cost
        st.bytes_per_save = nbytes
        st.cost_ewma_s = cost if st.cost_ewma_s is None else (
            self.alpha * cost + (1.0 - self.alpha) * st.cost_ewma_s)
        self._last_dispatch_t = self.clock()
        if self.block:
            done.wait()
        return {"step": step, "path": path}

    def _verdict(self, step: int) -> str:
        """"snapshot", or why not: "cadence", "budget" or "busy"."""
        if step % self.every != 0:
            return "cadence"
        if self._last_dispatch_t is not None and self.overhead_budget > 0:
            elapsed = max(self.clock() - self._last_dispatch_t, 1e-12)
            ewma = self.stats.cost_ewma_s
            if ewma is not None and ewma > self.overhead_budget * elapsed:
                return "budget"
        # depth-1 discipline: at most one snapshot in flight — the queue can
        # be empty while the writer is still mid-save, so busy-ness is the
        # previous save's done event, not queue occupancy (the pinned
        # buffers are the writer's until then)
        if (self._q.full() or
                (self._in_flight is not None and not self._in_flight.is_set())):
            return "busy"
        return "snapshot"

    # -------------------------------------------------------------- writer

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, tuple) and isinstance(item[0], _Flush):
                item[1].set()
                continue
            step, host, ready, meta, model, n_nodes, specs, done = item
            t0 = time.perf_counter()
            try:
                if ready is not None:
                    ready.synchronize()
                checkpoint.save(checkpoint.step_dir(self.root, step), host,
                                step=step, meta=meta, retries=self.retries,
                                backoff_s=self.backoff_s, model=model,
                                mesh=self._wmesh, n_nodes=n_nodes,
                                group=self._group, specs=specs)
                if self.mesh is None or self.mesh.rank == 0:
                    checkpoint.prune(self.root, self.keep_last)
                self.stats.saves += 1
            except Exception as e:  # never kill the training thread
                self.stats.failures += 1
                self.stats.last_error = f"{type(e).__name__}: {e}"
            finally:
                self.stats.write_s += time.perf_counter() - t0
                done.set()

    def flush(self) -> None:
        """Wait until every dispatched snapshot is durable (or failed)."""
        if self._closed:
            return
        done = threading.Event()
        self._q.put((_Flush(), done))
        done.wait()

    def close(self) -> None:
        """Flush pending snapshots and stop the writer (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=30.0)

    def __enter__(self) -> "RunSnapshotter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
