"""Host-side streaming input pipeline: glues a sample source to the
streaming governor (core.streaming) and the driver.

The governor decides (B, mu) from the rate model; the pipeline yields
batches of exactly B samples per round, discarding mu, and tracks t'
(samples arrived) so training curves can be plotted against the paper's
x-axis. `StreamingPipeline` and `StreamCounters` are numpy, as in the JAX
package, so both packages deal identical batches from the same seed.

Streaming-engine extensions (see train.driver for the full picture):

* **Supersteps** — `next_superstep(K)` draws K governed rounds and stacks them
  on a new leading K axis, feeding the K-round loop of one superstep so the
  metric fetch is paid once per K rounds.
* **Async prefetch** — `DevicePrefetcher` runs the governed splitter in a
  background thread and stages the *next* superstep onto the device while
  the current one computes, overlapping host sample synthesis + H2D with
  device work (the compute/stream overlap of Fig. 4). On CUDA a staged
  batch is copied from pinned host memory, `non_blocking`, on a side
  stream; an event recorded after the copies is what the consumer's stream
  waits on before the batch is used, and each staged tensor is marked as
  used on the consumer's stream so its memory is not reused early.
  Each staged item carries a counter snapshot so consumer-visible accounting
  (`samples_arrived`, `samples_discarded`, `rounds`) stays coherent with the
  batch being trained on, not with how far ahead the producer has run.
* **Checkpoint continuity** — the splitter's exact stream position
  (counter quad + PRNG bit-generator state + live plan) is exported by
  `splitter_state()` / restored by `load_splitter_state()` (both from
  `GovernedPlanMixin`); the driver's prefetch `meta` carries it with each
  staged superstep for `train.snapshot`
  (docs/DESIGN.md §Fault-tolerant streaming).
* **Adaptive B** — `update_plan` may move B between the buckets of an adopted
  `core.rates.BucketLadder` mid-stream
  (docs/DESIGN.md §Adaptive batch buckets). The plan is latched once per
  superstep under a lock, so every
  superstep is dealt at a single width even when the swap lands from the
  consumer thread mid-production; supersteps already staged in the prefetch
  ring keep their old width (their samples were drawn — dropping them would
  lose stream samples) and drain through the old bucket's superstep, while
  each staged item's `meta` snapshot tells the consumer which plan dealt it.
* **Sharded node axis** — over a mesh that splits the nodes across ranks,
  every rank runs the same seeded splitter and keeps its own rows of the
  node axis (`shard_batch`): the reference's `P(None, dp)` batch sharding,
  in SPMD form.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import StreamConfig
from repro_torch.core.rates import BucketLadder, Plan, plan as make_plan
from repro_torch.core.streaming import GovernedPlanMixin


class StreamCounters(NamedTuple):
    """Splitter accounting as of a specific round (the paper's t' bookkeeping)."""

    samples_arrived: int
    samples_consumed: int
    samples_discarded: int
    rounds: int


class StreamingPipeline(GovernedPlanMixin):
    def __init__(self, sample_fn: Callable[[np.random.Generator, int], Dict[str, np.ndarray]],
                 stream_cfg: StreamConfig, n_nodes: int, rounds_R: int, *,
                 batch: Optional[int] = None, horizon: Optional[float] = None,
                 ladder: Optional[BucketLadder] = None, seed: int = 0):
        if stream_cfg.streaming_rate > 0:
            self.plan = make_plan(stream_cfg, n_nodes, rounds_R, B=batch,
                                  horizon_samples=horizon)
        else:
            self.plan = Plan(B=batch or n_nodes, mu=max(stream_cfg.forced_mu, 0),
                             R=rounds_R, Re=float("inf"), regime="resourceful")
        self.stream_cfg = stream_cfg
        self.sample_fn = sample_fn
        self.n_nodes = n_nodes
        # adopt_ladder / update_plan / last_superstep_plan: GovernedPlanMixin
        self._init_plan_state(ladder, horizon)
        self._rng = np.random.default_rng(seed)
        self.samples_arrived = 0
        self.samples_consumed = 0
        self.samples_discarded = 0
        self.rounds = 0

    def counters(self) -> StreamCounters:
        return StreamCounters(self.samples_arrived, self.samples_consumed,
                              self.samples_discarded, self.rounds)

    def _round(self, plan: Plan) -> Dict[str, np.ndarray]:
        B, mu = plan.B, plan.mu
        batch = self.sample_fn(self._rng, B + mu)
        batch = {k: v[:B] for k, v in batch.items()}  # splitter discards mu
        self.samples_arrived += B + mu
        self.samples_consumed += B
        self.samples_discarded += mu
        self.rounds += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._round(self._latch_plan())

    def next_superstep(self, k: int) -> Dict[str, np.ndarray]:
        """Draw K governed rounds and stack them: leaves [K, B, ...]. The
        plan is latched once for the whole superstep, so a concurrent
        `update_plan` can never produce ragged round widths within one
        stack."""
        plan = self._latch_plan()
        rounds = [self._round(plan) for _ in range(k)]
        out = {key: np.stack([r[key] for r in rounds]) for key in rounds[0]}
        self._last_superstep_plan = plan
        return out


def exact_split_error(B: int, n_nodes: int, ranks: int) -> Optional[str]:
    """Why a B-sample exact-mode batch of `n_nodes` nodes does not split
    evenly over `ranks` ranks (None when it does): each rank must hold the
    same share, whole nodes of equal runs, as the reference's
    `P(None, dp)` refuses an uneven split rather than train on part of
    the batch or weight the ranks unequally."""
    if n_nodes % ranks:
        return f"{n_nodes} nodes do not split evenly over {ranks} ranks"
    if B % n_nodes:
        return f"a batch of {B} samples does not split evenly over " \
               f"{n_nodes} nodes"
    return None


def shard_batch(batch: Dict[str, Any], mesh, n_nodes: int, *,
                node_axis: bool, membership=None) -> Dict[str, Any]:
    """This rank's part of a superstep batch on a `mesh` that splits
    `n_nodes` nodes over its ranks (the whole batch without one). With
    `node_axis` the leaves are [K, n_nodes, B/n_nodes, ...] and the rank
    keeps its node rows; under a partial `membership` (an elastic run's
    cohort: `core.mixing.Membership` of the n_nodes) they are
    [K, m, B/m, ...] over the m active nodes, and the rank keeps its
    active nodes' cohort rows (`dist.cohort_rows`), which may be none.
    Without `node_axis` (the exact mode), they are [K, B, ...],
    node j's samples the j-th of n_nodes equal runs, and the rank keeps
    its nodes' runs, an equal share: an uneven split raises ValueError
    (`exact_split_error`). The split is over the node (data) axes only:
    the ranks of one model group take the same rows."""
    from repro_torch.dist import (cohort_rows, is_sharded, n_data_nodes,
                                  node_index, node_rows)

    if not is_sharded(mesh):
        return batch
    rows = node_rows(mesh, n_nodes)
    if node_axis:
        if membership is not None and not membership.is_full:
            rows = slice(*cohort_rows(mesh, membership)[node_index(mesh)])
        return {k: v[:, rows] for k, v in batch.items()}
    out = {}
    for k, v in batch.items():
        B = v.shape[1]
        why = exact_split_error(B, n_nodes, n_data_nodes(mesh))
        if why:
            raise ValueError(f"exact mode on a sharded node axis: {why}")
        per = B // n_nodes
        out[k] = v[:, rows.start * per:rows.stop * per]
    return out


class _Stop:
    pass


def _tensors(staged: Any):
    if isinstance(staged, torch.Tensor):
        return [staged]
    values = staged.values() if isinstance(staged, dict) else staged
    return [t for t in values if isinstance(t, torch.Tensor)]


class _Raise(NamedTuple):
    exc: BaseException


def stage_batch(batch: Dict[str, np.ndarray],
                device: torch.device) -> Dict[str, torch.Tensor]:
    """H2D for one numpy batch. On CUDA each array is copied into pinned host
    memory and sent with a `non_blocking` copy on the current stream (the
    caching host allocator keeps the pinned block until that copy is done);
    on the CPU the tensors share the arrays' memory."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class DevicePrefetcher:
    """Depth-bounded prefetch ring between a host-side producer and the
    training loop: a daemon thread repeatedly calls `produce()` (host sample
    synthesis through the governed splitter) and stages the result onto
    `device` (`stage_batch`; without a device items pass through as they
    are) so the next superstep's transfer happens while the current
    superstep computes.

    On a CUDA `device` the staging runs on a side CUDA stream: pinned host
    memory, `non_blocking` copies, and an event recorded after them.
    `__next__` makes the consumer's current
    stream wait on that event and marks every staged tensor as used on that
    stream (`record_stream`), so the batch is neither read before it lands
    nor its memory handed back to the side stream while the consumer still
    reads it.

    `counters()` is sampled immediately after each produce; `__next__` returns
    the staged batch after adopting that snapshot into `self.counters`, so the
    consumer sees exactly the accounting a synchronous loop would have seen at
    that round — regardless of how far ahead the producer ring has run. The
    optional `meta` hook rides the same snapshot mechanism (e.g. the
    pipeline's `last_superstep_plan`, so the consumer knows which batch
    bucket a staged superstep was dealt at even while the ring drains items
    produced under a superseded plan).
    """

    def __init__(self, produce: Callable[[], Any], *,
                 counters: Optional[Callable[[], StreamCounters]] = None,
                 meta: Optional[Callable[[], Any]] = None,
                 depth: int = 2, device: Optional[torch.device] = None):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self._device = None if device is None else torch.device(device)
        self._side = (torch.cuda.Stream(device=self._device)
                      if self._device is not None
                      and self._device.type == "cuda" else None)
        self._produce = produce
        self._counters = counters or (lambda: None)
        self._meta = meta or (lambda: None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._final: Optional[Any] = None  # latched _Stop/_Raise terminal state
        self._undelivered: Optional[_Raise] = None  # error stranded by close()
        self._close_raised = False  # close() re-raises a pending error ONCE
        self._error_delivered = False  # __next__ already surfaced the error
        self.counters: Optional[StreamCounters] = None
        self.meta: Optional[Any] = None
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def _staged(self, item: Any):
        """Stage one item (`stage_batch` onto `device`, or as it is without
        one); on CUDA, on the side stream, returning the event the consumer
        must wait on (None elsewhere)."""
        if self._device is None:
            return item, None
        if self._side is None:
            return stage_batch(item, self._device), None
        with torch.cuda.stream(self._side):
            staged = stage_batch(item, self._device)
            ready = torch.cuda.Event()
            ready.record(self._side)
        return staged, ready

    def _put_stopaware(self, item: Any) -> bool:
        """Bounded-ring put that wakes promptly when close() sets the stop
        event (a plain blocking put could deadlock against close()'s drain).
        Returns False when the item could not be delivered because the ring
        was shut down first — terminal `_Raise` items must then be stashed,
        not dropped, or a pending producer error would vanish."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    item = self._produce()
                except StopIteration:
                    break
                snap = self._counters()
                meta = self._meta()
                staged, ready = self._staged(item)
                self._put_stopaware((staged, snap, meta, ready))
        except BaseException as e:  # surface producer failures at the consumer
            if not self._put_stopaware(_Raise(e)):
                self._undelivered = _Raise(e)
            return
        self._put_stopaware(_Stop())

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self):
        # once the worker has signalled termination, nothing will ever be
        # enqueued again — keep resolving without touching the queue
        got = self._final if self._final is not None else self._q.get()
        if isinstance(got, _Stop):
            self._final = got
            raise StopIteration
        if isinstance(got, _Raise):
            self._final = got
            self._error_delivered = True
            raise got.exc
        staged, snap, meta, ready = got
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for t in _tensors(staged):
                t.record_stream(consumer)
        if snap is not None:
            self.counters = snap
        if meta is not None:
            self.meta = meta
        return staged

    def _drain(self) -> Optional[_Raise]:
        """Empty the ring; return the last pending `_Raise` found, if any."""
        pending = None
        try:
            while True:
                item = self._q.get_nowait()
                if isinstance(item, _Raise):
                    pending = item
        except queue.Empty:
            pass
        return pending

    def close(self) -> None:
        """Shut the ring down. Never deadlocks against a worker blocked on a
        full ring (`_put_stopaware` polls the stop event), and re-raises a
        producer error that was still pending — staged in the ring or
        stranded by the shutdown itself — exactly once; an error already
        delivered through `__next__` is not raised again. Idempotent
        otherwise."""
        self._stop.set()
        # drain so a blocked producer can observe the stop event
        pending = self._drain()
        self._thread.join(timeout=5.0)
        # the worker may have enqueued (or stashed) its error between the
        # first drain and its exit
        pending = self._drain() or pending or self._undelivered
        self._undelivered = None
        if self._final is None:
            # nothing will ever be enqueued again: a post-close __next__
            # must not block on the dead worker
            self._final = pending if pending is not None else _Stop()
        if (pending is not None and not self._error_delivered
                and not self._close_raised):
            self._close_raised = True
            raise pending.exc

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
