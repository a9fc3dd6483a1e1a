"""Superstep streaming engine: the execution loop that keeps the device fed at
the rate the paper's analysis assumes — the single-device path of
`repro.train.driver`, elastic membership included.

The paper's Fig. 3(c) splits a streaming learner into a *splitter* (one node
receives the stream and deals B samples per round, discarding mu) and the
*compute network* (N nodes process their B/N shares, then average). Fig. 4
shows why the split matters: whenever the stream outpaces the effective
processing rate R_e (eq. 4), samples pile up or drop. The driver runs three
stages:

1. **Splitter (host thread)** — `data.pipeline.StreamingPipeline` runs the
   governed splitter of Fig. 3(c): per round it draws B + mu samples, keeps B,
   and stacks K rounds into one superstep batch (leading K axis).
2. **Stage (H2D overlap)** — `data.pipeline.DevicePrefetcher` stages the
   *next* superstep onto the device (pinned memory, side CUDA stream) from a
   background thread while the current superstep computes.
3. **Compute (device)** — a superstep runs the K rounds and returns the K
   per-round metrics stacked on the device; the driver fetches them with ONE
   host copy per superstep, which is also the superstep's one
   synchronisation, so the timed window covers the device work and not only
   its launches.

Any superstep of signature `superstep(state, batches) -> (state, metrics)`
(batch leaves [K, ...], metric leaves stacked [K]) plugs in via
`superstep_fn`, or bucket-keyed via `superstep_builder` (`build(B) ->
superstep`, e.g. `core.krasulina.krasulina_superstep_builder`); when both
are omitted the LM trainer's builder (`train.trainer.superstep_builder`) is
built here, as in the reference. `run_cfg` only needs `.stream` and
`.averaging` (e.g. `configs.paper_pca.PCARunConfig`) when a superstep is
passed, and is a full `RunConfig` for the LM trainer.

Closing the loop, the driver times every superstep, inverts eq. 4 to get the
*measured* R_p / R_e (`core.rates.measured_processing_rate`), and re-plans
(B, mu) via `core.rates.replan`; with a multi-bucket `GovernorConfig` ladder
B may move between registered buckets, an online
`core.rates.RoundTimeEstimator` estimates (R_p, R_c), switches are debounced
(`core.rates.BucketHysteresis`), and the first supersteps of every new
bucket are excluded from governor input
(docs/DESIGN.md §Adaptive batch buckets). The clock is read exactly twice
per superstep, as in the reference, so a fake clock drives both governors
identically.

Elastic membership (docs/DESIGN.md §Elastic membership): a
`core.faults.FaultSchedule` with node faults, or a straggler policy other
than "wait", makes joins and leaves plan swaps on the governed pipeline.
Each membership change re-deals at the cohort (B snapped onto the cohort's
ladder), the superstep of each (bucket, cohort size) is built once and
reused, supersteps already staged drain under the cohort that dealt them,
and a rejoining node can be synced to the cohort's mean. A cohort superstep
runs on the active rows of the full [N, ...] state: gathered and scattered
back by `elastic_superstep`, or in place when the superstep takes the ids
itself (the LM trainer's, whose state is too large to gather). Link faults
alone (loss, bandwidth) keep the full node axis and add `bw_factor` and
`link_drops` to the history records.

Train-to-serve publication (docs/DESIGN.md §Train-to-serve publication):
a `serve.publisher.SnapshotPublisher` passed as `publisher=` is offered the
state at every superstep boundary, after the timed window; it publishes the
consensus mean over the active nodes (`train.trainer.publish_extract`)
under its own cost governor. Fault tolerance (docs/DESIGN.md
§Fault-tolerant streaming): a `train.snapshot.RunSnapshotter` passed as
`snapshotter=` runs after the publisher at the same boundary, and
`resume_from=` (a snapshot root or one step directory) restores the state,
the splitter's stream position, the governor, the membership and the
publisher's version before the first superstep, so the resumed run deals
and trains what the uninterrupted one would have.

Sharded node axis: with a `repro_torch.dist.Mesh` that splits the nodes over
the ranks of a process group, every rank runs this driver (SPMD): the same
seeded splitter deals every rank the same stream, and each keeps its own
rows of the node axis, or in the exact mode its nodes' equal share of the
batch (`data.pipeline.shard_batch`; buckets that do not split evenly over
the ranks raise). The governor re-plans from measured round times, which
differ between ranks; so rank 0's clock is the one that counts: its
superstep time is broadcast before the governor reads it, and the governor,
deterministic in it, makes the same plan on every rank, so the shapes every
rank deals never diverge (the reference has one controller and one clock).
The splitter runs synchronously on a sharded axis (no prefetch ring): a
superstep dealt ahead under a plan that another rank has already replaced
would deal different widths on different ranks.

Elastic membership runs there too. The fault schedule and the straggler
policy are deterministic in the superstep and in rank 0's round times, so
every rank resolves the same cohort; each superstep checks that against
rank 0's (`dist.broadcast_object`) and raises on a rank that diverged,
which would otherwise hang the group. A cohort's active ids split over the
ranks as contiguous, uneven runs of cohort rows (`dist.cohort_rows`; a rank
may hold none, and still joins every message): each rank is dealt its
active nodes' rows of the batch and hands the cohort superstep its own
active rows as local indices; a superstep is built per (bucket, cohort row
table), the compiled signatures staying (bucket, cohort size). A rejoin
sync all-reduces the donors' f32 sum. Publication, snapshots and resuming
run there too: the publisher's and the snapshotter's decisions are rank
0's, the published consensus iterate is an all-reduce of the ranks'
masked row sums (`train.trainer.publish_extract`), every rank writes its
own rows of one checkpoint in the reference's layout and restores its rows
from any checkpoint of the same run, split or not (`train.snapshot`).
Over a model axis the same: each leaf's blocks are joined before their
rows are written, and cut again from the rows a rank reads.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import dist as rdist
from repro_torch.configs.base import GovernorConfig
from repro_torch.core import rates
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.mixing import Membership
from repro_torch.data.pipeline import (DevicePrefetcher, StreamCounters,
                                       StreamingPipeline, exact_split_error,
                                       shard_batch, stage_batch)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import (check_mesh, is_sharded, multi_rank,
                              n_data_nodes)
from repro_torch.train.trainer import (make_node_batch, publish_extract,
                                       superstep_builder as lm_superstep_builder)


def _map_state(fn: Callable, state: Any, *others: Any) -> Any:
    """`fn` on the leaves of `state` (nested NamedTuples, dicts, lists and
    tuples of tensors and Python numbers), matched with the same leaves of
    `others`."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_map_state(fn, *xs)
                             for xs in zip(state, *others)))
    if isinstance(state, dict):
        return {k: _map_state(fn, state[k], *(o[k] for o in others))
                for k in state}
    if isinstance(state, (list, tuple)):
        return type(state)(_map_state(fn, *xs) for xs in zip(state, *others))
    return fn(state, *others)


def _node_rows(p: Any, n: int) -> bool:
    """Whether a state leaf carries the full node axis [n, ...]."""
    return isinstance(p, torch.Tensor) and p.dim() > 0 and p.shape[0] == n


def elastic_superstep(cohort_fn: Callable, n_full: int) -> Callable:
    """Adapt a cohort-sized superstep to the full node axis
    (docs/DESIGN.md §Elastic membership).

    State leaves keep their full [n_full, ...] extent across membership
    changes; the wrapper gathers the active rows `ids`, runs the cohort
    superstep on the dense [m, ...] block, and writes the results back into
    those rows — dropped rows pass through untouched (their mixing row has
    degraded to self-weight 1). Every other leaf (a 0-dim tensor, a Python
    round counter) takes the cohort's new value. `ids` is a sequence of
    node indices or an index tensor, so every membership of one cohort size
    shares one superstep.

    A cohort superstep that declares `takes_ids = True` works on the active
    rows of the full state itself, `cohort_fn(state, ids, batches)`, and is
    returned as it is: the LM trainer's, whose state cannot be gathered
    beside itself at full width."""
    if getattr(cohort_fn, "takes_ids", False):
        return cohort_fn
    cache: Dict[Tuple[torch.device, Tuple[int, ...]], torch.Tensor] = {}

    def index(ids, device: torch.device) -> torch.Tensor:
        key = (device, tuple(int(i) for i in ids))
        t = cache.get(key)
        if t is None:
            t = torch.as_tensor(key[1], dtype=torch.long, device=device)
            cache[key] = t
        return t

    def fn(state, ids, batches):
        if isinstance(ids, torch.Tensor):
            ids = ids.tolist()

        def take(p):
            return (p.index_select(0, index(ids, p.device))
                    if _node_rows(p, n_full) else p)

        def put(p, sub):
            if _node_rows(p, n_full):
                p.index_copy_(0, index(ids, p.device), sub.to(p.dtype))
                return p
            return sub

        sub, metrics = cohort_fn(_map_state(take, state), batches)
        return _map_state(put, state, sub), metrics

    return fn


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs of the streaming engine (all host-side)."""

    superstep: int = 8  # K: rounds folded into one superstep
    # staged supersteps in flight; 0 = synchronous. Depth 1 covers
    # steady-state host synthesis, depth 2 also absorbs scheduling jitter
    prefetch_depth: int = 2
    replan_every: int = 1  # supersteps between governor re-plans; 0 = open loop
    # supersteps whose timings the governor ignores on the INITIAL bucket:
    # the first calls pay one-off costs (kernel build and load, allocator
    # warm-up), and treating them as processing time would make replan
    # discard thousands of samples for a one-off cost
    warmup_supersteps: int = 2
    # same gate for every bucket first visited later in the run
    warmup_per_bucket: int = 1
    # the adaptive-B bucket ladder + online (R_p, R_c) estimator; the default
    # (single-bucket) config pins B and adapts mu only
    governor: GovernorConfig = GovernorConfig()


class StreamingDriver:
    """Owns the three-stage loop: governed splitter -> prefetch ring ->
    K-round superstep on the device, plus the closed-loop (B, mu) governor.

    Without a `mesh` it drives one device with an explicit `n_nodes`. With
    one (`repro_torch.dist.Mesh`), every rank of its group runs the driver
    on its rows of the node axis; `n_nodes` defaults to `n_data_nodes(mesh)`
    (one node per rank). Over a model axis (the LM trainer's only: another
    run config refuses one) the ranks of a model group take the same rows
    and hold their blocks of them; every rank steps in lockstep on rank 0's
    plan. `clock` is injectable so tests can fake slow hardware and watch
    the governor raise mu.
    """

    def __init__(self, run_cfg, mesh, state: Any,
                 sample_fn: Callable[[np.random.Generator, int], Dict[str, np.ndarray]],
                 *, superstep_fn: Optional[Callable] = None,
                 superstep_builder: Optional[Callable[[int], Callable]] = None,
                 engine: EngineConfig = EngineConfig(),
                 batch: Optional[int] = None, horizon: Optional[float] = None,
                 n_nodes: Optional[int] = None, seed: int = 0,
                 clock: Callable[[], float] = time.perf_counter,
                 faults: Optional[FaultSchedule] = None,
                 publisher: Optional[Any] = None,
                 snapshotter: Optional[Any] = None,
                 resume_from: Optional[str] = None,
                 device: DeviceLike = None):
        if engine.superstep < 1:
            raise ValueError("superstep K must be >= 1")
        if mesh is not None and getattr(run_cfg, "model", None) is None:
            check_mesh(mesh, "a driver without an LM trainer")
        if n_nodes is None:
            if mesh is None:
                raise ValueError("pass n_nodes when driving without a mesh")
            n_nodes = n_data_nodes(mesh)
        # the ranks of a split node axis or of a model axis step in lockstep
        self._sharded = multi_rank(mesh)
        self.device = resolve_device(device)
        self.run_cfg = run_cfg
        self.mesh = mesh
        self.state = state
        self.engine = engine
        self.clock = clock
        self.decentralized = run_cfg.averaging.mode != "exact"
        self.n_nodes = n_nodes
        self._horizon = horizon
        gov = engine.governor
        # elastic membership: NODE faults and/or a non-lockstep straggler
        # policy turn joins/leaves into plan swaps on the governed pipeline.
        # Link-only schedules (loss / bandwidth) stay on the standard path:
        # they reshape the mixing operator and the round times, not the
        # cohort
        self._faults = faults
        if faults is not None and faults.n != self.n_nodes:
            raise ValueError(f"fault schedule covers {faults.n} nodes "
                             f"but the driver has {self.n_nodes}")
        self._elastic = ((faults is not None and faults.has_node_faults)
                         or gov.straggler_policy != "wait")
        if self._elastic:
            if not self.decentralized:
                raise ValueError("elastic membership needs a decentralized "
                                 "node axis (averaging mode gossip)")
            if run_cfg.averaging.mode == "hierarchical":
                raise ValueError("elastic membership is not defined for "
                                 "pod-structured hierarchical averaging")
        self._straggler = (rates.StragglerPolicy(
            self.n_nodes, gov.straggler_policy,
            slow_factor=gov.straggler_slow_factor,
            deadline_s=gov.straggler_deadline_s,
            patience=gov.straggler_patience) if self._elastic else None)
        self.pipeline = StreamingPipeline(
            sample_fn, run_cfg.stream, self.n_nodes, run_cfg.averaging.rounds,
            batch=batch, horizon=horizon, seed=seed)
        self.ladder = self._make_ladder(gov)
        if self._sharded and not self.decentralized:
            # every rank takes an equal share of each batch (`shard_batch`)
            for B in self.ladder.buckets:
                why = exact_split_error(B, self.n_nodes, n_data_nodes(mesh))
                if why:
                    raise ValueError(f"exact mode on a sharded node axis: "
                                     f"{why}")
        self.pipeline.adopt_ladder(self.ladder)
        # cohort ladders always derive from the FULL-membership base ladder,
        # so a rejoin to a previously seen cohort size restores that cohort's
        # exact buckets (and their built supersteps) rather than drifting
        self._base_ladder = self.ladder
        self._cohort_ladders: Dict[int, rates.BucketLadder] = {
            self.n_nodes: self.ladder}
        self._membership: Optional[Membership] = None
        self._last_round_s: Optional[float] = None
        self.membership_events: List[Dict[str, Any]] = []
        if self._elastic:
            self._membership = Membership.full(self.n_nodes)
            self.pipeline.swap_membership(self._membership, self.ladder)
        # superstep source, most to least specific: an explicit bucket-keyed
        # builder, a single superstep_fn (served to every bucket), or the LM
        # trainer's builder
        if superstep_builder is None:
            if superstep_fn is not None:
                superstep_builder = lambda B: superstep_fn
            else:
                superstep_builder = lm_superstep_builder(
                    run_cfg, mesh, n_nodes=self.n_nodes, device=self.device)
        self._builder = superstep_builder
        # membership-aware builders take (B, membership); single-argument
        # builders (and the superstep_fn adapter above) take B alone and can
        # only serve full-membership supersteps
        try:
            params = inspect.signature(superstep_builder).parameters
            self._builder_elastic = len(params) >= 2
        except (TypeError, ValueError):
            self._builder_elastic = False
        # one superstep per (bucket, cohort size), built on first visit and
        # reused on every revisit; the active ids are an argument, so all
        # same-size memberships share one superstep (on a split axis, per
        # cohort: see `_superstep_for`)
        self._built: Dict[Tuple[int, int, Optional[Membership]],
                          Callable] = {}
        self._prefetcher: Optional[DevicePrefetcher] = None
        self._supersteps_done = 0  # across run() calls
        # governor warm-up gate, per (bucket, cohort) signature: supersteps
        # completed at each (the first of a fresh one pays one-off costs)
        self._sig_seen: Dict[Tuple[int, int], int] = {}
        self._initial_B = self.pipeline.plan.B
        self._initial_sig = (self._initial_B, self.n_nodes)
        self._hysteresis = rates.BucketHysteresis(gov.hysteresis)
        self._estimator = (rates.RoundTimeEstimator(
            self.n_nodes, run_cfg.averaging.rounds, window=gov.window)
            if gov.estimate_rates else None)
        # train-to-serve publication: offered the state at the superstep
        # boundary, after the timed window — its cost is engine bookkeeping
        # the publisher's own governor budgets, not stream processing
        self._publisher = publisher
        if publisher is not None:
            publisher.configure(extract=publish_extract(
                self.n_nodes if self.decentralized else None,
                run=run_cfg if hasattr(run_cfg, "model") else None,
                mesh=mesh), mesh=mesh)
        self._pub_masks: Dict[Optional[Membership], torch.Tensor] = {}
        self.history: List[Dict[str, Any]] = []
        # fault tolerance: the snapshotter runs at the superstep boundary,
        # after publication. `_last_splitter_state` is the splitter snapshot
        # that rode the prefetch `meta` with the superstep just consumed:
        # restoring it re-deals the staged-but-unconsumed supersteps a crash
        # threw away
        self._snapshotter = snapshotter
        if snapshotter is not None and self._sharded:
            snapshotter.bind(mesh)
        self._last_splitter_state: Optional[dict] = None
        self.resumed_from: Optional[str] = None
        if resume_from is not None:
            from repro_torch.train import snapshot as _snapshot
            self.resumed_from = _snapshot.restore_driver(self, resume_from)

    def _make_ladder(self, gov: GovernorConfig) -> rates.BucketLadder:
        """Resolve the governor's B ladder: explicit buckets (clipped to the
        Theorem-4 horizon ceiling, snapped to multiples of N), an auto
        geometric ladder around the planned B, or the pinned single-bucket
        ladder."""
        N = self.n_nodes
        base_B = self.pipeline.plan.B
        if gov.buckets:
            return rates.BucketLadder.from_buckets(
                gov.buckets, N, horizon_samples=self._horizon)
        if gov.n_buckets == 1:
            # pinned B: keep the planned/user batch EXACTLY, including a B
            # that is not a multiple of N in exact mode (no node split)
            return rates.BucketLadder((base_B,))
        return rates.BucketLadder.build(
            base_B, N, n_buckets=gov.n_buckets, factor=gov.bucket_factor,
            horizon_samples=self._horizon)

    @property
    def compiled_signatures(self) -> Tuple[Tuple[int, int], ...]:
        """(bucket, cohort size) pairs with a built superstep (the
        reference's compiled executables)."""
        return tuple(sorted({key[:2] for key in self._built}))

    @property
    def membership(self) -> Optional[Membership]:
        """The active cohort future supersteps will be dealt under (None on a
        non-elastic driver)."""
        return self._membership

    def _superstep_for(self, p: rates.Plan) -> Callable:
        mem = p.membership
        partial_cohort = mem is not None and not mem.is_full
        m = mem.n_active if mem is not None else self.n_nodes
        # on a split axis a cohort's superstep depends on which nodes it
        # holds (the builder shares one among the cohorts of one row
        # table); on one process, on its size alone
        key = (p.B, m, mem if partial_cohort and is_sharded(self.mesh)
               else None)
        fn = self._built.get(key)
        if fn is None:
            if self._builder_elastic:
                fn = self._builder(p.B, mem if partial_cohort else None)
            elif partial_cohort:
                raise ValueError(
                    "elastic membership needs a membership-aware superstep "
                    "builder `build(B, membership)`; this driver was given a "
                    "single-argument builder (or a bare superstep_fn)")
            else:
                fn = self._builder(p.B)
            if partial_cohort:
                fn = elastic_superstep(fn, rdist.n_local(self.mesh,
                                                         self.n_nodes))
            self._built[key] = fn
        return fn

    # ---------------------------------------------------------------- stages

    def _host_superstep(self) -> Dict[str, np.ndarray]:
        """Stage 1: K governed splitter rounds, stacked [K, B, ...] (exact)
        or split [K, m, B/m, ...] over the *active cohort* (decentralized
        node axis; the latched plan's membership decides the split). On a
        sharded mesh, this rank's rows of it (`shard_batch`)."""
        batch = self.pipeline.next_superstep(self.engine.superstep)
        if self.decentralized:
            p = self.pipeline.last_superstep_plan
            m = self.n_nodes if p.membership is None else p.membership.n_active
            batch = make_node_batch(batch, m, axis=1)
        return shard_batch(batch, self.mesh, self.n_nodes,
                           node_axis=self.decentralized,
                           membership=self.pipeline.last_superstep_plan
                           .membership)

    # ------------------------------------------------------------- main loop

    def run(self, supersteps: int, *,
            log_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
            log_every: int = 1) -> Tuple[Any, List[Dict[str, Any]]]:
        """Drive `supersteps` supersteps (K rounds each). Returns the final
        state and the per-superstep history of metrics, throughput, and
        governor decisions.

        The prefetch ring persists across calls (it keeps staging between
        runs, bounded at `prefetch_depth`), so a warm-up `run()` leaves the
        ring hot for a subsequent timed one; call `close()` (or use the
        driver as a context manager) when done."""
        if (self.engine.prefetch_depth > 0 and self._prefetcher is None
                and not self._sharded):
            self._prefetcher = DevicePrefetcher(
                self._host_superstep, device=self.device,
                counters=self.pipeline.counters,
                # the plan that dealt the superstep and the splitter's
                # post-deal stream position, so a snapshot pins exactly
                # what was consumed
                meta=lambda: (self.pipeline.last_superstep_plan,
                              self.pipeline.splitter_state()),
                depth=self.engine.prefetch_depth)
        source = self._prefetcher
        for i in range(supersteps):
            # membership changes land OUTSIDE the timed window: the swap (and
            # any rejoin state sync) is engine bookkeeping, not stream
            # processing the governor should bill to R_p
            if self._elastic:
                self._apply_membership(self._supersteps_done)
            # the timed window covers batch acquisition too: when the HOST is
            # the bottleneck (prefetch ring empty, slow synthesis), that wait
            # must show up in measured_Re or the governor would keep calling
            # an input-bound run "resourceful"
            t0 = self.clock()
            if source is not None:
                staged = next(source)
                counters = source.counters
                used_plan, split_state = source.meta or (None, None)
            else:
                staged = stage_batch(self._host_superstep(), self.device)
                counters = self.pipeline.counters()
                used_plan = self.pipeline.last_superstep_plan
                split_state = self.pipeline.splitter_state()
            if split_state is not None:
                self._last_splitter_state = split_state
            # after a bucket or membership switch the ring may still drain
            # supersteps dealt at the old width/cohort: each runs through the
            # superstep of the (bucket, cohort) that DEALT it (their samples
            # were drawn from the stream)
            used_plan = used_plan or self.pipeline.plan
            fn = self._superstep_for(used_plan)
            mem = used_plan.membership
            if mem is not None and not mem.is_full:
                # this rank's active rows (every active id on one process)
                self.state, metrics = fn(
                    self.state, rdist.local_ids(self.mesh, mem), staged)
            else:
                self.state, metrics = fn(self.state, staged)
            # one host copy per K rounds: the superstep's one sync point
            names = list(metrics)
            fetched = torch.stack([metrics[k] for k in names]).cpu().numpy()
            metrics = dict(zip(names, fetched))
            wall_s = max(self.clock() - t0, 1e-12)
            if self._sharded:
                # rank 0's clock plans for every rank: the governor is
                # deterministic in the wall time, so every rank then makes
                # rank 0's plan
                wall_s = rdist.broadcast_object(wall_s, self.mesh)
            rec = self._observe(metrics, wall_s, counters, used_plan)
            if self._publisher is not None:
                snap = self._publisher.maybe_publish(
                    self.state, self._supersteps_done, aux=self._publish_aux())
                rec["published_version"] = snap.version if snap else None
            if self._snapshotter is not None:
                ck = self._snapshotter.maybe_snapshot(self)
                rec["checkpoint"] = ck["step"] if ck else None
            if log_fn and (i % log_every == 0 or i == supersteps - 1):
                log_fn(rec)
        return self.state, self.history

    def _publish_aux(self) -> Optional[torch.Tensor]:
        """The publisher extract's aux: a [N] f32 membership mask on the
        device for decentralized runs (consensus mean over *active* nodes),
        None in exact mode. Cached per membership."""
        if not self.decentralized:
            return None
        mem = self._membership
        mask = self._pub_masks.get(mem)
        if mask is None:
            mask = (torch.ones(self.n_nodes, dtype=torch.float32)
                    if mem is None else torch.as_tensor(
                        np.asarray(mem.active, np.float32)))
            mask = mask.to(self.device)
            self._pub_masks[mem] = mask
        return mask

    # ---------------------------------------------------------- membership

    def _ladder_for(self, m: int) -> rates.BucketLadder:
        lad = self._cohort_ladders.get(m)
        if lad is None:
            lad = self._base_ladder.for_cohort(m,
                                               horizon_samples=self._horizon)
            self._cohort_ladders[m] = lad
        return lad

    def _apply_membership(self, step: int) -> None:
        """Resolve the cohort for superstep `step`: the fault layer's alive
        mask intersected with the straggler policy's debounced verdicts. A
        change is a `swap_membership` plan swap on the pipeline (eq. 4
        re-inverted at the cohort, B snapped onto the cohort's ladder) —
        never a restart; supersteps already staged drain under the
        membership that dealt them."""
        desired = (self._faults.alive(step) if self._faults is not None
                   else Membership.full(self.n_nodes))
        if self._straggler is not None:
            if self._faults is not None and self._last_round_s:
                # per-node times are scaled from MEASURED round times only:
                # before the first timed superstep there is no base to scale
                # the fault factors by
                self._straggler.observe(
                    self._faults.round_s_per_node(step, self._last_round_s))
            desired = self._straggler.propose(desired)
        if self._sharded:
            # every rank resolves the cohort from the same schedule and rank
            # 0's round times; one that did not would deal other rows and
            # hang the group at its next message
            first = rdist.broadcast_object(desired, self.mesh)
            if first != desired:
                raise RuntimeError(
                    f"rank {self.mesh.rank} resolved the cohort "
                    f"{desired.active_ids} at superstep {step}, rank 0 "
                    f"{first.active_ids}")
        prev = self._membership
        if desired == prev:
            return
        ladder = self._ladder_for(desired.n_active)
        new_plan = self.pipeline.swap_membership(desired, ladder)
        self.ladder = ladder
        if prev is not None and self.engine.governor.sync_on_rejoin:
            self._sync_rejoined(prev, desired)
        self._membership = desired
        self.membership_events.append({
            "superstep": step, "from": prev, "to": desired,
            "plan": new_plan})

    @torch.no_grad()
    def _sync_rejoined(self, prev: Membership, new: Membership) -> None:
        """Overwrite rejoining nodes' state rows with the mean of the nodes
        that stayed active (in f32, cast to the leaf's dtype), so a stale
        iterate re-enters at the cohort's consensus point instead of
        dragging the consensus error back up. Once per rejoin, in place,
        one leaf at a time. A trainer state's per-node optimizer steps (a
        tuple of ints) take the donors' mean the same way, truncated as the
        reference's cast of its f32 mean. On a split node axis each rank
        sums its own donor rows in f32, the sum is all-reduced (every rank
        takes part, with zeros where it holds no donor) and each rank
        writes the mean into its own rejoining rows."""
        joined = [i for i in new.active_ids if not prev.active[i]]
        donors = [i for i in prev.active_ids if new.active[i]]
        if not joined or not donors:
            return
        sharded = is_sharded(self.mesh)
        local = rdist.node_rows(self.mesh, self.n_nodes)
        n = local.stop - local.start
        mine = lambda ids: [i - local.start for i in ids
                            if local.start <= i < local.stop]
        here_joined, here_donors = mine(joined), mine(donors)

        def fix(p):
            if not _node_rows(p, n):
                return p
            mean = p.new_zeros(p.shape[1:], dtype=torch.float32)
            for i in here_donors:
                mean.add_(p[i].float())
            if sharded:
                rdist.all_reduce_(mean, self.mesh)
            mean.div_(len(donors))
            for j in here_joined:
                p[j].copy_(mean)
            return p

        self.state = _map_state(fix, self.state)
        opt = getattr(self.state, "opt", None)
        steps = getattr(opt, "step", None)
        if isinstance(steps, tuple) and len(steps) == n:
            total = sum(steps[i] for i in here_donors)
            if sharded:
                total = int(rdist.all_reduce_(
                    torch.tensor([total], dtype=torch.float64),
                    self.mesh)[0])
            mean = int(np.float32(total) / np.float32(len(donors)))
            steps = tuple(mean if i in here_joined else s
                          for i, s in enumerate(steps))
            self.state = self.state._replace(opt=opt._replace(step=steps))

    def close(self) -> None:
        """Stop the prefetch thread and flush/stop the snapshot writer
        (idempotent)."""
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
        if self._snapshotter is not None:
            self._snapshotter.close()

    def __enter__(self) -> "StreamingDriver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- governor

    def _observe(self, metrics: Dict[str, np.ndarray], wall_s: float,
                 counters: Optional[StreamCounters],
                 used_plan: rates.Plan) -> Dict[str, Any]:
        i = self._supersteps_done
        self._supersteps_done += 1
        K = self.engine.superstep
        round_s = wall_s / K
        stream = self.run_cfg.stream
        self._last_round_s = round_s
        B_used = used_plan.B
        # the cohort that processed THIS superstep (may differ from the
        # current cohort while the ring drains churn-era items)
        m_used = used_plan.n_active or self.n_nodes
        sig = (B_used, m_used)
        # per-signature warm-up gate: a superstep on a freshly visited
        # (bucket, cohort) must not feed the governor or the estimator
        seen = self._sig_seen.get(sig, 0)
        self._sig_seen[sig] = seen + 1
        warm = seen >= (self.engine.warmup_supersteps
                        if sig == self._initial_sig
                        else self.engine.warmup_per_bucket)
        measured_Rp = rates.measured_processing_rate(
            B_used, m_used, used_plan.R, round_s, stream.comms_rate)
        rec: Dict[str, Any] = {
            "superstep": i,
            "round": (i + 1) * K,
            # last round of the superstep == what a per-round loop would print
            "metrics": {k: float(np.asarray(v)[-1]) for k, v in metrics.items()},
            "wall_s": wall_s,
            "rounds_per_s": K / wall_s,
            "samples_per_s": K * B_used / wall_s,
            "measured_Rp": measured_Rp,
            "measured_Re": rates.measured_effective_rate(round_s),
            "plan": used_plan,
            "bucket": B_used,
            "n_active": m_used,
            "counters": counters,
        }
        if self._faults is not None and self._faults.has_link_faults:
            # link-model observability: the active bandwidth slowdown and
            # the Bernoulli edge drops realized at this superstep's last
            # consensus round
            rec["bw_factor"] = self._faults.bw_factor(rec["round"])
            rec["link_drops"] = self._faults.link_drops(rec["round"])
        governed = stream.streaming_rate > 0
        if governed and warm and self._estimator is not None:
            if m_used != self.n_nodes:
                self._estimator.observe_cohort(B_used, m_used, round_s)
            else:
                self._estimator.observe(B_used, round_s)
        every = self.engine.replan_every
        if governed and every > 0 and (i + 1) % every == 0 and warm:
            est = self._estimator.estimate() if self._estimator else None
            if est is not None:
                rec["est_Rp"], rec["est_Rc"] = est.Rp, est.Rc
            # the re-plan targets the CURRENT cohort (eq. 4 re-inverted at
            # N = n_active), even while drain-era supersteps are observed
            cur = self.pipeline.plan
            m_cur = cur.n_active or self.n_nodes
            if len(self.ladder) > 1:
                observed = rates.observed_stream(
                    stream, m_used, used_plan.R, B_used, round_s,
                    estimate=est)
                target_B = rates.select_bucket(
                    self.ladder, observed, m_cur, cur.R,
                    horizon_samples=self._horizon)
                rec["target_bucket"] = target_B
                # hysteresis: only `governor.hysteresis` consecutive re-plans
                # agreeing on the same bucket confirm a switch
                decided_B = self._hysteresis.step(cur.B, target_B)
            else:
                decided_B = cur.B
            # the wall-time inversion happens at the OBSERVED bucket (the
            # ring may still drain old-width supersteps); the plan is derived
            # at the hysteresis-confirmed one
            new_plan = rates.replan(stream, m_cur, cur.R, B_used,
                                    round_s, ladder=self.ladder, estimate=est,
                                    decided_B=decided_B,
                                    horizon_samples=self._horizon,
                                    membership=cur.membership)
            if new_plan.B != cur.B:
                self.pipeline.update_plan(new_plan)
                rec["replanned"] = new_plan
                rec["bucket_switch"] = (cur.B, new_plan.B)
            # Re is measured and jitters every superstep; only an actual
            # change of the governor's *decision* (mu / regime) counts
            elif (new_plan.mu, new_plan.regime) != (cur.mu, cur.regime):
                self.pipeline.update_plan(new_plan)
                rec["replanned"] = new_plan
        self.history.append(rec)
        return rec
