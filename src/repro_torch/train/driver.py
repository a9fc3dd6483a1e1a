"""Superstep streaming engine: the execution loop that keeps the device fed at
the rate the paper's analysis assumes — the non-elastic, single-device path
of `repro.train.driver`.

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
(docs/DESIGN.md §Adaptive batch buckets). The clock is read exactly twice per superstep, as in the
reference, so a fake clock drives both governors identically.

Elastic membership, fault schedules, train-to-serve publication, snapshots
and resume come with later slices and raise `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GovernorConfig
from repro_torch.core import rates
from repro_torch.data.pipeline import (DevicePrefetcher, StreamCounters,
                                       StreamingPipeline, stage_batch)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train.trainer import (make_node_batch,
                                       superstep_builder as lm_superstep_builder)


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


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with the port's {slice_name} "
                               f"slice")


class StreamingDriver:
    """Owns the three-stage loop: governed splitter -> prefetch ring ->
    K-round superstep on the device, plus the closed-loop (B, mu) governor.

    This slice drives one device with an explicit `n_nodes` (`mesh` must be
    None). `clock` is injectable so tests can fake slow hardware and watch
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
                 faults: Optional[Any] = None,
                 publisher: Optional[Any] = None,
                 snapshotter: Optional[Any] = None,
                 resume_from: Optional[str] = None,
                 device: DeviceLike = None):
        if engine.superstep < 1:
            raise ValueError("superstep K must be >= 1")
        if mesh is not None:
            raise _later("driving a device mesh", "sharded")
        if n_nodes is None:
            raise ValueError("pass n_nodes when driving without a mesh")
        if faults is not None or engine.governor.straggler_policy != "wait":
            raise _later("elastic membership (faults, stragglers)", "elastic")
        if publisher is not None:
            raise _later("train-to-serve publication", "serving")
        if snapshotter is not None or resume_from is not None:
            raise _later("snapshots and resume", "durability")
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
        self.pipeline = StreamingPipeline(
            sample_fn, run_cfg.stream, self.n_nodes, run_cfg.averaging.rounds,
            batch=batch, horizon=horizon, seed=seed)
        self.ladder = self._make_ladder(gov)
        self.pipeline.adopt_ladder(self.ladder)
        # superstep source, most to least specific: an explicit bucket-keyed
        # builder, a single superstep_fn (served to every bucket), or the LM
        # trainer's builder
        if superstep_builder is None:
            if superstep_fn is not None:
                superstep_builder = lambda B: superstep_fn
            else:
                superstep_builder = lm_superstep_builder(
                    run_cfg, None, n_nodes=self.n_nodes, device=self.device)
        self._builder = superstep_builder
        # one superstep per bucket, built on first visit and reused
        self._built: Dict[int, Callable] = {}
        self._prefetcher: Optional[DevicePrefetcher] = None
        self._supersteps_done = 0  # across run() calls
        # governor warm-up gate, per bucket: supersteps completed at each
        self._seen: Dict[int, int] = {}
        self._initial_B = self.pipeline.plan.B
        self._hysteresis = rates.BucketHysteresis(gov.hysteresis)
        self._estimator = (rates.RoundTimeEstimator(
            self.n_nodes, run_cfg.averaging.rounds, window=gov.window)
            if gov.estimate_rates else None)
        self.history: List[Dict[str, Any]] = []

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

    def _superstep_for(self, p: rates.Plan) -> Callable:
        fn = self._built.get(p.B)
        if fn is None:
            fn = self._builder(p.B)
            self._built[p.B] = fn
        return fn

    # ---------------------------------------------------------------- stages

    def _host_superstep(self) -> Dict[str, np.ndarray]:
        """Stage 1: K governed splitter rounds, stacked [K, B, ...] (exact)
        or split [K, N, B/N, ...] (decentralized node axis)."""
        batch = self.pipeline.next_superstep(self.engine.superstep)
        if self.decentralized:
            batch = make_node_batch(batch, self.n_nodes, axis=1)
        return batch

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
        if self.engine.prefetch_depth > 0 and self._prefetcher is None:
            self._prefetcher = DevicePrefetcher(
                self._host_superstep, device=self.device,
                counters=self.pipeline.counters,
                meta=lambda: self.pipeline.last_superstep_plan,
                depth=self.engine.prefetch_depth)
        source = self._prefetcher
        for i in range(supersteps):
            # the timed window covers batch acquisition too: when the HOST is
            # the bottleneck (prefetch ring empty, slow synthesis), that wait
            # must show up in measured_Re or the governor would keep calling
            # an input-bound run "resourceful"
            t0 = self.clock()
            if source is not None:
                staged = next(source)
                counters = source.counters
                used_plan = source.meta
            else:
                staged = stage_batch(self._host_superstep(), self.device)
                counters = self.pipeline.counters()
                used_plan = self.pipeline.last_superstep_plan
            # after a bucket switch the ring may still drain supersteps dealt
            # at the old width: each runs through the superstep of the bucket
            # that DEALT it (their samples were drawn from the stream)
            used_plan = used_plan or self.pipeline.plan
            fn = self._superstep_for(used_plan)
            self.state, metrics = fn(self.state, staged)
            # one host copy per K rounds: the superstep's one sync point
            names = list(metrics)
            fetched = torch.stack([metrics[k] for k in names]).cpu().numpy()
            metrics = dict(zip(names, fetched))
            wall_s = max(self.clock() - t0, 1e-12)
            rec = self._observe(metrics, wall_s, counters, used_plan)
            if log_fn and (i % log_every == 0 or i == supersteps - 1):
                log_fn(rec)
        return self.state, self.history

    def close(self) -> None:
        """Stop the prefetch thread (idempotent)."""
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None

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
        B_used = used_plan.B
        m_used = self.n_nodes
        # per-bucket warm-up gate: a superstep on a freshly visited bucket
        # must not feed the governor or the estimator
        seen = self._seen.get(B_used, 0)
        self._seen[B_used] = seen + 1
        warm = seen >= (self.engine.warmup_supersteps
                        if B_used == self._initial_B
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
        governed = stream.streaming_rate > 0
        if governed and warm and self._estimator is not None:
            self._estimator.observe(B_used, round_s)
        every = self.engine.replan_every
        if governed and every > 0 and (i + 1) % every == 0 and warm:
            est = self._estimator.estimate() if self._estimator else None
            if est is not None:
                rec["est_Rp"], rec["est_Rc"] = est.Rp, est.Rc
            cur = self.pipeline.plan
            if len(self.ladder) > 1:
                observed = rates.observed_stream(
                    stream, m_used, used_plan.R, B_used, round_s,
                    estimate=est)
                target_B = rates.select_bucket(
                    self.ladder, observed, self.n_nodes, cur.R,
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
            new_plan = rates.replan(stream, self.n_nodes, cur.R, B_used,
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
