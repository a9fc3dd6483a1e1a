"""The streaming governor's plan state: hooks the rate model (core.rates) to
the governed splitter (`data.pipeline.StreamingPipeline`), which per round
yields exactly B samples split N ways and accounts for mu discarded samples
(Fig. 4's timeline). Host-side, numpy; copied from `repro.core.streaming`.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from repro_torch.core.rates import (BucketLadder, Plan, checked_plan_swap, plan,
                                    snap_plan_to_ladder)


class GovernedPlanMixin:
    """Lock-guarded closed-loop plan state shared by the governed sources
    (`data.pipeline.StreamingPipeline`; the reference's `GovernedStream` is
    not ported, the driver deals through the pipeline): `update_plan`
    validates swaps against the adopted bucket ladder, `adopt_ladder` snaps
    an unregistered plan onto it, and the per-superstep latch guarantees
    every superstep is dealt at a single width even when a swap lands from
    the consumer thread mid-production. Hosts must provide `plan`,
    `stream_cfg`, and `n_nodes` before calling `_init_plan_state`.
    """

    def _init_plan_state(self, ladder: Optional[BucketLadder],
                         horizon: Optional[float] = None) -> None:
        self.ladder: Optional[BucketLadder] = None
        self._plan_horizon = horizon
        self._plan_lock = threading.Lock()
        self._last_superstep_plan = self.plan
        if ladder is not None:
            self.adopt_ladder(ladder)

    def adopt_ladder(self, ladder: BucketLadder) -> None:
        """Register the bucket ladder `update_plan` validates against. If the
        current plan's B is not a registered bucket it is snapped to the
        nearest keep-up bucket (mu re-derived) — call before consumption."""
        self.plan = snap_plan_to_ladder(self.plan, self.stream_cfg,
                                        self.n_nodes, ladder,
                                        horizon_samples=self._plan_horizon)
        self.ladder = ladder
        self._last_superstep_plan = self.plan

    def update_plan(self, new_plan: Plan) -> None:
        """Closed-loop governor hook (see `core.rates.replan`): adopt a plan
        re-derived from measured rates. Without a ladder B stays fixed and
        only mu adapts; with one, B may move to any registered bucket
        (`core.rates.checked_plan_swap`); counters carry over."""
        with self._plan_lock:
            self.plan = checked_plan_swap(self.plan, new_plan, self.ladder)

    def swap_membership(self, membership, ladder: Optional[BucketLadder] = None
                        ) -> Plan:
        """Adopt a new active cohort: a join/leave is a plan swap, not a
        restart (docs/DESIGN.md §Elastic membership).

        Under the plan lock, eq. 4 is re-inverted at N = n_active and (B, mu)
        re-derived, snapped onto `ladder` (the cohort's bucket ladder — pass
        the one derived from the full-membership base ladder via
        `BucketLadder.for_cohort` so a return to full membership restores the
        original buckets exactly). Supersteps already dealt keep their old
        plan snapshot and drain under the membership that dealt them; only
        future supersteps latch the new cohort. Returns the adopted plan."""
        with self._plan_lock:
            cur = self.plan
            if cur.membership == membership:
                return cur
            if cur.membership is None and membership.is_full:
                # initial stamp: same cohort, just record the mask — keep the
                # user's exact B rather than re-deriving it
                self.plan = dataclasses.replace(cur, membership=membership)
                return self.plan
            m = membership.n_active
            governed = (self.stream_cfg is not None
                        and self.stream_cfg.streaming_rate > 0)
            if governed:
                try:
                    new = plan(self.stream_cfg, m, cur.R,
                               horizon_samples=self._plan_horizon)
                except ValueError:
                    # the shrunk cohort cannot keep up with the stream at any
                    # B: a death must NOT crash the run — hold the current B
                    # (rounded to the cohort) and let the plan go
                    # under-provisioned (mu > 0 discards, Fig. 4's drop rule)
                    B = -(-cur.B // m) * m
                    new = plan(self.stream_cfg, m, cur.R, B=B,
                               horizon_samples=self._plan_horizon)
                if ladder is not None:
                    new = snap_plan_to_ladder(new, self.stream_cfg, m, ladder,
                                              horizon_samples=self._plan_horizon)
            else:
                # ungoverned: keep B as close as possible while splitting
                # evenly across the cohort
                B = -(-cur.B // m) * m
                new = dataclasses.replace(cur,
                                          B=ladder.snap(B) if ladder else B)
            new = dataclasses.replace(new, membership=membership)
            self.ladder = ladder if ladder is not None else self.ladder
            self.plan = new
            return new

    def splitter_state(self) -> dict:
        """JSON-serializable snapshot of the splitter: the t' counter quad,
        the PRNG's exact bit-generator state, and the live plan
        (docs/DESIGN.md §Fault-tolerant streaming).

        Called from the producer thread right after a superstep is dealt
        (the prefetcher's `meta` hook), the snapshot pins the stream position
        of that superstep's last sample — restoring it re-deals every sample
        after that point identically, which is how staged-but-unconsumed
        supersteps lost in a crash are regenerated rather than skipped. The
        stream itself cannot be replayed; only the synthesis position can."""
        with self._plan_lock:
            return {"counters": [int(self.samples_arrived),
                                 int(self.samples_consumed),
                                 int(self.samples_discarded),
                                 int(self.rounds)],
                    "rng": self._rng.bit_generator.state,
                    "plan": self.plan.to_json()}

    def load_splitter_state(self, state: dict, *,
                            plan: Optional[Plan] = None) -> None:
        """Restore a `splitter_state` snapshot: counters, PRNG position, and
        the live plan (override with `plan` to adopt the consumer-side
        post-replan plan instead of the one the snapshot's producer saw).
        The ladder is not part of the snapshot — hosts re-derive it from
        config and re-adopt before restoring, so the restored plan is never
        re-snapped here."""
        with self._plan_lock:
            (self.samples_arrived, self.samples_consumed,
             self.samples_discarded, self.rounds) = (
                int(x) for x in state["counters"])
            self._rng.bit_generator.state = state["rng"]
            p = plan if plan is not None else Plan.from_json(state["plan"])
            self.plan = p
            self._last_superstep_plan = p

    def _latch_plan(self) -> Plan:
        with self._plan_lock:
            return self.plan

    @property
    def last_superstep_plan(self) -> Plan:
        """The plan that dealt the most recently produced superstep — what a
        prefetcher's `meta` hook snapshots so the consumer knows which plan
        a staged batch belongs to."""
        return self._last_superstep_plan
