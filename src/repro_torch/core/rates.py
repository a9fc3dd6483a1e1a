"""The paper's rate model (Section II-C): streaming rate R_s, per-node compute
rate R_p, communications rate R_c, consensus rounds R, network-wide mini-batch B,
N nodes — and the provisioning planner implied by Theorems 4-7.

    R_e  = ( B/(N*R_p) + R/R_c )^-1                      (eq. 4)
    R   <= floor( B*R_c * (1/R_s - 1/(N*R_p)) )          (eq. 3)

A system keeps up with the stream iff R_s <= B*R_e; otherwise it must discard
mu = R_s/R_e - B samples per round (Algorithms 1-2, steps 9-10).

The closed-loop half of the module feeds the streaming driver's governor
(docs/DESIGN.md §Adaptive batch buckets): `BucketLadder` registers the B
values the plan may move between (each with a pre-compiled superstep),
`RoundTimeEstimator` decomposes round times observed at different buckets
into a running (R_p, R_c) estimate by least squares, and `replan` /
`checked_plan_swap` re-derive and validate the (B, mu) plan from those
measured rates.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional, Tuple

from repro_torch.configs.base import StreamConfig


def _comm_time(R: int, Rc: float) -> float:
    """Per-round communication time R/R_c; R_c <= 0 means 'no comms model'
    (infinitely fast network), not a zero-rate one."""
    return R / Rc if Rc > 0 else 0.0


def effective_rate(B: float, N: int, R: int, Rp: float, Rc: float) -> float:
    """Mini-batches per second the network can process (eq. 4)."""
    return 1.0 / (B / (N * Rp) + _comm_time(R, Rc))


def rate_limited(stream: StreamConfig, bw_factor: float) -> StreamConfig:
    """The stream as seen through a bandwidth-capped network: a `bw:i-jxF`
    link fault (core/faults.py) makes the lockstep consensus round block on
    the capped edge, which is equivalent to dividing the network rate R_c by
    the cap factor in eq. 4. Used by the scenario harness to derive ground
    truth for simulated round times; the closed loop itself never consumes
    this — the governor *measures* the inflated round time and its estimator
    recovers the lower R_c on its own (that direction is what
    `benchmarks/bench_scenarios.py` asserts). A no-comms-model stream
    (comms_rate <= 0) has nothing to cap and passes through unchanged."""
    if bw_factor < 1.0:
        raise ValueError(f"bandwidth cap factor must be >= 1: {bw_factor}")
    if stream.comms_rate <= 0 or bw_factor == 1.0:
        return stream
    return dataclasses.replace(stream, comms_rate=stream.comms_rate / bw_factor)


def max_rounds(B: float, N: int, Rs: float, Rp: float, Rc: float) -> int:
    """Largest R compatible with keeping up with the stream (eq. 3)."""
    slack = 1.0 / Rs - 1.0 / (N * Rp)
    return max(0, math.floor(B * Rc * slack))


def discards_per_round(B: int, N: int, R: int, Rs: float, Rp: float, Rc: float) -> int:
    """mu = max(0, R_s/R_e - B): samples dropped at the splitter per round."""
    Re = effective_rate(B, N, R, Rp, Rc)
    # epsilon guard: B chosen exactly at the keep-up boundary must give mu = 0
    return max(0, math.ceil(Rs / Re - B - 1e-9))


@dataclass(frozen=True)
class Plan:
    B: int
    mu: int
    R: int
    Re: float
    regime: str  # "resourceful" | "under-provisioned"
    # Active-cohort snapshot (a `core.mixing.Membership`, or None = full/static
    # membership). Rides the per-superstep plan latch, so in-flight prefetched
    # batches drain under the membership that dealt them
    # (docs/DESIGN.md §Elastic membership).
    membership: Optional[object] = None

    @property
    def n_active(self) -> Optional[int]:
        return None if self.membership is None else self.membership.n_active

    def to_json(self) -> dict:
        """JSON form for checkpoint manifests (train.snapshot): everything a
        resumed driver needs to adopt the exact plan, membership included."""
        return {"B": self.B, "mu": self.mu, "R": self.R, "Re": self.Re,
                "regime": self.regime,
                "membership": (None if self.membership is None
                               else self.membership.to_json())}

    @classmethod
    def from_json(cls, state: dict) -> "Plan":
        mem = state.get("membership")
        if mem is not None:
            from repro_torch.core.mixing import Membership
            mem = Membership.from_json(mem)
        return cls(B=int(state["B"]), mu=int(state["mu"]), R=int(state["R"]),
                   Re=float(state["Re"]), regime=state["regime"],
                   membership=mem)


def plan(stream: StreamConfig, N: int, R: int, *, B: Optional[int] = None,
         horizon_samples: Optional[float] = None) -> Plan:
    """Choose (B, mu) for a stream. If B is not given, pick the smallest B that
    keeps up (R_s <= B*R_e), clipped to the order-optimality ceiling
    B <= sqrt(t') from Theorem 4 when a sample horizon is known."""
    Rs, Rp, Rc = stream.streaming_rate, stream.processing_rate, stream.comms_rate
    if B is None:
        # R_s <= B*R_e  <=>  R_s*(B/(N Rp) + R/Rc) <= B
        #              <=>  B*(1 - Rs/(N Rp)) >= Rs*R/Rc
        denom = 1.0 - Rs / (N * Rp)
        if denom <= 0:
            raise ValueError(
                f"stream faster than total compute: R_s={Rs} >= N*R_p={N * Rp}")
        B = max(N, math.ceil(Rs * _comm_time(R, Rc) / denom))
        B = ((B + N - 1) // N) * N  # B must split evenly across nodes
    if horizon_samples:
        B = min(B, horizon_ceiling(N, horizon_samples))
    if stream.forced_mu >= 0:
        mu = stream.forced_mu
    else:
        mu = discards_per_round(B, N, R, Rs, Rp, Rc)
    Re = effective_rate(B, N, R, Rp, Rc)
    return Plan(B=B, mu=mu, R=R,
                Re=Re, regime="resourceful" if mu == 0 else "under-provisioned")


def horizon_ceiling(N: int, horizon_samples: float) -> int:
    """Theorem 4's order-optimality ceiling B <= sqrt(t'), rounded down to a
    multiple of N (and never below N)."""
    ceiling = max(N, int(math.sqrt(horizon_samples)))
    return (ceiling // N) * N or N


@dataclass(frozen=True)
class BucketLadder:
    """The registered network mini-batch sizes the governor may plan between
    (docs/DESIGN.md §Adaptive batch buckets).

    Each bucket's superstep is compiled (lazily, once) by the streaming
    driver, so a plan swap between registered buckets never retraces; an
    unregistered B is rejected at `checked_plan_swap`. Buckets are ascending,
    distinct multiples of N, and — when a sample horizon is known — clipped
    to Theorem 4's B <= sqrt(t') ceiling.
    """

    buckets: Tuple[int, ...]
    # The node count the buckets were derived for. Buckets are multiples of N
    # (the batch must split evenly across nodes), so a cohort change silently
    # invalidates them; storing N lets `snap`/`for_cohort` reject or re-derive
    # instead. None = legacy hand-built ladder, no cohort checking.
    N: Optional[int] = None

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("a BucketLadder needs at least one bucket")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be ascending and distinct: "
                             f"{self.buckets}")
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive: {self.buckets}")
        if self.N is not None:
            if self.N < 1:
                raise ValueError(f"ladder N must be positive: {self.N}")
            bad = [b for b in self.buckets if b % self.N]
            if bad:
                raise ValueError(
                    f"buckets {bad} are not multiples of N={self.N}; "
                    f"re-derive the ladder for the new cohort via "
                    f"`for_cohort`")

    def __len__(self) -> int:
        return len(self.buckets)

    def __contains__(self, B: int) -> bool:
        return B in self.buckets

    def snap(self, B: int, *, N: Optional[int] = None) -> int:
        """Smallest registered bucket >= B (the keep-up direction), or the
        largest bucket when B exceeds the ladder. Pass the current cohort
        size `N` to assert the ladder is still valid for it — snapping onto
        a ladder derived for a different cohort would hand compiled code a
        batch that no longer splits evenly across nodes."""
        if N is not None and self.N is not None and N != self.N:
            raise ValueError(
                f"ladder was derived for N={self.N} but cohort is now "
                f"N={N}; re-derive via `for_cohort`")
        for b in self.buckets:
            if b >= B:
                return b
        return self.buckets[-1]

    def for_cohort(self, n_active: int, *,
                   horizon_samples: Optional[float] = None) -> "BucketLadder":
        """Re-derive the ladder for a changed cohort size: the same candidate
        buckets re-normalized to multiples of `n_active` (and re-clipped to
        the Theorem-4 ceiling, itself a multiple of the new N). Identity when
        the cohort already matches, so full-membership ladders are reused
        (and their compiled supersteps with them)."""
        if n_active == self.N:
            return self
        return BucketLadder.from_buckets(self.buckets, n_active,
                                         horizon_samples=horizon_samples)

    @classmethod
    def from_buckets(cls, raw, N: int, *,
                     horizon_samples: Optional[float] = None) -> "BucketLadder":
        """Normalize arbitrary candidate buckets into a valid ladder: each
        rounded up to a multiple of N (never below N), clipped to the
        Theorem-4 sqrt-horizon ceiling (itself a multiple of N — candidates
        above it collapse onto the ceiling, the largest order-optimal B),
        then deduped/sorted. Guarantees every registered bucket survives
        `plan`'s horizon clip unchanged, so a plan at a registered bucket
        can never be clipped to an unregistered value mid-run."""
        cand = {max(N, -(-int(c) // N) * N) for c in raw}
        if horizon_samples:
            ceil_B = horizon_ceiling(N, horizon_samples)
            cand = {min(c, ceil_B) for c in cand}
        return cls(tuple(sorted(cand)), N=N)

    @classmethod
    def build(cls, base_B: int, N: int, *, n_buckets: int = 3,
              factor: int = 2,
              horizon_samples: Optional[float] = None) -> "BucketLadder":
        """Geometric ladder centered on `base_B`: floor((n-1)/2) buckets below
        and the rest above, normalized by `from_buckets` (multiples of N,
        Theorem-4 ceiling)."""
        if n_buckets < 1:
            raise ValueError("n_buckets must be >= 1")
        if factor < 2:
            raise ValueError("bucket_factor must be >= 2")
        below = (n_buckets - 1) // 2
        cand = [base_B * factor ** i for i in range(-below, n_buckets - below)]
        return cls.from_buckets(cand, N, horizon_samples=horizon_samples)


@dataclass(frozen=True)
class RateEstimate:
    """Online decomposition of observed round times into the rate model's
    compute and communication terms: T = B/(N*R_p) + R/R_c. `Rc = 0.0` means
    the fitted comm intercept was ~0 (no comms model), matching the
    `comms_rate <= 0` convention everywhere else in this module."""

    Rp: float
    Rc: float
    n_obs: int = 0


class RoundTimeEstimator:
    """Least-squares (R_p, R_c) estimation from per-round wall times observed
    at *different* network mini-batch sizes B
    (docs/DESIGN.md §Adaptive batch buckets).

    Eq. 4's round time is affine in B — T(B) = a*B + c with a = 1/(N*R_p)
    and c = R/R_c — so supersteps timed at two or more distinct buckets
    identify both terms: slope -> R_p, intercept -> R_c. This replaces the
    binary comm-floor-disproof heuristic of `replan` (which can only either
    trust the config's R_c or zero it) with a measurement; with only one
    bucket visited the system is unidentifiable and `estimate()` returns
    None, falling back to that heuristic. A bounded window keeps the fit
    tracking the hardware's *current* rates.
    """

    def __init__(self, N: int, R: int, *, window: int = 64):
        if N < 1 or R < 0:
            raise ValueError(f"bad estimator dims N={N} R={R}")
        self.N, self.R = N, R
        # (equivalent full-cohort B, seconds); B is fractional after the
        # `observe_cohort` x = B*N/m normalization
        self._obs: Deque[Tuple[float, float]] = deque(maxlen=max(2, window))

    def observe(self, B: int, round_s: float) -> None:
        if B > 0 and round_s > 0 and math.isfinite(round_s):
            self._obs.append((B, round_s))

    def observe_cohort(self, B: int, n_active: int, round_s: float) -> None:
        """Observe a round timed at a partial cohort of `n_active` nodes.

        The affine model T(B) = B/(N*R_p) + R/R_c assumes all N nodes share
        the compute; at a cohort of m nodes the compute term is B/(m*R_p) =
        (B*N/m)/(N*R_p), so the observation enters the fit at the equivalent
        full-cohort regressor x = B*N/m. This keeps one estimator coherent
        across membership eras instead of resetting the window on every
        churn event."""
        if n_active < 1:
            return
        self.observe(B * self.N / n_active, round_s)

    def state_dict(self) -> dict:
        """JSON-serializable snapshot of the fit: the observation window as
        [[B, round_s], ...] plus the dims it was built for (checked on load
        so a checkpoint cannot silently feed a differently-shaped fit)."""
        return {"N": self.N, "R": self.R,
                "window": self._obs.maxlen,
                "obs": [[float(b), float(t)] for b, t in self._obs]}

    def load_state_dict(self, state: dict) -> None:
        """Restore the observation window exactly — the resumed estimator
        produces bit-identical estimates to the uninterrupted one."""
        if (state["N"], state["R"]) != (self.N, self.R):
            raise ValueError(
                f"estimator snapshot is for N={state['N']} R={state['R']}, "
                f"but this estimator has N={self.N} R={self.R}")
        self._obs = deque(((b, t) for b, t in state["obs"]),
                          maxlen=state.get("window", self._obs.maxlen))

    def estimate(self) -> Optional[RateEstimate]:
        n = len(self._obs)
        if n < 3 or len({b for b, _ in self._obs}) < 2:
            return None  # slope and intercept are not separable yet
        sx = sum(b for b, _ in self._obs)
        sy = sum(t for _, t in self._obs)
        sxx = sum(b * b for b, _ in self._obs)
        sxy = sum(b * t for b, t in self._obs)
        denom = n * sxx - sx * sx
        if denom <= 0:
            return None
        a = (n * sxy - sx * sy) / denom
        if a <= 0:
            return None  # negative compute term: noise dominates, keep fallback
        c = max((sy - a * sx) / n, 0.0)
        Rp = 1.0 / (self.N * a)
        Rc = self.R / c if c > 1e-12 else 0.0
        return RateEstimate(Rp=Rp, Rc=Rc, n_obs=n)


class BucketHysteresis:
    """Debounce bucket proposals: a switch is confirmed only after `patience`
    consecutive re-plans agree on the same target bucket, so one jittery
    superstep timing cannot thrash the ladder. `patience=1` switches
    immediately; proposals equal to the current bucket reset the streak."""

    def __init__(self, patience: int = 2):
        if patience < 1:
            raise ValueError("hysteresis patience must be >= 1")
        self.patience = patience
        self._pending: Optional[int] = None
        self._streak = 0

    def state_dict(self) -> dict:
        return {"pending": self._pending, "streak": self._streak}

    def load_state_dict(self, state: dict) -> None:
        self._pending = state["pending"]
        self._streak = int(state["streak"])

    def step(self, current_B: int, target_B: int) -> int:
        """Returns the bucket to adopt now: `target_B` once confirmed, else
        `current_B`."""
        if target_B == current_B:
            self._pending, self._streak = None, 0
            return current_B
        if target_B == self._pending:
            self._streak += 1
        else:
            self._pending, self._streak = target_B, 1
        if self._streak >= self.patience:
            self._pending, self._streak = None, 0
            return target_B
        return current_B


class PerNodeRoundTime:
    """Per-node EWMA of observed round times
    (docs/DESIGN.md §Elastic membership).

    The superstep itself only yields one wall time (the slowest node's —
    gossip is lockstep), so per-node times come from outside the engine: a
    `core.faults.FaultSchedule` in tests/benchmarks, node-local heartbeats in
    a real deployment. The EWMA smooths one-off jitter so the straggler
    policy reacts to sustained slowdowns, not noise."""

    def __init__(self, n: int, *, alpha: float = 0.5):
        if n < 1 or not 0.0 < alpha <= 1.0:
            raise ValueError(f"bad PerNodeRoundTime n={n} alpha={alpha}")
        self.n = n
        self.alpha = alpha
        self._ewma: list = [None] * n

    def observe_all(self, round_s_per_node) -> None:
        """Fold one round's per-node wall times into the EWMAs. Entries that
        are None / non-finite / non-positive (e.g. dead nodes) are skipped —
        their EWMA freezes at the last live value."""
        if len(round_s_per_node) != self.n:
            raise ValueError(f"expected {self.n} per-node times, "
                             f"got {len(round_s_per_node)}")
        for i, t in enumerate(round_s_per_node):
            if t is None or not math.isfinite(t) or t <= 0:
                continue
            prev = self._ewma[i]
            self._ewma[i] = t if prev is None else (
                self.alpha * t + (1.0 - self.alpha) * prev)

    def state_dict(self) -> dict:
        return {"n": self.n, "alpha": self.alpha,
                "ewma": [None if v is None else float(v)
                         for v in self._ewma]}

    def load_state_dict(self, state: dict) -> None:
        if state["n"] != self.n:
            raise ValueError(f"EWMA snapshot is for n={state['n']}, "
                             f"but this tracker has n={self.n}")
        self._ewma = list(state["ewma"])

    def value(self, node: int) -> Optional[float]:
        return self._ewma[node]

    @property
    def seeded(self) -> bool:
        """True once any node has a real observation. The first observation
        seeds a node's EWMA directly (no synthetic prior), so callers should
        withhold made-up fallback times — e.g. the driver only feeds times
        scaled from *measured* warm-up rounds, never a constant seed — or the
        constant dominates every node's EWMA equally and masks slow/fast
        ratios until it decays."""
        return any(v is not None for v in self._ewma)

    def median(self, ids=None) -> Optional[float]:
        """Median EWMA over `ids` (default: all nodes with observations)."""
        vals = sorted(v for i, v in enumerate(self._ewma)
                      if v is not None and (ids is None or i in ids))
        if not vals:
            return None
        k = len(vals)
        return vals[k // 2] if k % 2 else 0.5 * (vals[k // 2 - 1] + vals[k // 2])


class StragglerPolicy:
    """Decide which nodes the governor should wait for
    (docs/DESIGN.md §Elastic membership).

    Three modes, all fed by `PerNodeRoundTime`:

    * "wait"     — never drop anyone; the superstep runs at the slowest
                   active node's pace (the paper's lockstep assumption — the
                   baseline the benchmarks compare against).
    * "drop"     — a node whose EWMA round time exceeds `slow_factor` x the
                   active-cohort median is proposed out; it is proposed back
                   in once it recovers below the threshold.
    * "deadline" — a node slower than the absolute `deadline_s` is proposed
                   out (and back in on recovery); the effective round time
                   is capped at the deadline.

    Every in/out proposal is debounced through a per-node `BucketHysteresis`
    (membership bit as a two-rung ladder), so one jittery reading can neither
    evict nor readmit a node — the same patience discipline the governor
    applies to bucket switches."""

    MODES = ("wait", "drop", "deadline")

    def __init__(self, n: int, mode: str = "wait", *, slow_factor: float = 2.0,
                 deadline_s: float = 0.0, patience: int = 2,
                 alpha: float = 0.5):
        if mode not in self.MODES:
            raise ValueError(f"unknown straggler policy {mode!r}; "
                             f"one of {self.MODES}")
        if mode == "drop" and slow_factor <= 1.0:
            raise ValueError(f"slow_factor must be > 1: {slow_factor}")
        if mode == "deadline" and deadline_s <= 0.0:
            raise ValueError(f"deadline_s must be > 0: {deadline_s}")
        self.n, self.mode = n, mode
        self.slow_factor, self.deadline_s = slow_factor, deadline_s
        self.times = PerNodeRoundTime(n, alpha=alpha)
        self._hyst = [BucketHysteresis(patience) for _ in range(n)]
        self._kept = [True] * n  # straggler verdict per node (debounced)

    def state_dict(self) -> dict:
        """JSON-serializable snapshot of everything the policy accumulates:
        per-node EWMAs, debounce streaks, and the kept/evicted verdicts. The
        policy's *parameters* (mode, factors, patience) come from config and
        are echoed only for a consistency check on load."""
        return {"n": self.n, "mode": self.mode,
                "times": self.times.state_dict(),
                "hyst": [h.state_dict() for h in self._hyst],
                "kept": [bool(k) for k in self._kept]}

    def load_state_dict(self, state: dict) -> None:
        if (state["n"], state["mode"]) != (self.n, self.mode):
            raise ValueError(
                f"straggler snapshot is for n={state['n']} "
                f"mode={state['mode']!r}, but this policy has n={self.n} "
                f"mode={self.mode!r}")
        self.times.load_state_dict(state["times"])
        for h, hs in zip(self._hyst, state["hyst"]):
            h.load_state_dict(hs)
        self._kept = [bool(k) for k in state["kept"]]

    def _too_slow(self, node: int, cohort_ids) -> bool:
        t = self.times.value(node)
        if t is None:
            return False  # no evidence — keep the node
        if self.mode == "deadline":
            return t > self.deadline_s
        med = self.times.median(cohort_ids)
        return med is not None and t > self.slow_factor * med

    def observe(self, round_s_per_node) -> None:
        self.times.observe_all(round_s_per_node)

    def propose(self, membership) -> "object":
        """Intersect a fault-layer membership with the debounced straggler
        verdicts: nodes the fault layer killed stay out regardless; of the
        survivors, sustained stragglers are dropped (drop/deadline modes).
        Never empties the cohort — the least-slow node is always kept."""
        if self.mode == "wait":
            return membership
        ids = membership.active_ids
        for i in ids:
            want = 0 if self._too_slow(i, ids) else 1
            self._kept[i] = bool(
                self._hyst[i].step(int(self._kept[i]), want))
        kept = [i for i in ids if self._kept[i]]
        if not kept:  # never stall the whole stream on a universal verdict
            best = min(ids, key=lambda i: self.times.value(i) or 0.0)
            kept = [best]
        out = membership
        for i in ids:
            if i not in kept:
                out = out.drop(i)
        return out

    def effective_round_s(self, membership, round_s_per_node) -> float:
        """The wall time one gossip round actually costs under this policy:
        the slowest *retained* node ("wait": slowest active node — lockstep;
        "drop": stragglers excluded; "deadline": capped at the deadline)."""
        vals = [round_s_per_node[i] for i in membership.active_ids
                if round_s_per_node[i] is not None]
        if not vals:
            return 0.0
        worst = max(vals)
        if self.mode == "deadline":
            return min(worst, self.deadline_s)
        return worst


def measured_processing_rate(B: int, N: int, R: int, wall_s_per_round: float,
                             Rc: float = 0.0) -> float:
    """Invert eq. 4: recover the per-node compute rate R_p actually achieved
    from an observed per-round wall time.

    The round time decomposes as T = B/(N*R_p) + R/R_c; subtracting the
    modeled communication term leaves the compute term. With no comms model
    (Rc <= 0) the whole wall time is attributed to compute, which makes the
    recovered R_p a conservative (pessimistic) estimate. If the observed wall
    time is at or below the modeled comm floor R/R_c, the measurement has
    disproven the comms constant — the whole wall time is attributed to
    compute rather than trusting the model over the observation (which would
    yield an absurd R_p)."""
    comm_s = _comm_time(R, Rc)
    if wall_s_per_round <= comm_s:
        comm_s = 0.0
    compute_s = max(wall_s_per_round - comm_s, 1e-12)
    return B / (N * compute_s)


def measured_effective_rate(wall_s_per_round: float) -> float:
    """Observed R_e: mini-batches per second actually completed."""
    return 1.0 / max(wall_s_per_round, 1e-12)


def observed_stream(stream: StreamConfig, N: int, R: int, B: int,
                    wall_s_per_round: float, *,
                    estimate: Optional[RateEstimate] = None) -> StreamConfig:
    """StreamConfig with (R_p, R_c) replaced by what measurement supports.

    With a `RoundTimeEstimator` estimate (supersteps observed at two or more
    buckets) both rates come from the least-squares fit. Without one, a
    single (B, wall-time) point cannot separate compute from comms, so the
    fallback keeps the config's R_c unless the observation disproves it: a
    round finished at or under the modeled comm floor R/R_c zeroes the comm
    term rather than letting a wrong constant dominate the re-planned R_e."""
    if estimate is not None:
        return dataclasses.replace(stream, processing_rate=estimate.Rp,
                                   comms_rate=estimate.Rc)
    if wall_s_per_round <= _comm_time(R, stream.comms_rate):
        stream = dataclasses.replace(stream, comms_rate=0.0)
    Rp = measured_processing_rate(B, N, R, wall_s_per_round, stream.comms_rate)
    return dataclasses.replace(stream, processing_rate=Rp)


def select_bucket(ladder: BucketLadder, stream: StreamConfig, N: int, R: int,
                  *, horizon_samples: Optional[float] = None) -> int:
    """The bucket the rate model asks for: the smallest registered B that
    keeps up with the stream (eq. 4's keep-up condition, Theorem-4 ceiling
    applied by `plan`), or the largest bucket when no B can keep up — B*R_e
    is increasing in B, so the top of the ladder minimizes the discard rate
    R_s - B*R_e in the under-provisioned regime."""
    try:
        target = ladder.snap(plan(stream, N, R,
                                  horizon_samples=horizon_samples).B)
    except ValueError:  # stream outruns total compute: nothing keeps up
        target = ladder.buckets[-1]
    if horizon_samples:
        # ladders built via `from_buckets` are already ceiling-clipped; for
        # a hand-built ladder, never select a bucket that `plan` would clip
        # down to an unregistered B
        ceil_B = horizon_ceiling(N, horizon_samples)
        fits = [b for b in ladder.buckets if b <= ceil_B]
        if fits and target > ceil_B:
            target = fits[-1]
    return target


def snap_plan_to_ladder(current: Plan, stream: StreamConfig, N: int,
                        ladder: BucketLadder, *,
                        horizon_samples: Optional[float] = None) -> Plan:
    """Fit an existing plan onto a ladder: if its B is already registered the
    plan is returned unchanged; otherwise B snaps to the nearest keep-up
    bucket and mu is re-derived (for ungoverned streams only B is replaced).
    Shared by the governed sources' `adopt_ladder` so the snap semantics
    cannot drift between them."""
    if current.B in ladder:
        return current
    B = ladder.snap(current.B)
    if stream.streaming_rate > 0:
        out = plan(stream, N, current.R, B=B,
                   horizon_samples=horizon_samples)
        return dataclasses.replace(out, membership=current.membership)
    return dataclasses.replace(current, B=B)


def replan(stream: StreamConfig, N: int, R: int, B: int,
           wall_s_per_round: float, *,
           ladder: Optional[BucketLadder] = None,
           estimate: Optional[RateEstimate] = None,
           decided_B: Optional[int] = None,
           horizon_samples: Optional[float] = None,
           membership: Optional[object] = None) -> Plan:
    """Closed-loop governor step: re-derive (B, mu) from the *measured* round
    time instead of the config's nominal R_p (Nokleby & Bajwa 2017 style
    adaptation of the DMB plan). `B` is the batch size the wall time was
    observed at.

    Without a `ladder` (or with a single-bucket one) B is held fixed — the
    node-split batch shape feeds compiled code — and the adaptation shows up
    purely in mu, the number of samples the splitter must discard per round
    to keep up with R_s at the rate the hardware is actually delivering.
    With a multi-bucket ladder the re-plan may also move B to another
    *registered* bucket (`select_bucket`), each of which has a pre-compiled
    superstep, so the swap still never retraces. Pass `estimate` from a
    `RoundTimeEstimator` to close the loop on R_c as well.

    A user-pinned `forced_mu >= 0` stays in force (the experiment knob wins
    over the feedback loop); the re-plan then only refreshes the measured
    Re / regime diagnosis.

    `decided_B` overrides the bucket selection: pass it when the target went
    through an external debounce (the driver's `BucketHysteresis` sits
    between `select_bucket` and the plan) — the wall-time inversion still
    happens at the observed `B`, but the plan is derived at `decided_B`.

    `N` is the *active cohort* size (eq. 4 re-inverted per cohort); pass
    `membership` to stamp the cohort snapshot onto the returned plan."""
    observed = observed_stream(stream, N, R, B, wall_s_per_round,
                               estimate=estimate)
    if decided_B is not None:
        target_B = decided_B
    elif ladder is not None and len(ladder) > 1:
        target_B = select_bucket(ladder, observed, N, R,
                                 horizon_samples=horizon_samples)
    else:
        target_B = B
    out = plan(observed, N, R, B=target_B, horizon_samples=horizon_samples)
    if membership is not None:
        out = dataclasses.replace(out, membership=membership)
    if ladder is not None and out.B not in ladder:
        # misconfigured hand-built ladder: no registered bucket fits the
        # Theorem-4 ceiling, so the horizon clip just produced an
        # unregistered B that `checked_plan_swap` would reject mid-run —
        # hold the nearest registered bucket (un-clipped) instead of
        # crashing the governor loop. Ladders from `from_buckets` can never
        # hit this.
        out = plan(observed, N, R, B=ladder.snap(out.B))
        if membership is not None:
            out = dataclasses.replace(out, membership=membership)
    return out


def checked_plan_swap(current: Plan, new: Plan,
                      ladder: Optional[BucketLadder] = None) -> Plan:
    """Guard for closed-loop plan swaps (`update_plan` on the governed
    streams): the node-split batch shape feeds compiled code, so B may only
    move to a bucket whose superstep is registered (and pre-compiled) on the
    ladder. Without a ladder B must stay fixed — the pre-ladder pinned-B
    behavior; only mu and the Re/regime diagnosis may adapt."""
    if ladder is not None:
        if new.B not in ladder:
            raise ValueError(
                f"replan proposed unregistered batch bucket B={new.B}; "
                f"registered buckets: {list(ladder.buckets)}")
        return new
    if new.B != current.B:
        raise ValueError(
            f"closed-loop replan must keep B fixed: {current.B} -> {new.B}")
    return new


def dmb_stepsize(t: int, L: float, sigma: float, D_W: float) -> float:
    """Theorem 4's stepsize: eta_t = 1 / (L + (sigma/D_W) * sqrt(t))."""
    return 1.0 / (L + (sigma / D_W) * math.sqrt(max(t, 1)))


def krasulina_stepsize(t: int, c: float, Q: float) -> float:
    """Theorems 3/5 stepsize: eta_t = c / (Q + t)."""
    return c / (Q + t)


def min_comms_rate_for_optimality(B: int, N: int, R: int, Rs: float, Rp: float) -> float:
    """Eq. (26): R_c >= N*R*R_s*R_p / (B*(N*R_p - R_s))."""
    denom = B * (N * Rp - Rs)
    if denom <= 0:
        return float("inf")
    return N * R * Rs * Rp / denom
