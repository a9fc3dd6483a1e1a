"""Deterministic fault injection for the elastic node axis: numpy, copied
whole from `repro.core.faults` so both packages draw the same link drops
(docs/DESIGN.md §Elastic membership).

A `FaultSchedule` scripts node churn against the driver's superstep counter:
node death (with optional rejoin), transient slowdown factors, and flaky
periodic dropout. The same schedule object drives

* the mixing mask — `alive(step)` yields the `core.mixing.Membership` the
  superstep must run under, and
* the clock — `time_factors(step)` yields per-node wall-time multipliers the
  tests/benchmarks fold into their fake clocks and the straggler policy's
  per-node round times.

Keeping faults a pure function of the step index (no RNG, no wall clock)
makes every churn scenario replayable: tests, benchmarks, and the launch CLI
all share one spec format, parsed by `FaultSchedule.parse`:

    death:1@5        node 1 dies at step 5, never returns
    death:1@5-12     node 1 dies at step 5, rejoins at step 12
    slow:0@3-9x4     node 0 runs 4x slower during steps [3, 9)
    flaky:2@4-20p3   node 2 alternates dead/alive every 3 steps in [4, 20)

The scenario harness (core/scenarios.py, docs/DESIGN.md §Scenario harness)
extends the grammar with *link* faults — per-edge models after Nokleby &
Bajwa's rate-limited networks (arXiv:1704.07888) and the lossy collaborative
setting of Ozfatura, Gündüz & Poor (arXiv:2112.05559):

    link:1-2@4-20p0.1   edge (1, 2) loses each round w.p. 0.1 in steps [4, 20)
    bw:0-3@5-15x4       edge (0, 3) runs at 1/4 bandwidth in steps [5, 15)

Link loss realizations stay a pure function of (seed, step, edge) — drawn
from a counter-based generator, never a shared RNG stream — so the same
scenario seed replays the identical drop masks across runs and prefetch
depths. Dropped links degrade to self-weights (`lossy_matrix`), keeping the
round's operator doubly stochastic. Bandwidth caps slow the edge's endpoints
(`round_s_per_node`), which is how they reach the straggler policy and the
governor's round-time estimator.

Comma-separate multiple faults: "death:1@5-12,slow:0@3-9x4,link:1-2@4-20p0.1".
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.mixing import (Membership, _connected,
                                    metropolis_weights)

KINDS = ("death", "slow", "flaky")
LINK_KINDS = ("link", "bw")

_SPEC_RE = re.compile(
    r"^(?P<kind>death|slow|flaky):(?P<node>\d+)@(?P<start>\d+)"
    r"(?:-(?P<end>\d+))?(?:x(?P<factor>[0-9.]+))?(?:p(?P<period>\d+))?$")

_LINK_RE = re.compile(
    r"^(?P<kind>link|bw):(?P<i>\d+)-(?P<j>\d+)@(?P<start>\d+)"
    r"(?:-(?P<end>\d+))?(?:x(?P<factor>[0-9.]+))?(?:p(?P<prob>[0-9.]+))?$")


def _fmt(v: float) -> str:
    """Canonical numeric spelling for round-tripping specs ('4', '0.1')."""
    return f"{v:g}"


@dataclass(frozen=True)
class NodeFault:
    """One scripted fault on one node over the step window [start, end)."""

    node: int
    kind: str  # death | slow | flaky
    start: int
    end: int = -1  # exclusive; -1 = until the end of the run
    factor: float = 1.0  # slowdown multiplier (kind == "slow")
    period: int = 0  # dead/alive alternation period (kind == "flaky")

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.node < 0 or self.start < 0:
            raise ValueError(f"bad fault target: node={self.node} "
                             f"start={self.start}")
        if self.end != -1 and self.end <= self.start:
            raise ValueError(f"fault window is empty: [{self.start}, {self.end})")
        if self.kind == "slow" and self.factor <= 1.0:
            raise ValueError(f"slowdown factor must be > 1: {self.factor}")
        if self.kind == "flaky" and self.period < 1:
            raise ValueError(f"flaky fault needs period >= 1: {self.period}")

    def _in_window(self, step: int) -> bool:
        return step >= self.start and (self.end == -1 or step < self.end)

    def dead_at(self, step: int) -> bool:
        if not self._in_window(step):
            return False
        if self.kind == "death":
            return True
        if self.kind == "flaky":
            # starts dead at `start`, alternates every `period` steps
            return ((step - self.start) // self.period) % 2 == 0
        return False

    def factor_at(self, step: int) -> float:
        if self.kind == "slow" and self._in_window(step):
            return self.factor
        return 1.0

    def spec(self) -> str:
        """Canonical DSL token: `parse` of it reproduces this fault."""
        end = "" if self.end == -1 else f"-{self.end}"
        tok = f"{self.kind}:{self.node}@{self.start}{end}"
        if self.kind == "slow":
            tok += f"x{_fmt(self.factor)}"
        elif self.kind == "flaky":
            tok += f"p{self.period}"
        return tok


@dataclass(frozen=True)
class LinkFault:
    """One scripted fault on one undirected edge over steps [start, end).

    kind "link": the edge drops each round independently with probability
    `prob` (Bernoulli packet loss). kind "bw": messages over the edge take
    `factor`x longer (bandwidth cap) — the edge stays in the mixing graph but
    gates the lockstep round time of both endpoints."""

    i: int
    j: int
    kind: str  # link | bw
    start: int
    end: int = -1  # exclusive; -1 = until the end of the run
    prob: float = 0.0  # per-round loss probability (kind == "link")
    factor: float = 1.0  # bandwidth slowdown multiplier (kind == "bw")

    def __post_init__(self):
        if self.kind not in LINK_KINDS:
            raise ValueError(
                f"unknown link fault kind {self.kind!r}; one of {LINK_KINDS}")
        if self.i < 0 or self.j < 0 or self.i == self.j:
            raise ValueError(f"bad link target: {self.i}-{self.j}")
        if self.start < 0:
            raise ValueError(f"bad fault start: {self.start}")
        if self.end != -1 and self.end <= self.start:
            raise ValueError(f"fault window is empty: [{self.start}, {self.end})")
        if self.kind == "link" and not 0.0 < self.prob <= 1.0:
            raise ValueError(f"link loss needs prob in (0, 1]: {self.prob}")
        if self.kind == "bw" and self.factor <= 1.0:
            raise ValueError(f"bandwidth factor must be > 1: {self.factor}")

    def _in_window(self, step: int) -> bool:
        return step >= self.start and (self.end == -1 or step < self.end)

    @property
    def edge(self) -> Tuple[int, int]:
        return (min(self.i, self.j), max(self.i, self.j))

    def spec(self) -> str:
        end = "" if self.end == -1 else f"-{self.end}"
        tok = f"{self.kind}:{self.i}-{self.j}@{self.start}{end}"
        if self.kind == "link":
            tok += f"p{_fmt(self.prob)}"
        else:
            tok += f"x{_fmt(self.factor)}"
        return tok


class FaultSchedule:
    """A replayable script of node and link faults over `n` node slots.

    `seed` feeds the counter-based generator behind Bernoulli link-loss
    realizations (`link_drops`); it is not part of the DSL string, so
    equality and the `parse(str(s), n, seed)` round trip carry it
    explicitly."""

    def __init__(self, n: int, faults: Sequence[NodeFault] = (),
                 links: Sequence[LinkFault] = (), seed: int = 0):
        if n < 1:
            raise ValueError(f"need at least one node: n={n}")
        for f in faults:
            if f.node >= n:
                raise ValueError(f"fault targets node {f.node} but n={n}")
        for lf in links:
            if lf.i >= n or lf.j >= n:
                raise ValueError(f"fault targets link {lf.i}-{lf.j} but n={n}")
        self.n = n
        self.faults: Tuple[NodeFault, ...] = tuple(faults)
        self.links: Tuple[LinkFault, ...] = tuple(links)
        self.seed = seed

    @classmethod
    def parse(cls, spec: str, n: int, seed: int = 0) -> "FaultSchedule":
        """Parse the comma-separated fault DSL (module docstring)."""
        faults, links = [], []
        for tok in filter(None, (t.strip() for t in spec.split(","))):
            kind = tok.split(":", 1)[0]
            if kind in LINK_KINDS:
                m = _LINK_RE.match(tok)
                if not m:
                    raise ValueError(f"bad link fault spec {tok!r}; expected "
                                     f"e.g. 'link:1-2@4-20p0.1', "
                                     f"'bw:0-3@5-15x4'")
                g = m.groupdict()
                links.append(LinkFault(
                    i=int(g["i"]), j=int(g["j"]), kind=g["kind"],
                    start=int(g["start"]),
                    end=-1 if g["end"] is None else int(g["end"]),
                    prob=0.0 if g["prob"] is None else float(g["prob"]),
                    factor=1.0 if g["factor"] is None else float(g["factor"])))
                continue
            m = _SPEC_RE.match(tok)
            if not m:
                raise ValueError(f"bad fault spec {tok!r}; expected e.g. "
                                 f"'death:1@5-12', 'slow:0@3-9x4', "
                                 f"'flaky:2@4-20p3', 'link:1-2@4-20p0.1'")
            g = m.groupdict()
            faults.append(NodeFault(
                node=int(g["node"]), kind=g["kind"], start=int(g["start"]),
                end=-1 if g["end"] is None else int(g["end"]),
                factor=1.0 if g["factor"] is None else float(g["factor"]),
                period=0 if g["period"] is None else int(g["period"])))
        return cls(n, faults, links, seed)

    def __str__(self) -> str:
        return ",".join(f.spec() for f in self.faults + self.links)

    def __repr__(self) -> str:
        return (f"FaultSchedule({self.n}, {str(self)!r}, seed={self.seed})")

    def __eq__(self, other) -> bool:
        if not isinstance(other, FaultSchedule):
            return NotImplemented
        return (self.n, self.faults, self.links, self.seed) == (
            other.n, other.faults, other.links, other.seed)

    def __hash__(self) -> int:
        return hash((self.n, self.faults, self.links, self.seed))

    @property
    def has_node_faults(self) -> bool:
        return bool(self.faults)

    @property
    def has_link_faults(self) -> bool:
        return bool(self.links)

    def alive(self, step: int) -> Membership:
        """The membership the fault layer dictates at a driver superstep."""
        mask = [True] * self.n
        for f in self.faults:
            if f.dead_at(step):
                mask[f.node] = False
        if not any(mask):
            raise ValueError(f"fault schedule kills every node at step {step}")
        return Membership(self.n, tuple(mask))

    def time_factors(self, step: int) -> np.ndarray:
        """Per-node wall-time multipliers at a step (1.0 = nominal). Factors
        from overlapping slowdowns on the same node multiply."""
        out = np.ones(self.n)
        for f in self.faults:
            out[f.node] *= f.factor_at(step)
        return out

    def round_s_per_node(self, step: int, base_round_s: float) -> list:
        """Simulated per-node round times at a step: the nominal round time
        scaled by each node's slowdown factor — including bandwidth caps on
        incident links, which slow both endpoints — None for dead nodes. This
        is the feed for `core.rates.StragglerPolicy.observe` in tests and
        `benchmarks/bench_elastic.py`."""
        alive = self.alive(step).active
        factors = self.time_factors(step) * self.link_time_factors(step)
        return [base_round_s * float(factors[i]) if alive[i] else None
                for i in range(self.n)]

    # -- link models (scenario harness) -----------------------------------

    def link_time_factors(self, step: int) -> np.ndarray:
        """Per-node wall-time multipliers from bandwidth-capped incident
        links: a `bw:i-j@a-bx4` fault makes both endpoints' rounds 4x longer
        while active (the consensus round blocks on the slowest edge).
        Overlapping caps on a node take the max, not the product — the edges
        transfer concurrently and the slowest gates."""
        out = np.ones(self.n)
        for lf in self.links:
            if lf.kind == "bw" and lf._in_window(step):
                out[lf.i] = max(out[lf.i], lf.factor)
                out[lf.j] = max(out[lf.j], lf.factor)
        return out

    def bw_factor(self, step: int) -> float:
        """The lockstep round's communication slowdown at a step: the max
        active bandwidth-cap factor (1.0 = links at nominal rate). Scales the
        comm term of simulated round times, which is how rate-limited links
        reach the governor's (R_p, R_c) estimator."""
        f = 1.0
        for lf in self.links:
            if lf.kind == "bw" and lf._in_window(step):
                f = max(f, lf.factor)
        return f

    def link_drops(self, step: int) -> Tuple[Tuple[int, int], ...]:
        """The undirected edges lost at a step, as a sorted (i, j) tuple.

        Each active `link` fault draws an independent Bernoulli(prob) from a
        counter-based generator keyed on (seed, step, edge) — a pure function
        of the arguments, with no RNG stream shared across steps — so masks
        are identical across runs, resumes, and prefetch depths."""
        drops = set()
        for lf in self.links:
            if lf.kind != "link" or not lf._in_window(step):
                continue
            i, j = lf.edge
            rng = np.random.default_rng(
                np.random.SeedSequence(entropy=(self.seed, step, i, j)))
            if rng.random() < lf.prob:
                drops.add((i, j))
        return tuple(sorted(drops))

    def lossy_matrix(self, A: np.ndarray, step: int) -> np.ndarray:
        """Realize this step's link losses on a symmetric doubly-stochastic
        one-round mixing matrix.

        Dropped edges leave the graph for the round; the survivors are
        re-derived by Metropolis reweighting (`core.mixing`), which puts the
        lost mass on the endpoints' self-weights — the operator stays doubly
        stochastic and, while the realization stays connected, contractive.
        If a draw disconnects the graph, the dropped weight is folded onto
        the diagonal directly (each lost edge degrades to self-weight);
        still doubly stochastic, merely non-contracting for that round —
        eq. 17's B-connectivity over the window restores progress."""
        A = np.array(A, dtype=float, copy=True)
        n = A.shape[0]
        if n != self.n:
            raise ValueError(f"matrix n={n} vs schedule n={self.n}")
        drops = [e for e in self.link_drops(step)
                 if e[0] < n and e[1] < n and A[e[0], e[1]] != 0.0]
        if not drops:
            return A
        adj = np.abs(A) > 0
        np.fill_diagonal(adj, False)
        for i, j in drops:
            adj[i, j] = adj[j, i] = False
        if _connected(adj):
            return metropolis_weights(adj.astype(float))
        for i, j in drops:
            A[i, i] += A[i, j]
            A[j, j] += A[j, i]
            A[i, j] = A[j, i] = 0.0
        return A

    def events_between(self, lo: int, hi: int) -> bool:
        """True if membership differs anywhere in (lo, hi] from step lo —
        a cheap way for callers to skip mask recomputation on quiet spans."""
        base = self.alive(lo).active
        return any(self.alive(s).active != base for s in range(lo + 1, hi + 1))
