"""Config-driven scenario registry: the paper's assumptions as a testbed —
the port's copy of `repro.core.scenarios`, with the same registry, axes and
operators (numpy, so the operator tables and link drops are the
reference's to the bit) and its mixing compiled onto the device.

The convergence
story the paper actually proves (eq. 17, Theorem 4) is about *B-connected
time-varying graphs* under a compute/communication mismatch, Nokleby & Bajwa
(arXiv:1704.07888) analyze the rate-*limited* network regime, and Ozfatura,
Gündüz & Poor (arXiv:2112.05559) motivate lossy/bandwidth-constrained links
for collaborative learning. This registry composes those three orthogonal
axes into named, seeded, deterministic scenarios (`ScenarioConfig` in
`configs/base.py` — mirroring how `configs/` registers models):

* **topology schedules** — the mixing graph switches per consensus round
  (ring -> torus -> expander / random-geometric), compiled into ONE
  `core.mixing.ScheduledMixOp` whose phase is picked on the device per
  round (a phase switch builds nothing).
* **link models** — Bernoulli packet loss and bandwidth caps from the
  extended `core.faults.FaultSchedule` DSL; loss realizations are folded
  into the per-round operator table (Metropolis-reweighted, doubly
  stochastic), bandwidth caps reach the governor through simulated round
  times (`core.rates.rate_limited` is the ground-truth model).
* **non-IID streams** — `data.synthetic`'s drifting-covariance PCA and
  Dirichlet label-skewed logreg host samplers, threaded through the governed
  splitter.

Deviations from the paper's eq. 17 assumptions are documented in
docs/DESIGN.md §Scenario harness. The port's PCA streams draw their
covariance from a `torch.Generator` (`data.synthetic.make_pca_stream`);
`build_stream(scn, pca=...)` takes the reference's stream carried across by
`convert.pca_stream` when the draws must be the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.configs.base import AveragingConfig, ScenarioConfig
from repro_torch.configs.paper_logreg import LogRegConfig
from repro_torch.configs.paper_pca import FIG7
from repro_torch.core import mixing
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.mixing import ScheduledMixOp, scheduled_mix_op
from repro_torch.data import synthetic
from repro_torch.device import DeviceLike

TOPOLOGIES = ("ring", "torus", "circulant2", "expander", "geometric")
CIRCULANTS = ("ring", "torus", "circulant2")
STREAMS = ("iid_pca", "drift_pca", "iid_logreg", "skew_logreg")

# stream ground-truth configs: the PCA cells run the paper's Fig. 7 spectrum,
# the logreg cells a small conditional-Gaussian problem (Fig. 9 family)
PCA_CFG = FIG7
LOGREG_CFG = LogRegConfig(dim=5, generator="cond_gauss", noise_var=2.0)


# ---------------------------------------------------------------------------
# Per-phase topology operators
# ---------------------------------------------------------------------------


def topology_matrix(name: str, n: int, *, seed: int = 0,
                    self_weight: float = 0.0) -> np.ndarray:
    """Dense one-round doubly-stochastic operator for a named topology.

    Circulant families densify their shift schedule (so scenario operators
    stay bit-comparable with the device gossip path); the dense families
    (expander / geometric) sample a connected graph from `seed` and take
    Metropolis weights."""
    if name in CIRCULANTS:
        return np.asarray(
            mixing.schedule_matrix(mixing.schedule(name, n, self_weight), n))
    if name == "expander":
        if n < 3:
            return np.asarray(
                mixing.schedule_matrix(mixing.schedule("ring", n), n))
        return mixing.random_regular_expander(n, deg=4 if n >= 6 else 2,
                                              seed=seed)
    if name == "geometric":
        return mixing.random_geometric(n, seed=seed)
    raise ValueError(f"unknown topology {name!r}; one of {TOPOLOGIES}")


def _validate(scn: ScenarioConfig) -> None:
    if scn.n_nodes < 1:
        raise ValueError(f"scenario {scn.name!r}: need n_nodes >= 1")
    if scn.rounds < 1:
        raise ValueError(f"scenario {scn.name!r}: need rounds >= 1")
    if not scn.topology_schedule:
        raise ValueError(f"scenario {scn.name!r}: empty topology schedule")
    for topo, seg in scn.topology_schedule:
        if topo not in TOPOLOGIES:
            raise ValueError(f"scenario {scn.name!r}: unknown topology "
                             f"{topo!r}; one of {TOPOLOGIES}")
        if seg < 1:
            raise ValueError(f"scenario {scn.name!r}: segment length {seg}")
    if scn.stream not in STREAMS:
        raise ValueError(f"scenario {scn.name!r}: unknown stream "
                         f"{scn.stream!r}; one of {STREAMS}")
    sched = fault_schedule(scn)
    if sched is not None:
        if sched.has_node_faults:
            raise ValueError(f"scenario {scn.name!r}: node faults belong in "
                             f"the driver's --faults schedule; scenario "
                             f"links take link:/bw: tokens only")
        for lf in sched.links:
            if lf.kind == "link" and lf.end == -1:
                raise ValueError(
                    f"scenario {scn.name!r}: link-loss fault {lf.spec()!r} "
                    f"needs a bounded window — realizations are precomputed "
                    f"over a finite round horizon and repeat beyond it")


def fault_schedule(scn: ScenarioConfig) -> Optional[FaultSchedule]:
    """The scenario's link-fault schedule (windows index consensus rounds),
    seeded by the scenario seed; None when the link model is clean."""
    if not scn.links:
        return None
    return FaultSchedule.parse(scn.links, scn.n_nodes, seed=scn.seed)


def scenario_period(scn: ScenarioConfig) -> int:
    """Rounds before the per-round operator table repeats: the topology
    period, stretched to cover every bounded link window (and any explicit
    `period_rounds`), rounded up to a whole number of topology cycles."""
    t_topo = sum(seg for _, seg in scn.topology_schedule)
    period = max(t_topo, scn.period_rounds)
    sched = fault_schedule(scn)
    if sched is not None:
        for lf in sched.links:
            if lf.end != -1:
                period = max(period, lf.end)
    return -(-period // t_topo) * t_topo


def _phase_name_at(scn: ScenarioConfig, t: int) -> str:
    """Topology name active at (1-based) consensus round t."""
    t_topo = sum(seg for _, seg in scn.topology_schedule)
    r = (t - 1) % t_topo
    for topo, seg in scn.topology_schedule:
        if r < seg:
            return topo
        r -= seg
    raise AssertionError("unreachable")


def one_round_matrices(scn: ScenarioConfig) -> list:
    """The realized one-round operator of every round in the period, indexed
    by t % period (slot 0 holds round t = period): topology phase composed
    with that round's link-loss realization. This is the ground truth the
    property suite checks (doubly stochastic each round, contracting window
    products) and the source `build_mix` compiles."""
    period = scenario_period(scn)
    sched = fault_schedule(scn)
    out = [None] * period
    for t in range(1, period + 1):
        A = topology_matrix(_phase_name_at(scn, t), scn.n_nodes,
                            seed=scn.seed, self_weight=scn.self_weight)
        if sched is not None:
            A = sched.lossy_matrix(A, t)
        out[t % period] = A
    return out


def build_mix(scn: ScenarioConfig, *,
              device: DeviceLike = None) -> ScheduledMixOp:
    """Compile the scenario into one time-varying consensus operator on
    `device`.

    Per-round realized operators are deduplicated (loss-free rounds of the
    same topology phase share one effective operator), then handed to
    `core.mixing.scheduled_mix_op` — circulant phases as shift schedules,
    realized/dense phases as matrices. The round->phase lookup and the
    operator stack are device tensors: every round of every scenario reuses
    one built superstep."""
    _validate(scn)
    period = scenario_period(scn)
    sched = fault_schedule(scn)
    phases, lut, index = [], [], {}
    for i in range(period):
        t = period if i == 0 else i  # slot i serves rounds t === i (mod period)
        topo = _phase_name_at(scn, t)
        drops = () if sched is None else sched.link_drops(t)
        if topo in CIRCULANTS and not drops:
            spec = mixing.schedule(topo, scn.n_nodes, scn.self_weight)
            key = ("sched", spec)
        else:
            A = topology_matrix(topo, scn.n_nodes, seed=scn.seed,
                                self_weight=scn.self_weight)
            if sched is not None:
                A = sched.lossy_matrix(A, t)
            spec = np.asarray(A, np.float32)
            key = ("dense", topo, drops)
        if key not in index:
            index[key] = len(phases)
            phases.append(spec)
        lut.append(index[key])
    return scheduled_mix_op(phases, scn.n_nodes, scn.rounds,
                            phase_by_round=lut, device=device)


def window_lambda2(scn: ScenarioConfig, window: Optional[int] = None) -> float:
    """eq. 17 B-connectivity check: the worst contraction rate of any
    length-`window` product of consecutive realized one-round operators
    (cyclic over the period; `window=None` uses the full period). < 1 means
    every window mixes — the B-connected condition the time-varying
    convergence results assume."""
    mats = one_round_matrices(scn)
    period = len(mats)
    window = period if window is None else window
    worst = 0.0
    for start in range(period):
        P = np.eye(scn.n_nodes)
        for k in range(window):
            t = start + k + 1  # rounds start at 1
            P = mats[t % period] @ P
        worst = max(worst, mixing.lambda2(P))
    return worst


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


class ScenarioStream(NamedTuple):
    """A scenario's host sampler plus its ground truth for metrics/tests."""

    sample: Callable  # (np rng, n) -> batch dict, splitter-compatible
    kind: str
    pca: Optional[synthetic.PCAStream] = None  # iid_pca
    drift: Optional[synthetic.DriftingPCAStream] = None  # drift_pca
    logreg: Optional[synthetic.SkewedLogRegStream] = None  # *_logreg


def build_stream(scn: ScenarioConfig, *,
                 pca: Optional[synthetic.PCAStream] = None,
                 device: DeviceLike = None) -> ScenarioStream:
    """The scenario's stream axis: a host sampler for the governed splitter
    (`data.pipeline.StreamingPipeline`) with its ground truth attached.
    Non-IID kinds lay nodes out as contiguous blocks, aligned with
    `train.trainer.make_node_batch` (exact at mu = 0). The PCA kinds draw
    over `pca` (default `make_pca_stream` of the scenario's seed on
    `device`)."""
    _validate(scn)
    cfg = dataclasses.replace(PCA_CFG, seed=scn.seed)
    if scn.stream in ("iid_pca", "drift_pca") and pca is None:
        pca = synthetic.make_pca_stream(cfg, device=device)
    if scn.stream == "iid_pca":
        return ScenarioStream(synthetic.make_pca_host_sampler(pca), "iid_pca",
                              pca=pca)
    if scn.stream == "drift_pca":
        drift = synthetic.make_drifting_pca_sampler(
            cfg, rate=scn.stream_param, stream=pca)
        return ScenarioStream(drift.sample, "drift_pca", drift=drift)
    cfg = dataclasses.replace(LOGREG_CFG, seed=scn.seed)
    alpha = float("inf") if scn.stream == "iid_logreg" else scn.stream_param
    lr = synthetic.make_skewed_logreg_sampler(cfg, scn.n_nodes, alpha=alpha,
                                              seed=scn.seed)
    return ScenarioStream(lr.sample, scn.stream, logreg=lr)


def averaging_config(scn: ScenarioConfig) -> AveragingConfig:
    """The gossip config a scenario superstep runs under. The topology field
    names the first segment for observability; the actual operator sequence
    comes from `build_mix`'s override."""
    topo = scn.topology_schedule[0][0]
    return AveragingConfig(mode="gossip", rounds=scn.rounds,
                           topology=topo if topo in CIRCULANTS else "ring",
                           self_weight=scn.self_weight)


def comm_factor(scn: ScenarioConfig, step: int) -> float:
    """The scenario's communication slowdown at a round (bandwidth caps)."""
    sched = fault_schedule(scn)
    return 1.0 if sched is None else sched.bw_factor(step)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, ScenarioConfig] = {}


def register(scn: ScenarioConfig) -> ScenarioConfig:
    """Validate and add a scenario to the registry (names are unique)."""
    if scn.name in SCENARIOS:
        raise ValueError(f"scenario {scn.name!r} already registered")
    _validate(scn)
    SCENARIOS[scn.name] = scn
    return scn


def get_scenario(name: str) -> ScenarioConfig:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{scenario_names()}") from None


def scenario_names() -> Tuple[str, ...]:
    return tuple(sorted(SCENARIOS))


# The sweep axes (the reference's `benchmarks/bench_scenarios.py` crosses
# them into the excess-risk matrix — >= 3 values per axis). Link windows
# index consensus rounds and must cover the bench horizons.
TOPOLOGY_AXIS: Dict[str, Tuple[Tuple[str, int], ...]] = {
    "ring": (("ring", 1),),
    "tv_rte": (("ring", 2), ("torus", 2), ("expander", 2)),
    "geometric": (("geometric", 1),),
}
LINK_AXIS: Dict[str, str] = {
    "clean": "",
    "lossy": "link:0-1@1-257p0.3,link:2-3@1-257p0.3",
    "ratelimited": "bw:0-1@1-257x4",
}
STREAM_AXIS: Dict[str, Tuple[str, float]] = {
    "iid_pca": ("iid_pca", 0.0),
    "drift_pca": ("drift_pca", 2e-4),
    "skew_logreg": ("skew_logreg", 0.3),
}


def make_scenario(topo_key: str, link_key: str, stream_key: str, *,
                  n_nodes: int = 8, rounds: int = 2,
                  seed: int = 0) -> ScenarioConfig:
    """Compose one cell of the topology x link x stream matrix from the
    named axis values (unregistered; name = 'topo/link/stream')."""
    stream, param = STREAM_AXIS[stream_key]
    return ScenarioConfig(
        name=f"{topo_key}/{link_key}/{stream_key}", n_nodes=n_nodes,
        rounds=rounds, topology_schedule=TOPOLOGY_AXIS[topo_key],
        links=LINK_AXIS[link_key], stream=stream, stream_param=param,
        seed=seed)


# Named scenarios for the launch CLI (`python -m repro_torch.launch.train
# --scenario NAME`) and the tests — one representative per axis extreme.
register(make_scenario("ring", "clean", "iid_pca"))
register(make_scenario("tv_rte", "clean", "iid_pca"))
register(make_scenario("geometric", "clean", "iid_pca"))
register(make_scenario("ring", "lossy", "iid_pca"))
register(make_scenario("ring", "ratelimited", "iid_pca"))
register(make_scenario("ring", "clean", "drift_pca"))
register(make_scenario("geometric", "lossy", "skew_logreg"))
register(make_scenario("tv_rte", "ratelimited", "drift_pca"))
