"""Elastic membership of the port against the JAX package's, on the CPU.

* `FaultSchedule` (copied whole, numpy): parse round trips, `alive`,
  `time_factors`, `round_s_per_node`, `link_time_factors`, `bw_factor`,
  `link_drops`, `lossy_matrix` and `events_between` equal to the
  reference's exactly;
* `masked_schedule` / `masked_matrix`, the disconnected and partitioned
  drop sets among them (their relabeling fallback): exactly the
  reference's matrices;
* `elastic_superstep` on tensors against the reference's on jax arrays:
  the same rows gathered, run and written back, scalars taking the
  cohort's value;
* the port's `StreamingDriver` against the reference's on the FIG7 PCA
  superstep (N = 5, ring R = 2, K = 2) with the same numpy draws (the
  reference's `sqrt_cov` carried across): equal `membership_events`,
  compiled signatures and per-superstep plans, iterates within 1e-5 of
  themselves and of the largest entry (f32 reassociation; the iterates
  grow to a few hundred under the test's stepsize 10/t) — churn with rejoin, flaky nodes, a
  governed re-plan at the cohort, straggler drop and readmission, the
  prefetch ring draining the old cohort, rejoin sync on and off, and link
  faults staying non-elastic with their records;
* the LM trainer's cohort superstep (no gather of the state) against the
  reference's gather, run and scatter on reduced granite-8b, 3 rounds;
* a rejoin through both drivers on reduced granite-8b, with rejoin sync
  on and off (the per-node optimizer steps);
* the launcher's `--faults`, `--scenario`, `--straggler-policy` and
  `--no-rejoin-sync` on the reduced config with `device="cpu"`.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AveragingConfig as JAveragingConfig
from repro.configs.base import GovernorConfig as JGovernorConfig
from repro.configs.base import StreamConfig as JStreamConfig
from repro.configs.paper_pca import FIG7 as JFIG7
from repro.configs.paper_pca import PCARunConfig as JPCARunConfig
from repro.core import faults as jfaults
from repro.core import krasulina as jkras
from repro.core import mixing as jmix
from repro.data.synthetic import make_pca_host_sampler as jhost_sampler
from repro.data.synthetic import make_pca_stream as jmake_pca_stream
from repro.train import driver as jdriver
from repro_torch import convert
from repro_torch.configs.base import (AveragingConfig, GovernorConfig,
                                      StreamConfig)
from repro_torch.configs.paper_pca import PCARunConfig
from repro_torch.core import faults, krasulina, mixing
from repro_torch.core.mixing import Membership
from repro_torch.data.synthetic import make_pca_host_sampler
from repro_torch.launch import train as launch_train
from repro_torch.train import driver

# one intra-op thread: pytest-xdist runs several workers on the machine's
# cores, and a thread pool of every core in each of them oversubscribes
# the cores (a reduced-granite step then takes tens of times longer)
torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# FaultSchedule: the reference's numbers exactly
# ---------------------------------------------------------------------------

SPECS = [
    "death:1@5",
    "death:1@5-12,slow:0@3-9x4",
    "flaky:2@4-20p3,slow:3@0-30x2.5",
    "death:4@2-5,link:1-2@4-20p0.1,bw:0-3@5-15x4",
    "link:0-1@1-257p0.3,link:2-3@1-257p0.3",
    "bw:0-1@1-257x4,bw:1-4@3x2",
]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_schedule_matches_reference(spec, seed):
    n = 5
    t = faults.FaultSchedule.parse(spec, n, seed=seed)
    j = jfaults.FaultSchedule.parse(spec, n, seed=seed)
    assert str(t) == str(j)
    assert faults.FaultSchedule.parse(str(t), n, seed=seed) == t
    assert (t.has_node_faults, t.has_link_faults) == (j.has_node_faults,
                                                      j.has_link_faults)
    A = jmix.ring_matrix(n)
    for step in range(0, 40):
        assert t.alive(step).active == j.alive(step).active
        np.testing.assert_array_equal(t.time_factors(step),
                                      j.time_factors(step))
        np.testing.assert_array_equal(t.link_time_factors(step),
                                      j.link_time_factors(step))
        assert t.round_s_per_node(step, 0.01) == j.round_s_per_node(step,
                                                                    0.01)
        assert t.bw_factor(step) == j.bw_factor(step)
        assert t.link_drops(step) == j.link_drops(step)
        np.testing.assert_array_equal(t.lossy_matrix(A, step),
                                      j.lossy_matrix(A, step))
        assert t.events_between(step, step + 3) == j.events_between(
            step, step + 3)


@pytest.mark.parametrize("bad", ["death:x@1", "slow:0@3-9x0.5", "flaky:1@2p0",
                                 "link:1-1@2p0.5", "bw:0-9@1x2", "death:1@5-3"])
def test_fault_schedule_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        jfaults.FaultSchedule.parse(bad, 5)
    with pytest.raises(ValueError):
        faults.FaultSchedule.parse(bad, 5)


def test_link_drops_are_a_pure_function_of_seed_step_edge():
    """Two schedule objects with one seed draw the same masks (numpy's
    counter-seeded generator, as the reference); another seed draws
    others."""
    spec = "link:0-1@1-200p0.5,link:2-3@1-200p0.5"
    a = faults.FaultSchedule.parse(spec, 4, seed=3)
    b = faults.FaultSchedule.parse(spec, 4, seed=3)
    c = faults.FaultSchedule.parse(spec, 4, seed=4)
    da = [a.link_drops(s) for s in range(1, 200)]
    assert da == [b.link_drops(s) for s in range(1, 200)]
    assert da != [c.link_drops(s) for s in range(1, 200)]
    assert 0 < sum(map(len, da)) < 2 * 199


# ---------------------------------------------------------------------------
# Masked operators
# ---------------------------------------------------------------------------

MASKS = [
    ("ring", 6, (1, 3, 5)),      # disconnected: relabeled onto a ring
    ("ring", 8, (0, 4)),         # partitioned: relabeled
    ("ring", 5, (2,)),
    ("circulant2", 9, (0, 1, 5)),
    ("torus", 12, (3, 7)),
    ("ring", 4, (0, 1, 2)),      # one survivor: identity
    ("ring", 7, ()),             # full membership: A itself
]


@pytest.mark.parametrize("topo,n,dropped", MASKS)
def test_masked_matrix_and_schedule_match_reference(topo, n, dropped):
    mem = Membership.full(n).drop(*dropped)
    jmem = jmix.Membership.full(n).drop(*dropped)
    A = mixing.schedule_matrix(mixing.schedule(topo, n), n)
    got = mixing.masked_matrix(A, mem)
    want = jmix.masked_matrix(A, jmem)
    np.testing.assert_array_equal(got, want)
    assert mixing.is_doubly_stochastic(got)
    ids = list(mem.active_ids)
    if 1 < len(ids) < n:
        assert mixing.lambda2(got[np.ix_(ids, ids)]) < 1.0 - 1e-9
    assert (mixing.masked_schedule(topo, mem)
            == jmix.masked_schedule(topo, jmem))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_matrix_of_dense_graphs_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for A in (mixing.random_geometric(10, seed=seed),
              mixing.random_regular_expander(10, deg=4, seed=seed)):
        dropped = tuple(rng.choice(10, size=3, replace=False).tolist())
        got = mixing.masked_matrix(A, Membership.full(10).drop(*dropped))
        want = jmix.masked_matrix(A, jmix.Membership.full(10).drop(*dropped))
        np.testing.assert_array_equal(got, want)


def test_masked_matrix_refuses_a_mismatched_membership():
    with pytest.raises(ValueError, match="membership"):
        mixing.masked_matrix(np.eye(4), Membership.full(5))


# ---------------------------------------------------------------------------
# elastic_superstep on tensors
# ---------------------------------------------------------------------------

def test_elastic_superstep_matches_reference():
    n, d = 5, 3
    w = np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)
    ids = (0, 2, 3)

    def cohort(sub, batches, xp):
        assert sub["w"].shape == (len(ids), d)  # dense cohort block
        return ({"w": sub["w"] * 2.0 + batches["z"], "t": sub["t"] + 1},
                {"m": sub["w"].sum()})

    jstate = {"w": jnp.asarray(w), "t": jnp.asarray(7)}
    z = np.arange(len(ids) * d, dtype=np.float32).reshape(len(ids), d)
    jout, jm = jax.jit(jdriver.elastic_superstep(
        lambda s, b: cohort(s, b, jnp), n))(
        jstate, jnp.asarray(ids, jnp.int32), {"z": jnp.asarray(z)})
    tstate = {"w": torch.from_numpy(w.copy()), "t": 7}
    for tids in (ids, torch.tensor(ids)):
        tout, tm = driver.elastic_superstep(
            lambda s, b: cohort(s, b, torch), n)(
            {"w": tstate["w"].clone(), "t": 7}, tids,
            {"z": torch.from_numpy(z)})
        np.testing.assert_allclose(tout["w"].numpy(), np.asarray(jout["w"]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(tout["w"][1].numpy(), w[1])  # frozen
        assert tout["t"] == int(jout["t"]) == 8
        np.testing.assert_allclose(float(tm["m"]), float(jm["m"]), rtol=1e-6)


def test_elastic_superstep_hands_the_full_state_to_a_takes_ids_superstep():
    seen = []

    def fn(state, ids, batches):
        seen.append((state["w"].shape, tuple(ids)))
        return state, {}

    fn.takes_ids = True
    assert driver.elastic_superstep(fn, 4) is fn
    fn({"w": torch.zeros(4, 2)}, (0, 3), {})
    assert seen == [((4, 2), (0, 3))]


# ---------------------------------------------------------------------------
# The driver against the reference's
# ---------------------------------------------------------------------------

class _FakeClock:
    """Advances `dt` per read; `pause` really sleeps, so the prefetch thread
    has filled its ring before each consume in both packages."""

    def __init__(self, dt, pause=0.0):
        self.t, self.dt, self.pause = 0.0, dt, pause

    def __call__(self):
        time.sleep(self.pause)
        self.t += self.dt
        return self.t


N = 5


@pytest.fixture(scope="module")
def pca():
    js = jmake_pca_stream(JFIG7)
    ts = convert.pca_stream(np.asarray(js.cov), np.asarray(js.sqrt_cov),
                            np.asarray(js.top_eigvec), js.lambda1,
                            js.eigengap, device="cpu")
    w0 = np.random.default_rng(0).standard_normal(JFIG7.dim).astype(
        np.float32)
    return js, ts, w0 / np.linalg.norm(w0)


def _drivers(pca, spec, *, stream=None, gov=None, dt=1e-3, batch=10,
             prefetch=0, supersteps=8, fault_seed=0, mix_scn=None):
    """The port's and the reference's drivers on the same stream, faults and
    clock, each run `supersteps`; returns both drivers and final states."""
    js, ts, w0 = pca
    stream = stream or {}
    gov = gov or {}
    step = lambda t: 10.0 / t
    eng = dict(superstep=2, prefetch_depth=prefetch, replan_every=1,
               warmup_supersteps=0, warmup_per_bucket=0)
    pause = 0.05 if prefetch else 0.0
    t_cfg = PCARunConfig(averaging=AveragingConfig(mode="gossip", rounds=2),
                         stream=StreamConfig(**stream))
    j_cfg = JPCARunConfig(averaging=JAveragingConfig(mode="gossip", rounds=2),
                          stream=JStreamConfig(**stream))
    t_faults = (faults.FaultSchedule.parse(spec, N, seed=fault_seed)
                if spec else None)
    j_faults = (jfaults.FaultSchedule.parse(spec, N, seed=fault_seed)
                if spec else None)
    t_mix = j_mix = None
    if mix_scn is not None:
        from repro.core import scenarios as jscen
        from repro_torch.core import scenarios as tscen
        t_mix = tscen.build_mix(mix_scn[0], device="cpu")
        j_mix = jscen.build_mix(mix_scn[1])
    t_drv = driver.StreamingDriver(
        t_cfg, None, krasulina.init_krasulina_state(w0, t_cfg.averaging, N,
                                                    device="cpu"),
        make_pca_host_sampler(ts), n_nodes=N, batch=batch, seed=1,
        superstep_builder=krasulina.krasulina_superstep_builder(
            t_cfg.averaging, N, step, mix=t_mix, device="cpu"),
        faults=t_faults, clock=_FakeClock(dt, pause), device="cpu",
        engine=driver.EngineConfig(**eng, governor=GovernorConfig(**gov)))
    j_drv = jdriver.StreamingDriver(
        j_cfg, None, jkras.init_krasulina_state(jnp.asarray(w0),
                                                j_cfg.averaging, N),
        jhost_sampler(js), n_nodes=N, batch=batch, seed=1,
        superstep_builder=jkras.krasulina_superstep_builder(
            j_cfg.averaging, N, step, mix=j_mix),
        faults=j_faults, clock=_FakeClock(dt, pause),
        engine=jdriver.EngineConfig(**eng,
                                    governor=JGovernorConfig(**gov)))
    with t_drv, j_drv:
        t_state, _ = t_drv.run(supersteps)
        j_state, _ = j_drv.run(supersteps)
    return t_drv, j_drv, t_state, j_state


def _plan(p):
    return None if p is None else p.to_json()


def _events(drv):
    return [(e["superstep"], None if e["from"] is None else e["from"].active,
             e["to"].active, _plan(e["plan"]))
            for e in drv.membership_events]


def _records(drv):
    return [(r["bucket"], r["n_active"], _plan(r["plan"]),
             _plan(r.get("replanned")), r.get("bw_factor"),
             r.get("link_drops"), tuple(r["counters"]))
            for r in drv.history]


def _same(t_drv, j_drv, t_state, j_state):
    assert _events(t_drv) == _events(j_drv)
    assert t_drv.compiled_signatures == j_drv.compiled_signatures
    assert _records(t_drv) == _records(j_drv)
    assert [set(r) for r in t_drv.history] == [set(r) for r in j_drv.history]
    assert t_state.t == int(j_state.t)
    want = np.asarray(j_state.w)
    np.testing.assert_allclose(t_state.w.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    for t_rec, j_rec in zip(t_drv.history, j_drv.history, strict=True):
        np.testing.assert_allclose(t_rec["metrics"]["consensus_err"],
                                   j_rec["metrics"]["consensus_err"],
                                   rtol=1e-4, atol=1e-6)


def test_churn_death_rejoin_matches_reference(pca):
    """Node 4 dies at superstep 2 and rejoins at 5: the drop era is dealt
    at B = 12 over 4 nodes, the rejoin reuses the full cohort's superstep."""
    t_drv, j_drv, ts, js = _drivers(pca, "death:4@2-5")
    _same(t_drv, j_drv, ts, js)
    assert t_drv.compiled_signatures == ((10, 5), (12, 4))
    assert [e["superstep"] for e in t_drv.membership_events] == [2, 5]
    eras = [(r["bucket"], r["n_active"]) for r in t_drv.history]
    assert eras == [(10, 5)] * 2 + [(12, 4)] * 3 + [(10, 5)] * 3


def test_flaky_nodes_share_one_cohort_superstep(pca):
    t_drv, j_drv, ts, js = _drivers(pca, "flaky:1@1-7p2,death:3@7-9",
                                    supersteps=10)
    _same(t_drv, j_drv, ts, js)
    masks = {e["to"] for e in t_drv.membership_events if not e["to"].is_full}
    assert len(masks) == 2 and t_drv.compiled_signatures == ((10, 5), (12, 4))


def test_governed_replan_follows_the_cohort(pca):
    stream = dict(streaming_rate=1e3, processing_rate=1e6, comms_rate=1e6)
    t_drv, j_drv, ts, js = _drivers(pca, "death:2@2-6", stream=stream,
                                    batch=None, dt=50.0)
    _same(t_drv, j_drv, ts, js)
    assert any("replanned" in r for r in t_drv.history)
    assert all(e["plan"].B % e["to"].n_active == 0
               for e in t_drv.membership_events)


def test_straggler_drop_and_readmission(pca):
    gov = dict(straggler_policy="drop", straggler_slow_factor=2.0,
               straggler_patience=2)
    t_drv, j_drv, ts, js = _drivers(pca, "slow:0@2-14x10", gov=gov,
                                    supersteps=24)
    _same(t_drv, j_drv, ts, js)
    evs = t_drv.membership_events
    assert evs and evs[0]["to"].active_ids == (1, 2, 3, 4)
    assert evs[-1]["to"].is_full


def test_deadline_policy_without_faults_runs_full_membership(pca):
    gov = dict(straggler_policy="deadline", straggler_deadline_s=1.0)
    t_drv, j_drv, ts, js = _drivers(pca, "", gov=gov, supersteps=3)
    _same(t_drv, j_drv, ts, js)
    assert t_drv.membership_events == [] and t_drv.membership.is_full


def test_prefetch_ring_drains_the_old_cohort(pca):
    t_drv, j_drv, ts, js = _drivers(pca, "death:3@2-900", prefetch=2)
    _same(t_drv, j_drv, ts, js)
    eras = [(r["bucket"], r["n_active"]) for r in t_drv.history]
    assert eras[0] == (10, 5) and eras[-1] == (12, 4)
    assert eras == sorted(eras, key=lambda e: -e[1])


@pytest.mark.parametrize("sync", [True, False])
def test_rejoin_sync_on_and_off(pca, sync):
    t_drv, j_drv, ts, js = _drivers(pca, "death:1@1-3",
                                    gov=dict(sync_on_rejoin=sync),
                                    supersteps=5)
    _same(t_drv, j_drv, ts, js)
    assert t_drv.membership.is_full


def test_sync_rejoined_pulls_rows_to_the_donors_mean(pca):
    drv = _drivers(pca, "death:1@1-2", supersteps=0)[0]
    w = np.arange(15.0, dtype=np.float32).reshape(5, 3)
    drv.state = {"w": torch.from_numpy(w.copy()),
                 "b": torch.from_numpy(w.copy()).to(torch.bfloat16), "t": 3}
    drv._sync_rejoined(Membership.full(5).drop(1, 3),
                       Membership.full(5).drop(3))
    got = drv.state["w"].numpy()
    np.testing.assert_allclose(got[1], w[[0, 2, 4]].mean(0))
    np.testing.assert_array_equal(got[[0, 2, 3, 4]], w[[0, 2, 3, 4]])
    assert drv.state["b"][1].float().tolist() == got[1].tolist()
    assert drv.state["t"] == 3


def test_link_faults_stay_non_elastic_with_records(pca):
    """Link-only schedules keep the full node axis, add `bw_factor` and
    `link_drops` to every record, equal to the reference's; with the
    scenario's scheduled mix they run through `krasulina_xi` and the
    matmul."""
    from repro.core import scenarios as jscen
    from repro_torch.core import scenarios as tscen
    spec = "link:0-1@1-40p0.5,bw:2-3@3-9x4"
    scn = (tscen.make_scenario("ring", "lossy", "iid_pca", n_nodes=N),
           jscen.make_scenario("ring", "lossy", "iid_pca", n_nodes=N))
    t_drv, j_drv, ts, js = _drivers(pca, spec, fault_seed=2, mix_scn=scn)
    _same(t_drv, j_drv, ts, js)
    assert t_drv.membership is None and t_drv.membership_events == []
    assert any(r["link_drops"] for r in t_drv.history)
    assert {r["bw_factor"] for r in t_drv.history} == {1.0, 4.0}


def test_driver_refusals_match_reference(pca):
    js, ts, w0 = pca
    t_cfg = PCARunConfig(averaging=AveragingConfig(mode="gossip", rounds=2))
    state = krasulina.init_krasulina_state(w0, t_cfg.averaging, 4,
                                           device="cpu")
    with pytest.raises(ValueError, match="covers 3 nodes"):
        driver.StreamingDriver(t_cfg, None, state, make_pca_host_sampler(ts),
                               n_nodes=4, batch=8, device="cpu",
                               faults=faults.FaultSchedule.parse(
                                   "death:1@2-4", 3))
    hier = PCARunConfig(averaging=AveragingConfig(mode="hierarchical"))
    with pytest.raises(ValueError, match="hierarchical"):
        driver.StreamingDriver(hier, None, state, make_pca_host_sampler(ts),
                               n_nodes=4, batch=8, device="cpu",
                               faults=faults.FaultSchedule.parse(
                                   "death:1@2-4", 4))
    full = krasulina.build_krasulina_superstep(t_cfg.averaging, 4,
                                               lambda t: 10.0 / t,
                                               device="cpu")
    drv = driver.StreamingDriver(
        t_cfg, None, state, make_pca_host_sampler(ts),
        superstep_builder=lambda B: full, n_nodes=4, batch=8, device="cpu",
        faults=faults.FaultSchedule.parse("death:1@1", 4),
        engine=driver.EngineConfig(superstep=1, prefetch_depth=0,
                                   replan_every=0))
    drv.run(1)  # full membership: fine
    with pytest.raises(ValueError, match="membership-aware"):
        drv.run(1)  # node 1 dies: the 1-arg builder cannot serve it


# ---------------------------------------------------------------------------
# The LM trainer's cohort superstep
# ---------------------------------------------------------------------------

def test_lm_cohort_superstep_matches_gather_run_scatter():
    """Reduced granite-8b (2 layers, f32, Adam), N = 4, node 1 dropped: the
    port's in-place cohort superstep (K = 3 rounds) against the reference's
    `elastic_superstep` of its 3-node superstep. The active rows follow the
    reference within the Adam bounds of tests/test_torch_trainer.py (99.9%
    of the entries within 1e-5, all within 6 lr); the dropped row stays
    bit for bit what it was; losses within rtol 1e-5."""
    from test_torch_trainer import _agree, _draw, _runs, _states
    from repro.train import trainer as jtrainer
    from repro_torch.train import trainer

    jrun, trun = _runs("gossip", "none", "adam")
    mesh, rules, js, ts = _states(jrun, trun)
    ids = (0, 2, 3)
    rng = np.random.default_rng(5)
    toks = _draw(rng, 3 * 6)  # K = 3 rounds of 6 sequences, 2 a node
    batches = {k: v.reshape(3, 3, 2, -1) for k, v in toks.items()}
    with rules():
        jsup = jtrainer.build_superstep(jrun, mesh, n_nodes=3)[0]
        jfn = jax.jit(jdriver.elastic_superstep(jsup, 4))
        js, jm = jfn(js, jnp.asarray(ids, jnp.int32),
                     {k: jnp.asarray(v) for k, v in batches.items()})
    before = convert.train_tree(ts, trun.model)
    cohort = trainer.superstep_builder(trun, None, n_nodes=4, device="cpu")(
        12, Membership.full(4).drop(1))
    ts, tm = cohort(ts, ids, {k: torch.from_numpy(v)
                              for k, v in batches.items()})
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    got = convert.train_tree(ts, trun.model)
    want = jax.tree.map(np.asarray, js)
    rows = lambda tree, r: jax.tree.map(lambda a: a[list(r)], tree)
    _agree(rows(got["params"], ids), rows(want.params, ids), 1e-5,
           frac=0.999, bound=6 * trun.learning_rate)
    for a, b in zip(jax.tree.leaves(rows(got["params"], (1,))),
                    jax.tree.leaves(rows(before["params"], (1,)))):
        np.testing.assert_array_equal(a, b)
    # only the cohort's per-node steps advance, in both packages
    np.testing.assert_array_equal(got["step"], np.asarray(want.opt.step))
    np.testing.assert_array_equal(got["step"], [3, 0, 3, 3])


@pytest.mark.parametrize("sync", [True, False])
def test_lm_rejoin_matches_reference_driver(sync):
    """Reduced granite-8b (f32, Adam), N = 4, through both packages'
    `StreamingDriver` with their own trainer builders under `death:1@1-2`
    (K = 1, no prefetch, open loop): node 1 misses superstep 1 and rejoins
    at superstep 2, with rejoin sync on and off. Without the sync node 1
    re-enters one optimizer step behind the others, so its Adam bias
    correction runs at its own step, as in the reference. Equal membership
    events and per-node steps; losses within rtol 1e-5; parameters within
    the Adam bounds of tests/test_torch_trainer.py (99.9% of the entries
    within 1e-5, all within 6 lr)."""
    from test_torch_trainer import (B, JEngineConfig, JStreamingDriver,
                                    _agree, _draw, _runs, _states)

    jrun, trun = _runs("gossip", "none", "adam")
    mesh, rules, js, ts = _states(jrun, trun)
    sample = lambda rng, n: _draw(rng, n)
    spec = "death:1@1-2"
    with rules():
        with JStreamingDriver(
                jrun, mesh, js, sample, batch=B, n_nodes=4,
                faults=jfaults.FaultSchedule.parse(spec, 4),
                engine=JEngineConfig(superstep=1, prefetch_depth=0,
                                     replan_every=0,
                                     governor=JGovernorConfig(
                                         sync_on_rejoin=sync))) as jdrv:
            js, jhist = jdrv.run(3)
    with driver.StreamingDriver(
            trun, None, ts, sample, batch=B, n_nodes=4, device="cpu",
            faults=faults.FaultSchedule.parse(spec, 4),
            engine=driver.EngineConfig(superstep=1, prefetch_depth=0,
                                       replan_every=0,
                                       governor=GovernorConfig(
                                           sync_on_rejoin=sync))) as drv:
        ts, hist = drv.run(3)
    assert [(e["superstep"], e["to"].active_ids)
            for e in drv.membership_events] == [
        (e["superstep"], e["to"].active_ids) for e in jdrv.membership_events]
    assert [r["n_active"] for r in hist] == [4, 3, 4]
    for r, jr in zip(hist, jhist, strict=True):
        np.testing.assert_allclose(r["metrics"]["loss"],
                                   jr["metrics"]["loss"], rtol=1e-5)
    got = convert.train_tree(ts, trun.model)
    np.testing.assert_array_equal(got["step"], np.asarray(js.opt.step))
    np.testing.assert_array_equal(got["step"],
                                  [3, 3, 3, 3] if sync else [3, 2, 3, 3])
    _agree(got["params"], jax.tree.map(np.asarray, js.params), 1e-5,
           frac=0.999, bound=6 * trun.learning_rate)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

BASE = ["--arch", "granite-8b", "--reduced", "--device", "cpu", "--steps",
        "6", "--superstep", "2", "--averaging", "gossip", "--rounds", "2",
        "--batch", "8", "--seq", "16", "--nodes", "4", "--prefetch", "0"]


@pytest.mark.parametrize("flags,expect", [
    (["--faults", "death:1@1-2"], ["membership superstep 1: (0, 2, 3) B=9",
                                   "membership superstep 2: (0, 1, 2, 3)"]),
    (["--scenario", "tv_rte/clean/iid_pca"],
     ["scenario: tv_rte/clean/iid_pca n=4 R=2"]),
    (["--scenario", "ring/lossy/iid_pca"], ["drops=", "links=link:0-1"]),
    (["--straggler-policy", "drop", "--faults", "slow:0@0-9x10",
      "--straggler-factor", "2"], ["faults: slow:0@0-9x10"]),
    (["--faults", "death:1@1-2", "--no-rejoin-sync"],
     ["membership superstep 2: (0, 1, 2, 3)"]),
])
def test_launcher_flags(capsys, flags, expect):
    launch_train.main(BASE + flags)
    out = capsys.readouterr().out
    rounds = [line for line in out.splitlines() if line.startswith("round")]
    assert len(rounds) == 3 and all("nan" not in r for r in rounds)
    for e in expect:
        assert e in out, (e, out)


def test_launcher_scenario_needs_gossip():
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "granite-8b", "--reduced", "--device",
                           "cpu", "--scenario", "ring/clean/iid_pca"])
