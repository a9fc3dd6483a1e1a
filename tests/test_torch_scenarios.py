"""The scenario harness of the port against the JAX package's, on the CPU.

* the registry: the same eight scenarios with the same configs, axes,
  periods, link schedules and communication factors;
* the operators (numpy in both packages): `topology_matrix`,
  `one_round_matrices` and `window_lambda2` exactly the reference's;
  `build_mix`'s operator stack within 1e-7 (f32 matrix powers) and its
  round -> phase table equal;
* the samplers: `make_drifting_pca_sampler` over the reference's stream and
  `make_skewed_logreg_sampler` draw exactly the reference's numbers, and so
  does `build_stream` for every registered scenario;
* `ScheduledMixOp` against the reference's on the same inputs, at every
  round of a period, with `t` an int or a 0-dim tensor, within rtol 1e-6;
  a constant schedule equals the static operators;
* the Krasulina superstep (N = 8, R = 2, FIG7) and the LM superstep
  (reduced granite-8b, N = 4) through a scenario's scheduled mix against
  the reference's, 3 rounds: Krasulina iterates within rtol 1e-5, LM
  losses within rtol 1e-5, parameters within 1e-5 (Adam: 99.9% of them,
  every one within 6 lr, as tests/test_torch_trainer.py bounds it) and the
  consensus error, a max over leaves of what Adam moved, within rtol 1e-4;
* the fuse refusal: a scheduled or dense operator never fuses
  `krasulina_xi_gossip`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_logreg import LogRegConfig as JLogRegConfig
from repro.configs.paper_pca import FIG7 as JFIG7
from repro.core import krasulina as jkras
from repro.core import mixing as jmix
from repro.core import scenarios as jscen
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.configs.base import AveragingConfig
from repro_torch.configs.paper_logreg import LogRegConfig
from repro_torch.configs.paper_pca import FIG7
from repro_torch.core import krasulina, mixing
from repro_torch.core import scenarios as scen
from repro_torch.data import synthetic as syn

# one intra-op thread: pytest-xdist runs several workers on the machine's
# cores, and a thread pool of every core in each of them oversubscribes
# the cores (a reduced-granite step then takes tens of times longer)
torch.set_num_threads(1)

NAMES = scen.scenario_names()


def _jcfg(scn):
    """The reference's ScenarioConfig with the port's field values."""
    from repro.configs.base import ScenarioConfig as JScenarioConfig
    return JScenarioConfig(**dataclasses.asdict(scn))


def test_registry_matches_reference():
    assert NAMES == jscen.scenario_names() and len(NAMES) == 8
    for name in NAMES:
        assert (dataclasses.asdict(scen.get_scenario(name))
                == dataclasses.asdict(jscen.get_scenario(name)))
    assert scen.TOPOLOGY_AXIS == jscen.TOPOLOGY_AXIS
    assert scen.LINK_AXIS == jscen.LINK_AXIS
    assert scen.STREAM_AXIS == jscen.STREAM_AXIS
    with pytest.raises(KeyError, match="unknown scenario"):
        scen.get_scenario("nope")


@pytest.mark.parametrize("name", NAMES)
def test_scenario_operators_match_reference(name):
    scn = scen.get_scenario(name)
    jscn = jscen.get_scenario(name)
    assert scen.scenario_period(scn) == jscen.scenario_period(jscn)
    got, want = scen.one_round_matrices(scn), jscen.one_round_matrices(jscn)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert mixing.is_doubly_stochastic(a)
    assert scen.window_lambda2(scn) == jscen.window_lambda2(jscn)
    assert scen.window_lambda2(scn, 2) == jscen.window_lambda2(jscn, 2)
    assert scen.window_lambda2(scn) < 1.0
    for t in (1, 5, 100):
        assert scen.comm_factor(scn, t) == jscen.comm_factor(jscn, t)
    assert (dataclasses.asdict(scen.averaging_config(scn))
            == dataclasses.asdict(jscen.averaging_config(jscn)))
    mix = scen.build_mix(scn, device="cpu")
    jm = jscen.build_mix(jscn)
    np.testing.assert_allclose(mix.A_stack.numpy(), np.asarray(jm.A_stack),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(mix.phase_by_round.numpy(),
                                  np.asarray(jm.phase_by_round))
    assert (mix.n, mix.rounds, mix.period, mix.n_phases) == (
        jm.n, jm.rounds, jm.period, jm.n_phases)
    assert [mix.phase_at(t) for t in range(2 * mix.period)] == [
        jm.phase_at(t) for t in range(2 * jm.period)]


@pytest.mark.parametrize("topology", scen.TOPOLOGIES)
@pytest.mark.parametrize("n", [2, 3, 6, 9, 12])
def test_topology_matrix_matches_reference(topology, n):
    for seed in (0, 3):
        np.testing.assert_array_equal(
            scen.topology_matrix(topology, n, seed=seed),
            jscen.topology_matrix(topology, n, seed=seed))


def test_make_scenario_and_validation_match_reference():
    for topo in scen.TOPOLOGY_AXIS:
        for link in scen.LINK_AXIS:
            scn = scen.make_scenario(topo, link, "iid_pca", n_nodes=4)
            jscn = jscen.make_scenario(topo, link, "iid_pca", n_nodes=4)
            assert dataclasses.asdict(scn) == dataclasses.asdict(jscn)
            mix = scen.build_mix(scn, device="cpu")
            np.testing.assert_allclose(
                mix.A_stack.numpy(), np.asarray(jscen.build_mix(jscn).A_stack),
                rtol=0, atol=1e-7)
    bad = dataclasses.replace(scen.get_scenario("ring/lossy/iid_pca"),
                              links="death:1@2")
    with pytest.raises(ValueError, match="node faults"):
        scen.build_mix(bad)
    with pytest.raises(ValueError, match="already registered"):
        scen.register(scen.get_scenario(NAMES[0]))


# ---------------------------------------------------------------------------
# Samplers: the reference's draws
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fig7_stream():
    js = jsyn.make_pca_stream(JFIG7)
    ts = convert.pca_stream(np.asarray(js.cov), np.asarray(js.sqrt_cov),
                            np.asarray(js.top_eigvec), js.lambda1,
                            js.eigengap, device="cpu")
    return js, ts


def test_drifting_sampler_draws_match_reference(fig7_stream):
    js, ts = fig7_stream
    cfg = FIG7
    t = syn.make_drifting_pca_sampler(cfg, rate=2e-3, stream=ts)
    j = jsyn.make_drifting_pca_sampler(JFIG7, rate=2e-3)
    rt, rj = np.random.default_rng(4), np.random.default_rng(4)
    for n in (7, 100, 33):
        np.testing.assert_array_equal(t.sample(rt, n)["z"],
                                      j.sample(rj, n)["z"])
    for s in (0, 140, 1e4):
        np.testing.assert_array_equal(t.top_eigvec_at(s), j.top_eigvec_at(s))
        np.testing.assert_array_equal(t.cov_at(s), j.cov_at(s))
    assert (t.rate, t.lambda1, t.eigengap) == (j.rate, j.lambda1, j.eigengap)


@pytest.mark.parametrize("alpha", [0.3, 5.0, float("inf")])
def test_skewed_sampler_draws_match_reference(alpha):
    cfg = LogRegConfig(dim=5, generator="cond_gauss", noise_var=2.0, seed=3)
    jcfg = JLogRegConfig(dim=5, generator="cond_gauss", noise_var=2.0, seed=3)
    t = syn.make_skewed_logreg_sampler(cfg, 6, alpha=alpha)
    j = jsyn.make_skewed_logreg_sampler(jcfg, 6, alpha=alpha)
    np.testing.assert_array_equal(t.w_star, j.w_star)
    np.testing.assert_array_equal(t.node_pos_prob, j.node_pos_prob)
    rt, rj = np.random.default_rng(1), np.random.default_rng(1)
    for n in (12, 61):
        a, b = t.sample(rt, n), j.sample(rj, n)
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
    with pytest.raises(ValueError, match="concentration"):
        syn.make_skewed_logreg_sampler(cfg, 6, alpha=0.0)


@pytest.mark.parametrize("name", NAMES)
def test_build_stream_draws_match_reference(name, fig7_stream):
    js, ts = fig7_stream
    scn = scen.get_scenario(name)
    jscn = jscen.get_scenario(name)
    t = scen.build_stream(scn, pca=ts)  # the scenarios' seed is FIG7's, 0
    j = jscen.build_stream(jscn)
    assert t.kind == j.kind
    rt, rj = np.random.default_rng(2), np.random.default_rng(2)
    for n in (16, 40):
        a, b = t.sample(rt, n), j.sample(rj, n)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# ScheduledMixOp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tv_rte/clean/iid_pca", "ring/lossy/iid_pca",
                                  "geometric/lossy/skew_logreg"])
def test_scheduled_mix_op_matches_reference(name):
    scn = scen.get_scenario(name)
    mix = scen.build_mix(scn, device="cpu")
    jm = jscen.build_mix(_jcfg(scn))
    x = np.random.default_rng(0).standard_normal((scn.n_nodes, 3, 5)).astype(
        np.float32)
    for t in list(range(1, mix.period + 2)) + [None]:
        want = np.asarray(jm(jnp.asarray(x), t=t))
        for tt in ((t, torch.tensor(t)) if t is not None else (None,)):
            got = mix(torch.from_numpy(x), t=tt).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        mix(torch.from_numpy(x), phase=1).numpy(),
        np.asarray(jm(jnp.asarray(x), phase=1)), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="node axis"):
        mix(torch.zeros(scn.n_nodes + 1, 2))


def test_constant_schedule_equals_the_static_operators():
    n, R = 8, 2
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, 11)).astype(np.float32))
    ring = mixing.schedule("ring", n)
    sched = mixing.scheduled_mix_op([ring], n, R, device="cpu")
    static = mixing.circulant_mix_op(ring, n, R, impl="matmul", device="cpu")
    assert torch.equal(sched(x, t=5), static(x))
    A = scen.topology_matrix("geometric", n, seed=4)
    dense = mixing.dense_mix_op(A, R, device="cpu")
    assert torch.equal(mixing.scheduled_mix_op([A], n, R, device="cpu")(
        x, t=3), dense(x))
    with pytest.raises(ValueError, match="phase ids"):
        mixing.scheduled_mix_op([ring], n, R, phase_by_round=(0, 1))


def test_scheduled_and_dense_mix_never_fuse():
    ring = mixing.schedule("ring", 4)
    for mix in (mixing.scheduled_mix_op([ring], 4, 2, device="cpu"),
                mixing.dense_mix_op(mixing.ring_matrix(4), 2, device="cpu")):
        assert not krasulina._resolve_fuse_xi(mix, True, "cpu")
    for jm in (jmix.scheduled_mix_op([ring], 4, 2),
               jmix.dense_mix_op(jmix.ring_matrix(4), 2)):
        assert not jkras._resolve_fuse_xi(jm, True)


# ---------------------------------------------------------------------------
# Supersteps through a scenario's scheduled mix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tv_rte/clean/iid_pca",
                                  "ring/lossy/iid_pca"])
def test_krasulina_superstep_with_scheduled_mix_matches_reference(name):
    scn = scen.get_scenario(name)
    N, R, K = scn.n_nodes, scn.rounds, 5
    stepsize = lambda t: 5.0 / t
    w0 = np.random.default_rng(1).standard_normal(FIG7.dim).astype(np.float32)
    w0 /= np.linalg.norm(w0)
    z = np.random.default_rng(2).standard_normal(
        (K, N, 4, FIG7.dim)).astype(np.float32)
    av = AveragingConfig(mode="gossip", rounds=R)
    build = krasulina.krasulina_superstep_builder(
        av, N, stepsize, mix=scen.build_mix(scn, device="cpu"),
        device="cpu")
    ts, tm = build(4 * N)(krasulina.init_krasulina_state(w0, av, N,
                                                         device="cpu"),
                          {"z": torch.from_numpy(z)})
    jav = jscen.averaging_config(jscen.get_scenario(name))
    jsup = jkras.build_krasulina_superstep(jav, N, stepsize,
                                           mix=jscen.build_mix(
                                               jscen.get_scenario(name)))
    js, jm = jax.jit(jsup)(jkras.init_krasulina_state(jnp.asarray(w0), jav,
                                                      N),
                           {"z": jnp.asarray(z)})
    assert ts.t == int(js.t) == K
    np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tm["consensus_err"].numpy(),
                               np.asarray(jm["consensus_err"]), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["tv_rte/clean/iid_pca",
                                  "ring/lossy/iid_pca"])
def test_lm_superstep_with_scheduled_mix_matches_reference(name):
    """Reduced granite-8b (2 layers, f32, Adam), N = 4 (the scenario
    re-rooted), K = 3 rounds through the scheduled mix, the optimizer step
    its phase clock, in both packages."""
    from test_torch_trainer import B, _agree, _batch, _runs, _states
    from repro.train import trainer as jtrainer
    from repro_torch.train import trainer

    scn = dataclasses.replace(scen.get_scenario(name), n_nodes=4)
    jrun, trun = _runs("gossip", "none", "adam", rounds=scn.rounds)
    mesh, rules, js, ts = _states(jrun, trun)
    b = _batch(np.random.default_rng(3), True, k=3)
    with rules():
        jsup = jax.jit(jtrainer.build_superstep(
            jrun, mesh, n_nodes=4, mix=jscen.build_mix(_jcfg(scn)))[0])
        js, jm = jsup(js, {k: jnp.asarray(v) for k, v in b.items()})
    build = trainer.superstep_builder(trun, None, n_nodes=4, device="cpu",
                                      mix=scen.build_mix(scn, device="cpu"))
    ts, tm = build(B)(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    for k, rtol in (("loss", 1e-5), ("consensus_err", 1e-4)):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=rtol, err_msg=k)
    _agree(convert.train_tree(ts, trun.model)["params"],
           jax.tree.map(np.asarray, js.params), 1e-5, frac=0.999,
           bound=6 * trun.learning_rate)


def test_quantized_lm_config_refuses_a_scheduled_mix():
    from test_torch_trainer import _runs
    from repro_torch.train import trainer

    _, trun = _runs("gossip", "int8", "sgd")
    mix = scen.build_mix(scen.get_scenario("ring/clean/iid_pca"),
                         device="cpu")
    with pytest.raises(ValueError, match="linear-only"):
        trainer.build_train_step(trun, None, n_nodes=8, mix=mix,
                                 device="cpu")
