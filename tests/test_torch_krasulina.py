"""The port's D(M)-Krasulina (`repro_torch.core.krasulina`) against
`repro.core.krasulina` on the same numbers: the reference's Fig. 7 stream
carried across by `repro_torch.convert`, the same [K, N, Bn, d] batches made
with numpy from a seed, exact and gossip, fused and unfused. Tolerance rtol
1e-4 / atol 1e-5 on iterates after K <= 3 rounds (f32 reassociation between
XLA and PyTorch, and the reference's composed vs per-round schedules)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AveragingConfig as JAveragingConfig
from repro.configs.paper_pca import FIG7 as JFIG7
from repro.core import krasulina as jkras
from repro.core import problems as jproblems
from repro.data.synthetic import make_pca_stream as jmake_pca_stream
from repro_torch import convert
from repro_torch.configs.base import AveragingConfig
from repro_torch.configs.paper_pca import FIG7
from repro_torch.core import krasulina, problems
from repro_torch.core.mixing import Membership
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def streams():
    js = jmake_pca_stream(JFIG7)
    ts = convert.pca_stream(np.asarray(js.cov), np.asarray(js.sqrt_cov),
                            np.asarray(js.top_eigvec), js.lambda1,
                            js.eigengap, device="cpu")
    return js, ts


def _w0(seed=0):
    w = np.random.default_rng(seed).standard_normal(FIG7.dim).astype(np.float32)
    return w / np.linalg.norm(w)


def _avg(mode, rounds=3, topology="ring"):
    return (AveragingConfig(mode=mode, rounds=rounds, topology=topology),
            JAveragingConfig(mode=mode, rounds=rounds, topology=topology))


@pytest.mark.parametrize("mode,fuse", [("exact", None), ("gossip", True),
                                       ("gossip", False)])
@pytest.mark.parametrize("topology", ["ring", "circulant2"])
def test_superstep_matches_reference(streams, mode, fuse, topology):
    js, ts = streams
    N, Bn, K = 5, 4, 3
    avg, javg = _avg(mode, 3, topology)
    step = lambda t: 10.0 / t
    tmetric = lambda w: problems.pca_excess_risk(w, ts.cov, ts.lambda1)
    jmetric = lambda w: jproblems.pca_excess_risk(w, js.cov, js.lambda1)
    z = np.random.default_rng(1).standard_normal(
        (K, N, Bn, FIG7.dim)).astype(np.float32)
    if mode == "exact":
        z = z.reshape(K, N * Bn, FIG7.dim)
    w0 = _w0()
    tsup = krasulina.build_krasulina_superstep(avg, N, step, metric=tmetric,
                                               fuse_xi=fuse, device="cpu")
    jsup = jkras.build_krasulina_superstep(javg, N, step, metric=jmetric,
                                           fuse_xi=fuse)
    tstate, tm = tsup(krasulina.init_krasulina_state(w0, avg, N, device="cpu"),
                      {"z": torch.from_numpy(z)})
    jstate, jm = jax.jit(jsup)(jkras.init_krasulina_state(jnp.asarray(w0),
                                                          javg, N),
                               {"z": jnp.asarray(z)})
    assert tstate.t == int(jstate.t) == K
    np.testing.assert_allclose(tstate.w.numpy(), np.asarray(jstate.w), **TOL)
    for key in ("metric", "consensus_err"):
        assert tm[key].shape == (K,)
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]),
                                   **TOL)


def test_superstep_equals_sequential_rounds():
    """One K-round superstep == K one-round supersteps (gossip, fused)."""
    N, Bn, K = 4, 5, 3
    avg, _ = _avg("gossip", 4)
    sup = krasulina.build_krasulina_superstep(avg, N, lambda t: 10.0 / t,
                                              fuse_xi=True, device="cpu")
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (K, N, Bn, FIG7.dim)).astype(np.float32))
    state0 = krasulina.init_krasulina_state(_w0(), avg, N, device="cpu")
    seq = krasulina.KrasulinaState(state0.w.clone(), state0.t)
    full, ms = sup(state0, {"z": z})
    seq_metrics = []
    for k in range(K):
        seq, m = sup(seq, {"z": z[k:k + 1]})
        seq_metrics.append(m["consensus_err"][0])
    assert full.t == seq.t == K
    np.testing.assert_allclose(full.w.numpy(), seq.w.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ms["consensus_err"].numpy(),
                               torch.stack(seq_metrics).numpy(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("averaging", [None, "gossip"])
def test_run_d_krasulina_matches_reference_on_fixed_draws(streams, averaging):
    """With a `draw` that ignores its key/generator (one fixed batch, every
    round), both packages see the same samples, so whole trajectories can be
    compared: 6 rounds, N=4, B=40, R=4."""
    js, ts = streams
    Z = np.random.default_rng(3).standard_normal(
        (40, FIG7.dim)).astype(np.float32)
    kw = dict(N=4, B=40, steps=6, stepsize=lambda t: 10.0 / t)
    avg, javg = ((None, None) if averaging is None else _avg("gossip", 4))
    res = krasulina.run_d_krasulina(
        lambda g, n: torch.from_numpy(Z), torch.from_numpy(_w0()),
        averaging=avg, device="cpu",
        trace_metric=lambda w: problems.sin2_error(w, ts.top_eigvec), **kw)
    jres = jkras.run_d_krasulina(
        lambda k, n: jnp.asarray(Z), jnp.asarray(_w0()), averaging=javg,
        trace_metric=lambda w: jproblems.sin2_error(w, js.top_eigvec), **kw)
    np.testing.assert_allclose(res.w_nodes.numpy(), np.asarray(jres.w_nodes),
                               **TOL)
    np.testing.assert_allclose(res.trace_metric.numpy(),
                               np.asarray(jres.trace_metric), **TOL)
    np.testing.assert_array_equal(res.trace_t_prime.numpy(),
                                  np.asarray(jres.trace_t_prime))


def test_dm_krasulina_is_exact_d_krasulina_and_converges(streams):
    _, ts = streams
    metric = lambda w: problems.pca_excess_risk(w, ts.cov, ts.lambda1)
    kw = dict(N=4, B=100, steps=300, stepsize=lambda t: 10.0 / t,
              trace_metric=metric, seed=1, device="cpu")
    w0 = torch.from_numpy(_w0())
    dm = krasulina.run_dm_krasulina(ts.draw, w0, **kw)
    d = krasulina.run_d_krasulina(ts.draw, w0, **kw)
    np.testing.assert_array_equal(dm.w.numpy(), d.w.numpy())
    assert d.w_nodes.shape == (4, FIG7.dim)
    # the caller keeps w0: the in-place updates work on a copy
    np.testing.assert_array_equal(w0.numpy(), _w0())
    # R = 12 ring gossip on N = 4 tracks the exact oracle (as in the
    # reference's own test), and both find the top eigenvector
    g = krasulina.run_d_krasulina(ts.draw, w0,
                                  averaging=AveragingConfig(mode="gossip",
                                                            rounds=12), **kw)
    np.testing.assert_allclose(g.w.numpy(), dm.w.numpy(), rtol=1e-3,
                               atol=1e-4)
    assert float(dm.trace_metric[-1]) < 1e-2
    assert float(g.trace_metric[-1]) < 1e-2


def test_run_d_krasulina_fused_matches_mix_path(streams):
    _, ts = streams
    kw = dict(N=4, B=40, steps=50, stepsize=lambda t: 10.0 / t,
              averaging=AveragingConfig(mode="gossip", rounds=4), seed=9,
              device="cpu")
    w0 = torch.from_numpy(_w0())
    a = krasulina.run_d_krasulina(ts.draw, w0, fuse_xi=True, **kw)
    b = krasulina.run_d_krasulina(ts.draw, w0, fuse_xi=False, **kw)
    np.testing.assert_allclose(a.w_nodes.numpy(), b.w_nodes.numpy(), **TOL)


def test_guards_and_later_slices():
    step = lambda t: 1.0 / t
    with pytest.raises(ValueError, match="exact|gossip"):
        krasulina.build_krasulina_superstep(
            AveragingConfig(mode="hierarchical"), 4, step, device="cpu")
    # quantized gossip builds now (it used to raise), and never fuses
    quantized = krasulina.build_krasulina_superstep(
        AveragingConfig(mode="gossip", quantization="sign"), 4, step,
        fuse_xi=True, device="cpu")
    assert callable(quantized)
    build = krasulina.krasulina_superstep_builder(
        AveragingConfig(mode="gossip"), 4, step, device="cpu")
    assert build(40) is build(80, Membership.full(4))
    # a cohort superstep (elastic membership) is built once per cohort size
    cohort = build(39, Membership.full(4).drop(1))
    assert cohort is build(42, Membership.full(4).drop(2)) is not build(40)
    with pytest.raises(ValueError, match="split evenly"):
        krasulina.run_d_krasulina(lambda g, n: None, torch.zeros(3), N=4,
                                  B=10, steps=1, stepsize=step, device="cpu")


QUANT_AVG = [("sign", "tile", 4), ("int8", "tile", 4), ("int8", "global", 512),
             ("sign", "node", 8)]


@pytest.mark.parametrize("quant,stats,block_d", QUANT_AVG)
def test_quantized_superstep_matches_reference(streams, quant, stats, block_d):
    """Quantized gossip D-Krasulina, K = 3 rounds on the same fixed batches:
    the reference's jitted superstep and the port's, rtol 1e-4 / atol 1e-5.
    block_d 4 < d = 10 puts three statistic tiles on each buffer."""
    js, ts = streams
    N, Bn, K = 5, 4, 3
    kw = dict(mode="gossip", rounds=3, quantization=quant, quant_stats=stats,
              quant_block_d=block_d)
    avg, javg = AveragingConfig(**kw), JAveragingConfig(**kw)
    step = lambda t: 10.0 / t
    z = np.random.default_rng(4).standard_normal(
        (K, N, Bn, FIG7.dim)).astype(np.float32)
    w0 = _w0(2)
    tsup = krasulina.build_krasulina_superstep(
        avg, N, step, metric=lambda w: problems.sin2_error(w, ts.top_eigvec),
        device="cpu")
    jsup = jkras.build_krasulina_superstep(
        javg, N, step, metric=lambda w: jproblems.sin2_error(w, js.top_eigvec))
    tstate, tm = tsup(krasulina.init_krasulina_state(w0, avg, N, device="cpu"),
                      {"z": torch.from_numpy(z)})
    jstate, jm = jax.jit(jsup)(jkras.init_krasulina_state(jnp.asarray(w0),
                                                          javg, N),
                               {"z": jnp.asarray(z)})
    np.testing.assert_allclose(tstate.w.numpy(), np.asarray(jstate.w), **TOL)
    for key in ("metric", "consensus_err"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), **TOL)


@pytest.mark.parametrize("quant", ["sign", "int8"])
def test_quantized_run_d_krasulina_matches_reference_on_fixed_draws(streams,
                                                                    quant):
    """Whole trajectories (8 rounds, N = 4, B = 40, R = 4, tile statistics
    at block_d 4) on one fixed batch: rtol 1e-4 / atol 1e-5."""
    js, ts = streams
    Z = np.random.default_rng(5).standard_normal(
        (40, FIG7.dim)).astype(np.float32)
    kw = dict(N=4, B=40, steps=8, stepsize=lambda t: 10.0 / t)
    akw = dict(mode="gossip", rounds=4, quantization=quant, quant_stats="tile",
               quant_block_d=4)
    res = krasulina.run_d_krasulina(
        lambda g, n: torch.from_numpy(Z), torch.from_numpy(_w0()),
        averaging=AveragingConfig(**akw), device="cpu",
        trace_metric=lambda w: problems.sin2_error(w, ts.top_eigvec), **kw)
    jres = jkras.run_d_krasulina(
        lambda k, n: jnp.asarray(Z), jnp.asarray(_w0()),
        averaging=JAveragingConfig(**akw),
        trace_metric=lambda w: jproblems.sin2_error(w, js.top_eigvec), **kw)
    np.testing.assert_allclose(res.w_nodes.numpy(), np.asarray(jres.w_nodes),
                               **TOL)
    np.testing.assert_allclose(res.trace_metric.numpy(),
                               np.asarray(jres.trace_metric), **TOL)


@pytest.mark.parametrize("quant", ["sign", "int8", "int8_stoch"])
def test_quantized_config_never_fuses(quant, monkeypatch):
    """Repair of the fusion check: a quantized mix never reaches the fused
    (exact-wire) xi+gossip kernel, whatever `fuse_xi` asks and whatever the
    device; the superstep then runs mix(krasulina_xi(w, z))."""
    avg = AveragingConfig(mode="gossip", rounds=2, quantization=quant,
                          quant_stats="tile", quant_block_d=4)
    mix = krasulina.make_gossip_mix(avg, 4, device="cpu")
    for fuse_xi in (None, True, False):
        for device in ("cpu", "cuda"):
            assert krasulina._resolve_fuse_xi(mix, fuse_xi, device) is False

    def refuse(*a, **k):
        raise AssertionError("a quantized config reached the fused kernel")

    monkeypatch.setattr(krasulina, "krasulina_xi_gossip", refuse)
    sup = krasulina.build_krasulina_superstep(avg, 4, lambda t: 1.0 / t,
                                              fuse_xi=True, device="cpu")
    z = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 4, 5, 10)).astype(np.float32))
    w0 = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, 10)).astype(np.float32))
    state, _ = sup(krasulina.KrasulinaState(w0.clone(), 0), {"z": z[:1]})
    want = w0 + mix(tref.krasulina_xi_ref(w0, z[0]), key=1
                    if quant == "int8_stoch" else None)
    np.testing.assert_allclose(state.w.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_stochastic_noise_fresh_per_step():
    """Repair of the per-step key (the form of
    tests/test_krasulina_engine.py's test): int8_stoch gossip with the same
    round counter t gives the same mixed update, another t another."""
    avg = AveragingConfig(mode="gossip", rounds=2, quantization="int8_stoch")
    mix = krasulina.make_gossip_mix(avg, 4, device="cpu")
    w = torch.randn(4, 10, generator=torch.Generator().manual_seed(0))
    z = torch.randn(4, 5, 10, generator=torch.Generator().manual_seed(1))
    h1 = krasulina._gossip_xi(w, z, mix, False, 1)
    h1b = krasulina._gossip_xi(w, z, mix, False, 1)
    h2 = krasulina._gossip_xi(w, z, mix, False, 2)
    assert torch.equal(h1, h1b)
    assert not torch.equal(h1, h2)
    # and the superstep passes its round counter: two rounds on identical
    # samples from identical iterates move differently
    sup = krasulina.build_krasulina_superstep(avg, 4, lambda t: 1.0,
                                              device="cpu")
    zz = torch.stack([z, z])
    s1, _ = sup(krasulina.KrasulinaState(w.clone(), 0), {"z": zz[:1]})
    s2, _ = sup(krasulina.KrasulinaState(w.clone(), 1), {"z": zz[:1]})
    assert not torch.equal(s1.w, s2.w)


def test_quantized_gossip_converges_on_the_port(streams):
    """The reference's contract for quantized D-Krasulina
    (tests/test_krasulina_engine.py): sign tile-statistics gossip ends
    finite and below where it started."""
    _, ts = streams
    res = krasulina.run_d_krasulina(
        ts.draw, torch.from_numpy(_w0()), N=4, B=40, steps=200,
        stepsize=lambda t: 10.0 / t, seed=1, device="cpu",
        averaging=AveragingConfig(mode="gossip", rounds=4, quantization="sign",
                                  quant_stats="tile", quant_block_d=4),
        trace_metric=lambda w: problems.pca_excess_risk(w, ts.cov, ts.lambda1))
    assert np.isfinite(float(res.trace_metric[-1]))
    assert float(res.trace_metric[-1]) < float(res.trace_metric[0])


def test_theorem5_Q_matches_reference():
    for args in ((10, 10.0, 1.0, 10.0), (3072, 3.3, 2.0, 5.0)):
        assert krasulina.theorem5_Q(*args) == jkras.theorem5_Q(*args)


def test_convert_state_and_schedule():
    st = convert.krasulina_state(np.ones((3, 4), np.float32), np.int32(7),
                                 device="cpu")
    assert st.t == 7 and st.w.shape == (3, 4) and st.w.dtype == torch.float32
    assert convert.schedule([(np.int64(0), np.float32(0.5)),
                             (1, 0.5)]) == ((0, 0.5), (1, 0.5))
