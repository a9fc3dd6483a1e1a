"""The port's convex track against the JAX package on the same numbers: the
logistic losses (`core/problems.py`), the logistic-regression streams with
the reference's ground truth carried across (`data/synthetic.py`,
`convert.logreg_stream`), and the drivers `run_dmb`, `run_dsgd` (plain,
accelerated, over a dense expander and over a quantized circulant MixOp),
`run_local_sgd` and `run_dgd`.

A `draw` that ignores its key / generator and returns the first n rows of
one fixed numpy sample makes both packages see the same data, so whole
trajectories are compared: rtol 1e-4 / atol 1e-5 on iterates and metrics
(f32 reassociation between XLA and PyTorch over up to 30 steps). The
streams' own draws match the reference in distribution only, and are held
to that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_logreg import FIG6 as JFIG6
from repro.configs.paper_logreg import FIG9 as JFIG9
from repro.core import dmb as jdmb
from repro.core import dsgd as jdsgd
from repro.core import mixing as jmix
from repro.core import problems as jprob
from repro.data.synthetic import make_logreg_stream as jmake_logreg_stream
from repro_torch import convert
from repro_torch.configs.base import AveragingConfig
from repro_torch.configs.paper_logreg import FIG6, FIG9
from repro_torch.core import averaging, dmb, dsgd, mixing, problems
from repro_torch.data.synthetic import logreg_w_star, make_logreg_stream

TOL = dict(rtol=1e-4, atol=1e-5)
D = 5  # feature dimension of the fixed samples


def _fixed(seed=0, rows=400, d=D):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    w = rng.standard_normal(d + 1).astype(np.float32)
    y = np.where(x @ w[:-1] + w[-1] + 0.5 * rng.standard_normal(rows) > 0,
                 1.0, -1.0).astype(np.float32)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    return ((lambda k, n: (jx[:n], jy[:n])),
            (lambda g, n: (tx[:n], ty[:n])), (jx, jy), (tx, ty))


def _metrics(seed=9):
    _, _, (jx, jy), (tx, ty) = _fixed(seed, rows=200)
    return (lambda w: jprob.logistic_loss(w, jx, jy),
            lambda w: problems.logistic_loss(w, tx, ty))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.numpy()


def _same(res, jres, fields=("w", "w_av", "trace_metric")):
    for f in fields:
        np.testing.assert_allclose(_np(getattr(res, f)),
                                   _np(getattr(jres, f)), **TOL)
    np.testing.assert_array_equal(_np(res.trace_t_prime),
                                  _np(jres.trace_t_prime))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def test_logistic_loss_grad_and_projection_match_reference():
    """Closed-form gradient against `jax.grad`: rtol 1e-5 / atol 1e-6."""
    _, _, (jx, jy), (tx, ty) = _fixed(1, rows=64)
    for seed in range(3):
        w = np.random.default_rng(seed).standard_normal(D + 1).astype(
            np.float32) * 3
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
        np.testing.assert_allclose(float(problems.logistic_loss(tw, tx, ty)),
                                   float(jprob.logistic_loss(jw, jx, jy)),
                                   rtol=1e-6)
        np.testing.assert_allclose(problems.logistic_grad(tw, tx, ty).numpy(),
                                   np.asarray(jprob.logistic_grad(jw, jx, jy)),
                                   rtol=1e-5, atol=1e-6)
        for radius in (0.5, 100.0):
            np.testing.assert_allclose(
                problems.project_ball(tw, radius).numpy(),
                np.asarray(jprob.project_ball(jw, radius)), rtol=1e-6)
    _, tdraw, _, _ = _fixed(1, rows=64)
    risk = problems.logistic_risk(torch.zeros(D + 1), tdraw, None, n=64)
    np.testing.assert_allclose(float(risk), np.log(2.0), rtol=1e-6)


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------

def _reference_mus(cfg):
    """The class means the reference draws for the conditional Gaussians."""
    km, = jax.random.split(jax.random.PRNGKey(cfg.seed), 1)
    return np.array(jax.random.normal(km, (2, cfg.dim)))


def test_carried_w_star_is_the_references():
    js = jmake_logreg_stream(JFIG9)
    mus = _reference_mus(JFIG9)
    ts = convert.logreg_stream(FIG9, np.asarray(js.w_star), mus, device="cpu")
    np.testing.assert_array_equal(ts.w_star.numpy(), np.asarray(js.w_star))
    # the separator the port derives from those means is the reference's
    np.testing.assert_allclose(
        logreg_w_star(FIG9, torch.from_numpy(mus)).numpy(),
        np.asarray(js.w_star), rtol=1e-6, atol=1e-6)
    js6 = jmake_logreg_stream(JFIG6)
    ts6 = convert.logreg_stream(FIG6, np.asarray(js6.w_star), device="cpu")
    np.testing.assert_array_equal(ts6.w_star.numpy(), np.asarray(js6.w_star))
    with pytest.raises(ValueError, match="class means"):
        convert.logreg_stream(FIG9, np.asarray(js.w_star), device="cpu")
    with pytest.raises(ValueError, match="class means"):
        convert.logreg_stream(FIG6, np.asarray(js6.w_star), mus, device="cpu")


@pytest.mark.parametrize("which", ["fig6", "fig9"])
def test_carried_stream_draws_the_references_distribution(which):
    """Same problem, different numbers: the Bayes risk (the loss at w*)
    of 40,000 port draws and of 40,000 reference draws agree within 0.01
    (about 5 standard errors), and so do the label balances."""
    jcfg, cfg = (JFIG6, FIG6) if which == "fig6" else (JFIG9, FIG9)
    js = jmake_logreg_stream(jcfg)
    mus = None if which == "fig6" else _reference_mus(jcfg)
    ts = convert.logreg_stream(cfg, np.asarray(js.w_star), mus, device="cpu")
    x, y = ts.draw(torch.Generator().manual_seed(1), 40_000)
    jx, jy = js.draw(jax.random.PRNGKey(1), 40_000)
    assert x.shape == (40_000, cfg.dim) and set(y.unique().tolist()) == {-1.0, 1.0}
    np.testing.assert_allclose(
        float(problems.logistic_loss(ts.w_star, x, y)),
        float(jprob.logistic_loss(js.w_star, jx, jy)), atol=0.01)
    np.testing.assert_allclose(float(y.mean()), float(jy.mean()), atol=0.03)


def test_make_logreg_stream_is_seeded_and_consistent():
    a, b = (make_logreg_stream(FIG9, device="cpu") for _ in range(2))
    assert torch.equal(a.w_star, b.w_star) and a.mus.shape == (2, FIG9.dim)
    assert torch.equal(a.w_star, logreg_w_star(FIG9, a.mus))
    x1, _ = a.draw(torch.Generator().manual_seed(3), 10)
    x2, _ = b.draw(torch.Generator().manual_seed(3), 10)
    assert torch.equal(x1, x2)
    s6 = make_logreg_stream(FIG6, device="cpu")
    assert s6.w_star.shape == (FIG6.dim + 1,) and s6.mus is None


# ---------------------------------------------------------------------------
# Drivers on fixed draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,B,mu", [(4, 40, 0), (5, 20, 13), (1, 8, 0)])
def test_run_dmb_matches_reference(N, B, mu):
    jdraw, tdraw, _, _ = _fixed(2)
    jm, tm = _metrics()
    kw = dict(N=N, B=B, mu=mu, steps=25, stepsize=lambda t: 2.0 / t ** 0.5)
    res = dmb.run_dmb(problems.logistic_grad, tdraw, torch.zeros(D + 1),
                      trace_metric=tm, device="cpu", **kw)
    jres = jdmb.run_dmb(jprob.logistic_grad, jdraw, jnp.zeros(D + 1),
                        trace_metric=jm, **kw)
    _same(res, jres)


def test_run_dmb_tree_w0_matches_reference():
    """A tree w0 is packed once; the user's functions see the tree."""
    jdraw, tdraw, _, _ = _fixed(3)

    def grad_tree(lib):
        def g(p, x, y):
            flat = lib["cat"]([p["w"], p["b"]])
            full = lib["grad"](flat, x, y)
            return {"w": full[:-1], "b": full[-1:]}
        return g

    tlib = {"cat": torch.cat, "grad": problems.logistic_grad}
    jlib = {"cat": jnp.concatenate, "grad": jprob.logistic_grad}
    tproj = lambda p: {"w": problems.project_ball(p["w"], 0.8), "b": p["b"]}
    jproj = lambda p: {"w": jprob.project_ball(p["w"], 0.8), "b": p["b"]}
    kw = dict(N=4, B=20, steps=20, stepsize=lambda t: 1.0 / t ** 0.5)
    res = dmb.run_dmb(grad_tree(tlib), tdraw,
                      {"w": torch.zeros(D), "b": torch.zeros(1)},
                      project=tproj, trace_metric=lambda p: p["b"][0],
                      device="cpu", **kw)
    jres = jdmb.run_dmb(grad_tree(jlib), jdraw,
                        {"w": jnp.zeros(D), "b": jnp.zeros(1)},
                        project=jproj, trace_metric=lambda p: p["b"][0], **kw)
    for k in ("w", "b"):
        np.testing.assert_allclose(res.w[k].numpy(), np.asarray(jres.w[k]),
                                   **TOL)
        np.testing.assert_allclose(res.w_av[k].numpy(),
                                   np.asarray(jres.w_av[k]), **TOL)
    np.testing.assert_allclose(res.trace_metric.numpy(),
                               np.asarray(jres.trace_metric), **TOL)
    with pytest.raises(ValueError, match="single dtype"):
        dmb.run_dmb(grad_tree(tlib), tdraw,
                    {"w": torch.zeros(D), "b": torch.zeros(1).double()},
                    device="cpu", **kw)


@pytest.mark.parametrize("accelerated", [False, True])
@pytest.mark.parametrize("rounds", [0, 1, 3])
def test_run_dsgd_matches_reference(accelerated, rounds):
    N = 8
    jdraw, tdraw, _, _ = _fixed(4)
    jm, tm = _metrics()
    A = jmix.random_regular_expander(N, deg=4, seed=2)
    kw = dict(B=16, rounds=rounds, steps=30, seed=3,
              stepsize=((lambda t: 0.05 * (t + 1.0) / 2.0) if accelerated
                        else (lambda t: 2.5 / t ** 0.5)),
              accelerated=accelerated)
    res = dsgd.run_dsgd(problems.logistic_grad, tdraw, torch.zeros(D + 1), A,
                        trace_metric=tm, device="cpu",
                        project=lambda w: problems.project_ball(w, 2.0), **kw)
    jres = jdsgd.run_dsgd(jprob.logistic_grad, jdraw, jnp.zeros(D + 1),
                          jnp.asarray(A), trace_metric=jm,
                          project=lambda w: jprob.project_ball(w, 2.0), **kw)
    _same(res, jres)


@pytest.mark.parametrize("quant", ["sign", "int8"])
def test_run_dsgd_over_quantized_circulant_matches_reference(quant):
    """The convex quantized-gossip study's engine: a quantized tile-stats
    CirculantMixOp as the D-SGD consensus (block_d 4 < d + 1 = 6)."""
    N = 8
    jdraw, tdraw, _, _ = _fixed(5)
    jm, tm = _metrics()
    sched = mixing.schedule("ring", N)
    mk = dict(quantization=quant, stats="tile", block_d=4)
    kw = dict(B=16, rounds=2, steps=20, stepsize=lambda t: 0.5 / t ** 0.5)
    res = dsgd.run_dsgd(problems.logistic_grad, tdraw, torch.zeros(D + 1),
                        np.eye(N), trace_metric=tm, device="cpu",
                        mix=mixing.circulant_mix_op(sched, N, 2, device="cpu",
                                                    **mk), **kw)
    jres = jdsgd.run_dsgd(jprob.logistic_grad, jdraw, jnp.zeros(D + 1),
                          jnp.eye(N), trace_metric=jm,
                          mix=jmix.circulant_mix_op(sched, N, 2, **mk), **kw)
    _same(res, jres)


def test_run_local_sgd_matches_reference():
    jdraw, tdraw, _, _ = _fixed(6)
    jm, tm = _metrics()
    kw = dict(N=4, B=8, steps=25, stepsize=lambda t: 1.0 / t ** 0.5)
    _same(dsgd.run_local_sgd(problems.logistic_grad, tdraw, torch.zeros(D + 1),
                             trace_metric=tm, device="cpu", **kw),
          jdsgd.run_local_sgd(jprob.logistic_grad, jdraw, jnp.zeros(D + 1),
                              trace_metric=jm, **kw))


@pytest.mark.parametrize("mode", ["naive", "minibatched"])
def test_run_dgd_matches_reference(mode):
    N = 6
    jdraw, tdraw, _, _ = _fixed(7)
    jm, tm = _metrics()
    A = jmix.random_regular_expander(N, deg=2, seed=1)
    kw = dict(B=18, steps=25, stepsize=lambda t: 1.0 / t ** 0.5, mode=mode)
    res = dsgd.run_dgd(problems.logistic_grad, tdraw, torch.zeros(D + 1), A,
                       trace_metric=tm, device="cpu", **kw)
    jres = jdsgd.run_dgd(jprob.logistic_grad, jdraw, jnp.zeros(D + 1),
                         jnp.asarray(A), trace_metric=jm, **kw)
    _same(res, jres)
    with pytest.raises(ValueError, match="DGD mode"):
        dsgd.run_dgd(problems.logistic_grad, tdraw, torch.zeros(D + 1), A,
                     B=18, steps=1, stepsize=lambda t: 1.0, mode="eager",
                     device="cpu")


def test_consensus_and_dense_mix_op_match_reference():
    """rtol / atol 1e-5, the reference's bound for its dense engine."""
    A = jmix.random_regular_expander(16, deg=4, seed=1)
    h = np.random.default_rng(8).standard_normal((16, 24)).astype(np.float32)
    want = np.linalg.matrix_power(A, 8) @ h
    th = torch.from_numpy(h)
    for fuse in (True, False):
        op = mixing.dense_mix_op(A, 8, fuse=fuse, device="cpu")
        assert (op.A_eff is None) == (not fuse)
        np.testing.assert_allclose(op(th).numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        dsgd.consensus(th, torch.as_tensor(A, dtype=torch.float32), 8).numpy(),
        np.asarray(jdsgd.consensus(jnp.asarray(h), jnp.asarray(A, jnp.float32),
                                   8)), rtol=1e-5, atol=1e-5)
    assert mixing.dense_mix_op(A, 0, device="cpu")(th) is th


def test_fig9_dsgd_beats_local_on_the_port():
    """The paper's Fig. 9 ordering on the port's own stream, at a small
    size: D-SGD with R = 2 over a 6-regular expander ends with a lower
    excess risk than local SGD."""
    stream = make_logreg_stream(FIG9, device="cpu")
    xe, ye = stream.draw(torch.Generator().manual_seed(99), 4000)
    bayes = problems.logistic_loss(stream.w_star, xe, ye)
    metric = lambda w: problems.logistic_loss(w, xe, ye) - bayes
    kw = dict(B=32, steps=150, stepsize=lambda t: 2.5 / t ** 0.5,
              trace_metric=metric, seed=3, device="cpu")
    A = mixing.random_regular_expander(16, deg=6, seed=0)
    d = dsgd.run_dsgd(problems.logistic_grad, stream.draw,
                      torch.zeros(FIG9.dim + 1), A, rounds=2, **kw)
    local = dsgd.run_local_sgd(problems.logistic_grad, stream.draw,
                               torch.zeros(FIG9.dim + 1), N=16, **kw)
    assert float(d.trace_metric[-1]) < float(local.trace_metric[-1])
    mix = averaging.make_gossip_mix(
        AveragingConfig(mode="gossip", rounds=2, quantization="int8",
                        quant_stats="tile", quant_block_d=8), 16, device="cpu")
    q = dsgd.run_dsgd(problems.logistic_grad, stream.draw,
                      torch.zeros(FIG9.dim + 1), np.eye(16), rounds=2,
                      mix=mix, **kw)
    assert np.isfinite(float(q.trace_metric[-1]))
