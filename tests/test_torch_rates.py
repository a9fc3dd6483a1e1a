"""The port's rate model and governed splitter (copies of `repro.core.rates`
and `repro.core.streaming`, numpy / pure Python) against the reference on a
grid of inputs: the same plans, re-plans, ladders and bucket choices, and
the same dealt batches from the same seed — exactly, not to a tolerance."""
import itertools

import numpy as np
import pytest

from repro.configs.base import StreamConfig as JStreamConfig
from repro.core import rates as jrates
from repro.core.mixing import Membership as JMembership
from repro.data.pipeline import StreamingPipeline as JPipeline
from repro_torch.configs.base import StreamConfig
from repro_torch.core import rates
from repro_torch.core.mixing import Membership
from repro_torch.data.pipeline import StreamingPipeline

STREAMS = [(1e3, 1e6, 1e6), (5e4, 2e3, 1e3), (2e5, 1e4, 0.0), (1e4, 1e6, 1e2)]


def _js(t):
    return t.to_json() if t is not None else None


def _plan_or_error(mod, *args, **kw):
    try:
        return _js(mod.plan(*args, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("Rs,Rp,Rc", STREAMS)
def test_plan_matches_reference(Rs, Rp, Rc):
    for N, R, B, horizon in itertools.product((1, 4, 10), (1, 8),
                                              (None, 100, 1000),
                                              (None, 1e6)):
        a = _plan_or_error(rates, StreamConfig(Rs, Rp, Rc), N, R, B=B,
                           horizon_samples=horizon)
        b = _plan_or_error(jrates, JStreamConfig(Rs, Rp, Rc), N, R, B=B,
                           horizon_samples=horizon)
        assert a == b, (N, R, B, horizon)


@pytest.mark.parametrize("Rs,Rp,Rc", STREAMS)
def test_replan_and_select_bucket_match_reference(Rs, Rp, Rc):
    s, js = StreamConfig(Rs, Rp, Rc), JStreamConfig(Rs, Rp, Rc)
    N, R = 4, 2
    lad = rates.BucketLadder.build(64, N, n_buckets=4, factor=2)
    jlad = jrates.BucketLadder.build(64, N, n_buckets=4, factor=2)
    assert lad.buckets == jlad.buckets
    for B, round_s in itertools.product(lad.buckets, (1e-5, 1e-3, 0.1, 10.0)):
        for ladder, jladder in ((None, None), (lad, jlad)):
            a = rates.replan(s, N, R, B, round_s, ladder=ladder)
            b = jrates.replan(js, N, R, B, round_s, ladder=jladder)
            assert _js(a) == _js(b), (B, round_s)
        obs = rates.observed_stream(s, N, R, B, round_s)
        jobs = jrates.observed_stream(js, N, R, B, round_s)
        assert (obs.streaming_rate, obs.processing_rate, obs.comms_rate) == (
            jobs.streaming_rate, jobs.processing_rate, jobs.comms_rate)
        assert (rates.select_bucket(lad, obs, N, R)
                == jrates.select_bucket(jlad, jobs, N, R))


@pytest.mark.parametrize("raw,N,horizon", [((50, 100, 200), 10, None),
                                           ((7, 30, 64), 4, 1e4),
                                           ((100,), 3, None)])
def test_bucket_ladder_matches_reference(raw, N, horizon):
    lad = rates.BucketLadder.from_buckets(raw, N, horizon_samples=horizon)
    jlad = jrates.BucketLadder.from_buckets(raw, N, horizon_samples=horizon)
    assert lad.buckets == jlad.buckets
    for B in (1, 33, 64, 150, 10_000):
        assert lad.snap(B) == jlad.snap(B)
    assert rates.horizon_ceiling(N, 1e4) == jrates.horizon_ceiling(N, 1e4)


def test_estimator_and_hysteresis_match_reference():
    est, jest = rates.RoundTimeEstimator(4, 2), jrates.RoundTimeEstimator(4, 2)
    hyst, jhyst = rates.BucketHysteresis(2), jrates.BucketHysteresis(2)
    rng = np.random.default_rng(0)
    for _ in range(20):
        B = int(rng.choice([16, 32, 64]))
        t = float(B / 4 / 1e4 + 2 / 1e3 + rng.uniform(0, 1e-4))
        est.observe(B, t)
        jest.observe(B, t)
        target = int(rng.choice([16, 32, 64]))
        assert hyst.step(32, target) == jhyst.step(32, target)
    e, je = est.estimate(), jest.estimate()
    assert (e.Rp, e.Rc) == (je.Rp, je.Rc)


def test_plan_json_round_trip_with_membership():
    p = rates.Plan(B=40, mu=3, R=2, Re=1.5, regime="under-provisioned",
                   membership=Membership.full(4).drop(2))
    assert rates.Plan.from_json(p.to_json()) == p
    assert rates.krasulina_stepsize(10, 5.0, 2.0) == \
        jrates.krasulina_stepsize(10, 5.0, 2.0)


@pytest.mark.parametrize("forced_mu,B", [(0, 8), (3, 12)])
def test_pipeline_deals_the_reference_batches(forced_mu, B):
    """Same sample source, same seed: identical supersteps and counters."""
    sample = lambda rng, n: {"z": rng.standard_normal((n, 3), np.float32)}
    a = StreamingPipeline(sample, StreamConfig(forced_mu=forced_mu), 4, 1,
                          batch=B, seed=5)
    b = JPipeline(sample, JStreamConfig(forced_mu=forced_mu), 4, 1, batch=B,
                  seed=5)
    for _ in range(3):
        np.testing.assert_array_equal(a.next_superstep(2)["z"],
                                      b.next_superstep(2)["z"])
        assert tuple(a.counters()) == tuple(b.counters())


def test_splitter_state_and_membership_swap_match_reference():
    """The plan-state mixin: a splitter snapshot restores the exact stream
    position, and a cohort swap re-plans as the reference does."""
    sample = lambda rng, n: {"z": rng.standard_normal((n, 2), np.float32)}
    cfg, jcfg = StreamConfig(1e3, 1e4, 1e3), JStreamConfig(1e3, 1e4, 1e3)
    a = StreamingPipeline(sample, cfg, 4, 2, batch=40, seed=1)
    b = JPipeline(sample, jcfg, 4, 2, batch=40, seed=1)
    a.next_superstep(2)
    snap = a.splitter_state()
    want = a.next_superstep(2)["z"]
    a.load_splitter_state(snap)
    np.testing.assert_array_equal(a.next_superstep(2)["z"], want)
    got = a.swap_membership(Membership.full(4).drop(3))
    ref = b.swap_membership(JMembership.full(4).drop(3))
    assert got.to_json() == ref.to_json()
