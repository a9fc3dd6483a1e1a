"""The whole slice: the port's governed `StreamingDriver` against the JAX
package's on the same stream. Both drive the D-Krasulina superstep with the
same numpy host sampler (the reference's `sqrt_cov` carried across by
`repro_torch.convert`), the same splitter seed and a fake clock, so every
per-superstep governor decision (B, mu, regime) must be identical and the
final iterates equal to rtol 1e-4 / atol 1e-5, at prefetch depth 0 and 2.

Also here: the prefetch ring's ordering, error and close contracts, and the
entry points' refusal to run without a device on a machine without CUDA.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AveragingConfig as JAveragingConfig
from repro.configs.base import GovernorConfig as JGovernorConfig
from repro.configs.base import StreamConfig as JStreamConfig
from repro.configs.paper_pca import FIG7 as JFIG7
from repro.configs.paper_pca import PCARunConfig as JPCARunConfig
from repro.core import krasulina as jkras
from repro.core import problems as jproblems
from repro.data.synthetic import make_pca_host_sampler as jhost_sampler
from repro.data.synthetic import make_pca_stream as jmake_pca_stream
from repro.train.driver import EngineConfig as JEngineConfig
from repro.train.driver import StreamingDriver as JStreamingDriver
from repro_torch import convert
from repro_torch.configs.base import (AveragingConfig, GovernorConfig,
                                      StreamConfig)
from repro_torch.configs.paper_pca import FIG7, PCARunConfig
from repro_torch.core import krasulina, problems
from repro_torch.core.faults import FaultSchedule
from repro_torch.data.pipeline import DevicePrefetcher, StreamingPipeline
from repro_torch.data.synthetic import make_pca_host_sampler, make_pca_stream
from repro_torch.dist import Mesh
from repro_torch.serve.publisher import SnapshotPublisher
from repro_torch.train import checkpoint
from repro_torch.train.driver import EngineConfig, StreamingDriver
from repro_torch.train.snapshot import RunSnapshotter


class _FakeClock:
    """Advances `dt` per read. `pause` really sleeps, so the prefetch thread
    has filled its ring before each consume: which plan deals which staged
    superstep then does not depend on thread timing, in either package."""

    def __init__(self, dt, pause=0.0):
        self.t, self.dt, self.pause = 0.0, dt, pause

    def __call__(self):
        time.sleep(self.pause)
        self.t += self.dt
        return self.t


def _decisions(history):
    return [(rec["bucket"], rec["plan"].mu, rec["plan"].regime,
             rec.get("target_bucket"), rec.get("bucket_switch"),
             None if "replanned" not in rec else
             (rec["replanned"].B, rec["replanned"].mu,
              rec["replanned"].regime),
             tuple(rec["counters"])) for rec in history]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("dt,buckets", [(50.0, ()), (1e-4, (50, 100, 200))],
                         ids=["slow-mu", "fast-buckets"])
def test_driver_matches_reference_governor_and_state(depth, dt, buckets):
    N, K, steps = 4, 2, 5
    js = jmake_pca_stream(JFIG7)
    ts = convert.pca_stream(np.asarray(js.cov), np.asarray(js.sqrt_cov),
                            np.asarray(js.top_eigvec), js.lambda1,
                            js.eigengap, device="cpu")
    w0 = np.random.default_rng(0).standard_normal(FIG7.dim).astype(np.float32)
    w0 /= np.linalg.norm(w0)
    stream = dict(streaming_rate=1e3, processing_rate=1e6, comms_rate=1e6)
    step = lambda t: 10.0 / t
    pause = 0.1 if depth else 0.0

    t_cfg = PCARunConfig(averaging=AveragingConfig(mode="gossip", rounds=2),
                         stream=StreamConfig(**stream))
    t_build = krasulina.krasulina_superstep_builder(
        t_cfg.averaging, N, step, device="cpu",
        metric=lambda w: problems.sin2_error(w, ts.top_eigvec))
    t_drv = StreamingDriver(
        t_cfg, None, krasulina.init_krasulina_state(w0, t_cfg.averaging, N,
                                                    device="cpu"),
        make_pca_host_sampler(ts), superstep_builder=t_build, n_nodes=N,
        batch=100, seed=3, clock=_FakeClock(dt, pause), device="cpu",
        engine=EngineConfig(superstep=K, prefetch_depth=depth,
                            warmup_supersteps=0,
                            governor=GovernorConfig(buckets=buckets)))

    j_cfg = JPCARunConfig(averaging=JAveragingConfig(mode="gossip", rounds=2),
                          stream=JStreamConfig(**stream))
    j_build = jkras.krasulina_superstep_builder(
        j_cfg.averaging, N, step,
        metric=lambda w: jproblems.sin2_error(w, js.top_eigvec))
    j_drv = JStreamingDriver(
        j_cfg, None, jkras.init_krasulina_state(jnp.asarray(w0),
                                                j_cfg.averaging, N),
        jhost_sampler(js), superstep_builder=j_build, n_nodes=N, batch=100,
        seed=3, clock=_FakeClock(dt, pause),
        engine=JEngineConfig(superstep=K, prefetch_depth=depth,
                             warmup_supersteps=0,
                             governor=JGovernorConfig(buckets=buckets)))
    with t_drv, j_drv:
        t_state, t_hist = t_drv.run(steps)
        j_state, j_hist = j_drv.run(steps)
    assert _decisions(t_hist) == _decisions(j_hist)
    if dt > 1:
        assert t_drv.pipeline.plan.mu > 0  # the slow clock made it discard
    else:
        assert any("bucket_switch" in rec for rec in t_hist)  # B moved
    assert t_state.t == int(j_state.t) == steps * K
    np.testing.assert_allclose(t_state.w.numpy(), np.asarray(j_state.w),
                               rtol=1e-4, atol=1e-5)
    for t_rec, j_rec in zip(t_hist, j_hist):
        for key in ("metric", "consensus_err"):
            np.testing.assert_allclose(t_rec["metrics"][key],
                                       j_rec["metrics"][key],
                                       rtol=1e-4, atol=1e-5)
        assert set(t_rec) == set(j_rec)  # same history record keys


def test_driver_exact_mode_with_prefetch_converges():
    """Exact averaging on the port's own device stream: the prefetch ring
    and the K-round superstep reduce the Fig. 7 excess risk."""
    ts = make_pca_stream(FIG7, device="cpu")
    metric = lambda w: problems.pca_excess_risk(w, ts.cov, ts.lambda1)
    cfg = PCARunConfig(averaging=AveragingConfig(mode="exact"))
    sup = krasulina.build_krasulina_superstep(cfg.averaging, 4,
                                              lambda t: 10.0 / t,
                                              metric=metric, device="cpu")
    w0 = torch.ones(FIG7.dim) / FIG7.dim ** 0.5
    with StreamingDriver(cfg, None,
                         krasulina.init_krasulina_state(w0, cfg.averaging, 4,
                                                        device="cpu"),
                         make_pca_host_sampler(ts), superstep_fn=sup,
                         n_nodes=4, batch=100, device="cpu",
                         engine=EngineConfig(superstep=4, prefetch_depth=2,
                                             replan_every=0)) as drv:
        final, hist = drv.run(15)
    assert [rec["round"] for rec in hist] == [4 * (i + 1) for i in range(15)]
    assert hist[-1]["counters"].samples_consumed == 15 * 4 * 100
    assert final.t == 60 and final.w.shape == (FIG7.dim,)
    assert hist[-1]["metrics"]["metric"] < 5e-2
    assert hist[-1]["metrics"]["consensus_err"] == 0.0


def test_host_sampler_draws_match_reference():
    js = jmake_pca_stream(JFIG7)
    ts = convert.pca_stream(np.asarray(js.cov), np.asarray(js.sqrt_cov),
                            np.asarray(js.top_eigvec), js.lambda1,
                            js.eigengap, device="cpu")
    a = make_pca_host_sampler(ts)(np.random.default_rng(11), 7)["z"]
    b = jhost_sampler(js)(np.random.default_rng(11), 7)["z"]
    np.testing.assert_array_equal(a, b)


def test_pca_stream_spectrum():
    """The port's own stream (torch.Generator, so not the reference's
    covariance): top eigenpair and eigengap as configured."""
    ts = make_pca_stream(FIG7, device="cpu")
    ev, vecs = np.linalg.eigh(ts.cov.double().numpy())
    np.testing.assert_allclose(ev[-1], FIG7.lambda1, rtol=1e-5)
    np.testing.assert_allclose(ev[-1] - ev[-2], FIG7.eigengap, rtol=1e-4)
    assert abs(abs(vecs[:, -1] @ ts.top_eigvec.double().numpy()) - 1) < 1e-5
    np.testing.assert_allclose((ts.sqrt_cov @ ts.sqrt_cov).numpy(),
                               ts.cov.numpy(), atol=1e-5)
    z = ts.draw(torch.Generator().manual_seed(0), 4)
    assert z.shape == (4, FIG7.dim) and torch.isfinite(z).all()


# ---------------------------------------------------------------------------
# Prefetch ring (port of the reference's contracts)
# ---------------------------------------------------------------------------

def test_prefetch_preserves_order_counters_and_stages_tensors():
    def mk_pipe():
        return StreamingPipeline(
            lambda rng, n: {"x": rng.normal(size=(n, 2))},
            StreamConfig(forced_mu=3), n_nodes=2, rounds_R=1, batch=8, seed=7)

    sync_pipe, pre_pipe = mk_pipe(), mk_pipe()
    want = [(sync_pipe.next_superstep(2), sync_pipe.counters())
            for _ in range(6)]
    with DevicePrefetcher(lambda: pre_pipe.next_superstep(2),
                          counters=pre_pipe.counters, depth=2,
                          device=torch.device("cpu")) as pf:
        for batch, counts in want:
            got = next(pf)
            assert isinstance(got["x"], torch.Tensor)
            np.testing.assert_array_equal(got["x"].numpy(), batch["x"])
            assert pf.counters == counts
    assert pf.counters.samples_arrived <= pre_pipe.samples_arrived


def test_prefetch_finite_source_and_errors():
    it = iter(range(5))
    pf = DevicePrefetcher(lambda: next(it), depth=2)
    assert list(pf) == [0, 1, 2, 3, 4]
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()

    def boom():
        raise RuntimeError("producer died")

    pf = DevicePrefetcher(boom, depth=1)
    for _ in range(2):  # the error is latched, not one-shot
        with pytest.raises(RuntimeError, match="producer died"):
            next(pf)
    pf.close()  # already delivered: not raised again


def test_prefetch_close_while_worker_blocked_on_full_ring():
    produced = threading.Event()

    def produce():
        if produced.is_set():
            raise RuntimeError("late failure")
        produced.set()
        return 0

    pf = DevicePrefetcher(produce, depth=1)
    assert produced.wait(timeout=5.0)
    deadline = time.time() + 5.0
    while pf._q.qsize() < 1 and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="late failure"):
        pf.close()  # returns (no deadlock) AND surfaces the error
    assert not pf._thread.is_alive()
    pf.close()  # idempotent
    with pytest.raises((StopIteration, RuntimeError)):
        next(pf)


# ---------------------------------------------------------------------------
# Devices and later slices
# ---------------------------------------------------------------------------

def test_entry_points_without_device_need_the_card():
    """`device=None` means the CUDA card: on a machine without one every
    entry point raises and says to pass device='cpu' — never a quiet CPU
    run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: device=None runs on it")
    avg = AveragingConfig(mode="gossip")
    calls = [
        lambda: make_pca_stream(FIG7),
        lambda: krasulina.init_krasulina_state(torch.zeros(3), avg, 2),
        lambda: krasulina.build_krasulina_superstep(avg, 2, lambda t: 1.0),
        lambda: krasulina.krasulina_superstep_builder(avg, 2, lambda t: 1.0),
        lambda: krasulina.run_d_krasulina(lambda g, n: None, torch.zeros(3),
                                          N=1, B=1, steps=1,
                                          stepsize=lambda t: 1.0),
        lambda: krasulina.run_dm_krasulina(lambda g, n: None, torch.zeros(3),
                                           N=1, B=1, steps=1,
                                           stepsize=lambda t: 1.0),
        lambda: StreamingDriver(PCARunConfig(), None, None,
                                lambda rng, n: {}, superstep_fn=lambda s, b: s,
                                n_nodes=2),
        lambda: convert.krasulina_state(np.zeros(3), 0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _pca_driver(**kw):
    """FIG7 D-Krasulina on the driver, N = 2, ring R = 1, K = 2."""
    avg = AveragingConfig(mode="gossip", rounds=1)
    w0 = np.random.default_rng(0).standard_normal(FIG7.dim)
    w0 = (w0 / np.linalg.norm(w0)).astype(np.float32)
    return StreamingDriver(
        PCARunConfig(averaging=avg), None,
        krasulina.init_krasulina_state(w0, avg, 2, device="cpu"),
        make_pca_host_sampler(make_pca_stream(FIG7, device="cpu")),
        superstep_builder=krasulina.krasulina_superstep_builder(
            avg, 2, lambda t: 10.0 / t, device="cpu"),
        n_nodes=2, batch=10, device="cpu",
        engine=EngineConfig(superstep=2, prefetch_depth=0), **kw)


def _snapshot_at(root, supersteps):
    with _pca_driver(snapshotter=RunSnapshotter(
            root, every=1, overhead_budget=0, block=True)) as drv:
        drv.run(supersteps)
    return root


def _takes_effect(name, value):
    with _pca_driver(**{name: value}) as drv:
        if name == "resume_from":
            assert drv.resumed_from == checkpoint.step_dir(value, 1)
            assert drv._supersteps_done == 1 and drv.state.t == 2
        state, hist = drv.run(2)
    if name == "publisher":
        assert [r["published_version"] for r in hist] == [1, 2]
        torch.testing.assert_close(value.snapshot().params.w,
                                   state.w.mean(0))
    elif name == "snapshotter":
        assert [r["checkpoint"] for r in hist] == [1, 2]
        assert checkpoint.list_steps(value.root) == [1, 2]
        assert value._closed  # the driver's close() closed it
    else:
        assert state.t == 6 and [r["round"] for r in hist] == [4, 6]


@pytest.mark.parametrize("kwargs,match", [
    # a mesh with a model axis: the sharded model layouts wait for queue 1
    # item 3 (a node-only mesh drives: tests/test_torch_shard.py)
    ({"mesh": Mesh((1, 2), ("data", "model"))}, "sharded"),
    # elastic membership (faults, a straggler policy) needs gossip averaging
    ({"faults": FaultSchedule.parse("death:1@1", 2)}, "elastic"),
    ({"engine": EngineConfig(governor=GovernorConfig(
        straggler_policy="drop"))}, "elastic"),
    # the serving and durability slices' arguments: they take effect now
    ({"publisher": lambda root: SnapshotPublisher(overhead_budget=0.0)},
     "serving"),
    ({"snapshotter": lambda root: RunSnapshotter(
        root, every=1, overhead_budget=0, block=True)}, "durability"),
    ({"resume_from": lambda root: _snapshot_at(root, 1)}, "durability"),
    # no superstep: the LM trainer's builder, whose error feedback needs
    # gossip averaging
    ({"superstep_fn": None, "run_cfg": PCARunConfig(averaging=AveragingConfig(
        mode="exact", error_feedback="grads"))}, "error-feedback"),
])
def test_driver_later_slices_raise(kwargs, match, tmp_path):
    """Later slices raise NotImplementedError naming theirs (a mesh with a
    model axis: the sharded model layouts of queue 1 item 3); the elastic
    slice's configurations that the reference refuses raise its
    ValueError. The serving and durability arguments (`publisher`,
    `snapshotter`, `resume_from`), refused until their slice, are built
    here and checked to take effect."""
    if match in ("serving", "durability"):
        (name, make), = kwargs.items()
        _takes_effect(name, make(str(tmp_path)))
        return
    args = dict(mesh=None, superstep_fn=lambda s, b: (s, {}),
                run_cfg=PCARunConfig())
    args.update(kwargs)
    mesh, run_cfg = args.pop("mesh"), args.pop("run_cfg")
    later = match == "sharded"
    with pytest.raises(NotImplementedError if later else ValueError,
                       match=match):
        StreamingDriver(run_cfg, mesh, None, lambda rng, n: {},
                        n_nodes=2, device="cpu", **args)
