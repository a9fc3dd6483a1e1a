"""The port's full-loop async checkpoint/restore (`repro_torch.train.snapshot`)
against the JAX package's contracts (tests/test_snapshot.py), on the CPU:

* `RunSnapshotter` mechanics: argument checks, the cadence grid, the EWMA
  cost governor, the depth-1 busy skip, writer failures recorded without
  touching the training thread, last-k retention, no valid checkpoint;
* in-process kill-and-resume, bit for bit: the exact-mode LM engine with the
  prefetch ring on (its `meta` carries the splitter's stream position), and
  the elastic PCA engine under churn (resume mid-shrink) and with a
  straggler policy (a rejoin after the resume builds nothing new, the
  straggler EWMAs come back equal);
* SIGKILL: this file, run as a script, is the worker process; killed after
  a durable snapshot, or mid-save (a torn step directory), a fresh process
  resumes from the newest valid checkpoint and reproduces the uninterrupted
  final state bit for bit;
* across packages: the reference's driver writes at superstep CUT under
  churn, the port's resumes from it (the PCG64 splitter state and the
  `Plan` JSON of the reference) and matches the reference's uninterrupted
  run within the elastic parity tolerances of tests/test_torch_elastic.py
  (iterates within 1e-5 of themselves and of the largest entry).
"""
import argparse
import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (AveragingConfig, GovernorConfig,
                                      RunConfig, SHAPES, StreamConfig)
from repro_torch.configs.paper_pca import FIG7, PCARunConfig
from repro_torch.core import krasulina, rates
from repro_torch.core.faults import FaultSchedule
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.data.pipeline import StreamingPipeline
from repro_torch.data.synthetic import make_pca_host_sampler, make_pca_stream
from repro_torch.train import checkpoint, snapshot
from repro_torch.train.driver import EngineConfig, StreamingDriver
from repro_torch.train.snapshot import RunSnapshotter
from repro_torch.train.trainer import init_state

torch.set_num_threads(1)


class _FakeClock:
    def __init__(self, dt):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _leaves(state):
    out = {}
    checkpoint._walk(state, (), out)
    return out


def _assert_states_equal(a, b):
    fa, fb = _leaves(a), _leaves(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


# ---------------------------------------------------------------------------
# RunSnapshotter mechanics (stub driver: no engine needed)
# ---------------------------------------------------------------------------

def _stub_driver(step=0):
    pipe = StreamingPipeline(
        lambda rng, n: {"x": np.zeros((n, 2), np.float32)},
        StreamConfig(), n_nodes=1, rounds_R=1, batch=4)
    return types.SimpleNamespace(
        state={"w": torch.arange(4.0)}, pipeline=pipe, _supersteps_done=step,
        _last_splitter_state=None, _last_round_s=None, _sig_seen={},
        _hysteresis=rates.BucketHysteresis(2), _estimator=None,
        _straggler=None, _membership=None, _publisher=None)


def test_snapshotter_validates_args(tmp_path):
    for kw in ({"every": 0}, {"keep_last": 0}, {"overhead_budget": -0.1},
               {"alpha": 0.0}, {"alpha": 1.5}):
        with pytest.raises(ValueError):
            RunSnapshotter(str(tmp_path), **kw)


def test_snapshotter_cadence_grid(tmp_path):
    d = _stub_driver()
    with RunSnapshotter(str(tmp_path), every=2, overhead_budget=0,
                        block=True) as sn:
        for step in (1, 2, 3, 4):
            d._supersteps_done = step
            sn.maybe_snapshot(d)
    assert sn.stats.dispatches == 2 and sn.stats.saves == 2
    assert sn.stats.skipped_cadence == 2
    assert sn.stats.bytes_per_save == 16
    assert checkpoint.list_steps(str(tmp_path)) == [2, 4]


def test_snapshotter_budget_governor_skips(tmp_path):
    """With a 1 s/reading fake clock every dispatch 'costs' 1 s; a 0.5
    overhead budget must skip every other cadence hit."""
    d = _stub_driver()
    with RunSnapshotter(str(tmp_path), every=1, overhead_budget=0.5,
                        block=True, clock=_FakeClock(1.0)) as sn:
        for step in (1, 2, 3):
            d._supersteps_done = step
            sn.maybe_snapshot(d)
    assert sn.stats.dispatches == 2
    assert sn.stats.skipped_budget == 1


def test_snapshotter_busy_writer_skips_not_blocks(tmp_path, monkeypatch):
    release, entered = threading.Event(), threading.Event()
    orig = checkpoint.save

    def slow_save(*a, **kw):
        entered.set()
        release.wait(10.0)
        return orig(*a, **kw)

    monkeypatch.setattr(checkpoint, "save", slow_save)
    d = _stub_driver(step=1)
    with RunSnapshotter(str(tmp_path), every=1, overhead_budget=0) as sn:
        assert sn.maybe_snapshot(d) is not None
        assert entered.wait(10.0)
        d._supersteps_done = 2
        t0 = time.perf_counter()
        assert sn.maybe_snapshot(d) is None  # writer busy: skip, don't wait
        assert time.perf_counter() - t0 < 5.0
        assert sn.stats.skipped_busy == 1
        release.set()
        sn.flush()
    assert sn.stats.saves == 1


def test_snapshotter_failure_recorded_never_raised(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise OSError("disk on fire")

    monkeypatch.setattr(checkpoint, "save", boom)
    d = _stub_driver(step=1)
    with RunSnapshotter(str(tmp_path), every=1, overhead_budget=0,
                        block=True) as sn:
        assert sn.maybe_snapshot(d) is not None  # dispatched fine
    assert sn.stats.failures == 1 and sn.stats.saves == 0
    assert "disk on fire" in sn.stats.last_error


def test_snapshotter_retention_keeps_last_k(tmp_path):
    d = _stub_driver()
    with RunSnapshotter(str(tmp_path), every=1, keep_last=2,
                        overhead_budget=0, block=True) as sn:
        for step in (1, 2, 3, 4, 5):
            d._supersteps_done = step
            sn.maybe_snapshot(d)
    assert checkpoint.list_steps(str(tmp_path)) == [4, 5]


def test_snapshot_holds_the_values_from_before_an_in_place_update(tmp_path):
    """The copy is taken at dispatch: an in-place update of the state right
    after it does not reach the checkpoint."""
    d = _stub_driver(step=1)
    with RunSnapshotter(str(tmp_path), every=1, overhead_budget=0) as sn:
        sn.maybe_snapshot(d)
        d.state["w"].add_(100.0)
        sn.flush()
    out = checkpoint.restore(checkpoint.step_dir(str(tmp_path), 1),
                             {"w": torch.zeros(4)})
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(4.0))


def test_restore_driver_requires_a_valid_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        snapshot.restore_driver(_stub_driver(), str(tmp_path / "nowhere"))
    d = _stub_driver(step=3)
    with RunSnapshotter(str(tmp_path), every=1, overhead_budget=0,
                        block=True) as sn:
        sn.maybe_snapshot(d)
    os.remove(os.path.join(checkpoint.step_dir(str(tmp_path), 3),
                           "manifest.json"))
    with pytest.raises(FileNotFoundError, match="torn or corrupt"):
        snapshot.restore_driver(_stub_driver(), str(tmp_path))


# ---------------------------------------------------------------------------
# In-process kill-and-resume: exact-mode LM engine, prefetch ring on
# ---------------------------------------------------------------------------

SEQ, BATCH = 16, 4


def _lm_cfg():
    cfg = dataclasses.replace(
        reduced(get_config("granite-8b"), layers=1, d_model=16),
        vocab_size=32, d_ff=32)
    return RunConfig(model=cfg, shape=SHAPES["train_4k"],
                     averaging=AveragingConfig("exact", 1),
                     stream=StreamConfig(streaming_rate=1e3,
                                         processing_rate=1e6, comms_rate=1e6),
                     optimizer="adam", learning_rate=1e-3,
                     param_dtype="float32", remat=False)


def _lm_sample_fn():
    data = MarkovTokenStream(32, seed=0)

    def draw(rng, n):
        toks = data.sample(rng, n, SEQ + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return draw


def _lm_driver(run_cfg, clock, **kw):
    state = init_state(run_cfg, torch.Generator().manual_seed(0))
    return StreamingDriver(
        run_cfg, None, state, _lm_sample_fn(), batch=BATCH, n_nodes=1,
        engine=EngineConfig(superstep=2, prefetch_depth=2, replan_every=1,
                            warmup_supersteps=0),
        clock=clock, device="cpu", **kw)


def _advanced(steps):
    """A fake clock where the uninterrupted run's stood after `steps`
    supersteps (the driver reads it twice per superstep)."""
    clk = _FakeClock(1e-3)
    for _ in range(2 * steps):
        clk()
    return clk


def test_resume_bit_identical_exact_mode_with_prefetch(tmp_path):
    """Kill after CUT supersteps, resume from the newest snapshot: params,
    history tail, stream counters and the rate estimator are bit-identical
    to the uninterrupted run. The prefetch ring stays on: the splitter
    snapshot rides its `meta`, so supersteps staged but never consumed at
    the cut are dealt again, not skipped."""
    TOTAL, CUT = 8, 4
    run_cfg = _lm_cfg()
    with _lm_driver(run_cfg, _FakeClock(1e-3)) as ref:
        ref_state, ref_hist = ref.run(TOTAL)
        ref_est = ref._estimator.state_dict()

    with _lm_driver(run_cfg, _FakeClock(1e-3),
                    snapshotter=RunSnapshotter(
                        str(tmp_path), every=1, overhead_budget=0,
                        block=True)) as victim:
        victim.run(CUT)
        # the ring ran ahead of the consumer: the live splitter is past CUT
        assert victim.pipeline.rounds > CUT * 2
    assert checkpoint.list_steps(str(tmp_path))[-1] == CUT

    with _lm_driver(run_cfg, _advanced(CUT),
                    resume_from=str(tmp_path)) as resumed:
        assert resumed.resumed_from == checkpoint.step_dir(str(tmp_path), CUT)
        assert resumed._supersteps_done == CUT
        res_state, res_hist = resumed.run(TOTAL - CUT)
        res_est = resumed._estimator.state_dict()

    _assert_states_equal(ref_state, res_state)
    assert res_est == ref_est
    assert len(res_hist) == TOTAL - CUT
    for r_ref, r_res in zip(ref_hist[CUT:], res_hist):
        assert r_ref["round"] == r_res["round"]
        assert r_ref["counters"] == r_res["counters"]
        assert r_ref["metrics"]["loss"] == r_res["metrics"]["loss"]


# ---------------------------------------------------------------------------
# In-process resume under churn (elastic PCA engine)
# ---------------------------------------------------------------------------

N_PCA, B_PCA = 5, 10


def _pca_w0():
    w0 = np.random.default_rng(0).standard_normal(FIG7.dim).astype(np.float32)
    return w0 / np.linalg.norm(w0)


def _elastic_driver(faults, *, clock, builds=None, gov=None, stream=None,
                    **kw):
    run_cfg = PCARunConfig(
        pca=FIG7, averaging=AveragingConfig(mode="gossip", rounds=2))
    builder = krasulina.krasulina_superstep_builder(
        run_cfg.averaging, N_PCA, lambda t: 10.0 / t, device="cpu")
    if builds is not None:
        inner = builder

        def builder(B, membership=None):  # noqa: F811
            builds.append((B, N_PCA if membership is None
                           else membership.n_active))
            return inner(B, membership)

    state = krasulina.init_krasulina_state(_pca_w0(), run_cfg.averaging,
                                           N_PCA, device="cpu")
    stream = stream or make_pca_stream(FIG7, device="cpu")
    return StreamingDriver(
        run_cfg, None, state, make_pca_host_sampler(stream),
        superstep_builder=builder, n_nodes=N_PCA, batch=B_PCA, faults=faults,
        engine=EngineConfig(superstep=2, prefetch_depth=0, replan_every=1,
                            warmup_supersteps=0, warmup_per_bucket=0,
                            governor=gov or GovernorConfig()),
        clock=clock, device="cpu", **kw)


def test_resume_under_churn_bit_identical(tmp_path):
    """Resume from a checkpoint taken while the cohort was SHRUNK (node 4
    dead): the cohort, its re-derived bucket ladder and the whole trajectory
    — the later rejoin included — are bit-identical to the uninterrupted
    run."""
    TOTAL, CUT = 8, 3
    faults = FaultSchedule.parse("death:4@2-5", N_PCA)

    with _elastic_driver(faults, clock=_FakeClock(1e-3)) as ref:
        ref_state, ref_hist = ref.run(TOTAL)

    with _elastic_driver(faults, clock=_FakeClock(1e-3),
                         snapshotter=RunSnapshotter(
                             str(tmp_path), every=1, overhead_budget=0,
                             block=True)) as victim:
        victim.run(CUT)
        assert victim.membership.n_active == 4  # mid-shrink, as intended

    with _elastic_driver(faults, clock=_advanced(CUT),
                         resume_from=str(tmp_path)) as resumed:
        assert resumed.membership.n_active == 4
        assert resumed.membership == ref_hist[CUT - 1]["plan"].membership
        assert resumed.ladder.buckets == resumed._ladder_for(4).buckets
        assert resumed.pipeline.plan.B == 12  # ceil(10/4)*4, the shrunk-era B
        res_state, res_hist = resumed.run(TOTAL - CUT)

    _assert_states_equal(ref_state, res_state)
    assert resumed.membership.is_full  # rejoined at superstep 5
    eras = [(r["bucket"], r["n_active"]) for r in res_hist]
    assert eras == [(r["bucket"], r["n_active"]) for r in ref_hist[CUT:]]
    for r_ref, r_res in zip(ref_hist[CUT:], res_hist):
        assert r_ref["counters"] == r_res["counters"]
        assert (r_ref["metrics"]["consensus_err"]
                == r_res["metrics"]["consensus_err"])


def test_resume_rejoin_builds_nothing_new_and_straggler_state_survives(
        tmp_path):
    """Two drop eras; the resume lands in the full-cohort gap between them.
    The resumed process builds each (B, cohort) superstep once on first use
    — the second rejoin reuses the full cohort's — and the straggler EWMAs
    (a 3x-slowed node) come back bit-identical."""
    TOTAL, CUT = 10, 5
    spec = "death:4@2-4,slow:1@0-10x3,death:4@6-8"
    gov = GovernorConfig(straggler_policy="drop", straggler_slow_factor=4.0)

    with _elastic_driver(FaultSchedule.parse(spec, N_PCA), gov=gov,
                         clock=_FakeClock(1e-3)) as ref:
        ref_state, _ = ref.run(TOTAL)
        ref_straggler = ref._straggler.state_dict()

    with _elastic_driver(FaultSchedule.parse(spec, N_PCA), gov=gov,
                         clock=_FakeClock(1e-3),
                         snapshotter=RunSnapshotter(
                             str(tmp_path), every=1, overhead_budget=0,
                             block=True)) as victim:
        victim.run(CUT)
        assert victim.membership.is_full  # cut in the between-eras gap

    builds = []
    with _elastic_driver(FaultSchedule.parse(spec, N_PCA), gov=gov,
                         clock=_advanced(CUT), builds=builds,
                         resume_from=str(tmp_path)) as resumed:
        res_state, res_hist = resumed.run(TOTAL - CUT)
        res_straggler = resumed._straggler.state_dict()

    _assert_states_equal(ref_state, res_state)
    assert res_straggler == ref_straggler
    assert builds == [(10, 5), (12, 4)]
    eras = [(r["bucket"], r["n_active"]) for r in res_hist]
    assert eras == [(10, 5), (12, 4), (12, 4), (10, 5), (10, 5)]


# ---------------------------------------------------------------------------
# Publisher and snapshotter on one driver
# ---------------------------------------------------------------------------

def test_publisher_version_survives_resume(tmp_path):
    """The snapshot carries the publisher's version: a resumed driver's
    publisher continues the count, never reuses a version."""
    from repro_torch.serve.publisher import SnapshotPublisher

    faults = FaultSchedule.parse("death:4@2-5", N_PCA)
    pub = SnapshotPublisher(overhead_budget=0.0)
    with _elastic_driver(faults, clock=_FakeClock(1e-3), publisher=pub,
                         snapshotter=RunSnapshotter(
                             str(tmp_path), every=1, overhead_budget=0,
                             block=True)) as victim:
        _, hist = victim.run(3)
    assert [r["published_version"] for r in hist] == [1, 2, 3]
    assert [r["checkpoint"] for r in hist] == [1, 2, 3]
    # the consensus mean over the active nodes: node 4 is out at superstep 3
    snap = pub.snapshot()
    w = victim.state.w
    torch.testing.assert_close(snap.params.w, w[:4].mean(0), rtol=1e-6,
                               atol=1e-7)
    assert snap.params.t == victim.state.t
    pub2 = SnapshotPublisher(overhead_budget=0.0)
    with _elastic_driver(faults, clock=_advanced(3), publisher=pub2,
                         resume_from=str(tmp_path)) as resumed:
        assert pub2.version == 3
        _, hist = resumed.run(1)
    assert hist[-1]["published_version"] == 4


# ---------------------------------------------------------------------------
# SIGKILL (this file is the worker process)
# ---------------------------------------------------------------------------

TOTAL = 8


def _worker_cmd(root, *, out="", resume=False, snapshots=True):
    cmd = [sys.executable, os.path.abspath(__file__), "--root", str(root),
           "--supersteps", str(TOTAL)]
    if out:
        cmd += ["--out", str(out)]
    if resume:
        cmd += ["--resume"]
    if not snapshots:
        cmd += ["--no-snapshots"]
    return cmd


def _env(extra=None):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("SNAPSHOT_SLOW_AFTER_STEP", None)
    if extra:
        env.update(extra)
    return env


def _run_to_completion(cmd, env, timeout=300):
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "DONE" in out.stdout
    return out.stdout


def _kill_when(cmd, env, marker, timeout=300):
    """Start the worker, SIGKILL it as soon as `marker` appears on stdout."""
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + timeout
    try:
        for line in proc.stdout:
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {marker!r} within {timeout}s")
            if line.startswith(marker):
                os.kill(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
                assert proc.returncode == -signal.SIGKILL
                return
        raise AssertionError(f"worker exited before printing {marker!r}")
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
        proc.wait(timeout=30)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """One uninterrupted worker run shared by the SIGKILL cases."""
    d = tmp_path_factory.mktemp("snapref")
    out = d / "ref.npz"
    _run_to_completion(
        _worker_cmd(d / "unused-root", out=out, snapshots=False), _env())
    return np.load(out)


def _assert_matches_reference(ref, out_path):
    got = np.load(out_path)
    start = int(got["resumed_at"])
    assert 0 < start < TOTAL  # genuinely resumed mid-stream
    for k in ref.files:
        if k.startswith("state::"):
            np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    np.testing.assert_array_equal(ref["counters"], got["counters"])
    np.testing.assert_array_equal(ref["eras"][start:], got["eras"])
    return start


def test_sigkill_mid_stream_resume_bit_identical(tmp_path, reference_run):
    """SIGKILL the training process right after superstep 3's snapshot is
    durable (mid-shrink, node 4 dead); a fresh process resuming from the
    root reproduces the uninterrupted final state bit for bit."""
    root = tmp_path / "ckpt"
    _kill_when(_worker_cmd(root), _env(), "CKPT 3")
    assert checkpoint.newest_valid(str(root)) is not None
    out = tmp_path / "resumed.npz"
    _run_to_completion(_worker_cmd(root, out=out, resume=True), _env())
    start = _assert_matches_reference(reference_run, out)
    assert start >= 3


def test_sigkill_mid_save_leaves_torn_step_and_resumes_from_newest_valid(
        tmp_path, reference_run):
    """SIGKILL while the writer is mid-save for step 3 (after its first leaf
    write, before the manifest): the step directory is torn, `newest_valid`
    falls back to step 2, and the resumed run still matches the
    uninterrupted one bit for bit."""
    root = tmp_path / "ckpt"
    _kill_when(_worker_cmd(root), _env({"SNAPSHOT_SLOW_AFTER_STEP": "3"}),
               "SLOW-SAVE 3")
    torn = checkpoint.step_dir(str(root), 3)
    assert os.path.isdir(torn) and not checkpoint.is_valid(torn)
    assert checkpoint.newest_valid(str(root)) == \
        checkpoint.step_dir(str(root), 2)
    out = tmp_path / "resumed.npz"
    _run_to_completion(_worker_cmd(root, out=out, resume=True), _env())
    assert _assert_matches_reference(reference_run, out) == 2


# ---------------------------------------------------------------------------
# Across packages: the reference writes, the port resumes
# ---------------------------------------------------------------------------

def test_port_resumes_from_the_reference_checkpoint(tmp_path):
    """The reference's elastic PCA driver (FIG7, N = 5, death:4@2-5) writes
    its snapshot at superstep CUT = 3, mid-shrink; the port's driver resumes
    from it over the same numpy draws and matches the reference's
    uninterrupted run: the same eras, counters, plans and membership, the
    iterate within 1e-5."""
    import jax.numpy as jnp

    from repro.configs.base import AveragingConfig as JAveragingConfig
    from repro.configs.base import GovernorConfig as JGovernorConfig
    from repro.configs.paper_pca import FIG7 as JFIG7
    from repro.configs.paper_pca import PCARunConfig as JPCARunConfig
    from repro.core import faults as jfaults
    from repro.core import krasulina as jkras
    from repro.data.synthetic import make_pca_host_sampler as jhost_sampler
    from repro.data.synthetic import make_pca_stream as jmake_pca_stream
    from repro.train import driver as jdriver
    from repro.train.snapshot import RunSnapshotter as JRunSnapshotter
    from repro_torch import convert

    TOTAL_J, CUT = 8, 3
    spec = "death:4@2-5"
    js = jmake_pca_stream(JFIG7)
    ts = convert.pca_stream(np.asarray(js.cov), np.asarray(js.sqrt_cov),
                            np.asarray(js.top_eigvec), js.lambda1,
                            js.eigengap, device="cpu")
    j_cfg = JPCARunConfig(pca=JFIG7,
                          averaging=JAveragingConfig(mode="gossip", rounds=2))

    def j_driver(clock, **kw):
        return jdriver.StreamingDriver(
            j_cfg, None, jkras.init_krasulina_state(
                jnp.asarray(_pca_w0()), j_cfg.averaging, N_PCA),
            jhost_sampler(js), n_nodes=N_PCA, batch=B_PCA,
            superstep_builder=jkras.krasulina_superstep_builder(
                j_cfg.averaging, N_PCA, lambda t: 10.0 / t),
            faults=jfaults.FaultSchedule.parse(spec, N_PCA), clock=clock,
            engine=jdriver.EngineConfig(
                superstep=2, prefetch_depth=0, replan_every=1,
                warmup_supersteps=0, warmup_per_bucket=0,
                governor=JGovernorConfig()), **kw)

    with j_driver(_FakeClock(1e-3)) as ref:
        j_state, j_hist = ref.run(TOTAL_J)
    with j_driver(_FakeClock(1e-3), snapshotter=JRunSnapshotter(
            str(tmp_path), every=1, overhead_budget=0, block=True)) as victim:
        victim.run(CUT)

    with _elastic_driver(FaultSchedule.parse(spec, N_PCA),
                         clock=_advanced(CUT), stream=ts,
                         resume_from=str(tmp_path)) as resumed:
        assert resumed._supersteps_done == CUT
        assert resumed.membership.n_active == 4
        t_state, t_hist = resumed.run(TOTAL_J - CUT)

    plan = lambda p: None if p is None else p.to_json()
    for r_t, r_j in zip(t_hist, j_hist[CUT:], strict=True):
        assert (r_t["bucket"], r_t["n_active"]) == (r_j["bucket"],
                                                    r_j["n_active"])
        assert tuple(r_t["counters"]) == tuple(r_j["counters"])
        assert plan(r_t["plan"]) == plan(r_j["plan"])
    assert t_state.t == int(j_state.t)
    want = np.asarray(j_state.w)
    np.testing.assert_allclose(t_state.w.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The SIGKILL worker
# ---------------------------------------------------------------------------

def _arm_slow_save(after_step: int, sleep_s: float) -> None:
    """Make every save with step >= `after_step` hang after its first leaf
    write, so a SIGKILL during the hang leaves a torn step directory (leaves
    present, no manifest)."""
    orig = checkpoint._save_leaf
    hung = set()

    def slow(path, *a, **kw):
        orig(path, *a, **kw)
        step_dir = os.path.basename(os.path.dirname(path))
        if step_dir.startswith("step_"):
            step = int(step_dir[len("step_"):])
            if step >= after_step and step not in hung:
                hung.add(step)
                print(f"SLOW-SAVE {step}", flush=True)
                time.sleep(sleep_s)

    checkpoint._save_leaf = slow


def _worker_main() -> None:
    """The elastic PCA driver (FIG7, N = 5, death:4@2-5, K = 2) on a fake
    clock with blocking per-superstep snapshots: "CKPT k" means step k is
    durable. SNAPSHOT_SLOW_AFTER_STEP=k hangs the save of step k after its
    first leaf."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--supersteps", type=int, required=True)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--no-snapshots", action="store_true")
    args = ap.parse_args()
    slow_after = os.environ.get("SNAPSHOT_SLOW_AFTER_STEP")
    if slow_after is not None:
        _arm_slow_save(int(slow_after),
                       float(os.environ.get("SNAPSHOT_SLOW_WRITE_S", "120")))
    clock = _FakeClock(1e-3)
    resume_from = None
    if args.resume:
        path = checkpoint.newest_valid(args.root)
        if path is None:
            print("RESUME-FAILED: no valid checkpoint", flush=True)
            sys.exit(3)
        done = int(checkpoint.load_manifest(path)["meta"]["supersteps_done"])
        clock = _advanced(done)
        resume_from = args.root
    snap = (None if args.no_snapshots else RunSnapshotter(
        args.root, every=1, keep_last=100, overhead_budget=0, block=True))
    drv = _elastic_driver(FaultSchedule.parse("death:4@2-5", N_PCA),
                          clock=clock, snapshotter=snap,
                          resume_from=resume_from)
    start = drv._supersteps_done
    print(f"START {start}", flush=True)

    def log(rec):
        if rec.get("checkpoint") is not None:
            print(f"CKPT {rec['checkpoint']}", flush=True)

    with drv:
        drv.run(args.supersteps - start, log_fn=log)
    if args.out:
        arrs = {"state::" + "::".join(str(e[1]) for e in k):
                (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in _leaves(drv.state).items()}
        arrs["eras"] = np.array([(r["bucket"], r["n_active"])
                                 for r in drv.history])
        arrs["counters"] = np.array(drv.history[-1]["counters"])
        arrs["resumed_at"] = np.array(start)
        np.savez(args.out, **arrs)
    print("DONE", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker_main()
