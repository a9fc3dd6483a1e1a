"""Elastic membership and the scenario harness on the port's sharded node
axis, on CPU ranks in a gloo group (`tests/torch_dist_worker.py`, one
worker run per world size), against the JAX package on one process:

* the cohort shard rules on 2 and 4 ranks: a membership's active rows
  split over the ranks as contiguous, uneven runs of cohort rows
  (`dist.cohort_rows`), an uneven split of the full axis (N = 5 on 2
  ranks), a rank with no active row, a reach of 2 over a shard of one row,
  and a reach that would wrap (the op gathers). The exact and sign wires
  are bit for bit the port's plain per-round path over the m cohort rows,
  int8 (per-node statistics) too; every wire is held against the
  reference's plain mix over the m rows, the exact wire and the fused
  xi + gossip within 1e-6 of the largest entry, the quantized wires at
  tests/test_torch_shard.py's bounds (sign 1e-6, int8 1e-5, int8_stoch
  within a quantization step). The cohort's consensus error reduces over
  the active rows of every rank and divides by m. A dense op over the
  cohort and a scenario's scheduled op (ring/lossy/iid_pca) gather the
  node rows: within 1e-6 of the largest entry of the one-process
  product and of the reference's;
* the governed PCA driver on 2 ranks (FIG7, N = 5, ring R = 2, K = 2)
  against the JAX driver on one process with tests/test_torch_elastic.py's
  checks: equal membership events, compiled signatures and records, the
  iterate within 1e-5 relative plus 1e-5 of the largest entry, the
  consensus errors within 1e-4: death with rejoin (sync on and off),
  flaky nodes sharing one cohort superstep, a rank with no active row,
  straggler "drop" with readmission and "deadline";
* two registered scenarios on 2 ranks, N = 8 (ring/lossy/iid_pca and
  tv_rte/ratelimited/drift_pca): the same checks;
* the launcher under `torchrun` on 2 ranks with `--scenario` and
  `--faults` together, and with `--publish`; `--checkpoint` and
  `--resume` of the exact mode under churn on a model axis raise the
  reference's ValueError, as the driver's snapshotter and `resume_from`
  do.
"""
import os
import shutil
import subprocess
import sys

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
from repro.core import mixing as jmixing
from repro.core import scenarios as jscen
from repro.data.synthetic import make_pca_host_sampler as jhost_sampler
from repro.data.synthetic import make_pca_stream as jmake_pca_stream
from repro.kernels import ref as jref
from repro.train import driver as jdriver
from repro_torch import dist as rdist
from repro_torch.configs.paper_pca import PCARunConfig
from repro_torch.train.driver import StreamingDriver
from torch_dist_worker import (COHORT_CASES, COHORT_R, PCA_B, PCA_CASES,
                               PCA_K, PCA_N, SCENARIO_CASES,
                               SCN_T, SRC, FakeClock, cohort_inputs, events,
                               records, scenario_inputs, spawn)

torch.set_num_threads(1)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _stitch(parts):
    """The cohort's rows from every rank's (rows, values)."""
    return np.concatenate([v for _, v in sorted(parts, key=lambda p: p[0])])


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def cohorts(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"cohort{world}")
    res = spawn("cohort_rules", world, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    return world, res


def test_cohort_rows_split_the_active_ids():
    """`dist.cohort_rows` on 4 ranks of 10 nodes: contiguous cohort
    positions per shard, a shard whose nodes are all out holding none;
    `local_ids` the rank's active rows among its own."""
    from repro_torch.core.mixing import Membership

    four = [rdist.Mesh((4, 1), ("data", "model"), rank=r) for r in range(4)]
    mem = Membership.full(10).drop(6, 7, 0)
    assert rdist.cohort_rows(four[0], mem) == ((0, 2), (2, 5), (5, 5),
                                               (5, 7))
    assert [rdist.local_ids(m, mem) for m in four] == [(1, 2), (0, 1, 2),
                                                       (), (0, 1)]
    full = Membership.full(10)
    assert rdist.cohort_rows(four[0], full) == rdist.row_table(four[0], 10)
    assert rdist.local_ids(None, mem) == mem.active_ids


def test_cohort_rules_bit_for_bit_and_match_reference(cohorts):
    world, res = cohorts
    for label, n, dropped, topo, covered in COHORT_CASES[world]:
        runs = [r[label] for r in res]
        m = runs[0]["m"]
        x, w, z = cohort_inputs(label, m)
        sched = tuple(jmixing.schedule(topo, m))
        assert runs[0]["sched"] == sched
        assert sum(b - a for a, b in runs[0]["table"]) == m
        for r in runs:
            assert r["impl"] == ("shard" if covered else "roll"), label
            # int8_stoch draws the rank's own fold of the key: its noise
            # depends on the layout, by design
            for wire in ("exact", "sign", "int8"):
                if covered or wire != "exact":
                    np.testing.assert_array_equal(
                        r[wire], r[wire + "_plain"], err_msg=(label, wire))
                else:  # the gather rolls the composed R-round schedule
                    np.testing.assert_allclose(
                        r[wire], r[wire + "_plain"], rtol=1e-5, atol=1e-6)
        if label == "a rank out":
            assert min(b - a for a, b in runs[0]["table"]) == 0
        want = np.asarray(jref.gossip_mix_ref(jnp.asarray(x), sched,
                                              COHORT_R))
        got = _stitch([(r["rows"], r["exact"]) for r in runs])
        assert _rel(got, want) < 1e-6, label
        for quant, bound in (("sign", 1e-6), ("int8", 1e-5),
                             ("int8_stoch", 0.05)):
            key = jax.random.PRNGKey(0) if quant == "int8_stoch" else None
            jq = np.asarray(jref.gossip_mix_quant_ref(
                jnp.asarray(x), sched, COHORT_R, quant, block_d=512,
                key=key, per_node=True))
            assert _rel(_stitch([(r["rows"], r[quant]) for r in runs]),
                        jq) < bound, (label, quant)
        if covered:
            xi = jax.vmap(jref.krasulina_xi_ref)(jnp.asarray(w),
                                                 jnp.asarray(z))
            jxi = np.asarray(jref.gossip_mix_ref(xi, sched, COHORT_R))
            got = _stitch([(r["rows"], r["xi_gossip"]) for r in runs])
            assert _rel(got, jxi) < 1e-6, label
        dense = np.linalg.matrix_power(
            jmixing.ring_matrix(m).astype(np.float32), COHORT_R) @ x
        assert _rel(_stitch([(r["rows"], r["dense"]) for r in runs]),
                    dense) < 1e-6, label


def test_cohort_reductions_divide_by_m(cohorts):
    from repro.core import averaging as javeraging

    world, res = cohorts
    for label, *_ in COHORT_CASES[world]:
        m = res[0][label]["m"]
        x, w, _ = cohort_inputs(label, m)
        want = float(javeraging.consensus_error(
            {"x": jnp.asarray(x), "w": jnp.asarray(w)}))
        for r in res:
            np.testing.assert_allclose(r[label]["consensus_err"], want,
                                       rtol=1e-5, err_msg=label)


def test_scheduled_op_on_a_split_axis(cohorts):
    world, res = cohorts
    xs = scenario_inputs()
    jop = jscen.build_mix(jscen.get_scenario("ring/lossy/iid_pca"))
    for j, t in enumerate(SCN_T):
        got = _stitch([(r["scheduled"]["rows"], r["scheduled"]["got"][j])
                       for r in res])
        one = _stitch([(r["scheduled"]["rows"],
                        r["scheduled"]["one_process"][j]) for r in res])
        want = np.asarray(jop(jnp.asarray(xs), t=t))
        scale = np.abs(want).max()
        assert np.abs(got - one).max() <= 1e-6 * scale
        assert np.abs(got - want).max() <= 1e-6 * scale


# ---------------------------------------------------------------------------
# The governed PCA driver and two scenarios on 2 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pca_runs(tmp_path_factory):
    js = jmake_pca_stream(JFIG7)
    w0 = np.random.default_rng(0).standard_normal(JFIG7.dim).astype(
        np.float32)
    w0 /= np.linalg.norm(w0)
    path = tmp_path_factory.mktemp("elastic_driver") / "stream.npz"
    np.savez(path, cov=np.asarray(js.cov), sqrt_cov=np.asarray(js.sqrt_cov),
             top=np.asarray(js.top_eigvec), lambda1=js.lambda1,
             eigengap=js.eigengap, w0=w0)
    res = spawn("elastic_driver", 2, path.parent, path)
    shutil.rmtree(path.parent, ignore_errors=True)
    return res, js, w0


def _reference(js, w0, n, sample, *, spec=None, gov=None, supersteps=8,
               mix=None, faults=None):
    """The JAX driver on one process with the worker's `_pca_run`
    settings."""
    cfg = JPCARunConfig(averaging=JAveragingConfig(mode="gossip", rounds=2),
                        stream=JStreamConfig())
    if spec:
        faults = jfaults.FaultSchedule.parse(spec, n)
    eng = jdriver.EngineConfig(superstep=PCA_K, prefetch_depth=0,
                               replan_every=1, warmup_supersteps=0,
                               warmup_per_bucket=0,
                               governor=JGovernorConfig(**(gov or {})))
    with jdriver.StreamingDriver(
            cfg, None, jkras.init_krasulina_state(jnp.asarray(w0),
                                                  cfg.averaging, n),
            sample, n_nodes=n, batch=PCA_B if n == PCA_N else 2 * n, seed=1,
            superstep_builder=jkras.krasulina_superstep_builder(
                cfg.averaging, n, lambda t: 10.0 / t, mix=mix),
            faults=faults, clock=FakeClock(1e-3), engine=eng) as drv:
        state, _ = drv.run(supersteps)
    return drv, state


def _same(runs, drv, state):
    """tests/test_torch_elastic.py's `_same`, every rank against the
    reference's one process."""
    for r in runs:
        assert r["events"] == events(drv)
        assert r["signatures"] == drv.compiled_signatures
        assert r["records"] == records(drv)
        assert r["keys"] == [sorted(x) for x in drv.history]
        assert r["t"] == int(state.t)
        np.testing.assert_allclose(
            r["consensus_err"],
            [x["metrics"]["consensus_err"] for x in drv.history],
            rtol=1e-4, atol=1e-6)
    want = np.asarray(state.w)
    got = np.concatenate([r["w"] for r in sorted(runs,
                                                 key=lambda r: r["rows"])])
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", list(PCA_CASES))
def test_sharded_pca_driver_churn_matches_reference(pca_runs, name):
    res, js, w0 = pca_runs
    spec, gov, steps = PCA_CASES[name]
    drv, state = _reference(js, w0, PCA_N, jhost_sampler(js), spec=spec,
                            gov=gov, supersteps=steps)
    runs = [r[name] for r in res]
    _same(runs, drv, state)
    evs = runs[0]["events"]
    if name == "straggler drop":
        assert evs and evs[-1][2] == (True,) * PCA_N  # readmitted
    elif name == "deadline":  # node 2 over the deadline: evicted
        assert evs and evs[0][2] == (True, True, False, True, True)
    else:
        assert evs and any(not all(e[2]) for e in evs)
    if name == "flaky share a cohort":
        assert runs[0]["signatures"] == ((10, 5), (12, 4))
    if name == "a rank out":  # nodes 3 and 4: rank 1's every row
        assert any(e[2][3:] == (False, False) for e in evs)


@pytest.mark.parametrize("name", SCENARIO_CASES)
def test_sharded_scenario_matches_reference(pca_runs, name):
    res, js, w0 = pca_runs
    scn = jscen.get_scenario(name)
    drv, state = _reference(js, w0, scn.n_nodes,
                            jscen.build_stream(scn).sample, supersteps=6,
                            mix=jscen.build_mix(scn),
                            faults=jscen.fault_schedule(scn))
    runs = [r[name] for r in res]
    _same(runs, drv, state)
    assert runs[0]["events"] == []
    assert all("bw_factor" in keys for keys in runs[0]["keys"])


# ---------------------------------------------------------------------------
# What a split axis still refuses, and the launcher under torchrun
# ---------------------------------------------------------------------------


TWO = rdist.Mesh((2, 1), ("data", "model"))


@pytest.mark.parametrize("arg", ["publisher", "snapshotter", "resume_from"])
def test_driver_durability_on_a_split_axis_still_raises(arg, tmp_path):
    """Publication, snapshots and resuming run on a split node axis
    (tests/test_torch_shard_durability.py runs them on ranks): a publisher
    binds to the split mesh, and rank 0 decides for the others. Over a
    model axis they run too, for every family
    (tests/test_torch_model_axis_durability.py); what still raises is a
    snapshot or a resume of a run the reference refuses, the exact mode
    under churn (here the SSD family on a model axis, which passes the
    trainer's checks), with the reference's ValueError before any process
    group is entered."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.serve.publisher import SnapshotPublisher
    from repro_torch.train.snapshot import RunSnapshotter

    if arg == "publisher":
        pub = SnapshotPublisher()
        cfg = PCARunConfig(averaging=AveragingConfig(mode="gossip",
                                                     rounds=2))
        StreamingDriver(cfg, TWO, None, lambda rng, n: {}, n_nodes=2,
                        device="cpu", superstep_fn=lambda s, b: (s, {}),
                        faults=FaultSchedule.parse("death:1@1-2", 2),
                        publisher=pub)
        assert pub._mesh is TWO
        return
    value = (RunSnapshotter(str(tmp_path)) if arg == "snapshotter"
             else str(tmp_path))
    run = RunConfig(model=reduced(get_config("mamba2-2.7b")),
                    shape=SHAPES["train_4k"],
                    averaging=AveragingConfig(mode="exact"))
    try:
        with pytest.raises(ValueError, match="decentralized node axis"):
            StreamingDriver(run, rdist.Mesh((1, 2), ("data", "model")), None,
                            lambda rng, n: {}, n_nodes=2, device="cpu",
                            faults=FaultSchedule.parse("death:1@1-2", 2),
                            **{arg: value})
    finally:
        if arg == "snapshotter":
            value.close()


def test_one_process_builds_each_signature_once():
    """On one process a cohort's superstep is keyed by its size alone (on a
    split axis, by its cohort): a death and a flaky node make two cohorts
    of one size, which share one build, as the reference shares one
    compiled executable."""
    from repro_torch.configs.base import AveragingConfig, StreamConfig
    from repro_torch.configs.paper_pca import FIG7
    from repro_torch.core import krasulina
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.data.synthetic import (make_pca_host_sampler,
                                            make_pca_stream)
    from repro_torch.train.driver import EngineConfig

    n = 10
    avg = AveragingConfig(mode="gossip", rounds=2, topology="ring")
    stream = make_pca_stream(FIG7, device="cpu")
    builder = krasulina.krasulina_superstep_builder(
        avg, n, lambda t: 0.1 / (t + 10), device="cpu")
    builds = []

    def counting(B, membership=None):
        builds.append((B, n if membership is None else membership.n_active))
        return builder(B, membership)

    w0 = torch.ones(FIG7.dim) / FIG7.dim ** 0.5
    state = krasulina.init_krasulina_state(w0, avg, n, device="cpu")
    with StreamingDriver(
            PCARunConfig(pca=FIG7, averaging=avg, stream=StreamConfig()),
            None, state, make_pca_host_sampler(stream),
            superstep_builder=counting, n_nodes=n, batch=100, device="cpu",
            faults=FaultSchedule.parse("death:3@2-6,flaky:7@3-9p2", n),
            engine=EngineConfig(superstep=2, prefetch_depth=0,
                                replan_every=0)) as drv:
        drv.run(12)
    cohorts = {e["to"] for e in drv.membership_events
               if e["to"].n_active == n - 1}
    assert len(cohorts) == 2  # node 3 out, and node 7 out
    assert sorted(builds) == sorted(set(builds)) == list(
        drv.compiled_signatures) == [(100, 10), (104, 8), (108, 9)]


def _torchrun(*flags, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "granite-8b", "--reduced", "--device", "cpu",
         "--no-env-tuning", *flags],
        capture_output=True, text=True, timeout=timeout, env=env)


def test_launcher_scenario_and_faults_under_torchrun():
    """Two ranks, 4 nodes (2 a rank): a scenario's scheduled operator and
    link model with a node death; every rank resolves the same cohort and
    prints the same node means."""
    p = _torchrun("--steps", "6", "--superstep", "2", "--averaging",
                  "gossip", "--nodes", "4", "--batch", "8", "--seq", "32",
                  "--lr", "2e-3", "--prefetch", "0", "--scenario",
                  "ring/lossy/iid_pca", "--faults", "death:1@1-2")
    assert p.returncode == 0, p.stderr[-3000:]
    out = p.stdout.splitlines()
    assert sum(line.startswith("scenario: ring/lossy/iid_pca n=4")
               for line in out) == 2
    member = [line for line in out if line.startswith("membership")]
    assert member.count("membership superstep 1: (0, 2, 3) B=9") == 2
    assert member.count("membership superstep 2: (0, 1, 2, 3) B=8") == 2
    rounds = [line for line in out if line.startswith("round")]
    assert len(rounds) == 6 and all("nan" not in r for r in rounds)
    assert all("drops=" in r for r in rounds)
    assert [r.split(" (")[0] for r in rounds[0::2]] == [
        r.split(" (")[0] for r in rounds[1::2]]


@pytest.mark.parametrize("flags", [["--publish"],
                                   ["--checkpoint", "ck"],
                                   ["--resume", "ck"]])
def test_launcher_durability_under_torchrun_still_raises(flags, tmp_path,
                                                         monkeypatch):
    """`--publish` runs under torchrun (2 ranks, rank 0's versions on
    both; tests/test_torch_shard_durability.py runs `--checkpoint-every`
    and `--resume` there, tests/test_torch_model_axis_durability.py over
    a model axis, for every family); `--checkpoint` and `--resume` of a
    run the reference refuses still raise its ValueError: the exact mode
    under churn, here of the SSD family on a model axis."""
    from repro_torch.launch import train as launch_train

    if flags == ["--publish"]:
        p = _torchrun("--steps", "2", "--superstep", "1", "--averaging",
                      "gossip", "--nodes", "4", "--batch", "8", "--seq",
                      "16", "--prefetch", "0", "--publish",
                      "--publish-budget", "0")
        assert p.returncode == 0, p.stderr[-3000:]
        pubs = [line.split(" publishes=")[0] for line in
                p.stdout.splitlines() if line.startswith("publisher:")]
        assert pubs == ["publisher: v2"] * 2
        return
    flags = [str(tmp_path / f) if f == "ck" else f for f in flags]
    monkeypatch.setattr(launch_train, "make_host_mesh",
                        lambda **kw: rdist.Mesh((1, 2), ("data", "model")))
    ap = launch_train._parser()
    args = ap.parse_args(["--arch", "mamba2-2.7b", "--reduced",
                          "--device", "cpu", "--model-axis", "2",
                          "--averaging", "exact", "--nodes", "2",
                          "--faults", "death:1@1-2", *flags])
    with pytest.raises(ValueError, match="decentralized node axis"):
        launch_train._train(ap, args, distributed=True)
