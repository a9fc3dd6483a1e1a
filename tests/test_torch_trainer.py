"""The port's LM trainer against the JAX package's, on reduced granite-8b
(2 layers, d_model 256, vocab 512) in f32 on the CPU, from the same numbers
(`convert.train_state` of the reference's state), batches of 8 x 64 tokens
from the same `MarkovTokenStream` draws.

Tolerances, per wire:
* exact, gossip (ring, N = 4, R = 2) and hierarchical with SGD: parameters
  within rtol = atol = 1e-5 after 3 steps, losses and the consensus error
  within rtol 1e-5 (the two packages differ by f32 reassociation only);
* Adam: it divides by the root of the second moment, so an entry whose
  gradient is float noise moves by up to the full step either way. 99.9% of
  the entries within 1e-5, every entry within 2 lr per step; 99.9% of the
  moments within 1e-4 of the largest entry, every one within 1e-2 of it;
* int8 and sign with tile statistics: the compressor rounds, so float noise
  in a gradient can move an entry across a rounding boundary and change its
  wire value by one step. 99% of the entries within 1e-5, every entry
  within 1e-2; losses within rtol 1e-4, the consensus error (a max over
  leaves) within rtol 1e-2.

Also the superstep (K = 2), the `StreamingDriver` built with no superstep
(the trainer's own builder) against the reference's driver, the contracts of
tests/test_trainer_dist.py on one process, and the launcher."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import AveragingConfig as JAveragingConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import SHAPES as JSHAPES
from repro.launch.mesh import make_mesh
from repro.launch.sharding import activation_rules
from repro.models.common import mesh_rules
from repro.train import trainer as jtrainer
from repro.train.driver import EngineConfig as JEngineConfig
from repro.train.driver import StreamingDriver as JStreamingDriver
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
from repro_torch.core import averaging
from repro_torch.core.mixing import Membership
from repro_torch.core.packing import tree_leaves
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.dist import Mesh
from repro_torch.launch import train as launch_train
from repro_torch.train import checkpoint, trainer
from repro_torch.train.driver import EngineConfig, StreamingDriver

# one intra-op thread: pytest-xdist runs several workers on the machine's
# cores, and a thread pool of every core in each of them oversubscribes
# the cores (a reduced-granite step then takes tens of times longer)
torch.set_num_threads(1)

N, B, S = 4, 8, 64


def _runs(mode="gossip", quant="none", optimizer="sgd", rounds=2, **kw):
    lr = 0.5 if optimizer == "sgd" else 2e-3
    q = dict(quantization=quant, quant_stats="tile", quant_block_d=64)
    common = dict(optimizer=optimizer, learning_rate=lr,
                  param_dtype="float32", **kw)
    jrun = JRunConfig(model=jreduced(jget_config("granite-8b")),
                      shape=JSHAPES["train_4k"],
                      averaging=JAveragingConfig(mode, rounds, **q), **common)
    trun = RunConfig(model=reduced(get_config("granite-8b")),
                     shape=SHAPES["train_4k"],
                     averaging=AveragingConfig(mode, rounds, **q), **common)
    return jrun, trun


def _draw(rng, n, seq=S):
    toks = MarkovTokenStream(512, seed=0).sample(rng, n, seq + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _mesh_rules(jrun):
    mesh = make_mesh((1, 1), ("data", "model"))
    decentralized = jrun.averaging.mode != "exact"
    return mesh, lambda: mesh_rules(mesh, activation_rules(
        mesh, jrun.shape, node_axis=decentralized))


def _states(jrun, trun):
    """The reference's initial state and the port's copy of it."""
    mesh, rules = _mesh_rules(jrun)
    with rules():
        js = jtrainer.init_state(jrun, jax.random.PRNGKey(0))
        if jrun.averaging.mode != "exact":
            js = jtrainer.replicate_for_nodes(js, N)
    ts = convert.train_state(*jax.tree.map(np.asarray, tuple(js)),
                             trun.model, device="cpu")
    return mesh, rules, js, ts


def _batch(rng, decentralized, k=None):
    b = _draw(rng, B if k is None else k * B)
    if k is not None:
        b = {key: v.reshape(k, B, S) for key, v in b.items()}
    if decentralized:
        b = trainer.make_node_batch(b, N, axis=0 if k is None else 1)
    return b


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


def _agree(got, want, tol, frac=1.0, bound=None):
    """`frac` of the entries within tol (+ tol * |want|), every entry within
    `bound` (default tol)."""
    g, w = _flat(got), _flat(want)
    d = np.abs(g - w)
    assert g.shape == w.shape and np.isfinite(g).all()
    assert np.mean(d <= tol + tol * np.abs(w)) >= frac, np.mean(
        d <= tol + tol * np.abs(w))
    assert d.max() <= (tol + tol * np.abs(w).max() if bound is None
                       else bound), d.max()


# rtol of the metrics, exact wire / quantized wire: a wire value moved by a
# rounding boundary moves the consensus error's max
METRIC_TOL = {False: {"loss": 1e-5, "ce": 1e-5, "consensus_err": 1e-5},
              True: {"loss": 1e-4, "ce": 1e-4, "consensus_err": 1e-2}}

STEP_CASES = [
    # (mode, quantization, optimizer, microbatches)
    ("exact", "none", "sgd", 1),
    ("exact", "none", "sgd", 2),
    ("gossip", "none", "sgd", 1),
    ("hierarchical", "none", "sgd", 1),
    ("gossip", "none", "adam", 1),
    ("gossip", "int8", "sgd", 1),
    ("gossip", "sign", "sgd", 1),
]


@pytest.mark.parametrize("mode,quant,optimizer,mb", STEP_CASES)
def test_train_step_matches_reference(mode, quant, optimizer, mb):
    jrun, trun = _runs(mode, quant, optimizer, microbatches=mb)
    mesh, rules, js, ts = _states(jrun, trun)
    decentralized = mode != "exact"
    tstep = trainer.build_train_step(trun, None, n_nodes=N, device="cpu")
    rng = np.random.default_rng(1)
    with rules():
        jstep = jax.jit(jtrainer.build_train_step(jrun, mesh, n_nodes=N)[0])
        for _ in range(3):
            b = _batch(rng, decentralized)
            js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
            ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
            for k in ("loss", "ce", "consensus_err"):
                np.testing.assert_allclose(
                    float(tm[k]), float(jm[k]), atol=1e-7, err_msg=k,
                    rtol=METRIC_TOL[quant != "none"][k])
    want = jax.tree.map(np.asarray, js)
    got = convert.train_tree(ts, trun.model)
    np.testing.assert_array_equal(got["step"], np.asarray(want.opt.step))
    assert (got["step"] == 3).all()
    lr = trun.learning_rate
    if quant != "none":
        _agree(got["params"], want.params, 1e-5, frac=0.99, bound=1e-2)
    elif optimizer == "adam":
        _agree(got["params"], want.params, 1e-5, frac=0.999, bound=6 * lr)
        for k in ("m", "v"):
            scale = np.abs(_flat(getattr(want.opt, k))).max()
            _agree(got[k], getattr(want.opt, k), 1e-4 * scale, frac=0.999,
                   bound=1e-2 * scale)
    else:
        _agree(got["params"], want.params, 1e-5)
    if decentralized:
        assert float(tm["consensus_err"]) > 0 or mode == "hierarchical"


def test_superstep_matches_reference_and_steps():
    """K = 2 rounds in one call: per-round metrics stacked [K], the same as
    the reference's scan and as two calls of the port's train step."""
    jrun, trun = _runs("gossip", "none", "sgd")
    mesh, rules, js, ts = _states(jrun, trun)
    _, _, _, ts2 = _states(jrun, trun)
    b = _batch(np.random.default_rng(2), True, k=2)
    with rules():
        jsup = jax.jit(jtrainer.build_superstep(jrun, mesh, n_nodes=N)[0])
        js, jm = jsup(js, {k: jnp.asarray(v) for k, v in b.items()})
    sup = trainer.build_superstep(trun, None, n_nodes=N, device="cpu")
    ts, tm = sup(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    assert tm["loss"].shape == (2,) and ts.opt.step == (2,) * N
    for k in ("loss", "consensus_err"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5)
    _agree(convert.train_tree(ts, trun.model)["params"],
           jax.tree.map(np.asarray, js.params), 1e-5)
    step = trainer.build_train_step(trun, None, n_nodes=N, device="cpu")
    # within tests/test_driver.py's decentralized bound: the CPU's kernels
    # need not give the same bits for the same sums in a fresh allocation
    for j in range(2):
        ts2, m = step(ts2, {k: torch.from_numpy(v[j]) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(tm["loss"][j]),
                                   rtol=1e-6)
    for a, c in zip(tree_leaves(ts.params), tree_leaves(ts2.params),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_driver_builds_the_trainer_and_matches_reference():
    """`StreamingDriver(run_cfg, None, state, sample_fn, n_nodes=4)` with no
    superstep trains through the trainer's own builder; with the same
    sample_fn and splitter seed, replan_every=0, its per-superstep losses
    and final parameters match the reference's driver."""
    jrun, trun = _runs("gossip", "none", "sgd")
    mesh, rules, js, ts = _states(jrun, trun)
    sample = lambda rng, n: _draw(rng, n)
    with rules():
        with JStreamingDriver(jrun, mesh, js, sample, batch=B, n_nodes=N,
                              engine=JEngineConfig(superstep=2,
                                                   prefetch_depth=0,
                                                   replan_every=0)) as jdrv:
            js, jhist = jdrv.run(2)
    with StreamingDriver(trun, None, ts, sample, batch=B, n_nodes=N,
                         device="cpu",
                         engine=EngineConfig(superstep=2, prefetch_depth=2,
                                             replan_every=0)) as drv:
        ts, hist = drv.run(2)
    assert [r["round"] for r in hist] == [2, 4] and ts.opt.step == (4,) * N
    for r, jr in zip(hist, jhist, strict=True):
        for k in ("loss", "consensus_err"):
            np.testing.assert_allclose(r["metrics"][k], jr["metrics"][k],
                                       rtol=1e-5)
    _agree(convert.train_tree(ts, trun.model)["params"],
           jax.tree.map(np.asarray, js.params), 1e-5)


def _train(mode, rounds, steps=12):
    """tests/dist_worker.py's run on one process: N = 4 emulated nodes,
    Adam at 2e-3, 8 x 64 tokens per round."""
    _, trun = _runs(mode, "none", "adam", rounds=rounds)
    state = trainer.init_state(trun, torch.Generator().manual_seed(0))
    if mode != "exact":
        state = trainer.replicate_for_nodes(state, N)
    step = trainer.build_train_step(trun, None, n_nodes=N, device="cpu")
    rng = np.random.default_rng(0)
    losses, cerrs = [], []
    for _ in range(steps):
        b = _batch(rng, mode != "exact")
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        cerrs.append(float(m["consensus_err"]))
    spread = (float(averaging.consensus_error({"p": state.params["embed"]}))
              if mode != "exact" else 0.0)
    return {"losses": losses, "consensus_errs": cerrs, "param_spread": spread}


@pytest.fixture(scope="module")
def exact_res():
    return _train("exact", 2)


@pytest.fixture(scope="module")
def gossip_res():
    return _train("gossip", 2)


def test_exact_trains(exact_res):
    assert exact_res["losses"][-1] < exact_res["losses"][0]
    assert all(e == 0.0 for e in exact_res["consensus_errs"])


def test_gossip_trains_and_nodes_diverge(gossip_res):
    r = gossip_res
    assert r["losses"][-1] < r["losses"][0]
    assert max(r["consensus_errs"]) > 0.0
    assert 0.0 < r["param_spread"] < 0.5


def test_gossip_more_rounds_tighter_consensus(gossip_res):
    tight = _train("gossip", 8)
    assert tight["consensus_errs"][-1] < gossip_res["consensus_errs"][-1]


def test_gossip_close_to_exact_in_loss(exact_res, gossip_res):
    le, lg = exact_res["losses"][-1], gossip_res["losses"][-1]
    assert abs(le - lg) / le < 0.2
    assert exact_res["losses"] != gossip_res["losses"]


def test_init_state_masters_and_replication():
    """bf16 parameters get f32 masters and f32 moments; the node axis is a
    copy per node, not a view (the updates write in place)."""
    _, trun = _runs("gossip", "none", "adam")
    trun = dataclasses.replace(trun, param_dtype="bfloat16")
    state = trainer.init_state(trun, torch.Generator().manual_seed(0))
    assert state.params["embed"].dtype == torch.bfloat16
    assert state.opt.master["embed"].dtype == torch.float32
    assert state.opt.m["embed"].dtype == torch.float32
    rep = trainer.replicate_for_nodes(state, N)
    assert rep.params["embed"].shape == (N, 512, 256)
    rep.params["embed"][0].zero_()
    assert rep.params["embed"][1].abs().sum() > 0
    no_master = trainer.init_state(dataclasses.replace(
        trun, master_weights=False), torch.Generator().manual_seed(0))
    assert no_master.opt.master == ()


def test_later_slices_raise():
    """A mesh with a model axis still raises (the sharded model layouts of
    queue 1 item 3; a node-only mesh trains: tests/test_torch_trainer_dist.py);
    error feedback (gossip only, as in the
    reference) and cohort supersteps build: the cohort's takes the active
    ids and works on the full state (tests/test_torch_elastic.py holds it
    against the reference)."""
    _, trun = _runs("gossip", "none", "adam")
    ef = dataclasses.replace(trun, averaging=dataclasses.replace(
        trun.averaging, error_feedback="grads"))
    assert callable(trainer.superstep_builder(ef, None, n_nodes=N,
                                              device="cpu")(B))
    hier = dataclasses.replace(ef, averaging=dataclasses.replace(
        ef.averaging, mode="hierarchical"))
    with pytest.raises(ValueError, match="error-feedback"):
        trainer.superstep_builder(hier, None, n_nodes=N, device="cpu")
    with pytest.raises(NotImplementedError, match="sharded"):
        trainer.build_train_step(trun, Mesh((1, 2), ("data", "model")),
                                 n_nodes=N, device="cpu")
    build = trainer.superstep_builder(trun, None, n_nodes=N, device="cpu")
    cohort = build(B, Membership.full(N).drop(1))
    assert cohort.takes_ids and cohort is build(B, Membership.full(N).drop(2))
    assert build(B, Membership.full(N)) is build(2 * B)


def test_launcher_runs_on_the_cpu(capsys):
    """The command the README gives, in-process: one node on one device,
    as the reference's host mesh gives."""
    launch_train.main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
                       "--steps", "4", "--superstep", "2", "--averaging",
                       "gossip", "--rounds", "2", "--batch", "8", "--seq",
                       "16"])
    out = capsys.readouterr().out
    assert "plan: B=8 mu=0" in out and "nodes=1 K=2" in out
    rounds = [line for line in out.splitlines() if line.startswith("round")]
    assert len(rounds) == 2 and "consensus_err" in rounds[0]
    # --publish publishes every superstep (the governor is off at budget 0)
    launch_train.main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
                       "--steps", "4", "--superstep", "2", "--averaging",
                       "gossip", "--rounds", "2", "--batch", "8", "--seq",
                       "16", "--publish", "--publish-budget", "0"])
    out = capsys.readouterr().out
    assert "publisher: v2 publishes=2 skipped(budget=0 interval=0)" in out
    # the production mesh needs 256 ranks; a fault on a node the run does
    # not have, and elastic membership without gossip averaging, are refused
    for flag, exc in ((["--production-mesh"], ValueError),
                      (["--faults", "death:1@5-12"], ValueError),
                      (["--straggler-policy", "drop"], ValueError)):
        with pytest.raises(exc):
            launch_train.main(["--arch", "granite-8b", "--reduced",
                               "--device", "cpu", *flag])


def test_launcher_checkpoint_and_resume(tmp_path, capsys):
    """`--checkpoint DIR --checkpoint-every 1 --checkpoint-budget 0` for 2
    supersteps, then `--resume DIR` for 2 more: the resumed rounds print
    the uninterrupted run's losses, and a `resumed:` line. Without
    `--checkpoint-every`, `--checkpoint` saves the final state once."""
    base = ["--arch", "granite-8b", "--reduced", "--device", "cpu",
            "--superstep", "2", "--averaging", "gossip", "--rounds", "2",
            "--nodes", "2", "--batch", "4", "--seq", "16",
            "--replan-every", "0"]
    root = str(tmp_path / "ck")

    def rounds(out):
        return [line.split("(")[0] for line in out.splitlines()
                if line.startswith("round")]

    launch_train.main(base + ["--steps", "8"])
    whole = rounds(capsys.readouterr().out)
    launch_train.main(base + ["--steps", "4", "--checkpoint", root,
                              "--checkpoint-every", "1",
                              "--checkpoint-budget", "0"])
    out = capsys.readouterr().out
    assert "snapshotter: saves=2" in out and "failures=0" in out
    launch_train.main(base + ["--steps", "4", "--resume", root])
    out = capsys.readouterr().out
    assert f"resumed: {root}/step_00000002 (superstep 2)" in out
    assert len(whole) == 4 and rounds(out) == whole[2:]
    final = str(tmp_path / "final")
    launch_train.main(base + ["--steps", "2", "--checkpoint", final])
    assert f"checkpoint -> {final}" in capsys.readouterr().out
    assert checkpoint.loaded_step(final) == 2 and checkpoint.is_valid(final)
