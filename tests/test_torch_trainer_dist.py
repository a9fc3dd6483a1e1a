"""The port's LM trainer on a sharded node axis: reduced granite-8b on 4 CPU
ranks in a gloo group, one node per rank (`tests/torch_dist_worker.py`),
and the training launcher under `torchrun`.

* Against the JAX trainer at n_nodes = 4 (one device, no mesh), from the
  same state (`convert.train_state` of the reference's) and the same
  `MarkovTokenStream` batches of 8 x 64 tokens, 3 SGD steps: exact and
  gossip (ring R = 2) at tests/test_torch_trainer.py's tolerances
  (parameters within rtol = atol = 1e-5, losses and the consensus error
  within rtol 1e-5).
* tests/test_trainer_dist.py's contracts, 12 Adam steps of 16 x 64 tokens:
  exact trains with a consensus error of 0; gossip trains, its mixed
  gradients disagree (consensus error > 0) and its parameters drift apart
  (0 < spread < 0.5); 8 rounds give a tighter consensus than 2; gossip
  ends within 20% of exact in loss.
* `torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train
  ... --device cpu` prints one plan and falling losses on each rank, and
  `--production-mesh` (256 ranks) is refused on 2.
"""
import os
import re
import subprocess
import sys

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
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
from repro_torch.core.packing import tree_leaves
from repro_torch.data.lm import MarkovTokenStream
from torch_dist_worker import SRC, spawn

torch.set_num_threads(1)

N, B, S, STEPS = 4, 8, 64, 3


def _runs(mode):
    common = dict(optimizer="sgd", learning_rate=0.5, param_dtype="float32")
    jrun = JRunConfig(model=jreduced(jget_config("granite-8b")),
                      shape=JSHAPES["train_4k"],
                      averaging=JAveragingConfig(mode, 2), **common)
    trun = RunConfig(model=reduced(get_config("granite-8b")),
                     shape=SHAPES["train_4k"],
                     averaging=AveragingConfig(mode, 2), **common)
    return jrun, trun


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in leaves])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's 3 steps per mode, and the 4 ranks' results."""
    tmp = tmp_path_factory.mktemp("trainer_dist")
    given, want = {}, {}
    for mode in ("exact", "gossip"):
        jrun, trun = _runs(mode)
        mesh = make_mesh((1, 1), ("data", "model"))
        decentralized = mode != "exact"
        rng = np.random.default_rng(1)
        data = MarkovTokenStream(512, seed=0)
        batches = []
        for _ in range(STEPS):
            toks = data.sample(rng, B, S + 1)
            batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        with mesh_rules(mesh, activation_rules(mesh, jrun.shape,
                                               node_axis=decentralized)):
            js = jtrainer.init_state(jrun, jax.random.PRNGKey(0))
            if decentralized:
                js = jtrainer.replicate_for_nodes(js, N)
            ts = convert.train_state(*jax.tree.map(np.asarray, tuple(js)),
                                     trun.model, device="cpu")
            step = jax.jit(jtrainer.build_train_step(jrun, mesh,
                                                     n_nodes=N)[0])
            metrics = []
            for b in batches:
                jb = {k: jnp.asarray(v) for k, v in b.items()}
                if decentralized:
                    jb = jtrainer.make_node_batch(jb, N)
                js, m = step(js, jb)
                metrics.append({k: float(v) for k, v in m.items()})
        given[mode] = {"state": ts, "run": trun, "batches": batches}
        final = convert.train_state(*jax.tree.map(np.asarray, tuple(js)),
                                    trun.model, device="cpu")
        want[mode] = ([p.numpy() for p in tree_leaves(final.params)],
                      metrics)
    path = tmp / "given.pt"
    torch.save(given, path)
    return spawn("trainer", N, tmp, path), want


@pytest.mark.parametrize("mode", ["exact", "gossip"])
def test_sharded_trainer_matches_reference(runs, mode):
    res, want = runs
    want_leaves, want_metrics = want[mode]
    got = [r["compare"][mode] for r in res]
    for g in got:
        assert g["step"] == ((STEPS,) if mode == "gossip" else STEPS)
        for m, w in zip(g["metrics"], want_metrics):
            for k in ("loss", "ce", "consensus_err"):
                np.testing.assert_allclose(m[k], w[k], rtol=1e-5, atol=1e-7,
                                           err_msg=k)
    if mode == "gossip":  # the ranks' rows, stitched in rank order
        leaves = [np.concatenate(parts) for parts in
                  zip(*[g["params"] for g in got])]
    else:  # every rank holds the same replica
        for g in got[1:]:
            for a, b in zip(g["params"], got[0]["params"]):
                np.testing.assert_array_equal(a, b)
        leaves = got[0]["params"]
    g, w = _flat(leaves), _flat(want_leaves)
    assert g.shape == w.shape and np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    if mode == "gossip":
        assert want_metrics[-1]["consensus_err"] > 0


def _contract(runs, mode, rounds):
    res, _ = runs
    out = [r["contract"][(mode, rounds)] for r in res]
    for o in out[1:]:  # every rank reports the node means
        assert o == out[0]
    assert out[0]["n_nodes"] == N
    return out[0]


def test_exact_trains_on_4_ranks(runs):
    r = _contract(runs, "exact", 2)
    assert r["losses"][-1] < r["losses"][0]
    assert all(e == 0.0 for e in r["consensus_errs"])


def test_gossip_trains_and_nodes_diverge(runs):
    r = _contract(runs, "gossip", 2)
    assert r["losses"][-1] < r["losses"][0]
    assert max(r["consensus_errs"]) > 0.0
    assert 0.0 < r["param_spread"] < 0.5


def test_gossip_more_rounds_tighter_consensus(runs):
    tight = _contract(runs, "gossip", 8)
    loose = _contract(runs, "gossip", 2)
    assert tight["consensus_errs"][-1] < loose["consensus_errs"][-1]


def test_gossip_close_to_exact_in_loss(runs):
    le = _contract(runs, "exact", 2)["losses"]
    lg = _contract(runs, "gossip", 2)["losses"]
    assert abs(le[-1] - lg[-1]) / le[-1] < 0.2
    assert le != lg


def _torchrun(*flags, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "granite-8b", "--reduced", "--device", "cpu", *flags],
        capture_output=True, text=True, timeout=timeout, env=env)


def test_launcher_under_torchrun():
    p = _torchrun("--steps", "12", "--superstep", "2", "--averaging",
                  "gossip", "--rounds", "2", "--batch", "16", "--seq", "64",
                  "--lr", "2e-3", "--no-env-tuning")
    assert p.returncode == 0, p.stderr[-3000:]
    plans = [line for line in p.stdout.splitlines()
             if line.startswith("plan:")]
    assert len(plans) == 2
    assert {re.search(r"rank=(\d)/2", line).group(1) for line in plans} == {
        "0", "1"}
    assert all("nodes=2 " in line and "local_nodes=1" in line
               for line in plans)
    losses = [float(re.search(r"loss (\S+)", line).group(1))
              for line in p.stdout.splitlines() if line.startswith("round")]
    assert len(losses) == 12  # 6 supersteps, printed by each rank
    # both ranks print the same node means, in lockstep
    assert losses[0::2] == losses[1::2]
    assert losses[-1] < losses[0]


def test_launcher_production_mesh_needs_256_ranks():
    p = _torchrun("--steps", "2", "--superstep", "2", "--production-mesh",
                  timeout=120)
    assert p.returncode != 0
    assert "256 ranks" in p.stderr
