"""Snapshots, resume and publication of the port on a node axis split over
2 CPU ranks in a gloo group (`tests/torch_dist_worker.py` case
`shard_durability`, one worker run), and the launcher under torchrun:

* the ranks save one checkpoint of a reduced granite-8b state (f32, Adam,
  4 nodes, 2 a rank; params f32 and bf16), each its own rows: its files
  and manifest are byte for byte the one-process save of the same state,
  the JAX package's `checkpoint.restore` reads it, and the ranks restore
  their rows of the one-process checkpoint;
* the LM driver (gossip, ring R = 2) with a snapshot and a publication
  every superstep: resumed across a mesh change (2 ranks, then rank 0
  alone as one process from the ranks' snapshot, then the 2 ranks from
  the one process's snapshot) it ends bit for bit where the uninterrupted
  run does, and the one process's snapshot is byte for byte the ranks'
  snapshot of the same superstep; every rank publishes the same versions
  and the same params, equal to the one process's extract of the stitched
  state to f32 reassociation (one all-reduce of the ranks' row sums), and
  rank 0's engine adopts them;
* the governed PCA driver (N = 4, ring R = 2) under a node death with a
  snapshot every superstep, resumed on the ranks from its middle snapshot
  (iterate, round counter, membership events and plan records equal to
  the uninterrupted run's), and from its root once its newest snapshot is
  torn (the ranks skip it together);
* the planner's publish and snapshot messages against each rank's;
* `publish_extract` at one node a rank, bit for bit the one process's;
* the node-axis rule at one node a rank (`dist.node_leaf`): an exact
  run's replicated [1, 3] leaf is saved whole, byte for byte the one
  process's, and restored; a decentralized leaf that is not the rank's
  rows fails the save on every rank; a restore whose CRC32s fail on one
  rank's rows lands nothing on any rank;
* the launcher under torchrun (2 ranks) with `--checkpoint-every 1`, then
  `--resume` from the step directory of its second superstep: the resumed
  rounds print the uninterrupted run's losses.
"""
import dataclasses
import filecmp
import os
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jcheckpoint
from repro_torch import convert
from repro_torch import dist as rdist
from repro_torch.configs.paper_pca import FIG7
from repro_torch.core import mixing
from repro_torch.core.packing import tree_leaves, tree_map
from repro_torch.data.synthetic import make_pca_stream
from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.models.common import MetaGenerator
from repro_torch.train import checkpoint, trainer
from test_torch_trainer import _runs, _states
from torch_dist_worker import (DUR_B, DUR_BACK, DUR_N, DUR_PCA_SUPERSTEPS,
                               DUR_S, DUR_SAVE_STEP, DUR_SUPERSTEPS, lm_draw,
                               spawn)

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _run():
    jrun, trun = _runs("gossip", "none", "adam")
    return jrun, dataclasses.replace(trun, learning_rate=2e-3)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_durability")
    work = tmp / "work"
    work.mkdir()
    jrun, trun = _run()
    _, _, js, ts = _states(jrun, trun)
    # one step on one process, so every tree of the state holds numbers
    step = trainer.build_train_step(trun, None, n_nodes=DUR_N, device="cpu")
    batch = trainer.make_node_batch(
        lm_draw(np.random.default_rng(5), DUR_B, DUR_S), DUR_N)
    ts, _ = step(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    for label, state in (("f32", ts), ("bf16", ts._replace(
            params=tree_map(lambda t: t.to(torch.bfloat16), ts.params)))):
        checkpoint.save(str(work / f"one_{label}"), state,
                        step=DUR_SAVE_STEP, meta={"case": label},
                        model=trun.model)
    stream = make_pca_stream(FIG7, device="cpu")
    w0 = np.random.default_rng(0).standard_normal(FIG7.dim).astype(
        np.float32)
    mix = mixing.circulant_mix_op(mixing.schedule("ring", DUR_N), DUR_N,
                                  trun.averaging.rounds, fuse=False,
                                  device="cpu")
    given = {"work": str(work), "run": trun, "state": ts, "mix": mix,
             "pca": {"cov": stream.cov.numpy(),
                     "sqrt_cov": stream.sqrt_cov.numpy(),
                     "top": stream.top_eigvec.numpy(),
                     "lambda1": stream.lambda1, "eigengap": stream.eigengap,
                     "w0": w0 / np.linalg.norm(w0)}}
    path = tmp / "given.pt"
    torch.save(given, path)
    res = spawn("shard_durability", 2, tmp, path)
    yield res, given, js, ts
    shutil.rmtree(tmp, ignore_errors=True)  # the checkpoints under work


def _files(path):
    return sorted(f for f in os.listdir(path) if not f.endswith(".tmp"))


@pytest.mark.parametrize("label", ["f32", "bf16"])
def test_split_save_is_the_one_process_checkpoint(ranks, label):
    res, given, _, _ = ranks
    split = os.path.join(given["work"], f"split_{label}")
    one = os.path.join(given["work"], f"one_{label}")
    assert _files(split) == _files(one)
    match, mismatch, errors = filecmp.cmpfiles(split, one, _files(one),
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    assert checkpoint.is_valid(split)
    man = checkpoint.load_manifest(split)
    assert man == checkpoint.load_manifest(one)
    assert man["leaves"][".params::embed"]["shape"][0] == DUR_N


def test_split_checkpoint_restores_in_the_reference(ranks):
    res, given, js, ts = ranks
    split = os.path.join(given["work"], "split_f32")
    like = jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, js))
    got = jcheckpoint.restore(split, like)
    want = convert.train_tree(ts, given["run"].model)
    for a, b in zip(jax.tree.leaves(got.params),
                    jax.tree.leaves(want["params"]), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree.leaves(got.opt.v), jax.tree.leaves(want["v"]),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(got.opt.step), want["step"])


def _stitch(res, key):
    parts = sorted(res, key=lambda r: r["rows"])
    return jax.tree.map(lambda *xs: np.concatenate(xs),
                        *[r[key]["tree"] if "tree" in r[key] else r[key]
                          for r in parts])


def test_ranks_restore_the_one_process_checkpoint(ranks):
    res, given, _, ts = ranks
    want = convert.train_tree(ts, given["run"].model)
    parts = sorted(res, key=lambda r: r["rows"])
    got = jax.tree.map(lambda *xs: np.concatenate(xs),
                       *[r["restored"] for r in parts])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        np.testing.assert_array_equal(a, b)


def test_resume_across_a_mesh_change_bit_for_bit(ranks):
    """2 ranks -> rank 0 alone -> 2 ranks ends where the uninterrupted 2-rank
    run does, and the one process's snapshot of superstep DUR_BACK + 1 is
    the ranks' snapshot of it, leaf file for leaf file (the manifests
    differ only in the runs' wall clocks)."""
    res, given, _, _ = ranks
    want = _stitch(res, "lm")
    got = _stitch(res, "lm_resumed")
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    one = os.path.join(given["work"], "lm_one_process")
    assert [r["lm_resumed"]["from"] for r in res] == [
        checkpoint.step_dir(one, DUR_BACK + 1)] * 2
    split = checkpoint.step_dir(os.path.join(given["work"],
                                             "lm_uninterrupted"),
                                DUR_BACK + 1)
    one = checkpoint.step_dir(one, DUR_BACK + 1)
    assert _files(split) == _files(one)
    leaves = [f for f in _files(one) if f.endswith(".npy")]
    _, mismatch, errors = filecmp.cmpfiles(split, one, leaves, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    # the meta holds each run's own wall clock; the leaves are the same
    a, b = checkpoint.load_manifest(split), checkpoint.load_manifest(one)
    assert (a["step"], a["leaves"]) == (b["step"], b["leaves"])
    assert a["meta"]["splitter"] == b["meta"]["splitter"]
    for r in res:
        assert r["lm"]["saves"] == DUR_SUPERSTEPS
        assert r["lm"]["failures"] == 0
        assert r["lm"]["checkpoints"] == list(range(1, DUR_SUPERSTEPS + 1))


def test_publication_on_the_ranks(ranks):
    res, given, _, _ = ranks
    for r in res:
        assert r["lm"]["versions"] == list(range(1, DUR_SUPERSTEPS + 1))
    for a, b in zip(res[0]["lm"]["published"], res[1]["lm"]["published"],
                    strict=True):
        np.testing.assert_array_equal(a, b)
    # the one process's extract of the stitched final state
    st = _stitch(res, "lm")
    opt = types.SimpleNamespace(**{k: st[k] for k in (
        "step", "m", "v", "master", "ef_residual")})
    state = convert.train_state(st["params"], opt, given["run"].model,
                                device="cpu")
    want = trainer.publish_extract(DUR_N)(state, torch.ones(DUR_N))
    for a, b in zip(res[0]["lm"]["published"], tree_leaves(want),
                    strict=True):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-7)
    assert res[0]["polled"] and len(res[0]["tokens"]) == 4


def test_planned_publish_and_snapshot_messages(ranks):
    res, given, _, _ = ranks
    run = given["run"]
    for rank, r in enumerate(res):
        mesh = rdist.Mesh((2, 1), ("data", "model"), rank=rank)
        params = tree_map(lambda t: t[None].expand(2, *t.shape),
                          registry.init_params(MetaGenerator(), run.model,
                                               torch.float32))
        for wire, coll in ((r["publish_wire"], dryrun.publish_collectives(
                params, mesh)),
                           (r["snapshot_wire"],
                            dryrun.snapshot_collectives(mesh))):
            stats = wire["stats"]
            assert stats["messages"] == sum(
                v for k, v in coll.items() if k.endswith(".count"))
            assert stats["wire_bytes"] == dryrun.staged_bytes(coll)
        assert dryrun.publish_collectives(params, mesh)[
            "all-reduce.count"] == len(tree_leaves(params))


def test_pca_driver_resumes_on_the_ranks(ranks):
    """From the middle snapshot, and from the root once its newest
    snapshot is torn (one rank's rows of a leaf flipped: the ranks' joint
    CRC32 check fails on both, and they take the one before)."""
    res, given, _, _ = ranks
    half = DUR_PCA_SUPERSTEPS // 2
    root = os.path.join(given["work"], "pca")
    for r in res:
        whole, resumed, torn = r["pca"], r["pca_resumed"], r["pca_torn"]
        np.testing.assert_array_equal(resumed["w"], whole["w"])
        assert resumed["t"] == whole["t"]
        assert resumed["records"] == whole["records"]
        assert resumed["events"] == [e for e in whole["events"]
                                     if e[0] >= half]
        assert whole["events"]  # the death and the rejoin
        assert torn["from"] == checkpoint.step_dir(root,
                                                   DUR_PCA_SUPERSTEPS - 1)
        np.testing.assert_array_equal(torn["w"], whole["w"])
        assert torn["t"] == whole["t"]


def test_publish_extract_one_node_a_rank_bit_for_bit(tmp_path):
    """At one node a rank the all-reduce adds two numbers: the ranks'
    published params are the one process's, bit for bit (checked through
    the planner-free path: both halves summed in either order)."""
    r = np.random.default_rng(0)
    p = torch.from_numpy(r.standard_normal((2, 5, 3)).astype(np.float32))
    mask = torch.tensor([1.0, 1.0])
    want = trainer.publish_extract(2)({"p": p}, mask)["p"]
    w = mask / mask.sum()
    halves = [torch.zeros(5, 3).addcmul_(p[i], w[i]) for i in range(2)]
    np.testing.assert_array_equal((halves[0] + halves[1]).numpy(),
                                  want.numpy())
    np.testing.assert_array_equal((halves[1] + halves[0]).numpy(),
                                  want.numpy())


def test_node_axis_rule_at_one_node_a_rank(ranks, tmp_path):
    res, given, _, _ = ranks
    work = given["work"]
    one = str(tmp_path / "rep_one")
    checkpoint.save(one, {"c": torch.arange(3.0).reshape(1, 3), "t": 5},
                    step=1)
    split = os.path.join(work, "rep_split")
    assert _files(split) == _files(one)
    _, mismatch, errors = filecmp.cmpfiles(split, one, _files(one),
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    assert checkpoint.load_manifest(split)["leaves"]["c"]["shape"] == [1, 3]
    dec_one = str(tmp_path / "dec_one")
    checkpoint.save(dec_one, {"w": torch.arange(6.0).reshape(2, 3), "t": 5},
                    step=1)
    assert (checkpoint.load_manifest(os.path.join(work, "dec_split"))
            == checkpoint.load_manifest(dec_one))
    assert not os.path.exists(os.path.join(work, "bad_split",
                                           "manifest.json"))
    for r in res:
        np.testing.assert_array_equal(r["rep_restored"]["c"],
                                      [[0.0, 1.0, 2.0]])
        assert r["rep_restored"]["t"] == 5
        assert "leaf 'c' has 2 rows" in r["bad_save"]
        assert "['w']" in r["torn_restore"]
        np.testing.assert_array_equal(r["torn_like"], np.full((1, 3), -1.0))


def _torchrun(*flags, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "granite-8b", "--reduced", "--device", "cpu",
         "--no-env-tuning", "--superstep", "2", "--averaging", "gossip",
         "--rounds", "2", "--nodes", "4", "--batch", "8", "--seq", "32",
         "--lr", "2e-3", "--prefetch", "0", *flags],
        capture_output=True, text=True, timeout=timeout, env=env)


def _rounds(out):
    return sorted({line.split(" (")[0] for line in out.splitlines()
                   if line.startswith("round")})


def test_launcher_checkpoints_and_resumes_under_torchrun(tmp_path):
    root = tmp_path / "ck"
    whole = _torchrun("--steps", "8", "--checkpoint", str(root),
                      "--checkpoint-every", "1", "--checkpoint-budget", "0",
                      "--keep-last", "5")
    assert whole.returncode == 0, whole.stderr[-3000:]
    assert checkpoint.list_steps(str(root)) == [1, 2, 3, 4]
    assert sum(line.startswith("snapshotter: saves=4")
               for line in whole.stdout.splitlines()) == 2
    resumed = _torchrun("--steps", "4", "--resume",
                        checkpoint.step_dir(str(root), 2))
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert sum(line.startswith("resumed: ")
               for line in resumed.stdout.splitlines()) == 2
    got = _rounds(resumed.stdout)
    assert got and got == [r for r in _rounds(whole.stdout)
                           if int(r.split()[1]) > 4]
