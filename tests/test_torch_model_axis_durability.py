"""Durable runs on the port's model axis, on CPU ranks in a gloo group
(`tests/torch_dist_worker.py` `model_durability`, one worker run of 4
ranks), and the launcher under torchrun:

* the driver trains reduced granite-8b at d_model 512 with 2 KV heads
  (f32, Adam, 4 nodes; half a KV head a rank on 1 x 4) in the exact mode
  on 2 x 2 (FSDP + ZeRO-1) and in the gossip mode on 1 x 4, with a
  blocking snapshot after each of 3 supersteps: the last snapshot's files
  are byte for byte rank 0's one-process save of the gathered state, and
  its manifest entries the same;
* resumed on the same mesh from the snapshot after superstep 2, into
  zeroed blocks, its last superstep is the uninterrupted run's bit for
  bit;
* that snapshot restored onto the other mesh (2 x 2 -> 1 x 4, 1 x 4 ->
  2 x 2) and gathered is, bit for bit, what one process restores from it,
  and saved there again as a split checkpoint it is the same files;
* the launcher (2 ranks, `--model-axis 2`: reduced granite's one KV head
  split in two) snapshots each of 2 supersteps and resumes from the first
  snapshot with the uninterrupted run's losses.
"""
import filecmp
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
from repro_torch.core.packing import map_tensors, tree_leaves
from repro_torch.train import checkpoint, trainer
from torch_dist_worker import (DUR_N, MD_BACK, MD_RUNS, MD_SUPERSTEPS,
                               digest, spawn)

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MODES = [mode for mode, _ in MD_RUNS]


def _run(mode):
    cfg = reduced(get_config("granite-8b"), d_model=512)
    assert (cfg.num_heads, cfg.num_kv_heads) == (8, 2)
    return RunConfig(model=cfg, shape=SHAPES["train_4k"],
                     averaging=AveragingConfig(mode, 2), optimizer="adam",
                     learning_rate=2e-3, param_dtype="float32")


def _whole(mode):
    run = _run(mode)
    state = trainer.init_state(run, torch.Generator().manual_seed(0))
    if mode != "exact":
        state = trainer.replicate_for_nodes(state, DUR_N)
    return run, state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_durability")
    work = tmp / "work"
    work.mkdir()
    given = {"work": str(work)}
    for mode in MODES:
        given[mode] = _whole(mode)
    path = tmp / "given.pt"
    torch.save(given, path)
    yield spawn("model_durability", 4, tmp, path), work
    shutil.rmtree(tmp, ignore_errors=True)  # a few GB of checkpoints


def _leaf_files(path):
    return {k: e for k, e in checkpoint.load_manifest(path)["leaves"].items()}


def _same_files(a, b):
    """The leaves of checkpoints a and b: the same manifest entries and
    the same bytes."""
    la, lb = _leaf_files(a), _leaf_files(b)
    assert la == lb
    for ent in la.values():
        assert filecmp.cmp(os.path.join(a, ent["file"]),
                           os.path.join(b, ent["file"]), shallow=False)


def _one_process(path, mode):
    """The checkpoint at `path` restored on one process, its parameters
    and moments as numpy leaves in `tree_leaves` order."""
    run, state = _whole(mode)
    st = checkpoint.restore(path, map_tensors(torch.zeros_like, state),
                            model=run.model)
    return [t.numpy() for tree in (st.params, st.opt.m, st.opt.v)
            for t in tree_leaves(tree)]


@pytest.mark.parametrize("mode,name", MD_RUNS)
def test_snapshot_is_the_one_process_save(ranks, mode, name):
    res, work = ranks
    for r in res:
        got = r[mode]
        assert got["saves"] == MD_SUPERSTEPS and got["failures"] == 0, \
            got["error"]
        assert all(np.isfinite(got["losses"]))
    root = os.path.join(work, f"{mode}_{name}")
    assert checkpoint.list_steps(root) == list(range(1, MD_SUPERSTEPS + 1))
    _same_files(checkpoint.step_dir(root, MD_SUPERSTEPS),
                os.path.join(work, f"{mode}_one"))


@pytest.mark.parametrize("mode,name", MD_RUNS)
def test_resume_on_the_same_mesh_is_bit_for_bit(ranks, mode, name):
    res, work = ranks
    back = checkpoint.step_dir(os.path.join(work, f"{mode}_{name}"),
                               MD_BACK)
    for r in res:
        got = r[mode]
        assert got["resumed"]["from"] == back
        assert got["resumed"]["bitwise"]
        assert got["resumed"]["losses"] == got["losses"][MD_BACK:]


@pytest.mark.parametrize("mode,name", MD_RUNS)
def test_restore_onto_another_split_and_one_process(ranks, mode, name):
    """The snapshot after MD_BACK: what the other mesh's ranks restore and
    gather equals one process's restore bit for bit, their split save of
    it is the same files, and the last snapshot restores on one process
    to the state the ranks gathered."""
    res, work = ranks
    root = os.path.join(work, f"{mode}_{name}")
    back = checkpoint.step_dir(root, MD_BACK)
    want = _one_process(back, mode)
    last = _one_process(checkpoint.step_dir(root, MD_SUPERSTEPS), mode)
    other = res[0][mode]["other"]["mesh"]
    assert other != name
    for r in res:
        for got, ref in ((r[mode]["other"], want), (r[mode], last)):
            rows = got["rows"]
            if rows is not None:
                ref = [b[rows[0]:rows[1]] for b in ref]
            if got["state"]["leaves"] is not None:  # rank 0's arrays
                assert len(got["state"]["leaves"]) == len(ref)
                for a, b in zip(got["state"]["leaves"], ref):
                    np.testing.assert_array_equal(a, b)
            assert got["state"]["digest"] == digest(ref)
    _same_files(back, os.path.join(work, f"{mode}_{other}"))


def _torchrun(*flags, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "granite-8b", "--reduced", "--device", "cpu",
         "--no-env-tuning", "--superstep", "2", "--averaging", "gossip",
         "--rounds", "2", "--nodes", "4", "--batch", "8", "--seq", "32",
         "--lr", "2e-3", "--prefetch", "0", "--model-axis", "2", *flags],
        capture_output=True, text=True, timeout=timeout, env=env)


def _rounds(out):
    return sorted({line.split(" (")[0] for line in out.splitlines()
                   if line.startswith("round")})


def test_launcher_snapshots_and_resumes_a_model_axis(tmp_path):
    cfg = reduced(get_config("granite-8b"))
    assert cfg.num_kv_heads * cfg.resolved_head_dim // 2 < \
        cfg.resolved_head_dim  # half a KV head a rank
    root = tmp_path / "ck"
    whole = _torchrun("--steps", "4", "--checkpoint", str(root),
                      "--checkpoint-every", "1", "--checkpoint-budget", "0",
                      "--keep-last", "5")
    assert whole.returncode == 0, whole.stderr[-3000:]
    assert checkpoint.list_steps(str(root)) == [1, 2]
    assert sum(line.startswith("snapshotter: saves=2")
               for line in whole.stdout.splitlines()) == 2
    resumed = _torchrun("--steps", "2", "--resume",
                        checkpoint.step_dir(str(root), 1))
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert sum(line.startswith("resumed: ")
               for line in resumed.stdout.splitlines()) == 2
    got = _rounds(resumed.stdout)
    assert got and got == [r for r in _rounds(whole.stdout)
                           if int(r.split()[1]) > 2]
