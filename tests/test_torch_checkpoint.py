"""The port's checkpoint module (`repro_torch.train.checkpoint`) against the
JAX package's, on the CPU.

* each case of tests/test_checkpoint.py on the port: round trip of a
  reduced granite-8b `TrainState`, `put`, mismatch names, crash safety,
  atomic overwrite, torn-leaf CRC, orphan cleanup, retries, `newest_valid`
  and `prune`;
* interchange, exact: a `KrasulinaState` and a reduced granite-8b
  `TrainState` (3 layers, so the period position stacks), f32 and bf16,
  with and without the node axis, from the same numbers in both packages:
  the two manifests are equal (keys in order, files, shapes, dtype strings,
  CRC32s) and every leaf file is byte for byte the same; a reference
  checkpoint restores in the port and a port checkpoint in the reference
  (its bf16 leaves through a `put` that views them as `ml_dtypes.bfloat16`:
  the reference's own restore of a bf16 leaf has no such view) with equal
  numbers.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import AveragingConfig as JAveragingConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import SHAPES as JSHAPES
from repro.core import krasulina as jkras
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RunConfig, SHAPES
from repro_torch.core.krasulina import KrasulinaState
from repro_torch.core.packing import tree_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import init_state

torch.set_num_threads(1)


def _port_cfg(layers=2):
    return reduced(get_config("granite-8b"), layers=layers)


def _equal_states(a, b):
    la, lb = {}, {}
    ckpt._walk(a, (), la)
    ckpt._walk(b, (), lb)
    assert la.keys() == lb.keys()
    for k in la:
        if isinstance(la[k], torch.Tensor):
            assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k
        else:
            assert la[k] == lb[k], k


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py on the port
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    cfg = _port_cfg()
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], param_dtype="float32")
    state = init_state(run, torch.Generator().manual_seed(0))
    path = str(tmp_path / "ck")
    ckpt.save(path, state, step=42, meta={"arch": cfg.name}, model=cfg)
    like = state._replace(params=convert.tree_map(torch.zeros_like,
                                                   state.params))
    restored = ckpt.restore(path, like, model=cfg)
    assert ckpt.loaded_step(path) == 42
    _equal_states(state, restored)
    # into=True writes into the target's own tensors
    into = ckpt.restore(path, like, model=cfg, into=True)
    assert into.params["embed"] is like.params["embed"]
    _equal_states(state, into)


def test_lm_state_needs_its_model(tmp_path):
    run = RunConfig(model=_port_cfg(), shape=SHAPES["train_4k"],
                    param_dtype="float32")
    state = init_state(run, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="model config"):
        ckpt.save(str(tmp_path / "ck"), state)


def test_restore_with_put(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones(4)}}
    path = str(tmp_path / "ck2")
    ckpt.save(path, tree)
    seen = []
    out = ckpt.restore(path, tree,
                       put=lambda key, t: (seen.append(key), t * 2)[1])
    assert sorted(seen) == ["a", "nested::b"]
    np.testing.assert_array_equal(out["a"].numpy(),
                                  2 * np.arange(6.0).reshape(2, 3))


def test_restore_mismatch_names_missing_and_extra_keys(tmp_path):
    path = str(tmp_path / "ck3")
    ckpt.save(path, {"a": torch.ones(2), "old": torch.ones(3)})
    target = {"a": torch.ones(2), "renamed": torch.ones(3)}
    with pytest.raises(ValueError) as ei:
        ckpt.restore(path, target)
    msg = str(ei.value)
    assert "missing from checkpoint: ['renamed']" in msg
    assert "present in checkpoint but not in target: ['old']" in msg


def test_save_is_crash_safe(tmp_path, monkeypatch):
    """A crash mid-save never leaves a manifest pointing at missing leaves:
    the older checkpoint stays restorable until the new one is durable."""
    path = str(tmp_path / "ck4")
    tree_v1 = {"a": torch.zeros(2), "b": torch.zeros(3)}
    ckpt.save(path, tree_v1, step=1)

    calls = {"n": 0}
    real_save = np.save

    def dying_save(f, arr, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise OSError("disk full")  # crash after the first leaf
        return real_save(f, arr, **kw)

    monkeypatch.setattr(np, "save", dying_save)
    with pytest.raises(OSError):
        ckpt.save(path, {"a": torch.ones(2), "b": torch.ones(3)}, step=2)
    monkeypatch.setattr(np, "save", real_save)

    assert ckpt.loaded_step(path) == 1
    restored = ckpt.restore(path, tree_v1)
    np.testing.assert_array_equal(restored["b"].numpy(), np.zeros(3))
    assert not os.path.exists(os.path.join(path, "manifest.json.tmp"))


def test_save_overwrites_atomically(tmp_path):
    path = str(tmp_path / "ck5")
    ckpt.save(path, {"a": torch.zeros(2)}, step=1)
    ckpt.save(path, {"a": torch.ones(2)}, step=2)
    assert ckpt.loaded_step(path) == 2
    out = ckpt.restore(path, {"a": torch.zeros(2)})
    np.testing.assert_array_equal(out["a"].numpy(), np.ones(2))


def test_crc_detects_torn_leaf(tmp_path):
    path = str(tmp_path / "ck6")
    tree = {"a": torch.arange(8.0), "nested": {"b": torch.ones(4)}}
    ckpt.save(path, tree)
    fname = ckpt.load_manifest(path)["leaves"]["nested::b"]["file"]
    fpath = os.path.join(path, fname)
    raw = bytearray(open(fpath, "rb").read())
    raw[-1] ^= 0xFF  # corrupt the last data byte
    open(fpath, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="nested::b.*CRC32"):
        ckpt.restore(path, tree)
    ckpt.restore(path, tree, verify=False)
    assert not ckpt.is_valid(path)


def test_successful_save_cleans_orphans(tmp_path):
    path = str(tmp_path / "ck7")
    ckpt.save(path, {"a": torch.zeros(2)}, step=1)
    orphan = os.path.join(path, "stale_leaf.00000000.npy")
    np.save(orphan, np.zeros(3))
    ckpt.save(path, {"a": torch.ones(2)}, step=2)
    assert not os.path.exists(orphan)
    npys = [f for f in os.listdir(path) if f.endswith(".npy")]
    assert npys == [ckpt.load_manifest(path)["leaves"]["a"]["file"]]
    out = ckpt.restore(path, {"a": torch.zeros(2)})
    np.testing.assert_array_equal(out["a"].numpy(), np.ones(2))


def test_resave_of_a_step_takes_a_fresh_file_name(tmp_path):
    """A re-save at the live manifest's step writes `.g1` files, never over
    the leaves the live manifest references."""
    path = str(tmp_path / "ck7g")
    ckpt.save(path, {"a": torch.zeros(2)}, step=3)
    ckpt.save(path, {"a": torch.ones(2)}, step=3)
    assert ckpt.load_manifest(path)["leaves"]["a"]["file"] == \
        "a.00000003.g1.npy"
    np.testing.assert_array_equal(
        ckpt.restore(path, {"a": torch.zeros(2)})["a"].numpy(), np.ones(2))


def test_leaf_write_retries_transient_oserror(tmp_path, monkeypatch):
    fails = {"n": 2}
    real_save = np.save

    def flaky_save(f, arr, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("NFS blip")
        return real_save(f, arr, **kw)

    monkeypatch.setattr(np, "save", flaky_save)
    path = str(tmp_path / "ck8")
    ckpt.save(path, {"a": torch.ones(2)}, retries=3, backoff_s=0.001)
    assert ckpt.is_valid(path)

    fails["n"] = 99
    with pytest.raises(OSError):
        ckpt.save(str(tmp_path / "ck9"), {"a": torch.ones(2)}, retries=2,
                  backoff_s=0.001)


def test_newest_valid_skips_torn_checkpoint(tmp_path):
    root = str(tmp_path / "run")
    for step in (1, 2, 3):
        ckpt.save(ckpt.step_dir(root, step),
                  {"a": torch.full((2,), float(step))}, step=step)
    assert ckpt.list_steps(root) == [1, 2, 3]
    assert ckpt.newest_valid(root) == ckpt.step_dir(root, 3)

    p3 = ckpt.step_dir(root, 3)
    fname = ckpt.load_manifest(p3)["leaves"]["a"]["file"]
    open(os.path.join(p3, fname), "wb").write(b"not an npy")
    assert ckpt.newest_valid(root) == ckpt.step_dir(root, 2)
    os.remove(os.path.join(p3, "manifest.json"))
    assert ckpt.newest_valid(root) == ckpt.step_dir(root, 2)

    removed = ckpt.prune(root, keep_last=1)
    assert removed == [ckpt.step_dir(root, 1)]
    assert ckpt.list_steps(root) == [2, 3]
    assert ckpt.newest_valid(root) == ckpt.step_dir(root, 2)
    with pytest.raises(ValueError):
        ckpt.prune(root, keep_last=0)


# ---------------------------------------------------------------------------
# Interchange with the JAX package
# ---------------------------------------------------------------------------

LAYERS = 3  # reduced granite's period is one layer: layers::0 stacks 3


def _krasulina_pair(dtype, nodes):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((nodes, 24) if nodes else (24,)).astype(
        np.float32)
    js = jkras.KrasulinaState(jnp.asarray(w).astype(dtype),
                              jnp.asarray(17, jnp.int32))
    ts = KrasulinaState(torch.from_numpy(w).to(getattr(torch, dtype)), 17)
    return js, ts, None


def _granite_pair(dtype, nodes):
    """The same numbers in both packages: the reference's reduced granite
    state (bf16 parameters with f32 masters, or f32), every float leaf then
    drawn anew from a seed, the optimizer steps set to 7 (per node: 7, 8,
    9)."""
    jcfg = dataclasses.replace(jreduced(jget_config("granite-8b")),
                               num_layers=LAYERS)
    jrun = JRunConfig(model=jcfg, shape=JSHAPES["train_4k"],
                      averaging=JAveragingConfig("gossip" if nodes else
                                                 "exact", 2),
                      optimizer="adam", param_dtype=dtype)
    js = jtrainer.init_state(jrun, jax.random.PRNGKey(0))
    if nodes:
        js = jtrainer.replicate_for_nodes(js, nodes)
    rng = np.random.default_rng(2)
    f32 = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), (js.params, js.opt.m, js.opt.v, js.opt.master))
    steps = (np.arange(7, 7 + nodes, dtype=np.int32) if nodes
             else np.asarray(7, np.int32))
    params = jax.tree.map(lambda a, p: jnp.asarray(a).astype(p.dtype),
                          f32[0], js.params)
    js = jtrainer.TrainState(params, js.opt._replace(
        step=jnp.asarray(steps), m=jax.tree.map(jnp.asarray, f32[1]),
        v=jax.tree.map(jnp.asarray, f32[2]),
        master=jax.tree.map(jnp.asarray, f32[3])))
    tcfg = _port_cfg(LAYERS)
    ts = convert.train_state(f32[0], js.opt._replace(
        step=steps, m=f32[1], v=f32[2], master=f32[3]), tcfg, device="cpu")
    ts = ts._replace(params=convert.tree_map(
        lambda t: t.to(getattr(torch, dtype)), ts.params))
    return js, ts, tcfg


PAIRS = {"krasulina": _krasulina_pair, "granite": _granite_pair}
CASES = [(kind, dtype, nodes) for kind in PAIRS
         for dtype in ("float32", "bfloat16") for nodes in (None, 3)]


def _zeros_like(ts):
    out = {}
    ckpt._walk(ts, (), out)
    return ckpt._rebuild(ts, {p: torch.zeros_like(v) if isinstance(
        v, torch.Tensor) else (tuple(0 for _ in v) if isinstance(v, tuple)
                               else 0) for p, v in out.items()})


def _bf16_put(key, arr):
    if arr.dtype == np.dtype("V2"):
        arr = arr.view(ml_dtypes.bfloat16)
    return jnp.asarray(arr)


@pytest.mark.parametrize("kind,dtype,nodes", CASES)
def test_checkpoints_are_interchangeable(tmp_path, kind, dtype, nodes):
    js, ts, model = PAIRS[kind](dtype, nodes)
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jpath, js, step=5, meta={"who": "either"})
    ckpt.save(tpath, ts, step=5, meta={"who": "either"}, model=model)

    # the same manifest, key order included, and the same bytes on disk
    jm, tm = jckpt.load_manifest(jpath), ckpt.load_manifest(tpath)
    assert list(tm["leaves"]) == list(jm["leaves"])
    assert tm == jm
    for ent in jm["leaves"].values():
        with open(os.path.join(jpath, ent["file"]), "rb") as a, \
                open(os.path.join(tpath, ent["file"]), "rb") as b:
            assert a.read() == b.read(), ent["file"]

    # the reference's checkpoint in the port, with equal numbers
    got = ckpt.restore(jpath, _zeros_like(ts), model=model)
    _equal_states(ts, got)

    # the port's checkpoint in the reference
    like = jax.eval_shape(lambda: js)
    back = jckpt.restore(tpath, like, put=_bf16_put)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      np.asarray(b.astype(jnp.float32)))


def test_reference_bf16_restore_needs_a_view(tmp_path):
    """The fact behind `_bf16_put`: the reference writes a bf16 leaf as raw
    `<V2` records and its restore does not read them back as bf16 by
    itself."""
    path = str(tmp_path / "ck")
    tree = {"a": torch.arange(6, dtype=torch.bfloat16)}
    ckpt.save(path, tree)
    with open(os.path.join(path, "a.00000000.npy"), "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)
    like = {"a": jax.ShapeDtypeStruct((6,), jnp.bfloat16)}
    with pytest.raises(TypeError):
        jckpt.restore(path, like)
    out = jckpt.restore(path, like, put=_bf16_put)
    np.testing.assert_array_equal(np.asarray(out["a"].astype(jnp.float32)),
                                  np.arange(6, dtype=np.float32))
    # and the port reads it back bit for bit
    assert torch.equal(ckpt.restore(path, {"a": torch.zeros(
        6, dtype=torch.bfloat16)})["a"], tree["a"])
