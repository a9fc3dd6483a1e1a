"""The port's model axis on CPU ranks in a gloo group
(`tests/torch_dist_worker.py`), held against the JAX package through
numpy.

* (a) The tensor-parallel layers on 2 ranks (a model axis of 2): the loss
  and every gradient of reduced granite-8b and phi4-mini-3.8b at d_model
  512 (8 heads, 2 KV heads), and of the granite with a vocab of 513, which
  2 does not divide (its embedding split over d_model, the reference's
  `_ALT_SPECS`), from the reference's parameters cut to each
  rank's blocks (`convert.lm_params(mesh=...)`), against
  `repro.models.registry.loss_fn` under `jax.value_and_grad` on one
  device, with remat on and off: loss within rtol 1e-5, each gradient
  within rtol = atol = 1e-5 of its leaf's largest entry
  (tests/test_torch_lm.py's bounds).
* (b) The trainer on 4 ranks, on a 1 x 4 mesh (tensor-parallel over 4)
  and a 2 x 2 one (2 node shards, tensor-parallel over 2; ZeRO-1 over 2
  in the exact mode), exact and gossip (ring R = 2), 3 SGD steps of 8 x 32
  tokens at n_nodes = 4, against the JAX trainer at n_nodes = 4 on one
  device from the same state (`convert.train_state(mesh=...)` of the
  reference's): tests/test_torch_trainer.py's bounds (parameters within
  rtol = atol = 1e-5, losses and the consensus error within rtol 1e-5).
  The reduced granite keeps 4 KV heads here, one a rank on 1 x 4
  (tests/test_torch_model_axis_heads.py runs its 2, half a KV head a
  rank).
* (c) Each rank's bytes at rest equal the planner's `local_bytes`, and
  each step's messages by axis equal the planner's trace of the same step
  (`repro_torch.launch.dryrun`): the model axis's count and bytes, the
  data axis's count.
* (d) Every family executes on the model axis (MoE experts, MLA, early
  fusion, the SSD, the RG-LRU and the encoder-decoder), and so do heads,
  KV heads, FFN widths and vocabs the extent does not divide; the
  planner traces the dense archs on the production 16 x 16 mesh as
  executed.
"""
import dataclasses
import shutil

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
from repro.models import registry as jreg
from repro.models.common import mesh_rules
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (AveragingConfig, RunConfig, SHAPES,
                                      ShapeConfig)
from repro_torch.core.packing import tree_leaves
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.dist import Mesh
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import registry
from repro_torch.models.common import MetaGenerator
from repro_torch.optim import OptState
from repro_torch.train import trainer
from torch_dist_worker import MODEL_MESHES, spawn

torch.set_num_threads(1)

B, S, STEPS, N = 8, 64, 3, 4
S_TRAIN = 32  # the trainer cases' sequences
# (a)'s cases: name -> (arch, vocab or None for the arch's)
LAYER_CASES = {"granite-8b": ("granite-8b", None),
               "phi4-mini-3.8b": ("phi4-mini-3.8b", None),
               "granite-8b vocab 513": ("granite-8b", 513)}
MODES = ("exact", "gossip")


def _cfgs(arch, kv_heads=None, vocab=None):
    """The JAX and port configs of `arch` reduced at d_model 512 (8 heads,
    2 KV heads, or `kv_heads`; the arch's vocab, or `vocab`)."""
    j, t = (jreduced(jget_config(arch), d_model=512),
            reduced(get_config(arch), d_model=512))
    changes = {k: v for k, v in (("num_kv_heads", kv_heads),
                                 ("vocab_size", vocab)) if v}
    return (dataclasses.replace(j, **changes),
            dataclasses.replace(t, **changes))


def _batches(vocab, n, seq=S):
    data, rng = MarkovTokenStream(vocab, seed=0), np.random.default_rng(1)
    out = []
    for _ in range(n):
        toks = data.sample(rng, B, seq + 1)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    """(a): the 2 ranks' results, and the reference's."""
    tmp = tmp_path_factory.mktemp("model_layers")
    given, want = {}, {}
    for arch, (name, vocab) in LAYER_CASES.items():
        jcfg, tcfg = _cfgs(name, vocab=vocab)
        assert (tcfg.num_heads, tcfg.num_kv_heads) == (8, 2)
        jp = jreg.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        batch = _batches(tcfg.vocab_size, 1)[0]
        given[arch] = {"tree": jax.tree.map(np.asarray, jp), "cfg": tcfg,
                       "batch": batch}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for remat in (True, False):
            (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
                lambda p: jreg.loss_fn(p, jcfg, jb, remat=remat),
                has_aux=True))(jp)
            grads = convert.lm_params(jax.tree.map(np.asarray, jgrads),
                                      device="cpu")
            want[(arch, remat)] = (float(jloss), float(jm["ce"]),
                                   [g.numpy() for g in tree_leaves(grads)])
    path = tmp / "given.pt"
    torch.save(given, path)
    res = spawn("model_layers", 2, tmp, path)
    shutil.rmtree(tmp, ignore_errors=True)
    return res, want


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", list(LAYER_CASES))
def test_tensor_parallel_loss_and_grads_match_reference(layers, arch, remat):
    res, want = layers
    jloss, jce, jgrads = want[(arch, remat)]
    for r in res:
        got = r[(arch, remat)]
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
        np.testing.assert_allclose(got["ce"], jce, rtol=1e-5)
        for g, w in zip(got["grads"], jgrads, strict=True):
            scale = float(np.abs(w).max())
            assert scale > 0  # every leaf has a gradient
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale)


def _runs(mode):
    jcfg, tcfg = _cfgs("granite-8b", kv_heads=4)
    common = dict(optimizer="sgd", learning_rate=0.5, param_dtype="float32")
    return (JRunConfig(model=jcfg, shape=JSHAPES["train_4k"],
                       averaging=JAveragingConfig(mode, 2), **common),
            RunConfig(model=tcfg, shape=SHAPES["train_4k"],
                      averaging=AveragingConfig(mode, 2), **common))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(b), (c): the reference's 3 steps per mode, the port's whole
    initial state, and the 4 ranks' results on each mesh."""
    tmp = tmp_path_factory.mktemp("model_trainer")
    given, want, whole = {}, {}, {}
    for mode in MODES:
        jrun, trun = _runs(mode)
        mesh = make_mesh((1, 1), ("data", "model"))
        decentralized = mode != "exact"
        batches = _batches(trun.model.vocab_size, STEPS, S_TRAIN)
        with mesh_rules(mesh, activation_rules(mesh, jrun.shape,
                                               node_axis=decentralized)):
            js = jtrainer.init_state(jrun, jax.random.PRNGKey(0))
            if decentralized:
                js = jtrainer.replicate_for_nodes(js, N)
            params, jopt = jax.tree.map(np.asarray, tuple(js))
            # the port's own OptState of numpy trees: the ranks import the
            # port only
            state = (params, OptState(np.asarray(jopt.step), jopt.m, jopt.v,
                                      jopt.master, jopt.ef_residual))
            whole[mode] = convert.train_state(*state, trun.model,
                                              device="cpu")
            step = jax.jit(jtrainer.build_train_step(jrun, mesh,
                                                     n_nodes=N)[0])
            metrics = []
            for b in batches:
                jb = {k: jnp.asarray(v) for k, v in b.items()}
                if decentralized:
                    jb = jtrainer.make_node_batch(jb, N)
                js, m = step(js, jb)
                metrics.append({k: float(v) for k, v in m.items()})
        want[mode] = (jax.tree.leaves(jax.tree.map(np.asarray, js.params)),
                      metrics)
        for name in MODEL_MESHES:
            given[(name, mode)] = {"state": state, "run": trun,
                                   "batches": batches, "n_nodes": N}
    path = tmp / "given.pt"
    torch.save(given, path)
    res = spawn("model_trainer", 4, tmp, path)
    shutil.rmtree(tmp, ignore_errors=True)
    return res, want, whole


def _amesh(name):
    data, model = (int(x) for x in name.split("x"))
    return abstract_mesh((data, model), ("data", "model"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MODEL_MESHES))
def test_model_axis_trainer_matches_reference(trained, name, mode):
    res, want, _ = trained
    want_leaves, want_metrics = want[mode]
    got = [r[(name, mode)] for r in res]
    for g in got:
        assert g["step"] == ((STEPS,) * (g["rows"][1] - g["rows"][0])
                             if mode == "gossip" else STEPS)
        for m, w in zip(g["metrics"], want_metrics, strict=True):
            for k in ("loss", "ce", "consensus_err"):
                np.testing.assert_allclose(m[k], w[k], rtol=1e-5, atol=1e-7,
                                           err_msg=k)
    # every rank of a model group holds the same whole leaves (its rows of
    # the node axis in the gossip mode); stitch the node shards' rows
    leaves = [jax.tree.leaves(g["params"]) for g in got]
    first = {}
    for g, lv in zip(got, leaves):
        first.setdefault(g["rows"], lv)
        for a, b in zip(lv, first[g["rows"]]):
            np.testing.assert_array_equal(a, b)
    parts = [first[rows] for rows in sorted(first)]
    stitched = ([np.concatenate(p) for p in zip(*parts)]
                if mode == "gossip" else parts[0])
    assert len(stitched) == len(want_leaves)
    for a, b in zip(stitched, want_leaves):
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    if mode == "gossip":
        assert want_metrics[-1]["consensus_err"] > 0
    else:
        assert all(m["consensus_err"] == 0 for m in want_metrics)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MODEL_MESHES))
def test_model_axis_matches_the_planner(trained, name, mode):
    """(c): the bytes at rest of each rank equal `local_bytes` of the
    reference's placements (ZeRO-1 in the exact mode, the node axis over
    the data axes and the model shards in the gossip one), and each step
    sends what the planner's trace of that step counts (the planner's run
    is bf16 with Adam and masters: the message counts and the model axis's
    f32 bytes do not depend on them)."""
    res, _, whole = trained
    _, trun = _runs(mode)
    amesh = _amesh(name)
    node_axes = ("data",) if mode == "gossip" else None
    specs = shlib.train_state_specs(whole[mode], amesh, node_axes=node_axes,
                                    n_stacked=trun.model.num_layers)
    at_rest = shlib.local_bytes(whole[mode], specs, amesh)
    rec = dryrun.plan("granite-8b", "train_4k", amesh, averaging=mode,
                      rounds=2, microbatches=1, cfg=trun.model,
                      shape=ShapeConfig("t", S_TRAIN, B, "train"),
                      n_nodes=N)
    assert rec["temp_unsplit_over_model"] is False
    assert rec["collectives_planned"] == {}
    model = rec["collectives_model"]
    count = lambda coll: sum(v for k, v in coll.items()
                             if k.endswith(".count"))
    assert count(model) == model["all-reduce.count"] > 0
    for r in res:
        got = r[(name, mode)]
        assert got["at_rest"] == at_rest
        for wire in got["wire"]:
            assert wire["model_messages"] == model["all-reduce.count"]
            assert wire["model_wire_bytes"] == 2 * model["all-reduce"]
            assert wire["data_messages"] == count(rec["collectives"]) \
                - count(model)
            assert wire["staged_bytes"] == 0  # CPU tensors go unstaged


@pytest.mark.parametrize("mode", MODES)
def test_publish_extract_gathers_the_model_axis(trained, mode):
    """On 1 x 4 every rank publishes whole leaves: the consensus mean over
    the 4 nodes (gossip) or the parameters (exact) of the final state
    gathered through `convert.train_tree` (which the test above holds
    against the reference's)."""
    res, want, _ = trained
    _, trun = _runs(mode)
    final = [r[("1x4", mode)] for r in res]
    ref = convert.lm_params(final[0]["params"], device="cpu",
                            node_axis=mode == "gossip")
    want_leaves = [(p.mean(0) if mode == "gossip" else p).numpy()
                   for p in tree_leaves(ref)]
    for r in final:
        assert len(r["published"]) == len(want_leaves)
        for a, b in zip(r["published"], want_leaves):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch,changes", [
    ("qwen2-moe-a2.7b", {}),  # MoE experts
    ("minicpm3-4b", {}),  # MLA's wq_b and wkv_b
    # early fusion on a dense decoder (llama4-scout's is MoE as well)
    ("granite-8b", {"frontend_embed_dim": 128}),
    ("mamba2-2.7b", {}),  # the SSD's heads
    ("recurrentgemma-9b", {}),  # the RG-LRU's channels
    ("seamless-m4t-medium", {}),  # cross-attention's heads
])
def test_model_axis_executes(arch, changes):
    """What the model axis refused before the experts, MLA's heads,
    frontend_proj, the SSD, the RG-LRU and cross-attention split over it
    now executes: the trainer's checks pass, `init_state` cuts the state
    and the planner's record has no refusal
    (tests/test_torch_model_axis_experts.py and
    tests/test_torch_model_axis_families.py hold them against the
    reference)."""
    cfg = dataclasses.replace(reduced(get_config(arch), d_model=512),
                              **changes)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"],
                    averaging=AveragingConfig("gossip", 2), optimizer="sgd",
                    param_dtype="float32")
    mesh = Mesh((1, 2), ("data", "model"))
    trainer.check_supported(run)
    assert dryrun.model_axis_refusal(run.shape.mode, mesh) is None
    state = trainer.init_state(run, torch.Generator().manual_seed(0), mesh)
    whole = registry.init_params(MetaGenerator(), cfg)
    assert sum(t.numel() for t in tree_leaves(state.params)) < sum(
        t.numel() for t in tree_leaves(whole))


@pytest.mark.parametrize("changes,model", [
    ({}, 4),  # 2 KV heads: half a KV head a rank
    ({"num_heads": 6, "head_dim": 64}, 4),  # 1.5 heads a rank
    ({"d_ff": 1022}, 4),  # w_gate, w_up and w_down kept whole
])
def test_model_axis_executes_heads_the_extent_cuts(changes, model):
    """What the model axis refused before heads split inside a head now
    executes: the trainer builds its step and cuts its state, and the
    planner's record has no refusal."""
    cfg = dataclasses.replace(reduced(get_config("granite-8b"), d_model=512),
                              **changes)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"],
                    averaging=AveragingConfig("gossip", 2), optimizer="sgd",
                    param_dtype="float32")
    mesh = Mesh((1, model), ("data", "model"))
    trainer.check_supported(run)
    assert dryrun.model_axis_refusal(run.shape.mode, mesh) is None


@pytest.mark.parametrize("arch", ["granite-8b", "phi4-mini-3.8b",
                                  "starcoder2-15b", "chameleon-34b"])
def test_dryrun_traces_dense_archs_on_the_production_mesh(arch):
    """The planner traces each dense arch (2 layers at its published
    widths) on the reference's 16 x 16 mesh as each rank runs it: the
    model axis executed, its KV heads split inside a head, whose pieces
    cross the model group as all-gathers and reduce-scatters."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    mesh = abstract_mesh((16, 16), ("data", "model"))
    rec = dryrun.plan(arch, "train_4k", mesh, cfg=cfg, microbatches=1,
                      shape=ShapeConfig("t", 256, 16, "train"))
    assert rec["temp_unsplit_over_model"] is False
    assert "model_axis_refused" not in rec
    assert rec["collectives_planned"] == {}
    model = rec["collectives_model"]
    assert model["all-reduce.count"] > 0
    assert model["all-gather.count"] > 0 and model["reduce-scatter.count"] > 0
