"""Heads split inside a head on the port's model axis, on CPU ranks in a
gloo group (`tests/torch_dist_worker.py` `model_heads`, one worker run of
4 ranks), held against the JAX package through numpy:

* (a) On 1 x 4, reduced granite-8b at d_model 512 in five head cases:
  2 KV heads (half a KV head a rank: granite-8b's 8 over the production
  mesh's 16), 6 heads with 2 KV heads (1.5 heads a rank: phi4-mini-3.8b's
  24 over 16), an FFN width 4 does not divide (w_gate, w_up and w_down
  kept whole), one KV head of head dim 66 (wk and wv kept whole beside
  a split wq: every rank computes the whole k and v, and their gradients
  are summed over the model group) and 7 such heads (wq, wk, wv and wo
  kept whole: the whole attention on every rank). The loss and every gradient, from
  the reference's parameters cut to each rank's blocks, against
  `repro.models.registry.loss_fn` under `jax.value_and_grad` on one
  device (remat on): loss within rtol 1e-5, each gradient within rtol =
  atol = 1e-5 of its leaf's largest entry
  (tests/test_torch_model_axis.py's bounds). The heads' pieces cross
  the model group as all-gathers forward and reduce-scatters backward.
* (b) The trainer with 2 KV heads on 1 x 4 and 2 x 2 (ZeRO-1 over 2 in the
  exact mode), exact and gossip (ring R = 2), 3 SGD steps of 8 x 32 tokens
  at n_nodes = 4, against the JAX trainer at n_nodes = 4 on one device
  from the same state: tests/test_torch_trainer.py's bounds.
* (c) Each rank's bytes at rest equal the planner's `local_bytes`, and
  each step's messages by axis equal the planner's trace of the same step
  (`repro_torch.launch.dryrun`, which plans bf16 parameters), the heads'
  pieces included: the model axis's count and bytes by kind (the
  all-reduces are f32 in both; the heads' pieces move in the activations'
  dtype, so the f32 run's are twice the plan's), the data axis's
  count.
"""
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
from repro.models import registry as jreg
from repro.models.common import mesh_rules
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (AveragingConfig, RunConfig, SHAPES,
                                      ShapeConfig)
from repro_torch.core.packing import tree_leaves
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models.layers import _head_split
from repro_torch.optim import OptState
from torch_dist_worker import MODEL_MESHES, digest, np_leaves, spawn

torch.set_num_threads(1)

B, S, STEPS, N = 8, 64, 3, 4
S_TRAIN = 32  # the trainer cases' sequences
WORLD = 4
# (a): name -> changes to reduced granite-8b at d_model 512 (8 heads, 2
# KV heads, head dim 64, d_ff 1024)
HEAD_CASES = {
    "kv heads split in two": {},
    "1.5 heads a rank": {"num_heads": 6, "head_dim": 64},
    "ffn width 4 does not divide": {"d_ff": 1022},
    # one KV head of 66 columns, which 4 does not divide: wk and wv whole
    "kv heads kept whole": {"num_kv_heads": 1, "head_dim": 66},
    # 7 heads of 66 columns, 462 in all, which 4 does not divide either:
    # wq, wk, wv and wo whole, and every rank runs the whole attention
    "attention kept whole": {"num_heads": 7, "num_kv_heads": 1,
                             "head_dim": 66},
}
MODES = ("exact", "gossip")


def _cfgs(**changes):
    j = dataclasses.replace(jreduced(jget_config("granite-8b"),
                                     d_model=512), **changes)
    t = dataclasses.replace(reduced(get_config("granite-8b"), d_model=512),
                            **changes)
    return j, t


def _batches(vocab, n, seq=S):
    data, rng = MarkovTokenStream(vocab, seed=0), np.random.default_rng(1)
    out = []
    for _ in range(n):
        toks = data.sample(rng, B, seq + 1)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _runs(mode):
    jcfg, tcfg = _cfgs()
    common = dict(optimizer="sgd", learning_rate=0.5, param_dtype="float32")
    return (JRunConfig(model=jcfg, shape=JSHAPES["train_4k"],
                       averaging=JAveragingConfig(mode, 2), **common),
            RunConfig(model=tcfg, shape=SHAPES["train_4k"],
                      averaging=AveragingConfig(mode, 2), **common))


def _layer_refs(given):
    """(a)'s references: the reference's loss, ce and gradients."""
    want = {}
    for name, case in given.items():
        jcfg = _cfgs(**HEAD_CASES[name])[0]
        jp = jax.tree.map(jnp.asarray, case["tree"])
        jb = {k: jnp.asarray(v) for k, v in case["batch"].items()}
        (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jreg.loss_fn(p, jcfg, jb, remat=True),
            has_aux=True))(jp)
        grads = convert.lm_params(jax.tree.map(np.asarray, jgrads),
                                  device="cpu")
        want[name] = (float(jloss), float(jm["ce"]),
                      [g.numpy() for g in tree_leaves(grads)])
    return want


def _trainer_refs(inits):
    """(b)'s references: the JAX trainer's final leaves and metrics."""
    want = {}
    for mode, (js, batches) in inits.items():
        jrun, _ = _runs(mode)
        mesh = make_mesh((1, 1), ("data", "model"))
        with mesh_rules(mesh, activation_rules(mesh, jrun.shape,
                                               node_axis=mode != "exact")):
            step = jax.jit(jtrainer.build_train_step(jrun, mesh,
                                                     n_nodes=N)[0])
            metrics = []
            for b in batches:
                jb = {k: jnp.asarray(v) for k, v in b.items()}
                if mode != "exact":
                    jb = jtrainer.make_node_batch(jb, N)
                js, m = step(js, jb)
                metrics.append({k: float(v) for k, v in m.items()})
        want[mode] = (jax.tree.leaves(jax.tree.map(np.asarray, js.params)),
                      metrics)
    return want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results, the references (computed while the ranks
    run) and the port's whole initial states."""
    tmp = tmp_path_factory.mktemp("model_heads")
    layers, trainer_cases, inits, whole = {}, {}, {}, {}
    for name, changes in HEAD_CASES.items():
        jcfg, tcfg = _cfgs(**changes)
        jp = jreg.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        layers[name] = {"tree": jax.tree.map(np.asarray, jp), "cfg": tcfg,
                        "batch": _batches(tcfg.vocab_size, 1)[0]}
    for mode in MODES:
        jrun, trun = _runs(mode)
        mesh = make_mesh((1, 1), ("data", "model"))
        with mesh_rules(mesh, activation_rules(mesh, jrun.shape,
                                               node_axis=mode != "exact")):
            js = jtrainer.init_state(jrun, jax.random.PRNGKey(0))
            if mode != "exact":
                js = jtrainer.replicate_for_nodes(js, N)
        params, jopt = jax.tree.map(np.asarray, tuple(js))
        state = (params, OptState(np.asarray(jopt.step), jopt.m, jopt.v,
                                  jopt.master, jopt.ef_residual))
        whole[mode] = convert.train_state(*state, trun.model, device="cpu")
        batches = _batches(trun.model.vocab_size, STEPS, S_TRAIN)
        inits[mode] = (js, batches)
        for mesh_name in MODEL_MESHES:
            trainer_cases[(mesh_name, mode)] = {
                "state": state, "run": trun, "batches": batches,
                "n_nodes": N}
    path = tmp / "given.pt"
    torch.save({"layers": layers, "trainer": trainer_cases}, path)
    res, want = spawn("model_heads", WORLD, tmp, path, during=lambda: (
        _layer_refs(layers), _trainer_refs(inits)))
    return res, want, whole


@pytest.mark.parametrize("name", list(HEAD_CASES))
def test_split_heads_match_reference(ranks, name):
    res, (want, _), _ = ranks
    cfg = _cfgs(**HEAD_CASES[name])[1]
    jloss, jce, jgrads = want[name]
    # rank 0's gathered gradients; every rank holds the same bits
    grads = res[0]["layers"][(name, True)]["grads"]
    for g, w in zip(grads, jgrads, strict=True):
        scale = float(np.abs(w).max())
        assert scale > 0  # every leaf has a gradient
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale)
    for r in res:
        got = r["layers"][(name, True)]
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
        np.testing.assert_allclose(got["ce"], jce, rtol=1e-5)
        assert got["digest"] == digest(grads)
        # the heads' pieces crossed the model group where a split cut a
        # head: not where wk and wv are whole and each rank's heads are
        kinds = {kind for axis, kind in got["log"] if axis == "model"}
        hd = cfg.resolved_head_dim
        cut = (cfg.num_kv_heads * hd) % WORLD == 0 and (
            cfg.num_kv_heads % WORLD or cfg.num_heads % WORLD)
        assert ({"all-gather", "reduce-scatter"} <= kinds) == bool(cut)


def test_split_geometry():
    """Which ranks run which heads: granite-8b's 8 KV heads over 16 give
    each rank half of one, phi4-mini-3.8b's 24 heads 1.5 heads a rank,
    and a divisible split gathers nothing."""
    class Mesh:
        def __init__(self, m, i):
            self.shape, self.rank = {"data": 1, "model": m}, i

    def at(arch, m, i):
        """The rank's heads, from the blocks of wq and wk that
        `launch/sharding.py` places on it."""
        cfg, mesh = get_config(arch), Mesh(m, i)
        hd = cfg.resolved_head_dim

        def held(name, heads):
            shape = (cfg.d_model, heads * hd)
            spec = shlib.param_specs({name: torch.empty(shape,
                                                        device="meta")},
                                     mesh)[name]
            return torch.empty(shlib.local_shape(shape, spec, mesh),
                               device="meta")

        return _head_split(cfg, mesh, {"wq": held("wq", cfg.num_heads),
                                       "wk": held("wk", cfg.num_kv_heads)})

    g = at("granite-8b", 16, 5)  # heads 10, 11 -> KV head 2, half of it
    assert (g.q, g.kv, g.g_q, g.g_kv) == ((10, 12), (2, 3), 1, 2)
    p = at("phi4-mini-3.8b", 16, 1)  # rows 192..384: heads 1, 2
    assert (p.rows, p.q, p.kv, p.g_q, p.g_kv) == ((192, 384), (1, 3),
                                                  (0, 1), 2, 2)
    s = at("starcoder2-15b", 16, 7)  # a quarter of KV head 1
    assert (s.q, s.kv, s.g_q, s.g_kv) == ((21, 24), (1, 2), 1, 4)
    assert at("granite-8b", 8, 3)[3:] == (1, 1)
    assert at("granite-8b", 1, 0) is None
    # on 16 ranks, for every dense arch and rank: the heads that overlap
    # the rank's rows, and their KV heads, lie inside its blocks' columns,
    # which start on a head's first column
    for arch in ("granite-8b", "phi4-mini-3.8b", "starcoder2-15b",
                 "chameleon-34b"):
        cfg = get_config(arch)
        hd, H, KH = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
        for i in range(16):
            h = at(arch, 16, i)
            assert h.rows[0] >= h.q[0] * hd and h.rows[1] <= h.q[1] * hd
            for (lo, hi), g, width in ((h.q, h.g_q, H * hd // 16),
                                       (h.kv, h.g_kv, KH * hd // 16)):
                start = i // g * g * width
                assert 16 % g == 0 and start % hd == 0
                assert start <= lo * hd and hi * hd <= start + g * width


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", list(MODEL_MESHES))
def test_split_kv_heads_trainer_matches_reference(ranks, mesh_name, mode):
    res, (_, want), _ = ranks
    want_leaves, want_metrics = want[mode]
    got = [r["trainer"][(mesh_name, mode)] for r in res]
    for g in got:
        for m, w in zip(g["metrics"], want_metrics, strict=True):
            for k in ("loss", "ce", "consensus_err"):
                np.testing.assert_allclose(m[k], w[k], rtol=1e-5, atol=1e-7,
                                           err_msg=k)
    # every rank of a model group holds the same whole leaves (its rows of
    # the node axis in the gossip mode), which its model index 0 sent;
    # stitch the node shards' rows
    first = {g["rows"]: g["params"] for g in got if g["params"] is not None}
    for g in got:
        assert g["digest"] == digest(np_leaves(first[g["rows"]]))
    parts = [jax.tree.leaves(first[rows]) for rows in sorted(first)]
    stitched = ([np.concatenate(p) for p in zip(*parts)]
                if mode == "gossip" else parts[0])
    assert len(stitched) == len(want_leaves)
    for a, b in zip(stitched, want_leaves):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", list(MODEL_MESHES))
def test_split_kv_heads_match_the_planner(ranks, mesh_name, mode):
    res, _, whole = ranks
    _, trun = _runs(mode)
    data, model = (int(x) for x in mesh_name.split("x"))
    amesh = abstract_mesh((data, model), ("data", "model"))
    node_axes = ("data",) if mode == "gossip" else None
    specs = shlib.train_state_specs(whole[mode], amesh, node_axes=node_axes,
                                    n_stacked=trun.model.num_layers)
    at_rest = shlib.local_bytes(whole[mode], specs, amesh)
    rec = dryrun.plan("granite-8b", "train_4k", amesh, averaging=mode,
                      rounds=2, microbatches=1, cfg=trun.model,
                      shape=ShapeConfig("t", S_TRAIN, B, "train"),
                      n_nodes=N)
    assert rec["temp_unsplit_over_model"] is False
    assert "model_axis_refused" not in rec
    model_coll = rec["collectives_model"]
    count = lambda coll: sum(v for k, v in coll.items()
                             if k.endswith(".count"))
    kinds = {k for k in model_coll if not k.endswith(".count")}
    # 2 KV heads over a model axis of 4 are cut in two; over 2, whole
    assert ({"all-gather", "reduce-scatter"} <= kinds) == (model == 4)
    for r in res:
        got = r["trainer"][(mesh_name, mode)]
        assert got["at_rest"] == at_rest
        for wire in got["wire"]:
            assert wire["model_messages"] == count(model_coll)
            assert wire["model_wire_bytes"] == 2 * (
                model_coll["all-reduce"] + 2 * sum(
                    model_coll.get(k, 0)
                    for k in ("all-gather", "reduce-scatter")))
            assert wire["data_messages"] == count(rec["collectives"]) \
                - count(model_coll)
            assert wire["staged_bytes"] == 0  # CPU tensors go unstaged
