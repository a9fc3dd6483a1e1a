"""The SSD, RG-LRU and encoder-decoder families on the port's model axis,
and the MoE routing of the exact mode over a split data axis, on 4 CPU
ranks in a gloo group (`tests/torch_dist_worker.py` `model_families`, one
worker run), held against the JAX package through numpy:

* (a) On 1 x 4, the loss and every gradient, from the reference's
  parameters cut to each rank's blocks, against
  `repro.models.registry.loss_fn` under `jax.value_and_grad` on one
  device (remat on): loss within rtol 1e-5, each gradient within rtol =
  atol = 1e-5 of its leaf's largest entry. The cases: reduced mamba2-2.7b
  at d_model 256 (4 heads a rank; w_in's 276-column blocks cross z, x, B,
  C and dt), the same at d_model 192 with head_dim 64 (1.5 heads a rank,
  w_in's 838 columns kept whole, the conv, norm_scale and w_out split),
  the same at d_model 65 (d_inner 130: norm_scale and w_out kept whole,
  so every rank runs every head, w_in and the conv split and joined),
  reduced recurrentgemma-9b at d_model 256 with one period of 3 layers
  (64 lru columns a rank, the one KV head cut in four) and reduced
  seamless-m4t-medium at d_model 256 with a tied vocab of 514 (the
  d_model fallback, cross-attention one head a rank, frontend_proj's
  columns).
* (b) The trainer: 3 SGD steps of 8 x 32 tokens at n_nodes = 4 against
  the JAX trainer at n_nodes = 4 on one device from the same state, at
  tests/test_torch_trainer.py's bounds: each family on 1 x 4 (gossip,
  ring R = 2) and on 2 x 2 (exact: FSDP with ZeRO-1 over 2); the int8
  tile wire on mamba2, whose 64-column tiles straddle ranks in w_in; and
  recurrentgemma through the driver under `death:1@1-2` with the rejoin
  sync (Adam), against the JAX driver.
* (c) The MoE repair: reduced qwen2-moe-a2.7b (d_model 256, 6 experts,
  top-2, capacity factor 1.0, 8 x 32 tokens, SGD lr 0.5) in the exact
  mode on 2 x 2 and on 4 x 1 against the JAX trainer's one step at
  microbatches 1 (loss rtol 1e-5, parameters at the trainer tests'
  bounds, the dropped assignments one process's and > 0), and on 2 x 2
  at 2 microbatches against the reference at 2 microbatches of the batch
  whose rows are dealt as the ranks' slices (ROADMAP.md). One process
  emulates D data ranks at 6000 global tokens, where groups of 16
  straddle the ranks' boundaries part-way.
* (d) Each rank's bytes at rest equal the planner's `local_bytes`, each
  step's messages by axis equal the planner's trace of the same step, and
  the three archs' train_4k steps on the production 16 x 16 mesh are
  traced as executed.
"""
import dataclasses
import multiprocessing
import shutil
from concurrent.futures import ProcessPoolExecutor

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
from repro.core import faults as jfaults
from repro.models import registry as jreg
from repro.optim import init_optimizer as jinit_optimizer
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch import dist as rdist
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (AveragingConfig, RunConfig, SHAPES,
                                      ShapeConfig)
from repro_torch.core.packing import tree_leaves
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import moe, registry
from repro_torch.models.common import MetaGenerator, global_batch
from repro_torch.train import trainer
from test_torch_model_axis_elastic import _by_node, _nodes
from test_torch_trainer import (METRIC_TOL, JEngineConfig, JStreamingDriver,
                                _agree, _mesh_rules)
from torch_dist_worker import (LM_B, LM_SPEC, LM_SUPERSTEPS, ME_DT,
                               FakeClock, _init_state, digest, lm_draw,
                               np_leaves, spawn)

torch.set_num_threads(1)

B, S, STEPS, N = 8, 64, 3, 4
S_TRAIN = 32  # the trainer cases' sequences
WORLD = 4
# (a): name -> (arch, layers, d_model, changes to its reduced form,
# changes to its SSM config)
CASES = {
    "ssd 4 heads a rank": ("mamba2-2.7b", 2, 256, {}, {}),
    "ssd 1.5 heads a rank": ("mamba2-2.7b", 2, 192, {}, {"head_dim": 64}),
    # d_inner 130, which 4 does not divide: norm_scale and w_out whole, so
    # every rank runs every head, w_in's 336 and the conv's 196 columns
    # split and joined
    "ssd heads kept whole": ("mamba2-2.7b", 2, 65, {},
                             {"head_dim": 13, "state_dim": 33}),
    "rglru one period": ("recurrentgemma-9b", 3, 256, {}, {}),
    "encdec vocab 514": ("seamless-m4t-medium", 2, 256, {"vocab_size": 514},
                         {}),
}
# (b): the family cases the trainer runs, (mesh name, mode) of each mesh's
# runs, the quantized wire's case and the driver's
FAMILIES = ("ssd 4 heads a rank", "rglru one period", "encdec vocab 514")
MESH_MODES = (("1x4", "gossip"), ("2x2", "exact"))
INT8 = dict(quantization="int8", quant_stats="tile", quant_block_d=64)
WIRED = "ssd 4 heads a rank"
CHURNED = "rglru one period"
# (c): the MoE case, one SGD step in the exact mode on each (mesh name,
# microbatches)
MOE = "moe 6 experts top-2"
MOE_CFG = ("qwen2-moe-a2.7b", 2, 256, {},
           {"num_experts": 6, "top_k": 2, "capacity_factor": 1.0})
MOE_RUNS = (("2x2", 1), ("4x1", 1), ("2x2", 2))


def _cfgs(name):
    """(the JAX config, the port's) of a case."""
    arch, layers, d_model, changes, inner = (MOE_CFG if name == MOE
                                             else CASES[name])

    def cut(get, red):
        cfg = dataclasses.replace(red(get(arch), layers=layers,
                                      d_model=d_model), **changes)
        if inner:
            key = "moe" if cfg.moe is not None else "ssm"
            cfg = dataclasses.replace(cfg, **{key: dataclasses.replace(
                getattr(cfg, key), **inner)})
        return cfg

    return cut(jget_config, jreduced), cut(get_config, reduced)


def _batches(cfg, n, seq=S):
    data, rng = MarkovTokenStream(cfg.vocab_size, seed=0), \
        np.random.default_rng(1)
    out = []
    for _ in range(n):
        toks = data.sample(rng, B, seq + 1)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.is_encdec:  # as many frames as tokens, as the planner's
            b["frames"] = rng.standard_normal(
                (B, seq, cfg.frontend_embed_dim)).astype(np.float32)
        out.append(b)
    return out


def _dealt(batch, data, mb):
    """The batch's rows in the order the exact mode's `mb` microbatches
    take them over `data` data ranks: microbatch j is every rank's j-th
    slice of its share, in rank order."""
    order = np.arange(B).reshape(data, mb, B // data // mb).transpose(
        1, 0, 2).reshape(-1)
    return {k: v[order] for k, v in batch.items()}


def _runs(name, mode, wire=None, optimizer="sgd", mb=1):
    """The JAX package's run config and the port's, at microbatches `mb`
    both."""
    jcfg, tcfg = _cfgs(name)
    wire = wire or {}
    jwire = dict(wire, packed=False) if wire else {}
    common = dict(optimizer=optimizer,
                  learning_rate=0.5 if optimizer == "sgd" else 1e-3,
                  param_dtype="float32", microbatches=mb)
    return (JRunConfig(model=jcfg, shape=JSHAPES["train_4k"],
                       averaging=JAveragingConfig(mode, 2, **jwire),
                       **common),
            RunConfig(model=tcfg, shape=SHAPES["train_4k"],
                      averaging=AveragingConfig(mode, 2, **wire), **common))


def _trainer_runs(key):
    """(b)'s or (c)'s case `key`, (mesh name, mode, case name[, wire or
    microbatches]): (the JAX run, the port's run, the case name, its
    steps)."""
    mesh_name, mode, name = key[:3]
    if name == MOE:
        return (*_runs(MOE, mode, mb=key[3]), MOE, 1)
    if len(key) > 3:
        return (*_runs(name, mode, INT8), name, STEPS)
    return (*_runs(name, mode), name, STEPS)


def _tensors(tree):
    """A tree of arrays as CPU tensors, which the ranks load faster than
    numpy."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _init_params(name):
    """The initial parameters of a case: drawn by the port from a seed,
    as the reference's tree (numpy), which both packages start from."""
    cfg = _cfgs(name)[1]
    return convert.lm_tree(registry.init_params(
        torch.Generator().manual_seed(0), cfg), cfg)


def _init(jrun, name):
    """The reference's TrainState of `name`'s initial parameters (at N
    nodes in the decentralized modes)."""
    _, rules = _mesh_rules(jrun)
    with rules():
        params = jax.tree.map(jnp.asarray, _init_params(name))
        js = jtrainer.TrainState(params, jinit_optimizer(jrun.optimizer,
                                                         params))
        return (js if jrun.averaging.mode == "exact"
                else jtrainer.replicate_for_nodes(js, N))


def _layer_ref(name):
    """(a)'s reference of `name`: its loss, ce and gradients."""
    jcfg = _cfgs(name)[0]
    jp = jax.tree.map(jnp.asarray, _init_params(name))
    jb = {k: jnp.asarray(v) for k, v in _batches(_cfgs(name)[1], 1)[0]
          .items()}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jreg.loss_fn(p, jcfg, jb, remat=True), has_aux=True))(jp)
    grads = convert.lm_params(jax.tree.map(np.asarray, jgrads),
                              device="cpu")
    return (float(jloss), float(jm["ce"]),
            [g.numpy() for g in tree_leaves(grads)])


def _trainer_ref(key):
    """The JAX trainer's steps of (b)'s or (c)'s case `key` at N nodes:
    final parameters and metrics."""
    jrun, trun, name, steps = _trainer_runs(key)
    js = _init(jrun, name)
    mesh, rules = _mesh_rules(jrun)
    data = int(key[0].split("x")[0])
    with rules():
        step = jax.jit(jtrainer.build_train_step(jrun, mesh, n_nodes=N)[0])
        metrics = []
        for b in _batches(trun.model, steps, S_TRAIN):
            if jrun.averaging.mode == "exact":
                b = _dealt(b, data, jrun.microbatches)
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            if jrun.averaging.mode != "exact":
                jb = jtrainer.make_node_batch(jb, N)
            js, m = step(js, jb)
            metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.leaves(jax.tree.map(np.asarray, js.params)), metrics


def _driver_ref():
    """The JAX driver at N nodes under LM_SPEC on ME_DT's fake clock."""
    jrun, _ = _runs(CHURNED, "gossip", optimizer="adam")
    js = _init(jrun, CHURNED)
    mesh, rules = _mesh_rules(jrun)
    with rules():
        with JStreamingDriver(
                jrun, mesh, js, lambda rng, n: lm_draw(rng, n), batch=LM_B,
                n_nodes=N, faults=jfaults.FaultSchedule.parse(LM_SPEC, N),
                clock=FakeClock(ME_DT),
                superstep_builder=jtrainer.superstep_builder(jrun, mesh,
                                                             n_nodes=N),
                engine=JEngineConfig(superstep=1, prefetch_depth=0,
                                     replan_every=0)) as d:
            js, hist = d.run(LM_SUPERSTEPS)
    return (jax.tree.map(np.asarray, js), hist,
            [(e["superstep"], e["to"].active_ids)
             for e in d.membership_events])


def _reference(task):
    """One reference task, in a thread of the pool."""
    kind, key = task
    if kind == "layer":
        return _layer_ref(key)
    return _trainer_ref(key) if kind == "trainer" else _driver_ref()


def _one_process_drops():
    """Each MoE layer's dropped assignments of (c)'s first batch on one
    process (the routing the reference runs on the whole batch)."""
    cfg = _cfgs(MOE)[1]
    params = convert.lm_params(_init_params(MOE), device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(cfg, 1, S_TRAIN)[0].items()}
    with torch.no_grad(), moe.count_drops() as counts:
        registry.loss_fn(params, cfg, batch, remat=False)
    return [int(c) for c in counts]


KEYS = ([(mesh_name, mode, name) for name in FAMILIES
         for mesh_name, mode in MESH_MODES] + [("1x4", "gossip", WIRED,
                                               "int8")]
        + [(mesh_name, "exact", MOE, mb) for mesh_name, mb in MOE_RUNS])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results, the references (computed while the ranks
    run) and the port's whole initial states of the trainer cases."""
    tmp = tmp_path_factory.mktemp("model_families")
    layers, trainer_cases, whole = {}, {}, {}
    for name in CASES:
        layers[name] = {"tree": _tensors(_init_params(name)),
                        "cfg": _cfgs(name)[1],
                        "batch": _batches(_cfgs(name)[1], 1)[0]}
    params = {name: _tensors(_init_params(name))
              for name in FAMILIES + (MOE,)}
    for key in KEYS:
        _, trun, name, steps = _trainer_runs(key)
        trainer_cases[key] = {
            "params": params[name], "run": trun, "n_nodes": N,
            "batches": _batches(trun.model, steps, S_TRAIN)}
        if len(key) == 3 or name == MOE:
            one = _init_state(params[name], trun)
            whole[key] = (one if key[1] == "exact" else
                          trainer.replicate_for_nodes(one, N))
    path = tmp / "given.pt"
    torch.save({"layers": layers, "trainer": trainer_cases,
                "driver": (_runs(CHURNED, "gossip", optimizer="adam")[1],
                           params[CHURNED])}, path)
    # the longest first
    tasks = ([("driver", None)] + [("trainer", key) for key in KEYS]
             + [("layer", name) for name in CASES])

    def references():
        # processes, not threads: tracing the references holds the GIL
        with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context(
                "spawn")) as pool:
            got = list(pool.map(_reference, tasks))
        want = {key if kind != "layer" else ("layer", key): g
                for (kind, key), g in zip(tasks, got)}
        want["driver"] = want.pop(None)
        want["drops"] = _one_process_drops()
        return want

    res, want = spawn("model_families", WORLD, tmp, path, during=references)
    shutil.rmtree(tmp, ignore_errors=True)
    return res, want, whole


@pytest.mark.parametrize("name", list(CASES))
def test_split_layers_match_reference(ranks, name):
    """(a): the loss and every gradient; every rank holds the same
    gradient bits; the model group's messages are all-reduces, and the
    SSD's and the RG-LRU's all-gathers where their columns split."""
    res, want, _ = ranks
    jloss, jce, jgrads = want["layer", name]
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
        kinds = {kind for axis, kind in got["log"] if axis == "model"}
        # the SSD's and the RG-LRU's gathered columns, summed back to their
        # owners; columns joined whole (the encoder-decoder's frontend_proj
        # and d_model embedding columns, the leaves of an SSD whose heads
        # are kept whole), whose backward keeps the rank's
        whole = name in ("encdec vocab 514", "ssd heads kept whole")
        assert kinds == {"all-reduce", "all-gather"} | (
            set() if whole else {"reduce-scatter"})


def test_split_layouts():
    """Which blocks the model axis gives a rank: mamba2-2.7b at 16 holds
    661 w_in columns, 336 conv channels and 320 rows of w_out (5 heads),
    at 4 rank 1's w_in block holds the end of z and the start of x and
    the last rank's conv block the end of x, B and C; the reduced case's
    276-column blocks cross every segment; recurrentgemma-9b at 16 holds
    256 lru columns, one head and a sixteenth of its KV head;
    seamless-m4t-medium's and mamba2's vocabs fall back to d_model at
    16."""
    def specs(cfg, m, names):
        """The first layers' block shapes of `names` over 1 x m."""
        mesh = abstract_mesh((1, m), ("data", "model"))
        p = registry.init_params(MetaGenerator(), dataclasses.replace(
            cfg, num_layers=min(cfg.num_layers, 3)))
        got = {}
        shlib.map_with_path(lambda path, leaf, spec: got.setdefault(
            shlib._leaf_name(path), shlib.local_shape(leaf.shape, spec,
                                                      mesh)),
            p, shlib.param_specs(p, mesh))
        return {k: got[k] for k in names}

    M = "model"
    mamba = get_config("mamba2-2.7b")
    d_inner = mamba.ssm.expand * mamba.d_model
    assert specs(mamba, 16, ("w_in", "conv_w", "norm_scale", "w_out",
                             "embed")) == {
        "w_in": (2560, 661), "conv_w": (4, 336), "norm_scale": (320,),
        "w_out": (320, 2560), "embed": (50280, 160)}
    assert 320 // mamba.ssm.head_dim == 5
    w_in4, conv4 = 10576 // 4, 5376 // 4
    assert w_in4 < d_inner < 2 * w_in4 < 2 * d_inner  # z's end, x's start
    assert 3 * conv4 < d_inner < 4 * conv4  # x's end, B and C
    red = _cfgs("ssd 4 heads a rank")[1]
    assert specs(red, 4, ("w_in",))["w_in"] == (256, 276)
    # z [0, 512), x [512, 1024), B, C of 32 each, dt of 16: rank 1's
    # columns hold z's end and x's start, rank 3's x's end, B, C and dt
    bounds = (512, 1024, 1056, 1088)
    assert [sum(276 * j < b < 276 * (j + 1) for b in bounds)
            for j in range(4)] == [0, 1, 0, 3]
    half = _cfgs("ssd 1.5 heads a rank")[1]
    assert specs(half, 4, ("w_in", "conv_w", "w_out")) == {
        "w_in": (192, 838), "conv_w": (4, 112), "w_out": (96, 192)}
    rg = get_config("recurrentgemma-9b")
    got = specs(rg, 16, ("w_main_in", "lam", "w_out", "wq", "wk"))
    assert got["w_main_in"] == (4096, 256) and got["lam"] == (256,)
    assert got["wq"] == (4096, 256) and got["wk"] == (4096, 16)
    sm = get_config("seamless-m4t-medium")
    assert shlib._resolve("embed", (sm.vocab_size, sm.d_model),
                          abstract_mesh((1, 16), ("data", "model")),
                          ()) == (None, M)


@pytest.mark.parametrize("mesh_name,mode", MESH_MODES)
@pytest.mark.parametrize("name", FAMILIES)
def test_trainer_matches_reference(ranks, name, mesh_name, mode):
    """(b): metrics of every rank, and the stitched parameters of the
    model index 0 ranks, against the JAX trainer."""
    res, want, _ = ranks
    _check_trainer(res, want, (mesh_name, mode, name))


def _check_trainer(res, want, key):
    want_leaves, want_metrics = want[key]
    got = [r["trainer"][key] for r in res]
    for g in got:
        for m, w in zip(g["metrics"], want_metrics, strict=True):
            for k in ("loss", "ce", "consensus_err"):
                np.testing.assert_allclose(m[k], w[k], rtol=1e-5, atol=1e-7,
                                           err_msg=k)
    first = {g["rows"]: g["params"] for g in got if g["params"] is not None}
    for g in got:
        assert g["digest"] == digest(np_leaves(first[g["rows"]]))
    parts = [jax.tree.leaves(first[rows]) for rows in sorted(first)]
    stitched = ([np.concatenate(p) for p in zip(*parts)]
                if key[1] == "gossip" else parts[0])
    assert len(stitched) == len(want_leaves)
    for a, b in zip(stitched, want_leaves):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_int8_wire_on_split_ssd_matches_reference(ranks):
    """(b): the int8 tile wire on mamba2, whose 64-column tiles straddle
    ranks in w_in (`core.quantize.Slots`): the quantized bounds
    (tests/test_torch_trainer.py)."""
    res, want, _ = ranks
    key = ("1x4", "gossip", WIRED, "int8")
    want_leaves, want_metrics = want[key]
    for r in res:
        got = r["trainer"][key]
        for m, w in zip(got["metrics"], want_metrics, strict=True):
            for k in ("loss", "ce", "consensus_err"):
                np.testing.assert_allclose(m[k], w[k], atol=1e-7,
                                           rtol=METRIC_TOL[True][k],
                                           err_msg=k)
    got = jax.tree.leaves(res[0]["trainer"][key]["params"])
    _agree(got, want_leaves, 1e-5, frac=0.99, bound=1e-2)


def test_driver_under_churn_matches_reference(ranks):
    """(b): recurrentgemma through the driver under `death:1@1-2` with
    the rejoin sync (Adam) on 1 x 4: membership events and losses the JAX
    driver's, every node's parameters 99.9% within 1e-5 rel + 1e-5 and
    all within 6 lr, Adam's moments 99.9% within 1e-5 and all within
    1e-4."""
    res, want, _ = ranks
    js, hist, events = want["driver"]
    runs = [r["driver"] for r in res]
    assert events == [(1, (0, 2, 3)), (2, (0, 1, 2, 3))]
    for run in runs:
        assert run["events"] == events
        for m, jr in zip(run["metrics"], hist, strict=True):
            for k in ("loss", "ce", "consensus_err"):
                np.testing.assert_allclose(m[k], jr["metrics"][k],
                                           rtol=1e-5, atol=1e-7, err_msg=k)
        assert run["digest"] == runs[0]["digest"]
    np.testing.assert_array_equal(runs[0]["step"], js.opt.step)
    lr = _runs(CHURNED, "gossip", optimizer="adam")[1].learning_rate
    _agree([_nodes(runs)], [_by_node(js.params)], 1e-5, frac=0.999,
           bound=6 * lr)
    for k in ("m", "v"):
        _agree([_nodes(runs, k)], [_by_node(getattr(js.opt, k))], 1e-5,
               frac=0.999, bound=1e-4)


@pytest.mark.parametrize("mesh_name,mb", MOE_RUNS)
def test_moe_exact_routes_the_global_batch(ranks, mesh_name, mb):
    """(c): the exact mode over 2 and 4 data ranks gives the JAX
    trainer's one step (at `mb` microbatches the reference's batch dealt
    as the ranks' slices); the first batch's dropped assignments, summed
    over the data ranks, are one process's on every model index, and
    some are dropped."""
    res, want, _ = ranks
    key = (mesh_name, "exact", MOE, mb)
    _check_trainer(res, want, key)
    if mb == 1:
        model = int(mesh_name.split("x")[1])
        for j in range(model):  # each model index's data group
            got = [r["drops"][key] for r in res if r["trainer"][key][
                "model_index"] == j]
            assert [sum(c) for c in zip(*got)] == want["drops"]
        assert sum(want["drops"]) > 0


@pytest.mark.parametrize("data", [2, 3])
def test_global_routing_over_emulated_data_ranks(monkeypatch, data):
    """(c), the trap: at 6000 global tokens the dispatch groups hold 16
    tokens (4096 halved until it divides 6000), and over 2 data ranks a
    group straddles their boundary at 3000 part-way (over 3, at 2000 and
    4000). One process emulates the data ranks, each routing its share
    under `global_batch` with the other ranks' counts: outputs, drops and
    the mean of the ranks' aux losses equal the whole batch's routing on
    one process."""
    cfg = reduced(get_config("qwen2-moe-a2.7b"), d_model=32)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=6, top_k=2, capacity_factor=1.0,
        num_shared_experts=0, expert_d_ff=16))
    assert moe.group_size(6000) == 16
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((1, 6000, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), moe.count_drops() as drops:
        want, want_aux = moe.apply_moe(p, cfg, x)
    T = 6000 // data
    shares = x.split(T, dim=1)
    # each rank's [groups, E] counts, as the all-gather returns them
    counts = []
    for r, xs in enumerate(shares):
        monkeypatch.setattr(rdist, "all_gather_dim",
                            lambda t, mesh, dim: counts.append(t) or
                            t.repeat(data, 1, 1))
        _route(xs, p, cfg, data, r)
    every = torch.cat(counts)
    monkeypatch.setattr(rdist, "all_gather_dim", lambda t, mesh, dim: every)
    outs, auxes, dropped = [], [], 0
    for r, xs in enumerate(shares):
        with torch.no_grad(), moe.count_drops() as d:
            y, aux = _route(xs, p, cfg, data, r)
        outs.append(y)
        auxes.append(aux)
        dropped += int(sum(d))
    torch.testing.assert_close(torch.cat(outs, dim=1), want, rtol=1e-6,
                               atol=1e-6)
    assert dropped == int(sum(drops)) > 0
    torch.testing.assert_close(torch.stack(auxes).mean(), want_aux,
                               rtol=1e-6, atol=0)


def _route(xs, p, cfg, data, r):
    """`apply_moe` of data rank r's share under `global_batch` of an
    emulated {data} x 1 mesh."""
    mesh = rdist.Mesh((data, 1), ("data", "model"), rank=r)
    with torch.no_grad(), global_batch(mesh):
        return moe.apply_moe(p, cfg, xs)


def _plan_check(res, whole, key, trun):
    """Bytes at rest and each step's messages by axis against the
    planner's trace of the same step."""
    mesh_name, mode = key[:2]
    data, model = (int(x) for x in mesh_name.split("x"))
    amesh = abstract_mesh((data, model), ("data", "model"))
    node_axes = ("data",) if mode == "gossip" else None
    cfg = trun.model
    specs = shlib.train_state_specs(
        whole[key], amesh, node_axes=node_axes,
        n_stacked=None if cfg.is_encdec else shlib.stacked_layers(cfg))
    at_rest = shlib.local_bytes(whole[key], specs, amesh)
    if model == 1:  # replicas (ROADMAP.md queue 1 item 6), as planned
        at_rest = sum(
            t.numel() * t.element_size() for t in tree_leaves(
                (whole[key].params, whole[key].opt.m, whole[key].opt.v)))
    rec = dryrun.plan(_arch(key[2]), "train_4k", amesh, averaging=mode,
                      rounds=2, microbatches=trun.microbatches, cfg=cfg,
                      shape=ShapeConfig("t", S_TRAIN, B, "train"),
                      n_nodes=N)
    count = lambda coll: sum(v for k, v in coll.items()
                             if k.endswith(".count"))
    model_coll = rec.get("collectives_model", {})
    assert rec["temp_unsplit_over_model"] is False
    assert "model_axis_refused" not in rec
    for r in res:
        got = r["trainer"][key]
        assert got["at_rest"] == at_rest
        for wire in got["wire"]:
            assert wire["model_messages"] == count(model_coll)
            assert wire["model_wire_bytes"] == 2 * (
                model_coll.get("all-reduce", 0) + 2 * sum(
                    model_coll.get(k, 0)
                    for k in ("all-gather", "reduce-scatter")))
            assert wire["data_messages"] == count(rec["collectives"]) \
                - count(model_coll)
            assert wire["staged_bytes"] == 0  # CPU tensors go unstaged
    return rec


def _arch(name):
    return (MOE_CFG if name == MOE else CASES[name])[0]


@pytest.mark.parametrize("mesh_name,mode", MESH_MODES)
@pytest.mark.parametrize("name", FAMILIES)
def test_trainer_matches_the_planner(ranks, name, mesh_name, mode):
    """(d): bytes at rest and each step's messages by axis (the planner
    runs bf16, so the f32 run's gathered activations are twice the plan's
    bytes, as in tests/test_torch_model_axis_heads.py)."""
    res, _, whole = ranks
    rec = _plan_check(res, whole, (mesh_name, mode, name),
                      _runs(name, mode)[1])
    assert rec["collectives_model"]["all-reduce.count"] > 0


@pytest.mark.parametrize("mesh_name", ["2x2", "4x1"])
def test_moe_routing_messages_match_the_planner(ranks, mesh_name):
    """(d): the exact mode's routing all-gathers over the data group, one
    a MoE layer forward and one more under remat, are in the plan: traced
    on 2 x 2, derived on 4 x 1 (no model axis)."""
    res, _, whole = ranks
    key = (mesh_name, "exact", MOE, 1)
    rec = _plan_check(res, whole, key, _runs(MOE, "exact")[1])
    if mesh_name == "4x1":  # replicas: nothing else is gathered
        layers = _cfgs(MOE)[1].num_layers
        assert rec["collectives"]["all-gather.count"] == 2 * layers


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_dryrun_traces_the_archs_on_the_production_mesh(arch):
    """(d): each arch at its published widths, cut in depth (mamba2 to 2
    layers, recurrentgemma to one period of 3, seamless to 2 encoder and
    2 decoder layers), on the reference's 16 x 16 mesh is traced as each
    rank runs it: the model axis executed, its reductions all-reduces and
    its gathered pieces all-gathers over the model group."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=3 if cfg.rglru else 2,
                              encoder_layers=2 if cfg.is_encdec else 0)
    mesh = abstract_mesh((16, 16), ("data", "model"))
    shape = ShapeConfig("t", 256, 16, "train")
    if cfg.is_encdec:
        shape = dataclasses.replace(shape, seq_len=160)
    rec = dryrun.plan(arch, "train_4k", mesh, cfg=cfg, microbatches=1,
                      shape=shape)
    assert rec["temp_unsplit_over_model"] is False
    assert "model_axis_refused" not in rec
    assert rec["collectives_planned"] == {}
    model = rec["collectives_model"]
    assert model["all-reduce.count"] > 0
    assert model["all-gather.count"] > 0
