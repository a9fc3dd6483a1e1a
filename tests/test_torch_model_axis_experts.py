"""MoE experts, MLA's heads and early fusion's frontend_proj on the port's
model axis, on 4 CPU ranks in a gloo group (`tests/torch_dist_worker.py`
`model_experts`, one worker run), held against the JAX package through
numpy:

* (a) On 1 x 4, the loss and every gradient, from the reference's
  parameters cut to each rank's blocks, against
  `repro.models.registry.loss_fn` under `jax.value_and_grad` on one
  device (remat on): loss within rtol 1e-5, each gradient within rtol =
  atol = 1e-5 of its leaf's largest entry (tests/test_torch_model_axis.py's
  bounds). The cases, at d_model 512: reduced qwen2-moe-a2.7b (4 experts,
  top-4, 1 shared: one expert a rank), the same with 6 experts, top-2, at
  capacity factor 1 (6 % 4 != 0: each rank holds its columns of every
  expert, the reference's `_ALT_SPECS`; the batch drops assignments, and
  every rank counts the drops one process counts), the experts kept
  whole beside split shared experts and the reverse, reduced minicpm3-4b
  with 8 heads (2 whole heads a rank) and with 6 (1.5 heads a rank: wq_b,
  wkv_b and wo split inside a head, at head widths 48, 64 and 32), with
  wo and wkv_b kept whole beside a split wq_b, and reduced
  llama4-scout-17b-a16e at 4 layers with a `patches` batch
  (frontend_proj's columns, one expert a rank, chunked layers of 32
  tokens and a NoPE layer).
* (b) The trainer at d_model 256, 3 SGD steps of 8 x 32 tokens at
  n_nodes = 4, against the JAX trainer at n_nodes = 4 on one device from
  the same state: both qwen2-moe cases and minicpm3's 6 heads on 1 x 4
  (gossip, ring R = 2) and on 2 x 2 (exact: FSDP with ZeRO-1 over 2, the
  6 experts 3 a rank; the reference's one step, as the data ranks route
  the global batch), tests/test_torch_trainer.py's bounds; the int8 tile
  wire (64-column
  tiles) on the expert-parallel qwen2-moe on 1 x 4, whose statistic slots
  lie in leaves split on their first dim, at the quantized bounds; and the
  same model through the driver under `death:1@1-2` with the rejoin sync
  (Adam), against the JAX driver, at tests/test_torch_model_axis_elastic.py's
  bounds.
* (c) Each rank's bytes at rest equal the planner's `local_bytes`, and
  each step's messages by axis equal the planner's trace of the same step
  (the planner runs bf16, so the f32 run's gathered activations are twice
  the plan's bytes, as in tests/test_torch_model_axis_heads.py); the three
  archs' train_4k steps on the production 16 x 16 mesh are traced as
  executed.
"""
import dataclasses
import shutil
from concurrent.futures import ThreadPoolExecutor

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
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (AveragingConfig, RunConfig, SHAPES,
                                      ShapeConfig)
from repro_torch.core.packing import tree_leaves
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import moe, registry
from repro_torch.models.common import MetaGenerator
from repro_torch.train import trainer
from test_torch_model_axis_elastic import _by_node, _nodes
from test_torch_trainer import (METRIC_TOL, JEngineConfig, JStreamingDriver,
                                _agree, _mesh_rules)
from torch_dist_worker import (LM_B, LM_SPEC, LM_SUPERSTEPS, ME_DT,
                               FakeClock, _init_state, digest, lm_draw,
                               np_leaves, spawn)

torch.set_num_threads(1)

B, S, STEPS, N = 8, 64, 3, 4
S_TRAIN, D_TRAIN = 32, 256  # the trainer cases' sequences and width
WORLD = 4
PATCHES = 8  # early fusion's patch positions
# (a): name -> (arch, layers, changes to its reduced form at d_model 512,
# changes to its MoE or MLA config)
CASES = {
    "one expert a rank": ("qwen2-moe-a2.7b", 2, {}, {}),
    "within experts": ("qwen2-moe-a2.7b", 2, {},
                       {"num_experts": 6, "top_k": 2,
                        "capacity_factor": 1.0}),
    # E and F that 4 divides neither way: the experts whole on every
    # rank, the 2 shared experts' 2044 columns split
    "experts kept whole": ("qwen2-moe-a2.7b", 2, {},
                           {"num_experts": 6, "top_k": 2,
                            "expert_d_ff": 1022, "num_shared_experts": 2}),
    # the experts split on E, the one shared expert's 1022 columns whole
    "shared kept whole": ("qwen2-moe-a2.7b", 2, {}, {"expert_d_ff": 1022}),
    "mla 2 heads a rank": ("minicpm3-4b", 2, {}, {}),
    "mla 1.5 heads a rank": ("minicpm3-4b", 2, {"num_heads": 6,
                                               "num_kv_heads": 6}, {}),
    # v heads of 33 columns: wo (198 rows) and wkv_b (390 columns) whole,
    # wq_b split, so every rank runs every head and joins wq_b's columns
    "mla wo kept whole": ("minicpm3-4b", 2, {"num_heads": 6,
                                            "num_kv_heads": 6},
                          {"v_head_dim": 33}),
    "early fusion": ("llama4-scout-17b-a16e", 4, {"chunk_attn_window": 32},
                     {}),
}
DROPPING = "within experts"
# (b): (mesh name, mode) of each mesh's runs, the cases they run, and the
# quantized wire's case
MESH_MODES = (("1x4", "gossip"), ("2x2", "exact"))
TRAINER_CASES = ("one expert a rank", "within experts",
                 "mla 1.5 heads a rank")
INT8 = dict(quantization="int8", quant_stats="tile", quant_block_d=64)
WIRED = "one expert a rank"


def _cfgs(name, d_model=512):
    arch, layers, changes, inner = CASES[name]

    def cut(get, red):
        cfg = dataclasses.replace(red(get(arch), layers=layers,
                                      d_model=d_model), **changes)
        if inner:
            key = "moe" if cfg.moe is not None else "mla"
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
        if cfg.frontend_embed_dim:
            b["patches"] = rng.standard_normal(
                (B, PATCHES, cfg.frontend_embed_dim)).astype(np.float32)
        out.append(b)
    return out


def _trainer_runs(key):
    """(b)'s case `key`, (mesh name, mode, case name) or the int8 wire's
    ("1x4", "gossip", "int8"): (the JAX run, the port's run, the case
    name)."""
    _, mode, name = key
    if name == "int8":
        return (*_runs(WIRED, mode, INT8), WIRED)
    return (*_runs(name, mode), name)


def _runs(name, mode, wire=None, optimizer="sgd"):
    """The JAX package's run and the port's, one step a batch: the
    port's exact mode over the 2 x 2 mesh's 2 data ranks routes the
    global batch, as the reference does."""
    jcfg, tcfg = _cfgs(name, D_TRAIN)
    wire = wire or {}
    jwire = dict(wire, packed=False) if wire else {}
    common = dict(optimizer=optimizer,
                  learning_rate=0.5 if optimizer == "sgd" else 1e-3,
                  param_dtype="float32")
    return (JRunConfig(model=jcfg, shape=JSHAPES["train_4k"],
                       averaging=JAveragingConfig(mode, 2, **jwire),
                       **common),
            RunConfig(model=tcfg, shape=SHAPES["train_4k"],
                      averaging=AveragingConfig(mode, 2, **wire), **common))


def _tensors(tree):
    """A tree of arrays as CPU tensors, which the ranks load faster than
    numpy."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _init_params(name, d_model=512):
    """The initial parameters of a case: drawn by the port from a seed,
    as the reference's tree (numpy), which both packages start from."""
    cfg = _cfgs(name, d_model)[1]
    return convert.lm_tree(registry.init_params(
        torch.Generator().manual_seed(0), cfg), cfg)


def _init(jrun, name):
    """The reference's TrainState of `name`'s initial parameters (at N
    nodes in the decentralized modes)."""
    _, rules = _mesh_rules(jrun)
    with rules():
        params = jax.tree.map(jnp.asarray, _init_params(name, D_TRAIN))
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
    """The JAX trainer's steps of (b)'s case `key` at N nodes: final
    parameters and metrics."""
    jrun, trun, name = _trainer_runs(key)
    js = _init(jrun, name)
    mesh, rules = _mesh_rules(jrun)
    with rules():
        step = jax.jit(jtrainer.build_train_step(jrun, mesh, n_nodes=N)[0])
        metrics = []
        for b in _batches(trun.model, STEPS, S_TRAIN):
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            if jrun.averaging.mode != "exact":
                jb = jtrainer.make_node_batch(jb, N)
            js, m = step(js, jb)
            metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.leaves(jax.tree.map(np.asarray, js.params)), metrics


def _driver_ref():
    """The JAX driver at N nodes under LM_SPEC on ME_DT's fake clock."""
    jrun, _ = _runs(WIRED, "gossip", optimizer="adam")
    js = _init(jrun, WIRED)
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


def _one_process(case):
    """The port on one process: each MoE layer's dropped assignments, and
    where the router takes the top 1 its gradients (`_routers`)."""
    params = convert.lm_params(case["tree"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    with torch.no_grad(), moe.count_drops() as counts:
        registry.loss_fn(params, case["cfg"], batch, remat=False)
    grads = None
    if case["cfg"].moe.top_k == 1:
        live = [p.requires_grad_() for p in tree_leaves(params)]
        loss, _ = registry.loss_fn(params, case["cfg"], batch, remat=True)
        grads = [g.numpy() for g in torch.autograd.grad(loss, live)]
    return [int(c) for c in counts], grads


def _routers(tree) -> list:
    """Whether each leaf of a port tree (`tree_leaves` order) is a
    router."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in (
            [k == "router"] if torch.is_tensor(tree[k]) else
            _routers(tree[k]))]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _routers(t)]
    return [False]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results, the references (computed while the ranks
    run) and the port's whole initial states of the trainer cases."""
    tmp = tmp_path_factory.mktemp("model_experts")
    layers, trainer_cases, whole = {}, {}, {}
    for name in CASES:
        layers[name] = {"tree": _tensors(_init_params(name)),
                        "cfg": _cfgs(name)[1],
                        "batch": _batches(_cfgs(name)[1], 1)[0]}
    keys = [(mesh_name, mode, name) for name in TRAINER_CASES
            for mesh_name, mode in MESH_MODES] + [("1x4", "gossip", "int8")]
    params = {name: _tensors(_init_params(name, D_TRAIN))
              for name in TRAINER_CASES}
    for key in keys:
        _, trun, name = _trainer_runs(key)
        trainer_cases[key] = {
            "params": params[name], "run": trun, "n_nodes": N,
            "batches": _batches(trun.model, STEPS, S_TRAIN)}
        if key[2] in TRAINER_CASES:
            one = _init_state(params[name], trun)
            whole[name, key[1]] = (one if key[1] == "exact" else
                                   trainer.replicate_for_nodes(one, N))
    path = tmp / "given.pt"
    torch.save({"layers": layers, "trainer": trainer_cases,
                "driver": (_runs(WIRED, "gossip", optimizer="adam")[1],
                           params[WIRED])}, path)
    # the longest first
    tasks = ([("driver", None)] + [("trainer", key) for key in keys]
             + [("layer", name) for name in CASES])

    def references():
        with ThreadPoolExecutor(3) as pool:
            got = list(pool.map(_reference, tasks))
        want = {key if kind != "layer" else ("layer", key): g
                for (kind, key), g in zip(tasks, got)}
        want["driver"] = want.pop(None)
        want["one"] = {name: _one_process(case)
                       for name, case in layers.items()
                       if case["cfg"].moe is not None}
        return want

    res, want = spawn("model_experts", WORLD, tmp, path, during=references)
    shutil.rmtree(tmp, ignore_errors=True)
    return res, want, whole


@pytest.mark.parametrize("name", list(CASES))
def test_split_layers_match_reference(ranks, name):
    """(a): the loss and every gradient; every rank holds the same
    gradient bits; each MoE layer's dropped assignments are one
    process's on every rank (routing is replicated), and the drop case
    drops. A router that takes the top 1 normalizes its one gate to
    g / g = 1, so its gradient is that quotient's rounding beside the aux
    loss's share: the port on one process is 8.7e-5 of the leaf's largest
    entry off the reference there, and the split run is held within twice
    one process's distance (ROADMAP.md queue 3)."""
    res, want, _ = ranks
    jloss, jce, jgrads = want["layer", name]
    grads = res[0]["layers"][(name, True)]["grads"]
    drops, one = want["one"].get(name, (None, None))
    routers = _routers(convert.lm_params(_init_params(name),
                                         device="cpu")) if one else []
    for i, (g, w) in enumerate(zip(grads, jgrads, strict=True)):
        scale = float(np.abs(w).max())
        assert scale > 0  # every leaf has a gradient
        if one and routers[i]:
            assert np.abs(g - w).max() <= 2 * np.abs(one[i] - w).max()
            continue
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale)
    for r in res:
        got = r["layers"][(name, True)]
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
        np.testing.assert_allclose(got["ce"], jce, rtol=1e-5)
        assert got["digest"] == digest(grads)
        assert "all-reduce" in {kind for axis, kind in got["log"]
                                if axis == "model"}
    if drops is not None:
        for r in res:
            assert r["drops"][name] == drops
        assert sum(drops) > 0 or name != DROPPING


def test_split_layouts():
    """Which blocks the model axis gives a rank: qwen2-moe's 60 experts
    over 16 split each expert's F (the reference's `_ALT_SPECS`), llama4's
    16 one a rank, the reduced cases' as (a) names them; minicpm3-4b's 40
    heads over 16 are 2.5 a rank, its projections' blocks of 2 ranks
    holding 5 whole heads at each head width (96, 128, 64)."""
    def ffn_specs(cfg, m):
        """The placements of the first layer's expert leaves over 1 x m."""
        mesh = abstract_mesh((1, m), ("data", "model"))
        cfg = dataclasses.replace(cfg, num_layers=1)
        ffn = registry.init_params(MetaGenerator(), cfg)["blocks"][0]["ffn"]
        return {k: shlib.param_specs({k: ffn[k]}, mesh)[k]
                for k in ("we_gate", "we_up", "we_down")}

    M = "model"
    assert ffn_specs(get_config("qwen2-moe-a2.7b"), 16) == {
        "we_gate": (None, None, M), "we_up": (None, None, M),
        "we_down": (None, M, None)}
    assert ffn_specs(get_config("llama4-scout-17b-a16e"),
                     16)["we_down"] == (M, None, None)
    for name, split in (("one expert a rank", (M, None, None)),
                        ("within experts", (None, None, M))):
        assert ffn_specs(_cfgs(name)[1], 4)["we_gate"] == split
    cfg = get_config("minicpm3-4b")
    H, m = cfg.num_heads, 16
    mla = cfg.mla
    for hd in (mla.qk_nope_head_dim + mla.qk_rope_head_dim,
               mla.qk_nope_head_dim + mla.v_head_dim, mla.v_head_dim):
        cols = H * hd // m
        g = hd // np.gcd(hd, cols)
        assert g == 2 and g * cols == 5 * hd


@pytest.mark.parametrize("mesh_name,mode", MESH_MODES)
@pytest.mark.parametrize("name", TRAINER_CASES)
def test_trainer_matches_reference(ranks, name, mesh_name, mode):
    """(b): metrics of every rank, and the stitched parameters of the
    model index 0 ranks, against the JAX trainer."""
    res, want, _ = ranks
    want_leaves, want_metrics = want[mesh_name, mode, name]
    got = [r["trainer"][mesh_name, mode, name] for r in res]
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
                if mode == "gossip" else parts[0])
    assert len(stitched) == len(want_leaves)
    for a, b in zip(stitched, want_leaves):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_int8_wire_on_split_experts_matches_reference(ranks):
    """(b): the int8 tile wire's statistic slots at the reference's
    positions in expert leaves split on their first dim: the quantized
    bounds (tests/test_torch_trainer.py)."""
    res, want, _ = ranks
    want_leaves, want_metrics = want["1x4", "gossip", "int8"]
    for r in res:
        got = r["trainer"]["1x4", "gossip", "int8"]
        for m, w in zip(got["metrics"], want_metrics, strict=True):
            for k in ("loss", "ce", "consensus_err"):
                np.testing.assert_allclose(m[k], w[k], atol=1e-7,
                                           rtol=METRIC_TOL[True][k],
                                           err_msg=k)
    got = jax.tree.leaves(res[0]["trainer"]["1x4", "gossip", "int8"]
                          ["params"])
    _agree(got, want_leaves, 1e-5, frac=0.99, bound=1e-2)


def test_driver_under_churn_matches_reference(ranks):
    """(b): the expert-parallel model through the driver under
    `death:1@1-2` with the rejoin sync (Adam) on 1 x 4: membership events
    and losses the JAX driver's, every node's parameters 99.9% within
    1e-5 rel + 1e-5 and all within 6 lr, Adam's moments 99.9% within 1e-5
    and all within 1e-4."""
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
    lr = _runs(WIRED, "gossip", optimizer="adam")[1].learning_rate
    _agree([_nodes(runs)], [_by_node(js.params)], 1e-5, frac=0.999,
           bound=6 * lr)
    for k in ("m", "v"):
        _agree([_nodes(runs, k)], [_by_node(getattr(js.opt, k))], 1e-5,
               frac=0.999, bound=1e-4)


@pytest.mark.parametrize("mesh_name,mode", MESH_MODES)
@pytest.mark.parametrize("name", TRAINER_CASES)
def test_trainer_matches_the_planner(ranks, name, mesh_name, mode):
    """(c): bytes at rest and each step's messages by axis."""
    res, _, whole = ranks
    _, trun = _runs(name, mode)
    data, model = (int(x) for x in mesh_name.split("x"))
    amesh = abstract_mesh((data, model), ("data", "model"))
    node_axes = ("data",) if mode == "gossip" else None
    specs = shlib.train_state_specs(whole[name, mode], amesh,
                                    node_axes=node_axes,
                                    n_stacked=trun.model.num_layers)
    at_rest = shlib.local_bytes(whole[name, mode], specs, amesh)
    rec = dryrun.plan(CASES[name][0], "train_4k", amesh, averaging=mode,
                      rounds=2, microbatches=1, cfg=trun.model,
                      shape=ShapeConfig("t", S_TRAIN, B, "train"),
                      n_nodes=N)
    assert rec["temp_unsplit_over_model"] is False
    assert "model_axis_refused" not in rec
    model_coll = rec["collectives_model"]
    count = lambda coll: sum(v for k, v in coll.items()
                             if k.endswith(".count"))
    for r in res:
        got = r["trainer"][mesh_name, mode, name]
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


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "minicpm3-4b",
                                  "llama4-scout-17b-a16e"])
def test_dryrun_traces_the_archs_on_the_production_mesh(arch):
    """(c): each arch (2 layers at its published widths) on the
    reference's 16 x 16 mesh is traced as each rank runs it: the model
    axis executed, its reductions all-reduces over the model group."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    mesh = abstract_mesh((16, 16), ("data", "model"))
    rec = dryrun.plan(arch, "train_4k", mesh, cfg=cfg, microbatches=1,
                      shape=ShapeConfig("t", 256, 16, "train"))
    assert rec["temp_unsplit_over_model"] is False
    assert "model_axis_refused" not in rec
    assert rec["collectives_planned"] == {}
    model = rec["collectives_model"]
    assert model["all-reduce.count"] > 0
    # minicpm3's 2.5 heads a rank gather their pieces; qwen2-moe's 16
    # heads and llama4's 40 heads (8 KV heads, half a KV head a rank) as
    # the dense rule does
    cut = arch != "qwen2-moe-a2.7b"
    assert (model.get("all-gather.count", 0) > 0) == cut
