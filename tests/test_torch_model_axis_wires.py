"""The paper's Section VI wires over the port's model axis, on 4 CPU ranks in
a gloo group (`tests/torch_dist_worker.py` `model_wires`, one worker run),
against the JAX package on one process (reduced granite-8b: d_model 256, 4
heads, 1 KV head, vocab 512, 2 layers, f32, SGD at lr 0.5, ring R = 2,
N = 4 nodes, 2 steps of 2 x 64 tokens a node, tests/test_torch_trainer.py's
batches):

* the per-round quantized wire on 1 x 4 (every node on every rank, the
  leaves tensor-parallel over 4) and 2 x 2: int8 and sign with 64-column
  "tile" statistics (on 1 x 4 wk and wv's runs of 16 columns a rank
  straddle the tiles: their slots are completed over the model group;
  every other leaf holds whole tiles), int8 "node", sign "global" and, packed, int8
  "segment"; the reference unpacked as "auto" resolves there
  (`src/repro/core/averaging.py` `resolve_packed`), packed where the config
  opts in. Losses within rtol 1e-4, the consensus error within rtol 1e-2,
  99% of the parameters within 1e-5 and all within 1e-2
  (tests/test_torch_trainer.py's quantized bounds);
* error feedback (sign and int8, 64-column per-node tiles) on 1 x 4 and
  2 x 2, and int8 in a cohort superstep (K = 2, node 2 out) on 1 x 4
  against the JAX driver's `elastic_superstep`: the residuals at
  tests/test_torch_error_feedback.py's bounds (98% within 1e-5, all within
  4 times the largest residual), the parameters at the quantized bounds;
* the hierarchical mode on a ("pod", "data", "model") = (2, 1, 2) mesh
  (ring between the pods at self weight 0.6), unquantized and int8, against
  the JAX trainer on a (2, 1, 1) pod mesh (in a subprocess with 2 fake host
  devices: XLA_FLAGS is never set in the pytest process);
* int8_stoch: the same step twice gives the same bits;
* the planner: each rank's slot all-reduces over the model group ("slot
  all-reduce" in `dist.log`) equal the trace of `dryrun.plan(wire=...)`
  for that rank, to the message and the byte, and on 2 x 2 the node
  axis's gathers equal `dryrun.node_axis_collectives`; a tile width that
  the runs fill sends no slot message at all.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
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
from repro.train import driver as jdriver
from repro.train import trainer as jtrainer
from repro_torch import dist as rdist
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (SHAPES, AveragingConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.core.packing import map_tensors
from repro_torch.core.quantize import Slots, block_maps
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.optim import OptState
from repro_torch.train import trainer
from test_torch_error_feedback import _agree_residual
from test_torch_trainer import METRIC_TOL, _agree, _draw, _mesh_rules
from torch_dist_worker import (MW_DROPPED, MW_K, MW_N, MW_RUNS, MW_STEPS,
                               spawn)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
S, PER_NODE = 64, 2  # sequences of S tokens, PER_NODE a node a step (the
# batches of tests/test_torch_trainer.py)
HIER_SELF_WEIGHT = 0.6
TILE = dict(quant_stats="tile", quant_block_d=64)
# label -> the AveragingConfig changes of its wire (gossip, ring R = 2)
WIRES = {
    "int8 tile": dict(quantization="int8", **TILE),
    "sign tile": dict(quantization="sign", **TILE),
    "int8 node": dict(quantization="int8", quant_stats="node",
                      quant_block_d=64),
    "sign global": dict(quantization="sign", quant_stats="global"),
    "int8 segment packed": dict(quantization="int8", quant_stats="segment",
                                packed=True),
    "ef sign": dict(quantization="sign", error_feedback="grads", **TILE),
    "ef int8": dict(quantization="int8", error_feedback="grads", **TILE),
    "hier none": dict(self_weight=HIER_SELF_WEIGHT),
    "hier int8": dict(quantization="int8", self_weight=HIER_SELF_WEIGHT,
                      **TILE),
    "int8_stoch tile": dict(quantization="int8_stoch", **TILE),
}


def _pair(label):
    """The JAX and port runs of a wire: the reference unpacked where the
    port's "auto" resolves to unpacked on a model axis."""
    w = dict(WIRES[label])
    mode = "hierarchical" if label.startswith("hier") else "gossip"
    jw = dict(w)
    if "packed" not in w and "error_feedback" not in w:
        jw["packed"] = False
    common = dict(optimizer="sgd", learning_rate=0.5, param_dtype="float32")
    return (JRunConfig(model=jreduced(jget_config("granite-8b")),
                       shape=JSHAPES["train_4k"],
                       averaging=JAveragingConfig(mode, 2, **jw), **common),
            RunConfig(model=reduced(get_config("granite-8b")),
                      shape=SHAPES["train_4k"],
                      averaging=AveragingConfig(mode, 2, **w), **common))


def _kind(label):
    return "ef" if WIRES[label].get("error_feedback") else "plain"


def _init(label):
    """The reference's initial state at MW_N nodes (JAX arrays), and as
    numpy with the port's own OptState (the ranks import the port only)."""
    jrun, _ = _pair(label)
    _, rules = _mesh_rules(jrun)
    with rules():
        js = jtrainer.replicate_for_nodes(
            jtrainer.init_state(jrun, jax.random.PRNGKey(0)), MW_N)
    params, jopt = jax.tree.map(np.asarray, tuple(js))
    return js, (params, OptState(np.asarray(jopt.step), jopt.m, jopt.v,
                                 jopt.master, jopt.ef_residual))


def _batches():
    rng = np.random.default_rng(1)
    return [trainer.make_node_batch(_draw(rng, PER_NODE * MW_N, S), MW_N)
            for _ in range(MW_STEPS)]


def _cohort_batch():
    """MW_K rounds of the 3 active nodes' shares, PER_NODE sequences each."""
    m = MW_N - 1
    b = _draw(np.random.default_rng(4), MW_K * PER_NODE * m, S)
    return {k: v.reshape(MW_K, m, PER_NODE, S) for k, v in b.items()}


def _jax_run(label, batches):
    """The JAX trainer's MW_STEPS steps of `label` on one process."""
    jrun, _ = _pair(label)
    mesh, rules = _mesh_rules(jrun)
    js, _ = _init(label)
    with rules():
        step = jax.jit(jtrainer.build_train_step(jrun, mesh,
                                                 n_nodes=MW_N)[0])
        metrics = []
        for b in batches:
            js, m = step(js, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, js), metrics


def _jax_cohort(b):
    jrun, _ = _pair("ef int8")
    mesh, rules = _mesh_rules(jrun)
    js, _ = _init("ef int8")
    ids = tuple(i for i in range(MW_N) if i != MW_DROPPED)
    with rules():
        sup = jtrainer.build_superstep(jrun, mesh, n_nodes=MW_N - 1)[0]
        js, jm = jax.jit(jdriver.elastic_superstep(sup, MW_N))(
            js, jnp.asarray(ids, jnp.int32),
            {k: jnp.asarray(v) for k, v in b.items()})
    return jax.tree.map(np.asarray, js), np.asarray(jm["loss"])


def _jax_hier_worker(out_path):
    """The JAX trainer's hierarchical runs on a (2, 1, 1) pod mesh (run in
    a subprocess whose environment gives it 2 host devices)."""
    from repro.launch.mesh import make_mesh
    from repro.launch.sharding import activation_rules
    from repro.models.common import mesh_rules

    assert len(jax.devices()) == 2
    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"))
    res = {}
    for label in ("hier none", "hier int8"):
        jrun, _ = _pair(label)
        with mesh_rules(mesh, activation_rules(mesh, jrun.shape,
                                               node_axis=True)):
            js = jtrainer.replicate_for_nodes(
                jtrainer.init_state(jrun, jax.random.PRNGKey(0)), MW_N)
            step = jax.jit(jtrainer.build_train_step(jrun, mesh,
                                                     n_nodes=MW_N)[0])
            metrics = []
            for b in _batches():
                js, m = step(js, {k: jnp.asarray(v) for k, v in b.items()})
                metrics.append({k: float(v) for k, v in m.items()})
        res[label] = {"params": [np.asarray(x)
                                 for x in jax.tree.leaves(js.params)],
                      "metrics": metrics}
    torch.save(res, out_path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results and the references, computed while the ranks
    run."""
    tmp = tmp_path_factory.mktemp("model_wires")
    batches = _batches()
    labels = sorted({label for label, _ in MW_RUNS} | {"int8_stoch tile"})
    given = {"runs": {label: _pair(label)[1] for label in labels},
             "kind": {label: _kind(label) for label in labels},
             "state": {"plain": _init("int8 tile")[1],
                       "ef": _init("ef int8")[1]},
             "batches": batches, "cohort": _cohort_batch()}
    path = tmp / "given.pt"
    torch.save(given, path)

    def references():
        out = tmp / "jax_hier.pt"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"),
                                               HERE]))
        hier = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 str(out)], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        tasks = {label: (lambda label=label: _jax_run(label, batches))
                 for label in labels if not label.startswith(("hier",
                                                             "int8_stoch"))}
        tasks["cohort"] = lambda: _jax_cohort(given["cohort"])
        with ThreadPoolExecutor(3) as pool:
            futures = {k: pool.submit(fn) for k, fn in tasks.items()}
            ref = {k: f.result() for k, f in futures.items()}
        log, _ = hier.communicate(timeout=600)
        assert hier.returncode == 0, log[-3000:]
        ref["hier"] = torch.load(out, weights_only=False)
        return ref

    res, ref = spawn("model_wires", 4, tmp, path, during=references)
    shutil.rmtree(tmp, ignore_errors=True)
    return res, ref


def _stitched(res, label, name, key="params"):
    """Every node's leaves [N, ...] from the model index 0 ranks' rows."""
    runs = sorted((r["runs"][label, name] for r in res
                   if r["runs"][label, name]["model_index"] == 0),
                  key=lambda r: r["rows"])
    return [np.concatenate([r[key][j].numpy() for r in runs])
            for j in range(len(runs[0][key]))]


def _metrics_agree(got, want):
    for m, w in zip(got, want, strict=True):
        for k in ("loss", "ce", "consensus_err"):
            np.testing.assert_allclose(m[k], w[k], rtol=METRIC_TOL[True][k],
                                       atol=1e-7, err_msg=k)


GOSSIP = [(label, name) for label, name in MW_RUNS
          if not label.startswith(("ef", "hier"))]


@pytest.mark.parametrize("label,name", GOSSIP,
                         ids=[f"{a}-{b}".replace(" ", "_") for a, b in GOSSIP])
def test_quantized_wire_matches_reference(ranks, label, name):
    """The per-round wire's statistics at the reference's positions: every
    rank's metrics, and every node's stitched parameters, at the
    quantized bounds."""
    res, ref = ranks
    js, jm = ref[label]
    for r in res:
        _metrics_agree(r["runs"][label, name]["metrics"], jm)
    _agree(_stitched(res, label, name), js.params, 1e-5, frac=0.99,
           bound=1e-2)


EF = [(label, name) for label, name in MW_RUNS if label.startswith("ef")]


@pytest.mark.parametrize("label,name", EF,
                         ids=[f"{a}-{b}".replace(" ", "_") for a, b in EF])
def test_error_feedback_matches_reference(ranks, label, name):
    """Error feedback's per-node tiles of the reference's packed buffer:
    the residual blocks and the parameters against the JAX trainer."""
    res, ref = ranks
    js, jm = ref[label]
    for r in res:
        got = r["runs"][label, name]["metrics"]
        _metrics_agree(got, jm)
        for m, w in zip(got, jm):
            np.testing.assert_allclose(m["ef_rel"], w["ef_rel"], rtol=1e-2)
    _agree(_stitched(res, label, name), js.params, 1e-5, frac=0.99,
           bound=1e-2)
    _agree_residual(_stitched(res, label, name, "ef_residual"),
                    js.opt.ef_residual)


def test_error_feedback_in_a_cohort_matches_reference(ranks):
    """One cohort superstep (node MW_DROPPED out, K = MW_K) of error
    feedback int8 on 1 x 4 against the JAX driver's elastic superstep: the
    dropped node's rows untouched, the others at the EF bounds."""
    res, ref = ranks
    js, jloss = ref["cohort"]
    got = res[0]["cohort"]
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-4)
    assert got["step"] == tuple(0 if i == MW_DROPPED else MW_K
                                for i in range(MW_N))
    _agree([p.numpy() for p in got["params"]], js.params, 1e-5, frac=0.99,
           bound=1e-2)
    _agree_residual([e.numpy() for e in got["ef_residual"]],
                    js.opt.ef_residual)
    for r in res[1:]:
        np.testing.assert_array_equal(r["cohort"]["loss"], got["loss"])


@pytest.mark.parametrize("label", ["hier none", "hier int8"])
def test_hierarchical_mode_matches_reference(ranks, label):
    """Each model index runs the pods' reduce-scatter, gossip and gather
    on its columns; the quantized wire takes the pod means' statistics at
    their positions in the reference's padded pod-mean row."""
    res, ref = ranks
    want = ref["hier"][label]
    quantized = label != "hier none"
    for r in res:
        got = r["runs"][label, "2x1x2"]["metrics"]
        for m, w in zip(got, want["metrics"], strict=True):
            for k in ("loss", "ce", "consensus_err"):
                np.testing.assert_allclose(
                    m[k], w[k], atol=1e-7, err_msg=k,
                    rtol=METRIC_TOL[quantized][k])
    got = _stitched(res, label, "2x1x2")
    if quantized:
        _agree(got, want["params"], 1e-5, frac=0.99, bound=1e-2)
    else:
        _agree(got, want["params"], 1e-5)


def test_int8_stoch_repeats_on_a_model_axis(ranks):
    """int8_stoch folds the model index into a split leaf's key: the same
    step from the same state gives the same bits, and a finite loss."""
    res, _ = ranks
    assert all(r["stoch_same"] for r in res)
    assert np.isfinite(res[0]["stoch_loss"][0]["loss"])


def test_kernel_routes_on_the_cpu(ranks):
    """On the CPU every tensor takes the plain versions: no launch is
    counted, whatever the route."""
    res, _ = ranks
    for r in res:
        for run in r["runs"].values():
            assert not any(run["launches"].values())


@pytest.mark.parametrize("block_d,straddle", [(64, True), (16, False)])
def test_runs_that_fill_whole_tiles_need_no_message(block_d, straddle):
    """wk and wv hold 16 columns a rank on 1 x 4: 64-column tiles straddle
    four ranks, 16-column ones lie inside a rank's run, and then no leaf's
    slot straddles and the planner's trace sends no slot all-reduce."""
    _, run = _pair("int8 tile")
    mesh = dataclasses.replace(abstract_mesh((1, 4), ("data", "model")),
                               rank=1)
    lay = trainer.leaf_layout(run.model, mesh)
    pools = trainer.layer_pools(trainer.init_state(
        run, torch.Generator().manual_seed(0)).params, run.model)
    straddling = []
    for pool in pools:
        maps = block_maps([lay[i] for i in pool], 4, 1)
        width = sum(bm.span for bm in maps)
        straddling.append(len(Slots(maps, min(block_d, width), width, width,
                                    index=1).straddling))
    assert (sum(straddling) > 0) == straddle
    wire = dict(WIRES["int8 tile"], quant_block_d=block_d)
    rec = dryrun.plan("granite-8b", "train_4k", mesh, averaging="gossip",
                      rounds=2, microbatches=1, cfg=run.model, n_nodes=MW_N,
                      shape=ShapeConfig("t", S, PER_NODE * MW_N, "train"),
                      wire=wire)
    slot = rec["collectives_model"].get("slot all-reduce.count", 0)
    assert (slot > 0) == straddle
    assert rec["temp_unsplit_over_model"] is False


@pytest.mark.parametrize("label", ["int8 tile", "ef int8"])
def test_planned_slot_messages_match_the_ranks(ranks, label):
    """Each rank of 1 x 4 sends, per step, the slot all-reduces that the
    planner's trace of its step sends (its messages and bytes), and the
    model axis's other messages by count."""
    res, _ = ranks
    _, run = _pair(label)
    wire = {k: v for k, v in WIRES[label].items()}
    for rank, r in enumerate(res):
        mesh = dataclasses.replace(abstract_mesh((1, 4), ("data", "model")),
                                   rank=rank)
        sent = dryrun.traced_collectives(
            r["runs"][label, "1x4"]["wires"][0]["log"], "model")
        assert sent.get("slot all-reduce.count", 0) > 0
        if rank > 1:
            continue  # ranks 2 and 3 send what rank 1 does
        rec = dryrun.plan("granite-8b", "train_4k", mesh, averaging="gossip",
                          rounds=2, microbatches=1, cfg=run.model,
                          n_nodes=MW_N, wire=wire,
                          shape=ShapeConfig("t", S, PER_NODE * MW_N,
                                            "train"))
        planned = rec["collectives_model"]
        for k in ("slot all-reduce", "slot all-reduce.count",
                  "all-reduce.count"):
            assert sent.get(k, 0) == planned.get(k, 0), k


@pytest.mark.parametrize("label", ["int8 tile", "sign global", "ef int8"])
def test_planned_node_axis_matches_the_ranks_on_2x2(ranks, label):
    """On 2 x 2 the node axis's messages of each rank's step (the
    quantized wire's gathers of the node rows, error feedback's halo
    rows) are the planner's, to the byte."""
    res, _ = ranks
    _, run = _pair(label)
    for rank, r in enumerate(res):
        mesh = dataclasses.replace(abstract_mesh((2, 2), ("data", "model")),
                                   rank=rank)
        whole = trainer.replicate_for_nodes(trainer.init_state(
            run, torch.Generator().manual_seed(0)), MW_N)
        spec = trainer.state_placements(run, mesh, whole)
        rows = rdist.node_rows(mesh, MW_N)
        params = shlib.shard_tree(map_tensors(lambda x: x[rows],
                                              whole.params),
                                  spec.params, mesh)
        planned = dryrun.node_axis_collectives(run, params, mesh, MW_N)
        sent = dryrun.traced_collectives(
            r["runs"][label, "2x2"]["wires"][0]["log"], "data")
        assert sent == planned


if __name__ == "__main__":
    _jax_hier_worker(sys.argv[1])
