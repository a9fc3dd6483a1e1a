"""Error feedback and the hierarchical mode of the port's LM trainer on a
node axis split over CPU ranks in a gloo group (`tests/torch_dist_worker.py`
case `shard_ef`, one worker run per world size), against the port's own
one-process run and the JAX package's trainer:

* error feedback (reduced granite-8b, f32, SGD, ring R = 2, 2 steps of
  2 x 64 tokens a node) on the sign, int8 and int8_stoch wires, on 2 and 4
  ranks at n_nodes = 4, in a cohort (node 2 out, one superstep of K = 2:
  on 4 ranks rank 2 holds no active row) and, on 2 ranks, on the
  uneven split n_nodes = 5 (3 + 2 rows) with 2^18-entry column chunks (so
  the chunks a rank walks come from the full node count, not its rows):
  parameters and residuals bit for bit the one-process port's, whose
  operator is the plain per-round loop where the split takes the shard
  rule (per-round too) and the fused roll where it gathers; losses within
  f32 reassociation (the ranks' sums); sign and int8 against the JAX
  trainer at n_nodes = 4 within tests/test_torch_error_feedback.py's
  bounds (int8_stoch draws its noise from another generator: in
  distribution only, docs/DESIGN.md);
* the hierarchical mode at n_nodes = 4, pods = 2 on a ("pod", "data",
  "model") = (2, 2, 1) mesh (ring between the pods at self weight 0.6:
  at 1/2 two pods would take the exact mean): the exact wire, int8 with
  64-column tiles (the lanes' blocks hold whole tiles: the lanes gossip
  apart), int8 with 100-column tiles (tiles straddle the blocks: every
  block gathered) and int8_stoch (gathered), bit for bit the one-process
  port at pods = 2, and against the JAX trainer on a (2, 2, 1) pod mesh
  within tests/test_torch_trainer.py's tolerances (the JAX side in a
  subprocess with 4 fake host devices: XLA_FLAGS is never set in the
  pytest process); and at n_nodes = 8, two rows a rank (exact and int8
  lanes), bit for bit the one-process port, whose pod sums then span
  each lane's rows and the lanes;
* the planner (`launch.dryrun.node_axis_collectives`) against each step's
  messages on every rank, to the byte and the message.
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

from repro.train import driver as jdriver
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch import dist as rdist
from repro_torch.core import averaging, mixing
from repro_torch.core.mixing import Membership
from repro_torch.core.packing import map_tensors, tree_map
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.models.common import MetaGenerator
from repro_torch.train import trainer
from test_torch_error_feedback import _agree_residual, _ef_runs
from test_torch_trainer import METRIC_TOL, _agree, _draw, _runs, _states
from torch_dist_worker import (EF_DROPPED, EF_N, EF_UNEVEN_N, EF_WIRES,
                               HIER_CASES, HIER_K2_CASES, HIER_K2_N,
                               HIER_MESH, UNEVEN_CHUNK_ENTRIES,
                               spawn)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS, K, SEQ = 2, 2, 64
HIER_SELF_WEIGHT = 0.6


def _ef_pair(wire):
    if wire == "int8_stoch":
        jrun, trun = _runs("gossip", wire, "sgd")
        ef = lambda run: dataclasses.replace(run, averaging=dataclasses
                                             .replace(run.averaging,
                                                      error_feedback="grads"))
        return ef(jrun), ef(trun)
    return _ef_runs(wire)


def _hier_pair(wire, block):
    jrun, trun = _runs("hierarchical", wire, "sgd")
    h = lambda run: dataclasses.replace(run, averaging=dataclasses.replace(
        run.averaging, self_weight=HIER_SELF_WEIGHT, quant_block_d=block))
    return h(jrun), h(trun)


def _grow(ts, n):
    """A decentralized port state with its node axis repeated out to n
    rows (node 0's copies)."""
    grow = lambda t: torch.cat([t] + [t[:1]] * (n - t.shape[0]))
    opt = ts.opt
    return type(ts)(tree_map(grow, ts.params), opt._replace(
        step=tuple(opt.step) + (opt.step[0],) * (n - len(opt.step)),
        m=tree_map(grow, opt.m), v=tree_map(grow, opt.v),
        master=tree_map(grow, opt.master),
        ef_residual=tree_map(grow, opt.ef_residual)))


def _clone(ts):
    return map_tensors(lambda t: t.clone(), ts)


def _node_batches(n, seed):
    rng = np.random.default_rng(seed)
    return [trainer.make_node_batch(_draw(rng, 2 * n, SEQ), n)
            for _ in range(STEPS)]


def _cohort_batch():
    """K rounds of the 3 active nodes' shares, 2 sequences each."""
    b = _draw(np.random.default_rng(4), K * 2 * (EF_N - 1), SEQ)
    return {k: v.reshape(K, EF_N - 1, 2, SEQ) for k, v in b.items()}


def one_process_mix(avg, m, table):
    """The one-process operator whose numbers a split run's mix gives:
    the plain per-round loop where the shard rule covers `table` (it runs
    the rounds apart), else the fused roll (what the split's gather
    applies)."""
    sched = mixing.schedule(avg.topology, m, avg.self_weight)
    mesh = rdist.Mesh((len(table), 1), ("data", "model"))
    if ops.node_shard_info(mesh, m, sched, table) is not None:
        return mixing.circulant_mix_op(sched, m, avg.rounds, fuse=False,
                                       device="cpu")
    return mixing.circulant_mix_op(sched, m, avg.rounds, impl="roll",
                                   device="cpu")


def _steps(run, ts, batches, n, **kw):
    step = trainer.build_train_step(run, None, n_nodes=n, device="cpu", **kw)
    metrics = []
    for b in batches:
        ts, m = step(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return convert.train_tree(ts, run.model), metrics


def _inputs():
    jrun, trun = _ef_runs("int8")
    _, _, _, ts = _states(jrun, trun)
    given = {"ef": {}, "hier": {}}
    batches = _node_batches(EF_N, 1)
    ubatches = _node_batches(EF_UNEVEN_N, 2)
    for wire in EF_WIRES:
        given["ef"][wire] = {
            "run": _ef_pair(wire)[1], "state": ts, "batches": batches,
            "B": 8, "cohort_batches": _cohort_batch(),
            "uneven_state": _grow(ts, EF_UNEVEN_N),
            "uneven_batches": ubatches}
    _, _, _, hs = _states(*_hier_pair("none", 64))
    for label, wire, block in HIER_CASES:
        given["hier"][label] = {"run": _hier_pair(wire, block)[1],
                                "state": hs, "batches": batches, "n": EF_N}
    k2_state, k2_batches = _grow(hs, HIER_K2_N), _node_batches(HIER_K2_N, 3)
    for label, wire, block in HIER_K2_CASES:
        given["hier"][label] = {"run": _hier_pair(wire, block)[1],
                                "state": k2_state, "batches": k2_batches,
                                "n": HIER_K2_N}
    return given


# references shared by the two world sizes' fixtures, computed once
_REFS: dict = {}


def _cached(key, fn):
    if key not in _REFS:
        _REFS[key] = fn()
    return _REFS[key]


def _one_cohort(case, E):
    """The one-process cohort superstep: K steps of the cohort's rows in
    place, its operator the one E ranks' row table gives."""
    run = case["run"]
    mesh = rdist.Mesh((E, 1), ("data", "model"))
    mem = Membership.full(EF_N).drop(EF_DROPPED)
    m = mem.n_active
    step = trainer._build_node_step(
        run, m, one_process_mix(run.averaging, m,
                                rdist.cohort_rows(mesh, mem)), "cpu")
    ids = mem.active_ids
    ts = _clone(case["state"])
    for j in range(K):
        ts, metrics = step(ts, {k: torch.from_numpy(v[j]) for k, v in
                                case["cohort_batches"].items()},
                           ids, torch.as_tensor(ids))
    return convert.train_tree(ts, run.model), float(metrics["loss"])


def _one_process(given, E, small_chunks) -> dict:
    """The port's one-process runs of every case that E ranks run (what
    they must equal bit for bit): {(kind, case): result}, one task each."""
    tasks = {}
    # n_nodes = 4 splits into rows the shard rule covers on 2 and 4 ranks
    table = rdist.row_table(rdist.Mesh((2, 1), ("data", "model")), EF_N)
    utable = rdist.row_table(rdist.Mesh((2, 1), ("data", "model")),
                             EF_UNEVEN_N)
    for wire, case in given["ef"].items():
        run = case["run"]
        if ("ef", wire) not in _REFS:
            tasks["ef", wire] = lambda run=run, case=case: _steps(
                run, _clone(case["state"]), case["batches"], EF_N,
                mix=one_process_mix(run.averaging, EF_N, table))
        tasks["cohort", wire] = lambda case=case: _one_cohort(case, E)
        if E == 2:
            tasks["uneven", wire] = lambda run=run, case=case: _steps(
                run, _clone(case["uneven_state"]), case["uneven_batches"],
                EF_UNEVEN_N, mix=one_process_mix(run.averaging, EF_UNEVEN_N,
                                                 utable))
    lanes = rdist.row_table(rdist.Mesh((2, 1), ("data", "model")), 2)
    for label, case in given["hier"].items() if E == 4 else ():
        run = case["run"]
        mix = (one_process_mix(run.averaging, 2, lanes)
               if run.averaging.quantization == "none" else None)
        tasks["hier", label] = lambda run=run, case=case, mix=mix: _steps(
            run, _clone(case["state"]), case["batches"], case["n"], mix=mix,
            pods=2)
    out = {}
    with small_chunks():  # only the uneven split's chunks are that narrow
        uneven = {k: tasks.pop(k) for k in list(tasks) if k[0] == "uneven"}
        out.update(_parallel(uneven))
    out.update(_parallel(tasks))
    for key in [k for k in out if k[0] == "ef"]:
        _REFS[key] = out[key]
    return {**{k: v for k, v in _REFS.items() if k[0] == "ef"}, **out}


def _parallel(tasks: dict) -> dict:
    """Each task on a thread of its own (torch and XLA release the GIL, and
    this process runs one intra-op thread)."""
    with ThreadPoolExecutor(max(len(tasks), 1)) as pool:
        futures = {k: pool.submit(fn) for k, fn in tasks.items()}
        return {k: f.result() for k, f in futures.items()}


def _jax_ef(wire, batches):
    jrun, trun = _ef_pair(wire)
    mesh, rules, js, _ = _states(jrun, trun)
    with rules():
        jstep = jax.jit(jtrainer.build_train_step(jrun, mesh, n_nodes=EF_N)[0])
        metrics = []
        for b in batches:
            js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in jm.items()})
    return jax.tree.map(np.asarray, js), metrics


def _jax_cohort(wire, b):
    jrun, trun = _ef_pair(wire)
    mesh, rules, js, _ = _states(jrun, trun)
    ids = tuple(i for i in range(EF_N) if i != EF_DROPPED)
    with rules():
        jsup = jtrainer.build_superstep(jrun, mesh, n_nodes=EF_N - 1)[0]
        js, jm = jax.jit(jdriver.elastic_superstep(jsup, EF_N))(
            js, jnp.asarray(ids, jnp.int32),
            {k: jnp.asarray(v) for k, v in b.items()})
    return jax.tree.map(np.asarray, js), np.asarray(jm["loss"])


def _jax_hier_worker(out_path):
    """The JAX trainer's hierarchical runs on a (2, 2, 1) pod mesh (run in
    a subprocess whose environment gives it 4 host devices)."""
    from repro.launch.mesh import make_mesh
    from repro.launch.sharding import activation_rules
    from repro.models.common import mesh_rules

    assert len(jax.devices()) == 4
    mesh = make_mesh(*HIER_MESH)
    batches = _node_batches(EF_N, 1)
    res = {}
    for label, wire, block in HIER_CASES:
        if wire == "int8_stoch":
            continue
        jrun, _ = _hier_pair(wire, block)
        with mesh_rules(mesh, activation_rules(mesh, jrun.shape,
                                               node_axis=True)):
            js = jtrainer.replicate_for_nodes(
                jtrainer.init_state(jrun, jax.random.PRNGKey(0)), EF_N)
            step = jax.jit(jtrainer.build_train_step(jrun, mesh,
                                                     n_nodes=EF_N)[0])
            metrics = []
            for b in batches:
                js, m = step(js, {k: jnp.asarray(v) for k, v in b.items()})
                metrics.append({k: float(v) for k, v in m.items()})
        res[label] = {"params": [np.asarray(x)
                                 for x in jax.tree.leaves(js.params)],
                      "metrics": metrics}
    torch.save(res, out_path)


def _spawn(E, tmp, small_chunks):
    given = _inputs()
    path = tmp / "given.pt"
    torch.save(given, path)

    def references():
        hier = None
        if E == 4:
            hier_out = tmp / "jax_hier.pt"
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       XLA_FLAGS="--xla_force_host_platform_device_count=4",
                       PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..",
                                                                "src"),
                                                   HERE]))
            hier = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(hier_out)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        jax_tasks = {("jax_ef", w): lambda w=w: _jax_ef(
            w, given["ef"][w]["batches"]) for w in ("sign", "int8")}
        jax_tasks["jax_cohort"] = lambda: _jax_cohort("int8",
                                                      _cohort_batch())
        with ThreadPoolExecutor(1) as pool:  # beside the port's runs
            jax_refs = pool.submit(lambda: {
                k: _cached(k, fn) for k, fn in jax_tasks.items()})
            one = _one_process(given, E, small_chunks)
            jax_refs = jax_refs.result()
        ref = {"one": one,
               "jax_ef": {w: jax_refs["jax_ef", w] for w in ("sign", "int8")},
               "jax_cohort": jax_refs["jax_cohort"]}
        if hier is not None:
            log, _ = hier.communicate(timeout=600)
            assert hier.returncode == 0, log[-3000:]
            ref["jax_hier"] = torch.load(hier_out, weights_only=False)
        return ref

    res, ref = spawn("shard_ef", E, tmp, path, during=references)
    shutil.rmtree(tmp, ignore_errors=True)  # given.pt: ~0.5 GB
    return E, res, ref, given


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, small_chunks):
    return _spawn(2, tmp_path_factory.mktemp("shard_ef_2"), small_chunks)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, small_chunks):
    return _spawn(4, tmp_path_factory.mktemp("shard_ef_4"), small_chunks)


WORLDS = pytest.mark.parametrize("world", [2, 4], ids=["2ranks", "4ranks"])


@pytest.fixture(scope="module")
def small_chunks():
    """A context that sets `averaging.EF_CHUNK_ENTRIES` to
    UNEVEN_CHUNK_ENTRIES (the uneven split's chunks) and restores it."""
    import contextlib

    @contextlib.contextmanager
    def small_chunks():
        old = averaging.EF_CHUNK_ENTRIES
        averaging.EF_CHUNK_ENTRIES = UNEVEN_CHUNK_ENTRIES
        try:
            yield
        finally:
            averaging.EF_CHUNK_ENTRIES = old

    return small_chunks


def _stitch(res, kind, key):
    runs = sorted((r[kind][key] for r in res), key=lambda r: r["rows"])
    return jax.tree.map(lambda *xs: np.concatenate(xs),
                        *[r["tree"] for r in runs])


def _same(got, want):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        np.testing.assert_array_equal(a, b)


@WORLDS
@pytest.mark.parametrize("wire", EF_WIRES)
def test_ef_split_bit_for_bit_one_process(request, world, wire):
    E, res, ref, _ = request.getfixturevalue(f"ranks{world}")
    want, want_m = ref["one"]["ef", wire]
    got = _stitch(res, "ef", wire)
    _same(got["params"], want["params"])
    _same(got["ef_residual"], want["ef_residual"])
    np.testing.assert_array_equal(got["step"], want["step"])
    for r in res:
        for m, w in zip(r["ef"][wire]["metrics"], want_m, strict=True):
            for k in ("loss", "ef_norm", "ef_rel", "consensus_err"):
                np.testing.assert_allclose(m[k], w[k], rtol=1e-6, err_msg=k)
            assert 0 < m["ef_rel"] < 1


@WORLDS
@pytest.mark.parametrize("wire", ["sign", "int8"])
def test_ef_split_matches_reference(request, world, wire):
    E, res, ref, _ = request.getfixturevalue(f"ranks{world}")
    js, jmetrics = ref["jax_ef"][wire]
    got = _stitch(res, "ef", wire)
    for r in res:
        for m, jm in zip(r["ef"][wire]["metrics"], jmetrics, strict=True):
            np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-4)
            for k in ("ef_norm", "ef_rel"):
                np.testing.assert_allclose(m[k], jm[k], rtol=1e-3, atol=1e-7,
                                           err_msg=k)
    _agree(got["params"], js.params, 1e-5, frac=0.99, bound=1e-2)
    _agree_residual(got["ef_residual"], js.opt.ef_residual)


@WORLDS
@pytest.mark.parametrize("wire", EF_WIRES)
def test_ef_cohort_bit_for_bit_one_process(request, world, wire):
    E, res, ref, given = request.getfixturevalue(f"ranks{world}")
    want, want_loss = ref["one"]["cohort", wire]
    got = _stitch(res, "cohort", wire)
    _same(got["params"], want["params"])
    _same(got["ef_residual"], want["ef_residual"])
    np.testing.assert_array_equal(got["step"], [K, K, 0, K])
    # the dropped node's rows are as they were
    before = convert.train_tree(given["ef"][wire]["state"],
                                given["ef"][wire]["run"].model)
    for key in ("params", "ef_residual"):
        for a, b in zip(jax.tree.leaves(got[key]),
                        jax.tree.leaves(before[key])):
            np.testing.assert_array_equal(a[EF_DROPPED], b[EF_DROPPED])
    for r in res:
        np.testing.assert_allclose(r["cohort"][wire]["loss"][-1], want_loss,
                                   rtol=1e-6)


@WORLDS
def test_ef_cohort_matches_reference(request, world):
    """The int8 wire's cohort, as
    tests/test_torch_error_feedback.py::test_trainer_cohort_with_error_
    feedback_matches_reference holds one process."""
    E, res, ref, _ = request.getfixturevalue(f"ranks{world}")
    js, jloss = ref["jax_cohort"]
    got = _stitch(res, "cohort", "int8")
    for r in res:
        np.testing.assert_allclose(r["cohort"]["int8"]["loss"], jloss,
                                   rtol=1e-4)
    _agree(got["params"], js.params, 1e-5, frac=0.99, bound=1e-2)
    _agree_residual(got["ef_residual"], js.opt.ef_residual)


@pytest.mark.parametrize("wire", EF_WIRES)
def test_ef_uneven_split_bit_for_bit(ranks2, wire):
    """n_nodes = 5 on 2 ranks (3 + 2 rows) with 52,416-column chunks: the
    ranks walk the same chunks (cut from the full node count), their halo
    messages pair up, and the rows are the one process's."""
    E, res, ref, _ = ranks2
    want, _ = ref["one"]["uneven", wire]
    got = _stitch(res, "uneven", wire)
    assert [r["uneven"][wire]["rows"] for r in res] == [(0, 3), (3, 5)]
    _same(got["params"], want["params"])
    _same(got["ef_residual"], want["ef_residual"])


@pytest.mark.parametrize("label", [c[0] for c in HIER_CASES
                                   + HIER_K2_CASES])
def test_hierarchical_bit_for_bit_one_process(ranks4, label):
    E, res, ref, _ = ranks4
    want, want_m = ref["one"]["hier", label]
    got = _stitch(res, "hier", label)
    _same(got["params"], want["params"])
    for r in res:
        for m, w in zip(r["hier"][label]["metrics"], want_m, strict=True):
            np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-6)
            np.testing.assert_allclose(m["consensus_err"],
                                       w["consensus_err"], rtol=1e-5,
                                       atol=1e-7)
        assert r["hier"][label]["metrics"][-1]["consensus_err"] > 0


@pytest.mark.parametrize("label", [c[0] for c in HIER_CASES
                                   if c[1] != "int8_stoch"])
def test_hierarchical_matches_reference(ranks4, label):
    """Against the JAX trainer on a (2, 2, 1) pod mesh, within
    tests/test_torch_trainer.py's tolerances (exact: rtol = atol = 1e-5;
    int8: 99% within 1e-5, all within 1e-2)."""
    E, res, ref, _ = ranks4
    want = ref["jax_hier"][label]
    quantized = label != "exact"
    got = _stitch(res, "hier", label)
    g = np.concatenate([np.ravel(x) for x in jax.tree.leaves(got["params"])])
    w = np.concatenate([np.ravel(x) for x in want["params"]])
    if quantized:
        _agree([g], [w], 1e-5, frac=0.99, bound=1e-2)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    for r in res:
        for m, jm in zip(r["hier"][label]["metrics"], want["metrics"],
                         strict=True):
            for k, tol in METRIC_TOL[quantized].items():
                np.testing.assert_allclose(m[k], jm[k], rtol=tol, atol=1e-7,
                                           err_msg=k)


def _meta_params(run, n_rows):
    return tree_map(lambda t: t[None].expand(n_rows, *t.shape),
                    registry.init_params(MetaGenerator(), run.model,
                                         torch.float32))


def _check_plan(coll, wire):
    stats = wire["stats"]
    assert stats["messages"] == sum(v for k, v in coll.items()
                                    if k.endswith(".count"))
    assert stats["wire_bytes"] == dryrun.staged_bytes(coll)
    assert dryrun.traced_collectives(wire["log"]) == coll


@WORLDS
@pytest.mark.parametrize("wire", EF_WIRES)
def test_planned_ef_wire_matches_the_ranks(request, world, wire):
    """Each rank's planned EF step (full membership, the cohort) equals
    what it sent, to the byte and the message."""
    E, res, _, given = request.getfixturevalue(f"ranks{world}")
    run = given["ef"][wire]["run"]
    mem = Membership.full(EF_N).drop(EF_DROPPED)
    for rank, r in enumerate(res):
        mesh = rdist.Mesh((E, 1), ("data", "model"), rank=rank)
        rows = rdist.n_local(mesh, EF_N)
        for w in r["ef"][wire]["wires"]:
            _check_plan(dryrun.node_axis_collectives(
                run, _meta_params(run, rows), mesh, EF_N), w)
        coll = dryrun.node_axis_collectives(
            run, _meta_params(run, rows), mesh, EF_N, membership=mem)
        assert "all-reduce" in coll
        cohort = r["cohort"][wire]["wires"][0]
        # the cohort's superstep runs K steps
        _check_plan({k: v * K for k, v in coll.items()}, cohort)


@pytest.mark.parametrize("label", [c[0] for c in HIER_CASES
                                   + HIER_K2_CASES])
def test_planned_hierarchical_wire_matches_the_ranks(ranks4, label):
    E, res, _, given = ranks4
    run, n = given["hier"][label]["run"], given["hier"][label]["n"]
    kinds = set()
    for rank, r in enumerate(res):
        mesh = rdist.Mesh(*HIER_MESH, rank=rank)
        coll = dryrun.node_axis_collectives(run, _meta_params(run, n // E),
                                            mesh, n)
        kinds |= {k for k in coll if not k.endswith(".count")}
        for w in r["hier"][label]["wires"]:
            _check_plan(coll, w)
    assert "reduce-scatter" in kinds
    assert ("collective-permute" in kinds) == label.startswith("exact")


if __name__ == "__main__":
    _jax_hier_worker(sys.argv[1])
