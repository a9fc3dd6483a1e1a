"""Elastic membership and the vocab fallback over the port's model axis,
on 4 CPU ranks in a gloo group (`tests/torch_dist_worker.py`
`model_elastic`, one worker run), against the JAX package on one process:

* (a) reduced granite-8b at d_model 512 (f32, Adam, 2 layers, 4 nodes)
  through the `StreamingDriver` on 1 x 4 (tensor-parallel over 4, every
  node on every rank) under `death:1@1-2` (K = 1, no prefetch, open loop),
  with the rejoin sync on and off, against the JAX driver at n_nodes = 4
  from the same state, draws and clock: membership events, compiled
  signatures and per-node steps equal, losses within rtol 1e-5; the
  parameters at the bounds the same runs meet on the split node axis
  (tests/test_torch_shard_elastic_lm.py): with the sync 99.9% within
  1e-5 rel + 1e-5 (Adam turns the tensor-parallel sums' reassociation
  into O(lr) moves of a few entries), without it the share outside at
  most twice the reference's own against itself when its initial
  parameters move by one ulp, every entry within 6 lr; Adam's m and v
  99.9% within 1e-5 rel + 1e-5 and all within 1e-4;
* (b) the same on 2 x 2 (2 nodes a data rank: the rejoin sync is one f32
  all-reduce over the data group), and under the straggler policy "drop"
  with node 2 slowed 10x (`slow:2@1-3x10`, patience 1, a fake clock);
* (c) the 2 x 2 run's blocking snapshot taken in the cohort, resumed
  there into zeroed blocks: the membership and every node's optimizer
  step come back, and the last superstep is the uninterrupted run's bit
  for bit;
* (d) every run's final state published under a partial mask (node 1
  out): within 1e-6 relative of the port's one-process publication of the
  ranks' state;
* the planner, rank by rank, against what each rank sent in one cohort
  step (node 1 out) and one rejoin sync (`dist.stats`, `dist.log`): the
  node axis's messages and bytes (`dryrun.node_axis_collectives` with the
  membership), the model axis's (the trace of the cohort step,
  `dryrun.plan(membership=...)`, whose bf16 run moves the head pieces in
  half the bytes) and the sync's (`dryrun.rejoin_collectives`);
* the vocab fallback: reduced granite-8b with a vocab of 513, which no
  extent above 1 divides, so `embed` holds the rank's d_model columns (the
  reference's `_ALT_SPECS`): 2 gossip SGD steps on 1 x 4 and 2 x 2 against
  the JAX trainer at the model-axis trainer's bounds
  (tests/test_torch_model_axis.py: losses within rtol 1e-5, parameters
  within rtol = atol = 1e-5); the split checkpoint restores bit for bit, reads
  on one process as the ranks' state and, on 1 x 4, is byte for byte rank
  0's one-process save;
* what stays refused: elastic membership in the exact and hierarchical
  modes, with the reference's ValueError, on a model axis too.
"""
import dataclasses
import filecmp
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import GovernorConfig as JGovernorConfig
from repro.core import faults as jfaults
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch import dist as rdist
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AveragingConfig, ShapeConfig
from repro_torch.core import faults
from repro_torch.core.mixing import Membership
from repro_torch.core.packing import map_tensors, tree_leaves
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.optim import OptState
from repro_torch.train import checkpoint, trainer
from repro_torch.train.driver import EngineConfig, StreamingDriver
from test_torch_trainer import (JEngineConfig, JStreamingDriver, _agree,
                                _flat, _mesh_rules, _runs)
from torch_dist_worker import (LM_B, LM_S, LM_SPEC, LM_SUPERSTEPS, ME_BACK,
                               ME_DT, ME_MASK, ME_RUNS, ME_SLOW, ME_VOCAB,
                               ME_VOCAB_STEPS, MODEL_MESHES, FakeClock,
                               digest, lm_draw, np_leaves, spawn)

torch.set_num_threads(1)

N = 4
COHORT = Membership.full(N).drop(1)  # the planner probes' cohort


def _cfgs(vocab=None):
    j, t = (jreduced(jget_config("granite-8b"), d_model=512),
            reduced(get_config("granite-8b"), d_model=512))
    if vocab:
        j = dataclasses.replace(j, vocab_size=vocab)
        t = dataclasses.replace(t, vocab_size=vocab)
    return j, t


def _lm_runs(vocab=None):
    """The gossip (ring R = 2) runs of reduced granite-8b at d_model 512,
    the JAX package's and the port's: Adam, or with `vocab` SGD (the model
    axis trainer's parity bounds, tests/test_torch_model_axis.py)."""
    jrun, trun = _runs("gossip", "none", "sgd" if vocab else "adam")
    jcfg, tcfg = _cfgs(vocab)
    return (dataclasses.replace(jrun, model=jcfg),
            dataclasses.replace(trun, model=tcfg))


@functools.lru_cache(maxsize=None)
def _init(jrun):
    """The reference's initial state at N nodes as numpy, and one node's
    of it with the port's own OptState of its numpy trees (the ranks
    import the port only, and replicate it)."""
    _, rules = _mesh_rules(jrun)
    with rules():
        one = jtrainer.init_state(jrun, jax.random.PRNGKey(0))
        js = jax.tree.map(np.asarray, jtrainer.replicate_for_nodes(one, N))
    params, jopt = jax.tree.map(np.asarray, tuple(one))
    return js, (params, OptState(np.asarray(jopt.step), jopt.m, jopt.v,
                                 jopt.master, jopt.ef_residual))


def _governor(label):
    return next(gov for name, _, _, gov in ME_RUNS if name == label)


@functools.lru_cache(maxsize=None)
def _builder():
    """The reference's superstep builder, shared by its driver runs (one
    compile per signature)."""
    jrun, _ = _lm_runs()
    mesh, rules = _mesh_rules(jrun)
    return jtrainer.superstep_builder(jrun, mesh, n_nodes=N)


def _reference(spec, gov, start=None):
    """The JAX driver at N nodes under `spec`, on ME_DT's fake clock: its
    final state, history, membership events and compiled signatures."""
    jrun, _ = _lm_runs()
    mesh, rules = _mesh_rules(jrun)
    js = jax.tree.map(jnp.asarray, _init(jrun)[0] if start is None
                      else start)
    with rules():
        with JStreamingDriver(
                jrun, mesh, js, lambda rng, n: lm_draw(rng, n), batch=LM_B,
                n_nodes=N, faults=jfaults.FaultSchedule.parse(spec, N),
                clock=FakeClock(ME_DT), superstep_builder=_builder(),
                engine=JEngineConfig(superstep=1, prefetch_depth=0,
                                     replan_every=0,
                                     governor=JGovernorConfig(**gov))) as d:
            js, hist = d.run(LM_SUPERSTEPS)
    return (jax.tree.map(np.asarray, js), hist,
            [(e["superstep"], e["to"].active_ids)
             for e in d.membership_events], d.compiled_signatures)


def _ulp_miss(want):
    """The reference's share of entries outside 1e-5 of itself without
    the sync when its initial parameters move by one ulp."""
    jrun, _ = _lm_runs()
    start = _init(jrun)[0]
    up = lambda a: np.nextafter(a, np.float32(np.inf)).astype(a.dtype)
    moved = _reference(LM_SPEC, {"sync_on_rejoin": False}, start._replace(
        params=jax.tree.map(up, start.params)))[0]
    g, w = _flat(moved.params), _flat(want.params)
    return float(np.mean(np.abs(g - w) > 1e-5 + 1e-5 * np.abs(w)))


def _vocab_batches():
    data, rng = MarkovTokenStream(ME_VOCAB, seed=0), np.random.default_rng(1)
    out = []
    for _ in range(ME_VOCAB_STEPS):
        toks = data.sample(rng, LM_B, LM_S + 1)
        out.append(jtrainer.make_node_batch(
            {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, N))
    return out


def _vocab_reference(batches):
    """The JAX trainer's gossip steps with a vocab of 513 at N nodes: its
    final parameters and metrics."""
    jrun, _ = _lm_runs(ME_VOCAB)
    mesh, rules = _mesh_rules(jrun)
    js = jax.tree.map(jnp.asarray, _init(jrun)[0])
    with rules():
        step = jax.jit(jtrainer.build_train_step(jrun, mesh, n_nodes=N)[0])
        metrics = []
        for b in batches:
            js, m = step(js, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, js), metrics


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results and the references (computed while the ranks
    run); the ranks' work tree (snapshots, checkpoints) is removed at
    teardown."""
    tmp = tmp_path_factory.mktemp("model_elastic")
    work = tmp / "work"
    work.mkdir()
    _, trun = _lm_runs()
    jvrun, tvrun = _lm_runs(ME_VOCAB)
    batches = _vocab_batches()
    given = {"run": trun, "work": str(work), "state": _init(_lm_runs()[0])[1],
             "vocab_run": tvrun, "vocab_state": _init(jvrun)[1],
             "vocab_batches": batches}
    path = tmp / "given.pt"
    torch.save(given, path)

    def references():
        ref = {label: _reference(spec, gov)
               for label, name, spec, gov in ME_RUNS if name == "1x4"}
        ref["1x4 no sync", "miss"] = _ulp_miss(ref["1x4 no sync"][0])
        ref["2x2 straggler"] = _reference(ME_SLOW,
                                          _governor("2x2 straggler"))
        ref["vocab"] = _vocab_reference(batches)
        return ref

    res, ref = spawn("model_elastic", 4, tmp, path, during=references)
    path.unlink()
    yield res, ref, str(work)
    shutil.rmtree(tmp, ignore_errors=True)


def _ref_of(ref, label):
    """The reference of a run: the 2 x 2 death run shares 1 x 4's."""
    return ref["1x4 sync" if label == "2x2 sync" else label]


def _steps(runs):
    """Every node's optimizer step from the ranks' rows, in node order."""
    parts = {r["rows"]: r["step"] for r in runs}
    return np.concatenate([parts[rows] for rows in sorted(parts)])


def _nodes(runs, key="params"):
    """Every node's parameters (or Adam's `key` moment), flat
    (`_by_node`), from the ranks that sent them."""
    sent = {n: p.numpy() for r in runs
            for n, p in zip(r["nodes"], r[key])}
    assert sorted(sent) == list(range(N))
    return np.concatenate([sent[n] for n in range(N)])


def _by_node(tree):
    """A tree of [N, ...] leaves as one flat array, node by node, each
    node's leaves in `jax.tree.leaves` order."""
    leaves = [np.asarray(x) for x in jax.tree.leaves(tree)]
    return np.concatenate([x[j].ravel() for j in range(N) for x in leaves])


def _tree_of(flat, like):
    """The inverse of `_by_node`, with `like`'s structure and shapes."""
    leaves, treedef = jax.tree.flatten(like)
    parts, off = [[] for _ in leaves], 0
    for _ in range(N):
        for part, x in zip(parts, leaves):
            shape = np.shape(x)[1:]
            part.append(flat[off:off + int(np.prod(shape))].reshape(shape))
            off += part[-1].size
    return jax.tree.unflatten(treedef, [np.stack(p) for p in parts])


def _digests_agree(runs):
    """The ranks of one node shard (same rows) hold the same parameters."""
    by_rows = {}
    for r in runs:
        assert by_rows.setdefault(r["rows"], r["digest"]) == r["digest"]


@pytest.mark.parametrize("label", [r[0] for r in ME_RUNS],
                         ids=[r[0].replace(" ", "-") for r in ME_RUNS])
def test_driver_runs_match_reference(ranks, label):
    """(a), (b): every rank's membership events, signatures and losses are
    the reference driver's; the stitched parameters and per-node steps
    too, at the sync's bound or, without it, the reference's own noise,
    and Adam's m and v."""
    res, ref, _ = ranks
    js, jhist, events, signatures = _ref_of(ref, label)
    runs = [r["runs"][label] for r in res]
    for run in runs:
        assert run["events"] == events
        assert run["n_active"] == [h["n_active"] for h in jhist]
        assert run["signatures"] == signatures
        for m, jr in zip(run["metrics"], jhist, strict=True):
            for k in ("loss", "ce", "consensus_err"):
                np.testing.assert_allclose(m[k], jr["metrics"][k],
                                           rtol=1e-5, atol=1e-7, err_msg=k)
    if "straggler" in label:
        assert events and events[0] == (1, (0, 1, 3))
    else:
        assert events == [(1, (0, 2, 3)), (2, (0, 1, 2, 3))]
    _digests_agree(runs)
    np.testing.assert_array_equal(_steps(runs), js.opt.step)
    got = [_nodes(runs)]
    lr = _lm_runs()[1].learning_rate
    frac = 0.999
    if "no sync" in label:
        np.testing.assert_array_equal(js.opt.step, [3, 2, 3, 3])
        miss = ref["1x4 no sync", "miss"]
        # the reference's own ulp noise (Adam amplifies float noise into
        # O(lr) moves)
        assert 0 < miss < 0.05, miss
        frac = 1 - 2 * miss
    _agree(got, [_by_node(js.params)], 1e-5, frac=frac, bound=6 * lr)
    for k in ("m", "v"):
        _agree([_nodes(runs, k)], [_by_node(getattr(js.opt, k))], 1e-5,
               frac=0.999, bound=1e-4)


def test_cohort_snapshot_resumes_bit_for_bit(ranks):
    """(c): the snapshot after superstep ME_BACK, taken while node 1 was
    out, restores the cohort and every node's optimizer step; its resume
    rejoins node 1 and ends on the uninterrupted run's bits."""
    res, _, work = ranks
    back = checkpoint.step_dir(os.path.join(work, "snapshots"), ME_BACK)
    for r in res:
        run = r["runs"]["2x2 sync"]
        got = run["resumed"]
        assert got["from"] == back
        a, b = run["rows"]
        assert got["restored"] == ((0, 2, 3), (2, 1, 2, 2)[a:b])
        assert got["events"] == [(ME_BACK, (0, 1, 2, 3))]
        assert got["losses"] == [m["loss"] for m in
                                 run["metrics"][ME_BACK:]]
        assert got["bitwise"]


@pytest.mark.parametrize("label", ["1x4 sync", "2x2 sync"])
def test_publication_under_a_partial_mask(ranks, label):
    """(d): every rank publishes the consensus iterate of the active
    nodes, gathered from its blocks (and all-reduced over the data group
    on 2 x 2): the one-process publication of the stitched state."""
    res, ref, _ = ranks
    runs = [r["runs"][label] for r in res]
    assert len({tuple(r["published_digest"]) for r in runs}) == 1
    whole = convert.lm_params(_tree_of(_nodes(runs), _ref_of(ref, label)[0]
                                       .params), device="cpu", node_axis=True)
    want = trainer.publish_extract(N)(whole, torch.tensor(ME_MASK))
    got = runs[0]["published"]
    for a, b in zip(got, tree_leaves(want), strict=True):
        a, b = a.numpy(), b.numpy()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())


def _rank_mesh(name, rank):
    """Rank `rank` of the mesh `name` names, for the planner."""
    model = MODEL_MESHES[name]
    return dataclasses.replace(abstract_mesh((4 // model, model),
                                             ("data", "model")), rank=rank)


def _blocks(run, mesh):
    """Zero f32 tensors of the shapes of this rank's state (its blocks of
    its node rows)."""
    whole = trainer.replicate_for_nodes(trainer.init_state(
        run, torch.Generator().manual_seed(0)), N)
    spec = trainer.state_placements(run, mesh, whole)
    rows = rdist.node_rows(mesh, N)
    cut = lambda t, sp: (map_tensors(torch.zeros_like, shlib.shard_tree(
        map_tensors(lambda x: x[rows], t), sp, mesh)) if t != () else ())
    opt = whole.opt
    return trainer.TrainState(cut(whole.params, spec.params), opt._replace(
        step=opt.step[rows], m=cut(opt.m, spec.opt.m),
        v=cut(opt.v, spec.opt.v), master=()))


@pytest.mark.parametrize("name", list(MODEL_MESHES))
def test_planned_cohort_and_sync_match_the_ranks(ranks, name):
    """Each rank's cohort step (node 1 out) and rejoin sync send what the
    planner plans for that rank: the node axis's messages and bytes to
    the byte, the model axis's by the trace of the cohort step (its
    all-reduces f32 in both; the plan's bf16 head pieces half the bytes of
    the f32 run's), the sync's data-group all-reduce to the byte (none on
    1 x 4). On the CPU nothing is staged."""
    res, _, _ = ranks
    _, trun = _lm_runs()
    for rank, r in enumerate(res):
        probe = r["probes"][name]
        mesh = _rank_mesh(name, rank)
        state = _blocks(trun, mesh)
        step = probe["step"]
        assert step["stats"]["staged_bytes"] == 0
        node = dryrun.node_axis_collectives(trun, state.params, mesh, N,
                                            membership=COHORT)
        assert dryrun.traced_collectives(step["log"], "data") == node
        sync = dryrun.rejoin_collectives(state, mesh, N)
        assert dryrun.traced_collectives(probe["sync"]["log"]) == sync
        assert probe["sync"]["stats"]["wire_bytes"] == \
            dryrun.staged_bytes(sync)
        if name == "1x4":
            assert node == {} and sync == {}
        else:
            assert sum(v for k, v in node.items() if k.endswith(".count"))
            assert sync["all-reduce.count"] == 1 + len(tree_leaves(
                (state.params, state.opt.m, state.opt.v)))
        assert np.isfinite(probe["loss"])
        if rdist.model_index(mesh):
            continue  # the model group's ranks split its blocks evenly
        rec = dryrun.plan("granite-8b", "train_4k", mesh,
                          averaging="gossip", rounds=2, microbatches=1,
                          cfg=trun.model, n_nodes=N, membership=COHORT,
                          shape=ShapeConfig("t", LM_S, 9, "train"))
        assert rec["temp_unsplit_over_model"] is False
        planned = rec["collectives_model"]
        sent = dryrun.traced_collectives(step["log"], "model")
        assert {k: v for k, v in sent.items() if k.endswith(".count")} == {
            k: v for k, v in planned.items() if k.endswith(".count")}
        assert sent["all-reduce"] == planned["all-reduce"]
        for kind in ("all-gather", "reduce-scatter"):
            assert sent.get(kind, 0) == 2 * planned.get(kind, 0)


@pytest.mark.parametrize("name", list(MODEL_MESHES))
def test_vocab_fallback_matches_reference(ranks, name):
    """The vocab of 513 splits `embed`'s d_model dim: each rank's block
    is [513, 512 / m]; the lookup all-gathers over the model group; the
    gossip steps match the JAX trainer; the split checkpoint restores
    into zeroed blocks bit for bit."""
    res, ref, _ = ranks
    want, want_metrics = ref["vocab"]
    runs = [r["vocab"][name] for r in res]
    model = MODEL_MESHES[name]
    for run in runs:
        assert run["embed"] == (run["rows"][1] - run["rows"][0], ME_VOCAB,
                                512 // model)
        assert ("model", "all-gather") in run["log"]
        assert run["restored"]
        for m, w in zip(run["metrics"], want_metrics, strict=True):
            for k in ("loss", "ce", "consensus_err"):
                np.testing.assert_allclose(m[k], w[k], rtol=1e-5, atol=1e-7,
                                           err_msg=k)
    _digests_agree(runs)
    np.testing.assert_array_equal(_steps(runs), want.opt.step)
    got, want = _nodes(runs), _by_node(want.params)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_vocab_checkpoint_is_the_one_process_file(ranks):
    """The d_model-split `embed` is written as one process writes it: on
    1 x 4 the split checkpoint is byte for byte rank 0's one-process save
    of the gathered state, and each mesh's checkpoint restores on one
    process to the ranks' parameters bit for bit."""
    res, _, work = ranks
    split, one = (os.path.join(work, f) for f in ("vocab_1x4", "vocab_one"))
    la = checkpoint.load_manifest(split)["leaves"]
    assert la == checkpoint.load_manifest(one)["leaves"]
    for entry in la.values():
        assert filecmp.cmp(os.path.join(split, entry["file"]),
                           os.path.join(one, entry["file"]), shallow=False)
    _, tvrun = _lm_runs(ME_VOCAB)
    like = map_tensors(torch.zeros_like, trainer.replicate_for_nodes(
        trainer.init_state(tvrun, torch.Generator().manual_seed(0)), N))
    for name in MODEL_MESHES:
        st = checkpoint.restore(os.path.join(work, f"vocab_{name}"), like,
                                model=tvrun.model)
        got = convert.train_tree(st, tvrun.model)["params"]
        np.testing.assert_array_equal(
            _by_node(got), _nodes([r["vocab"][name] for r in res]))


@pytest.mark.parametrize("mode,match", [
    ("exact", "needs a decentralized node axis"),
    ("hierarchical", "not defined for pod-structured hierarchical"),
])
def test_elastic_refusals_on_a_model_axis(mode, match):
    """The reference refuses elastic membership in the exact and
    hierarchical modes (`repro.train.driver`); so does the port on a
    model axis, before any message."""
    _, trun = _lm_runs()
    run = dataclasses.replace(trun, averaging=AveragingConfig(mode, 2))
    mesh = rdist.Mesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match=match):
        StreamingDriver(run, mesh, None, lm_draw, batch=LM_B, n_nodes=N,
                        device="cpu",
                        faults=faults.FaultSchedule.parse(LM_SPEC, N),
                        engine=EngineConfig(superstep=1, prefetch_depth=0))


@pytest.mark.parametrize("sizes", [(1, 2), (1, 4), (2, 2)],
                         ids=["1x2", "1x4", "2x2"])
def test_cohort_superstep_builds_on_a_model_axis(sizes):
    """A cohort over a model axis builds (it raised until elastic
    membership ran there): it takes the active ids and works on the
    rank's state in place; one is built per cohort size, or per row
    table where the node axis is split."""
    _, trun = _lm_runs()
    build = trainer.superstep_builder(
        trun, rdist.Mesh(sizes, ("data", "model")), n_nodes=N, device="cpu")
    cohort = build(9, Membership.full(N).drop(1))
    assert cohort.takes_ids
    other = build(9, Membership.full(N).drop(2))
    if sizes[0] == 1:
        assert other is cohort
    else:  # node 1 and node 2 lie on different node shards
        assert other is not cohort
        assert build(9, Membership.full(N).drop(0)) is cohort


@pytest.mark.parametrize("mode,sizes", [("gossip", (4, 1)),
                                        ("exact", (2, 2))],
                         ids=["node-axis-only", "exact-mode"])
def test_planner_refuses_a_cohort_it_cannot_trace(mode, sizes):
    """The planner traces a cohort step only for a decentralized run over
    a model axis that the trainer executes; elsewhere a partial membership
    raises instead of planning the full membership's step."""
    _, trun = _lm_runs()
    mesh = abstract_mesh(sizes, ("data", "model"))
    with pytest.raises(ValueError, match="cohort step is traced only"):
        dryrun.build_lowerable("granite-8b", "train_4k", mesh, mode, 2,
                               cfg=trun.model, n_nodes=N,
                               membership=COHORT, microbatches=1,
                               shape=ShapeConfig("t", LM_S, 8, "train"))


def test_gathered_cohort_mixes_by_the_kernel_on_the_card():
    """A cohort layout that the halo rule does not cover (node 1 out on
    2 x 2: one row on the first node shard) gathers its rows; on the
    card's stand-in, the meta device, the gathered rows go through the
    `gossip_mix` kernel's wrapper (its footprint), not the plain roll."""
    from repro_torch.core import mixing
    from repro_torch.kernels import ops

    mesh = abstract_mesh((2, 2), ("data", "model"))
    rows = rdist.cohort_rows(mesh, COHORT)
    sched = mixing.schedule("ring", 3)
    assert ops.node_shard_info(mesh, 3, sched, rows) is None
    op = mixing.circulant_mix_op(sched, 3, 2, mesh=mesh, rows=rows,
                                 device="meta")
    seen = []
    ops.meta_hooks.append(lambda name, flops: seen.append(name))
    try:
        out = op(torch.empty((1, 8), device="meta"))
    finally:
        ops.meta_hooks.pop()
    assert out.shape == (1, 8) and seen == ["gossip_mix"]
