"""Rank code of the port's multi-rank tests (tests/test_torch_shard.py,
tests/test_torch_trainer_dist.py, tests/test_torch_model_axis.py,
tests/test_torch_shard_elastic.py, tests/test_torch_shard_elastic_lm.py);
not collected by pytest.

    python tests/torch_dist_worker.py CASE RANK WORLD STORE OUT [INPUT]

joins a gloo process group of WORLD CPU processes through the FileStore
at STORE (no TCP port, so parallel test workers never collide), builds
`make_host_mesh()` over the ranks (the model-axis cases build their own
meshes with a model axis), runs CASE on this rank's rows and saves its
results to OUT (`torch.save`). INPUT is a file the parent test wrote
(inputs it made with numpy from a seed, or a state converted from the JAX
package's); the ranks import the port only, and the parent holds their
rows against the reference. `spawn` is the parent's side.
"""
import datetime
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT_S = 240  # each rank's deadline; a hung collective fails at 120 s

# the shard rules' cases: tests/shard_worker.py's shape, and HIGHD's mix
N, D, R = 16, 1 << 12, 3
HIGHD_N, HIGHD_D, HIGHD_R = 10, 3072, 8
SMALL_N = 5  # the rules case's uncovered layout (circulant2 over 5 rows)


def spawn(case: str, world: int, tmp_path, inp=None, during=None):
    """Run CASE on `world` ranks and return each rank's results. Every rank
    is joined under a deadline and must exit 0. `during` (optional) is
    called while the ranks run, and then (results, its value) returned."""
    store = tmp_path / f"store_{case}_{world}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        out = tmp_path / f"{case}_{world}_{r}.pt"
        log = open(tmp_path / f"{case}_{world}_{r}.log", "w")
        cmd = [sys.executable, os.path.abspath(__file__), case, str(r),
               str(world), str(store), str(out)]
        if inp is not None:
            cmd.append(str(inp))
        procs.append((subprocess.Popen(cmd, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), out, log))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        extra = during() if during is not None else None
        for p, _, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p, _, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, out, _) in enumerate(procs):
        text = (tmp_path / f"{case}_{world}_{r}.log").read_text()
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text}"
    res = []
    for _, out, _ in procs:
        res.append(torch.load(out, weights_only=False))
        out.unlink()  # loaded: the disk holds every test's tmp until the end
    return res if during is None else (res, extra)


def _rows_of(x: np.ndarray, rows: slice) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x[rows]))


def rules(mesh, inp):
    """The shard rules and the mesh-aware op, consensus error and exact
    average on this rank's rows of inputs made by the parent."""
    from repro_torch.core import averaging, mixing
    from repro_torch.dist import n_data_nodes, node_rows
    from repro_torch.kernels import ops, ref

    data = np.load(inp)
    E = n_data_nodes(mesh)
    rows = node_rows(mesh, N)
    sched = mixing.schedule("ring", N, 0.5)
    x = data["x"]
    res = {"rows": (rows.start, rows.stop),
           "auto_impl": mixing.resolve_auto_impl("cpu", mesh),
           "shard_info": ops.node_shard_info(mesh, N, sched)}
    op = mixing.circulant_mix_op(sched, N, R, mesh=mesh, device="cpu")
    res["op_impl"] = op.impl
    res["exact"] = op(_rows_of(x, rows)).numpy()
    # the port's plain per-round path over the whole axis, this rank's rows
    res["plain"] = ref.gossip_mix_ref(torch.from_numpy(x), sched,
                                      R)[rows].numpy()
    for quant in ("sign", "int8", "int8_stoch"):
        opq = mixing.circulant_mix_op(sched, N, R, quantization=quant,
                                      stats="node", block_d=512, mesh=mesh,
                                      device="cpu")
        res[f"{quant}_impl"] = opq.impl
        res[quant] = opq(_rows_of(x, rows)).numpy()
        # the port's plain per-node version over the whole axis
        res[f"{quant}_plain"] = ref.gossip_mix_quant_ref(
            torch.from_numpy(x), sched, R, quant, block_d=512,
            key=opq._key0(None), per_node=True)[rows].numpy()
    # HIGHD's mix (n = 10, d = 3072, ring R = 8): the rule on every split,
    # even (5 + 5) or not (3 + 3 + 2 + 2)
    hrows = node_rows(mesh, HIGHD_N)
    hs = mixing.schedule("ring", HIGHD_N)
    hop = mixing.circulant_mix_op(hs, HIGHD_N, HIGHD_R, mesh=mesh,
                                  device="cpu")
    res["highd_impl"] = hop.impl
    res["highd"] = hop(_rows_of(data["xh"], hrows)).numpy()
    res["highd_plain"] = ref.gossip_mix_ref(
        torch.from_numpy(data["xh"]), hs, HIGHD_R)[hrows].numpy()
    res["highd_rows"] = (hrows.start, hrows.stop)
    # fused xi + gossip: xi node-local, then the halo rounds
    res["xi_gossip"] = ops.sharded_krasulina_xi_gossip(
        _rows_of(data["w"], rows), _rows_of(data["z"], rows), sched, R,
        mesh).numpy()
    # a layout the rule does not cover: a reach of 2 each way over 5 rows
    # wraps onto the longest shard's own rows (3 + 2 on 2 ranks, 2 + 1 + 1
    # + 1 on 4)
    n_small = SMALL_N
    ss = mixing.schedule("circulant2", n_small)
    small = mixing.circulant_mix_op(ss, n_small, R, mesh=mesh, device="cpu")
    srows = node_rows(mesh, n_small)
    res["small_impl"] = small.impl
    res["small_rows"] = (srows.start, srows.stop)
    res["small"] = small(_rows_of(data["xs"][:n_small], srows)).numpy()
    # the node-axis reductions over ranks
    tree = {"a": _rows_of(data["ta"], rows), "b": _rows_of(data["tb"], rows)}
    res["consensus_err"] = float(averaging.consensus_error(
        tree, mesh=mesh, n_nodes=N))
    res["exact_avg"] = {k: v.numpy() for k, v in
                        averaging.exact_average(tree, mesh, N).items()}
    return res


class FakeClock:
    """Advances `dt` per read."""

    def __init__(self, dt):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def decisions(history):
    """Every per-superstep governor decision of a driver's history."""
    return [(rec["bucket"], rec["plan"].mu, rec["plan"].regime,
             rec.get("target_bucket"), rec.get("bucket_switch"),
             None if "replanned" not in rec else
             (rec["replanned"].B, rec["replanned"].mu,
              rec["replanned"].regime),
             tuple(rec["counters"])) for rec in history]


DRIVER_CASES = [  # (averaging mode, clock dt, buckets)
    ("gossip", 50.0, ()), ("gossip", 1e-4, (50, 100, 200)),
    ("exact", 50.0, ())]


def driver(mesh, inp):
    """tests/test_torch_driver.py's governed PCA driver (FIG7, N = 4, K = 2,
    5 supersteps, ring R = 2) on this rank's rows of the node axis."""
    from repro_torch import convert
    from repro_torch.configs.base import (AveragingConfig, GovernorConfig,
                                          StreamConfig)
    from repro_torch.configs.paper_pca import PCARunConfig
    from repro_torch.core import krasulina, problems
    from repro_torch.data.synthetic import make_pca_host_sampler
    from repro_torch.train.driver import EngineConfig, StreamingDriver

    data = np.load(inp)
    ts = convert.pca_stream(data["cov"], data["sqrt_cov"], data["top"],
                            float(data["lambda1"]), float(data["eigengap"]),
                            device="cpu")
    out = {}
    for mode, dt, buckets in DRIVER_CASES:
        avg = AveragingConfig(mode=mode, rounds=2)
        cfg = PCARunConfig(averaging=avg, stream=StreamConfig(
            streaming_rate=1e3, processing_rate=1e6, comms_rate=1e6))
        build = krasulina.krasulina_superstep_builder(
            avg, 4, lambda t: 10.0 / t, device="cpu", mesh=mesh,
            metric=lambda w: problems.sin2_error(w, ts.top_eigvec))
        with StreamingDriver(
                cfg, mesh, krasulina.init_krasulina_state(
                    data["w0"], avg, 4, device="cpu", mesh=mesh),
                make_pca_host_sampler(ts), superstep_builder=build,
                n_nodes=4, batch=100, seed=3, clock=FakeClock(dt), device="cpu",
                engine=EngineConfig(superstep=2, prefetch_depth=2,
                                    warmup_supersteps=0,
                                    governor=GovernorConfig(
                                        buckets=buckets))) as drv:
            state, hist = drv.run(5)
        out[(mode, dt)] = {"decisions": decisions(hist),
                           "w": state.w.numpy(), "t": state.t,
                           "n_nodes": drv.n_nodes,
                           "metric": [r["metrics"]["metric"] for r in hist]}
    return out


def _local_state(state, rows: slice):
    """This rank's rows of a decentralized TrainState."""
    from repro_torch.core.packing import tree_map

    take = lambda t: t[rows].clone()
    opt = state.opt
    return type(state)(tree_map(take, state.params), opt._replace(
        step=tuple(opt.step[rows]), m=tree_map(take, opt.m),
        v=tree_map(take, opt.v), master=tree_map(take, opt.master),
        ef_residual=tree_map(take, opt.ef_residual)))


def trainer(mesh, inp):
    """The reduced granite trainer on this rank's rows: (1) from the states
    and batches the parent converted from the JAX package's, 3 SGD steps
    per mode, with the messages they sent (`dist.stats`); (2) tests/test_trainer_dist.py's contracts, 12 Adam steps of
    16 x 64 tokens per mode (exact, gossip R = 2, gossip R = 8) from the
    port's own seeded init."""
    from repro_torch import dist as rdist
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
    from repro_torch.core import averaging
    from repro_torch.core.packing import tree_leaves
    from repro_torch.data.lm import MarkovTokenStream
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import n_data_nodes, node_rows
    from repro_torch.train import trainer as tr

    n = n_data_nodes(mesh)
    rows = node_rows(mesh, n)
    given = torch.load(inp, weights_only=False)
    out = {"compare": {}, "contract": {}}
    for mode, case in given.items():
        state, run = case["state"], case["run"]
        decentralized = mode != "exact"
        if decentralized:
            state = _local_state(state, rows)
        step = tr.build_train_step(run, mesh, device="cpu")
        metrics = []
        rdist.reset_stats()
        for b in case["batches"]:  # [B, S] leaves, node split by the rank
            b = {k: torch.from_numpy(v)[None] for k, v in b.items()}
            if decentralized:
                b = tr.make_node_batch(b, n, axis=1)
            b = {k: v[0] for k, v in shard_batch(
                b, mesh, n, node_axis=decentralized).items()}
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        out["compare"][mode] = {
            "params": [p.numpy() for p in tree_leaves(state.params)],
            "step": state.opt.step, "metrics": metrics,
            "wire": dict(rdist.stats)}
    cfg = reduced(get_config("granite-8b"))
    data = MarkovTokenStream(cfg.vocab_size, seed=0)
    for mode, rounds in (("exact", 2), ("gossip", 2), ("gossip", 8)):
        run = RunConfig(model=cfg, shape=SHAPES["train_4k"],
                        averaging=AveragingConfig(mode=mode, rounds=rounds),
                        optimizer="adam", learning_rate=2e-3,
                        param_dtype="float32")
        state = tr.init_state(run, torch.Generator().manual_seed(0))
        if mode != "exact":
            state = tr.replicate_for_nodes(state, rows.stop - rows.start)
        step = tr.build_train_step(run, mesh, device="cpu")
        rng = np.random.default_rng(0)
        losses, cerrs = [], []
        for _ in range(12):
            toks = data.sample(rng, 16, 65)
            b = {"tokens": torch.from_numpy(toks[None, :, :-1]),
                 "labels": torch.from_numpy(toks[None, :, 1:])}
            if mode != "exact":
                b = tr.make_node_batch(b, n, axis=1)
            b = {k: v[0] for k, v in shard_batch(
                b, mesh, n, node_axis=mode != "exact").items()}
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            cerrs.append(float(m["consensus_err"]))
        spread = 0.0
        if mode != "exact":
            spread = float(averaging.consensus_error(
                {"p": tree_leaves(state.params)[0]}, mesh=mesh, n_nodes=n))
        out["contract"][(mode, rounds)] = {
            "losses": losses, "consensus_errs": cerrs,
            "param_spread": spread, "n_nodes": n}
    return out


def _state_bytes(state) -> int:
    """The bytes of a TrainState's tensors on this rank."""
    from repro_torch.core.packing import tree_leaves

    opt = state.opt
    return sum(t.numel() * t.element_size()
               for tree in (state.params, opt.m, opt.v, opt.master)
               if tree != () for t in tree_leaves(tree))


def model_layers(mesh, inp):
    """tests/test_torch_model_axis.py (a): each arch's loss and gradients
    on a model axis of 2, with and without remat (`_layer_grads`)."""
    from repro_torch.launch.mesh import make_host_mesh

    return _layer_grads(torch.load(inp, weights_only=False),
                        make_host_mesh(model=mesh.size), (True, False))


def _layer_grads(given, mesh, remats, lean=False):
    """Each case's loss and gradients on `mesh`'s model axis, from the
    reference's parameters cut to this rank's blocks
    (`convert.lm_params(mesh=...)`), under each of `remats`; the
    gradients gathered whole again (`gather_tree`; with `lean`, on rank 0
    only, and their `digest` on every rank), and the model axis's
    messages of the loss and its gradient (`dist.log`)."""
    from repro_torch import convert, dist as rdist
    from repro_torch.core.packing import tree_leaves, tree_map
    from repro_torch.launch import sharding as shlib
    from repro_torch.models import registry
    from repro_torch.models.common import mesh_rules
    from repro_torch.train.trainer import rest_specs

    out = {}
    for arch, case in given.items():
        cfg = case["cfg"]
        local = convert.lm_params(case["tree"], device="cpu", mesh=mesh,
                                  cfg=cfg)
        spec = rest_specs(cfg, mesh, exact=False)
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        for remat in remats:
            live = [p.detach().requires_grad_() for p in tree_leaves(local)]
            it = iter(live)
            params = tree_map(lambda _: next(it), local)
            rdist.reset_stats()
            with mesh_rules(mesh):
                loss, metrics = registry.loss_fn(params, cfg, batch,
                                                 remat=remat)
                grads = torch.autograd.grad(loss, live)
            log = {k: list(v) for k, v in rdist.log.items()}
            it = iter(grads)
            whole = shlib.gather_tree(tree_map(lambda _: next(it), local),
                                      spec, mesh)
            grads = [g.numpy() for g in tree_leaves(whole)]
            out[(arch, remat)] = {
                "loss": float(loss), "ce": float(metrics["ce"]),
                "grads": None if lean and mesh.rank else grads,
                "digest": digest(grads), "log": log}
    return out


def digest(arrays) -> list:
    """The CRC32 of each array's bytes: a rank's copy of leaves held
    against another's, bit for bit, without sending them."""
    import zlib

    return [zlib.crc32(np.ascontiguousarray(a).tobytes()) for a in arrays]


def np_leaves(tree) -> list:
    """The numpy leaves of a tree of dicts (keys sorted) and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in np_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in np_leaves(t)]
    return [tree]


MODEL_MESHES = {"1x4": 4, "2x2": 2}  # mesh name -> model extent


def model_trainer(mesh, inp):
    """tests/test_torch_model_axis.py (b), (c): `_trainer_runs` of the
    parent's cases."""
    return _trainer_runs(torch.load(inp, weights_only=False))


def _trainer_runs(given, lean=False):
    """The reduced granite trainer on 1 x 4 and 2 x 2 meshes, from the
    reference's states cut to this rank's blocks
    (`convert.train_state(mesh=...)`), 3 SGD steps per mode; its bytes at
    rest and each step's messages by axis (`dist.stats`); the final state
    gathered over the model axis (`convert.train_tree(mesh=...)`: the node
    rows stay the rank's), and where every node is local what
    `publish_extract` serves from it. With `lean` the gathered parameters
    come back from model index 0 only (their `digest` from every rank),
    and nothing is published."""
    from repro_torch import convert, dist as rdist
    from repro_torch.core.packing import tree_leaves
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import node_rows
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import trainer as tr

    meshes = {name: make_host_mesh(model=m)
              for name, m in MODEL_MESHES.items()}
    out = {}
    for (name, mode), case in given.items():
        mesh, run = meshes[name], case["run"]
        n = case["n_nodes"]
        decentralized = mode != "exact"
        state = convert.train_state(*case["state"], run.model, device="cpu",
                                    mesh=mesh)
        if decentralized:
            state = _local_state(state, node_rows(mesh, n))
        at_rest = _state_bytes(state)
        step = tr.build_train_step(run, mesh, n_nodes=n, device="cpu")
        metrics, wires = [], []
        for b in case["batches"]:  # [B, S] leaves
            b = {k: torch.from_numpy(v)[None] for k, v in b.items()}
            if decentralized:
                b = tr.make_node_batch(b, n, axis=1)
            b = {k: v[0] for k, v in shard_batch(
                b, mesh, n, node_axis=decentralized).items()}
            rdist.reset_stats()
            state, m = step(state, b)
            wires.append(dict(rdist.stats))
            metrics.append({k: float(v) for k, v in m.items()})
        tree = convert.train_tree(state, run.model, mesh)
        published = None
        if rdist.n_data_nodes(mesh) == 1 and not lean:  # every node here
            extract = tr.publish_extract(None if mode == "exact" else n,
                                         run=run, mesh=mesh)
            published = [p.numpy() for p in tree_leaves(extract(
                state, torch.ones(n)))]
        first = rdist.model_index(mesh) == 0
        out[(name, mode)] = {
            "published": published,
            "params": tree["params"] if first or not lean else None,
            "digest": digest(np_leaves(tree["params"])),
            "step": state.opt.step,
            "metrics": metrics, "wire": wires, "at_rest": at_rest,
            "rows": (node_rows(mesh, n).start, node_rows(mesh, n).stop),
            "model_index": rdist.model_index(mesh)}
    return out


def model_heads(mesh, inp):
    """tests/test_torch_model_axis_heads.py: (a) each head case's loss and
    gradients on 1 x world, with remat (`_layer_grads`); (b), (c) the
    trainer cases (`_trainer_runs`)."""
    from repro_torch.launch.mesh import make_host_mesh

    given = torch.load(inp, weights_only=False)
    return {"layers": _layer_grads(given["layers"],
                                   make_host_mesh(model=mesh.size), (True,),
                                   lean=True),
            "trainer": _trainer_runs(given["trainer"], lean=True)}


def _blocks(state, run, mesh, rows=None):
    """This rank's blocks of a whole TrainState of `run` over `mesh`'s
    model axis (its `rows` of the node axis first)."""
    from repro_torch.launch import sharding as shlib
    from repro_torch.train import trainer as tr

    specs = tr.state_placements(run, mesh, state)
    if rows is not None:
        state = _local_state(state, rows)
    cut = lambda tree, spec: (shlib.shard_tree(tree, spec, mesh)
                              if tree != () else tree)
    opt = state.opt
    return tr.TrainState(cut(state.params, specs.params), opt._replace(
        m=cut(opt.m, specs.opt.m), v=cut(opt.v, specs.opt.v),
        master=cut(opt.master, specs.opt.master)))


def _whole(state, run, mesh):
    """A rank's TrainState gathered over the model axis (and the exact
    mode's data axis): {"leaves": numpy leaves of the parameters and the
    moments in `tree_leaves` order, on rank 0 only, "digest": theirs, on
    every rank}, the node rows the rank's."""
    from repro_torch.core.packing import tree_leaves
    from repro_torch.launch import sharding as shlib
    from repro_torch.train import trainer as tr

    specs = tr.state_placements(run, mesh, state)
    opt = state.opt
    leaves = [t.numpy() for tree, spec in ((state.params, specs.params),
                                           (opt.m, specs.opt.m),
                                           (opt.v, specs.opt.v))
              for t in tree_leaves(shlib.gather_tree(tree, spec, mesh))]
    return {"leaves": None if mesh.rank else leaves,
            "digest": digest(leaves)}


# tests/test_torch_model_axis_durability.py: (mode, mesh name) of the
# driver runs, MD_SUPERSTEPS of one round, a blocking snapshot after each;
# the resume from the snapshot after MD_BACK, on the same mesh, and the
# restore of that snapshot onto the other mesh
MD_RUNS = (("exact", "2x2"), ("gossip", "1x4"))
MD_SUPERSTEPS, MD_BACK = 3, 2


def _md_driver(mesh, run, state, root, resume=None):
    """The reduced granite trainer (Adam) through the driver on this
    rank's blocks, DUR_N nodes, K = 1, no prefetch, open loop, a blocking
    snapshot every superstep under `root` (None: none)."""
    from repro_torch.train.driver import EngineConfig, StreamingDriver
    from repro_torch.train.snapshot import RunSnapshotter

    snap = (RunSnapshotter(root, every=1, keep_last=10, block=True,
                           overhead_budget=0.0) if root else None)
    return StreamingDriver(
        run, mesh, state, lambda rng, n: lm_draw(rng, n, DUR_S),
        batch=DUR_B, n_nodes=DUR_N, device="cpu", snapshotter=snap,
        resume_from=resume,
        engine=EngineConfig(superstep=1, prefetch_depth=0, replan_every=0))


def model_durability(mesh, inp):
    """tests/test_torch_model_axis_durability.py, per MD_RUNS case: the
    driver uninterrupted with its snapshots; the state gathered, and
    rank 0's one-process save of it beside the last snapshot; the resume
    from the snapshot at MD_BACK on the same mesh; and that snapshot
    restored onto the other mesh (into zeroed blocks), gathered, then
    saved there as a split checkpoint of its own."""
    import torch.distributed as dist

    from repro_torch import dist as rdist
    from repro_torch.core.packing import map_tensors
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import checkpoint, trainer as tr

    given = torch.load(inp, weights_only=False)
    work = given["work"]
    meshes = {name: make_host_mesh(model=m)
              for name, m in MODEL_MESHES.items()}
    out = {}
    for mode, name in MD_RUNS:
        run, whole = given[mode]
        mesh = meshes[name]
        node = mode != "exact"
        rows = rdist.node_rows(mesh, DUR_N) if node else None
        root = os.path.join(work, f"{mode}_{name}")
        with _md_driver(mesh, run, _blocks(whole, run, mesh, rows),
                        root) as drv:
            st, hist = drv.run(MD_SUPERSTEPS)
            res = {"losses": [r["metrics"]["loss"] for r in hist],
                   "saves": drv._snapshotter.stats.saves,
                   "failures": drv._snapshotter.stats.failures,
                   "error": drv._snapshotter.stats.last_error,
                   "state": _whole(st, run, mesh), "model_index":
                   rdist.model_index(mesh),
                   "rows": None if rows is None else (rows.start, rows.stop)}
        final = st
        # rank 0's one-process save of the gathered state (every node's
        # rows: on 1 x 4 they are all local)
        gathered = _gather_state(final, run, mesh)
        if mesh.rank == 0:
            checkpoint.save(os.path.join(work, f"{mode}_one"), gathered,
                            step=MD_SUPERSTEPS, model=run.model)
        dist.barrier()
        # the resume on the same mesh, from zeroed blocks
        zero = map_tensors(torch.zeros_like, _blocks(whole, run, mesh, rows))
        with _md_driver(mesh, run, zero, None, resume=checkpoint.step_dir(
                root, MD_BACK)) as drv:
            st, hist = drv.run(MD_SUPERSTEPS - MD_BACK)
            res["resumed"] = {
                "from": drv.resumed_from,
                "losses": [r["metrics"]["loss"] for r in hist],
                "bitwise": st.opt.step == final.opt.step and all(
                    torch.equal(a, b) for a, b in zip(
                        _tensors_of(st), _tensors_of(final), strict=True))}
        # the snapshot at MD_BACK onto the other mesh, and saved there
        other = [n for n in meshes if n != name][0]
        omesh = meshes[other]
        orows = rdist.node_rows(omesh, DUR_N) if node else None
        like = map_tensors(torch.zeros_like,
                           _blocks(whole, run, omesh, orows))
        back = checkpoint.step_dir(root, MD_BACK)
        restored = checkpoint.restore(
            back, like, model=run.model, into=True, mesh=omesh,
            n_nodes=DUR_N if node else None,
            specs=tr.state_placements(run, omesh, like))
        res["other"] = {"mesh": other, "state": _whole(restored, run, omesh),
                        "rows": None if orows is None
                        else (orows.start, orows.stop),
                        "model_index": rdist.model_index(omesh)}
        checkpoint.save(os.path.join(work, f"{mode}_{other}"), restored,
                        step=MD_BACK, model=run.model, mesh=omesh,
                        n_nodes=DUR_N if node else None,
                        specs=tr.state_placements(run, omesh, restored))
        out[mode] = res
    return out


def _tensors_of(state):
    """A TrainState's tensors, in `tree_leaves` order of each tree."""
    from repro_torch.core.packing import tree_leaves

    opt = state.opt
    return [t for tree in (state.params, opt.m, opt.v, opt.master)
            if tree != () for t in tree_leaves(tree)]


def _gather_state(state, run, mesh):
    """A rank's TrainState with its blocks gathered over the model axis
    (and the exact mode's data axis): the state one process holds, where
    every node's rows are the rank's."""
    from repro_torch import dist as rdist
    from repro_torch.launch import sharding as shlib
    from repro_torch.train import trainer as tr

    specs = tr.state_placements(run, mesh, state)
    assert run.averaging.mode == "exact" or not rdist.is_sharded(mesh)
    join = lambda tree, spec: (shlib.gather_tree(tree, spec, mesh)
                               if tree != () else tree)
    opt = state.opt
    return tr.TrainState(join(state.params, specs.params), opt._replace(
        m=join(opt.m, specs.opt.m), v=join(opt.v, specs.opt.v),
        master=join(opt.master, specs.opt.master)))


# ---------------------------------------------------------------------------
# Elastic membership on the split node axis (tests/test_torch_shard_elastic*)
# ---------------------------------------------------------------------------

# the cohort shard rules: (label, N, dropped nodes, topology, whether the
# halo rule covers the cohort's split) per world size; every case
# R = COHORT_R rounds over [m, COHORT_D] rows
COHORT_CASES = {
    2: [("uneven", 5, (), "ring", True),          # 3 + 2 rows
        ("node 0 out", 5, (0,), "ring", True),     # 2 + 2
        # 3 + 0: the ring over the 3 rows of one rank wraps onto them
        ("a rank out", 5, (3, 4), "ring", False),
        ("reach wraps", 10, (3, 4), "circulant2", False)],  # 3 + 5
    4: [("uneven", 10, (), "ring", True),         # 3 + 3 + 2 + 2
        ("node 0 out", 10, (0,), "ring", True),    # 2 + 3 + 2 + 2
        ("nodes 3, 4 out", 10, (3, 4), "ring", True),   # 3 + 1 + 2 + 2
        ("a rank out", 10, (6, 7), "ring", True),  # 3 + 3 + 0 + 2
        ("reach over a short shard", 10, (3, 4), "circulant2", True)],
}
COHORT_R, COHORT_D = 3, 1024
COHORT_WIRES = ("sign", "int8", "int8_stoch")
SCN_T = (1, 2, 3, 5)  # the rounds of the scheduled op's tables checked


def cohort_inputs(label: str, m: int):
    """The seeded numpy rows of a cohort case: x [m, D], w [m, 256] and
    z [m, 8, 256] for the fused xi + gossip."""
    rng = np.random.default_rng(sum(map(ord, label)) + m)
    return (rng.standard_normal((m, COHORT_D)).astype(np.float32),
            rng.standard_normal((m, 256)).astype(np.float32),
            rng.standard_normal((m, 8, 256)).astype(np.float32))


def scenario_inputs():
    return np.random.default_rng(11).standard_normal((8, 96)).astype(
        np.float32)


def cohort_rules(mesh, inp=None):
    """The shard rules over cohorts on this rank's active rows: every
    wire of the circulant op built with the cohort's row table, the fused
    xi + gossip, the cohort's reductions, and the port's plain per-round
    path over the m cohort rows; then a scenario's scheduled op and a
    dense op on a split axis, against the one-process op."""
    from repro_torch import dist as rdist
    from repro_torch.core import averaging, mixing, scenarios
    from repro_torch.core.mixing import Membership
    from repro_torch.kernels import ops, ref

    E = rdist.n_data_nodes(mesh)
    out = {}
    for label, n, dropped, topo, _ in COHORT_CASES[E]:
        mem = Membership.full(n).drop(*dropped)
        m = mem.n_active
        table = rdist.cohort_rows(mesh, mem)
        a, b = table[rdist.node_index(mesh)]
        x, w, z = cohort_inputs(label, m)
        sched = mixing.schedule(topo, m)
        mine = lambda v: torch.from_numpy(np.ascontiguousarray(v[a:b]))
        res = {"table": table, "rows": (a, b), "m": m, "sched": sched,
               "local_ids": rdist.local_ids(mesh, mem)}
        op = mixing.circulant_mix_op(sched, m, COHORT_R, mesh=mesh,
                                     rows=table, device="cpu")
        res["impl"] = op.impl
        res["exact"] = op(mine(x)).numpy()
        res["exact_plain"] = ref.gossip_mix_ref(torch.from_numpy(x), sched,
                                                COHORT_R)[a:b].numpy()
        for quant in COHORT_WIRES:
            opq = mixing.circulant_mix_op(sched, m, COHORT_R,
                                          quantization=quant, stats="node",
                                          block_d=512, mesh=mesh, rows=table,
                                          device="cpu")
            res[quant] = opq(mine(x)).numpy()
            res[quant + "_plain"] = ref.gossip_mix_quant_ref(
                torch.from_numpy(x), sched, COHORT_R, quant, block_d=512,
                key=opq._key0(None), per_node=True)[a:b].numpy()
        if op.impl == "shard":
            res["xi_gossip"] = ops.sharded_krasulina_xi_gossip(
                mine(w), mine(z), sched, COHORT_R, mesh, table).numpy()
        tree = {"x": mine(x), "w": mine(w)}
        res["consensus_err"] = float(averaging.consensus_error(
            tree, mesh=mesh, n_nodes=m))
        # a dense op over the cohort (its ring's matrix) on the split axis
        dense = mixing.dense_mix_op(mixing.ring_matrix(m), COHORT_R,
                                    mesh=mesh, rows=table, device="cpu")
        res["dense"] = dense(mine(x)).numpy()
        out[label] = res
    # a scenario's time-varying operator (ring/lossy/iid_pca, n = 8) on the
    # even split of its 8 rows, against the one-process op's rows
    scn = scenarios.get_scenario("ring/lossy/iid_pca")
    xs = scenario_inputs()
    rows = rdist.node_rows(mesh, scn.n_nodes)
    split = scenarios.build_mix(scn, device="cpu", mesh=mesh)
    whole = scenarios.build_mix(scn, device="cpu")
    out["scheduled"] = {
        "rows": (rows.start, rows.stop),
        "got": [split(torch.from_numpy(xs[rows]), t=t).numpy()
                for t in SCN_T],
        "one_process": [whole(torch.from_numpy(xs), t=t)[rows].numpy()
                        for t in SCN_T]}
    return out


# the PCA driver's elastic cases on 2 ranks: (fault spec, governor, supersteps)
PCA_CASES = {
    "death rejoin": ("death:4@2-5", {}, 8),
    "death rejoin, no sync": ("death:1@1-3", {"sync_on_rejoin": False}, 5),
    "flaky share a cohort": ("flaky:1@1-7p2,death:3@7-9", {}, 10),
    "a rank out": ("death:3@2-5,death:4@3-6", {}, 7),
    "straggler drop": ("slow:0@2-14x10", {"straggler_policy": "drop",
                                          "straggler_slow_factor": 2.0,
                                          "straggler_patience": 2}, 24),
    "deadline": ("slow:2@1-6x4", {"straggler_policy": "deadline",
                                  "straggler_deadline_s": 1e-3}, 8),
}
PCA_N, PCA_B, PCA_K = 5, 10, 2
SCENARIO_CASES = ("ring/lossy/iid_pca", "tv_rte/ratelimited/drift_pca")


def plan_json(p):
    return None if p is None else p.to_json()


def events(drv):
    """A driver's membership events as comparable tuples."""
    return [(e["superstep"], None if e["from"] is None else e["from"].active,
             e["to"].active, plan_json(e["plan"]))
            for e in drv.membership_events]


def records(drv):
    """A driver's per-superstep records as comparable tuples."""
    return [(r["bucket"], r["n_active"], plan_json(r["plan"]),
             plan_json(r.get("replanned")), r.get("bw_factor"),
             r.get("link_drops"), tuple(r["counters"]))
            for r in drv.history]


def _pca_run(mesh, w0, n, sample, *, spec=None, gov=None,
             supersteps=8, mix=None, faults=None):
    """One elastic PCA driver run on this rank's rows (ring R = 2,
    K = PCA_K, no prefetch, a re-plan each superstep on a fake clock):
    what tests/test_torch_shard_elastic.py's `_same` compares."""
    from repro_torch.configs.base import (AveragingConfig, GovernorConfig,
                                          StreamConfig)
    from repro_torch.configs.paper_pca import PCARunConfig
    from repro_torch.core import faults as tfaults
    from repro_torch.core import krasulina
    from repro_torch.dist import node_rows
    from repro_torch.train.driver import EngineConfig, StreamingDriver

    rows = node_rows(mesh, n)
    cfg = PCARunConfig(averaging=AveragingConfig(mode="gossip", rounds=2),
                       stream=StreamConfig())
    if spec:
        faults = tfaults.FaultSchedule.parse(spec, n)
    eng = EngineConfig(superstep=PCA_K, prefetch_depth=0, replan_every=1,
                       warmup_supersteps=0, warmup_per_bucket=0,
                       governor=GovernorConfig(**(gov or {})))
    with StreamingDriver(
            cfg, mesh, krasulina.init_krasulina_state(
                w0, cfg.averaging, n, device="cpu", mesh=mesh),
            sample, n_nodes=n, batch=PCA_B if n == PCA_N else 2 * n,
            seed=1, superstep_builder=krasulina.krasulina_superstep_builder(
                cfg.averaging, n, lambda t: 10.0 / t, mix=mix, device="cpu",
                mesh=mesh),
            faults=faults, clock=FakeClock(1e-3), device="cpu",
            engine=eng) as drv:
        state, _ = drv.run(supersteps)
    return {"events": events(drv), "signatures": drv.compiled_signatures,
            "records": records(drv),
            "keys": [sorted(r) for r in drv.history],
            "consensus_err": [r["metrics"]["consensus_err"]
                              for r in drv.history],
            "w": state.w.numpy(), "t": state.t,
            "rows": (rows.start, rows.stop)}


def elastic_driver(mesh, inp):
    """The governed PCA driver with elastic membership (FIG7, N = 5, ring
    R = 2, K = 2) and two registered scenarios (N = 8) on this rank's rows,
    from the reference's stream the parent saved."""
    from repro_torch import convert
    from repro_torch.core import scenarios
    from repro_torch.data.synthetic import make_pca_host_sampler

    data = np.load(inp)
    ts = convert.pca_stream(data["cov"], data["sqrt_cov"], data["top"],
                            float(data["lambda1"]), float(data["eigengap"]),
                            device="cpu")
    out = {}
    for name, (spec, gov, steps) in PCA_CASES.items():
        out[name] = _pca_run(mesh, data["w0"], PCA_N,
                             make_pca_host_sampler(ts), spec=spec, gov=gov,
                             supersteps=steps)
    for name in SCENARIO_CASES:
        scn = scenarios.get_scenario(name)
        stream = scenarios.build_stream(scn, pca=ts)
        out[name] = _pca_run(
            mesh, data["w0"], scn.n_nodes, stream.sample, supersteps=6,
            mix=scenarios.build_mix(scn, device="cpu", mesh=mesh),
            faults=scenarios.fault_schedule(scn))
    return out


# the LM trainer's elastic runs on 4 ranks x 1 node (reduced granite-8b,
# f32, Adam): (label, quantization, rejoin sync)
LM_RUNS = [("gossip sync", "none", True), ("gossip no sync", "none", False),
           ("int8 sync", "int8", True)]
LM_SPEC, LM_SUPERSTEPS, LM_B, LM_S = "death:1@1-2", 3, 8, 32
# the planner's probes of one cohort step (4 ranks x 1 node, node 1 out,
# unless full): (label, quantization, statistics, scheduled, dropped)
PLAN_PROBES = [("halo", "none", "global", False, (1,)),
               ("int8 node halo", "int8", "node", False, (1,)),
               ("int8 node full", "int8", "node", False, ()),
               ("int8 tile gather", "int8", "tile", False, (1,)),
               ("scheduled gather", "none", "global", True, ())]


def lm_draw(rng, n, seq=LM_S):
    """tests/test_torch_trainer.py's `_draw`: Markov tokens and labels."""
    from repro_torch.data.lm import MarkovTokenStream

    toks = MarkovTokenStream(512, seed=0).sample(rng, n, seq + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def elastic_trainer(mesh, inp):
    """(1) the reduced granite trainer under `death:1@1-2` through the
    StreamingDriver on this rank's node (`LM_RUNS`), from the state the
    parent converted from the JAX package's; (2) the planner's probes: one
    cohort or scenario step's messages (`dist.stats`); (3) the last three
    families on ranks 0 and 1 (2 nodes, gossip, self weight 0.6), 2 steps
    from the converted states and batches."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import convert, dist as rdist
    from repro_torch.configs.base import AveragingConfig, GovernorConfig
    from repro_torch.core import faults, scenarios
    from repro_torch.core.mixing import Membership
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import trainer as tr
    from repro_torch.train.driver import EngineConfig, StreamingDriver

    given = torch.load(inp, weights_only=False)
    rows = rdist.node_rows(mesh, 4)
    out = {"runs": {}, "probes": {}, "families": {}}
    for label, quant, sync in LM_RUNS:
        run = given["runs"][label]
        state = _local_state(given["state"], rows)
        with StreamingDriver(
                run, mesh, state, lambda rng, n: lm_draw(rng, n),
                batch=LM_B, n_nodes=4, device="cpu",
                faults=faults.FaultSchedule.parse(LM_SPEC, 4),
                engine=EngineConfig(superstep=1, prefetch_depth=0,
                                    replan_every=0,
                                    governor=GovernorConfig(
                                        sync_on_rejoin=sync))) as drv:
            state, hist = drv.run(LM_SUPERSTEPS)
        out["runs"][label] = {
            "events": [(e["superstep"], e["to"].active_ids)
                       for e in drv.membership_events],
            "n_active": [r["n_active"] for r in hist],
            "metrics": [r["metrics"] for r in hist],
            "tree": convert.train_tree(state, run.model),
            "rows": (rows.start, rows.stop)}
    # (2) the planner's probes
    base = given["runs"]["gossip sync"]
    rng = np.random.default_rng(3)
    for label, quant, stats, scheduled, dropped in PLAN_PROBES:
        run = dataclasses.replace(base, averaging=dataclasses.replace(
            base.averaging, quantization=quant, quant_stats=stats))
        mem = Membership.full(4).drop(*dropped)
        mix = None
        if scheduled:
            scn = dataclasses.replace(
                scenarios.get_scenario("ring/lossy/iid_pca"), n_nodes=4)
            mix = scenarios.build_mix(scn, device="cpu", mesh=mesh)
            run = dataclasses.replace(run, averaging=scenarios
                                      .averaging_config(scn))
        fn = tr.superstep_builder(run, mesh, n_nodes=4, mix=mix,
                                  device="cpu")(8, mem)
        batch = tr.make_node_batch(
            {k: torch.from_numpy(v)[None] for k, v in
             lm_draw(rng, 8 if mem.is_full else 9).items()},
            mem.n_active, axis=1)
        batch = shard_batch(batch, mesh, 4, node_axis=True, membership=mem)
        state = _local_state(given["state"], rows)
        rdist.reset_stats()
        if mem.is_full:
            fn(state, batch)
        else:
            fn(state, rdist.local_ids(mesh, mem), batch)
        out["probes"][label] = {"wire": dict(rdist.stats),
                                "log": {k: list(v) for k, v in
                                        rdist.log.items()}}
    # (3) the last three families on a 2-rank subgroup
    pair = dist.new_group([0, 1])
    if mesh.rank < 2:
        mesh2 = make_host_mesh(group=pair)
        rows2 = rdist.node_rows(mesh2, 2)
        for arch, case in given["families"].items():
            run = case["run"]
            state = _local_state(case["state"], rows2)
            step = tr.build_train_step(run, mesh2, n_nodes=2, device="cpu")
            metrics = []
            for b in case["batches"]:  # [2, B/2, ...] node batches
                state, m = step(state, {k: torch.from_numpy(v[rows2])
                                        for k, v in b.items()})
                metrics.append({k: float(v) for k, v in m.items()})
            out["families"][arch] = {
                "metrics": metrics, "tree": convert.train_tree(state,
                                                               run.model),
                "rows": (rows2.start, rows2.stop)}
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# Error feedback and the hierarchical mode on the split node axis
# (tests/test_torch_shard_ef.py)
# ---------------------------------------------------------------------------

EF_WIRES = ("sign", "int8", "int8_stoch")
EF_N, EF_UNEVEN_N, EF_DROPPED = 4, 5, 2
# the uneven split's error-feedback column chunks: 2^18 // 5 // 64 * 64 =
# 52,416 columns from the full node count, 24 chunks of a node's 1.25 M
# (from a rank's 3 or 2 rows: 87,360 or 131,072, and the ranks' halo
# messages would not pair up)
UNEVEN_CHUNK_ENTRIES = 1 << 18
# the hierarchical mode at n_nodes = 4 on a ("pod", "data", "model") =
# (2, 2, 1) mesh: (label, wire, tile width); a 100-column tile does not
# divide a lane's block, so its wire gathers the blocks
HIER_CASES = [("exact", "none", 64), ("int8 lanes", "int8", 64),
              ("int8 gathered", "int8", 100),
              ("int8_stoch", "int8_stoch", 64)]
# and at n_nodes = 8, two rows a rank: a pod's sum then spans each lane's
# rows and the lanes (held bit for bit against one process only)
HIER_K2_CASES = [("exact k=2", "none", 64), ("int8 lanes k=2", "int8", 64)]
HIER_K2_N = 8
HIER_MESH = ((2, 2, 1), ("pod", "data", "model"))


def _wires(step_fn):
    """Run step_fn() with `dist.stats` and `dist.log` reset: (result, its
    messages)."""
    from repro_torch import dist as rdist

    rdist.reset_stats()
    res = step_fn()
    return res, {"stats": dict(rdist.stats),
                 "log": {k: list(v) for k, v in rdist.log.items()}}


def _steps(run, mesh, state, batches, n, rows, **kw):
    """`batches` ([n, B/n, ...] numpy node batches) through the trainer's
    step on this rank's rows: (state, metrics, each step's messages)."""
    from repro_torch.train import trainer as tr

    step = tr.build_train_step(run, mesh, n_nodes=n, device="cpu", **kw)
    metrics, wires = [], []
    for b in batches:
        (state, m), w = _wires(lambda: step(state, {
            k: torch.from_numpy(np.ascontiguousarray(v[rows]))
            for k, v in b.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
        wires.append(w)
    return state, metrics, wires


def shard_ef(mesh, inp):
    """Error feedback (every wire of EF_WIRES) on this rank's rows of the
    reduced granite trainer: at full membership (n = EF_N), in a cohort
    (node EF_DROPPED out, one K-round superstep) and, on 2 ranks, on the
    uneven split n = EF_UNEVEN_N; on 4 ranks the hierarchical mode on a
    HIER_MESH mesh (HIER_CASES, HIER_K2_CASES). From the states and
    batches the parent
    made; each result the rank's tree (`convert.train_tree`), metrics and
    messages."""
    from repro_torch import convert, dist as rdist
    from repro_torch.core import averaging
    from repro_torch.core.mixing import Membership
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import trainer as tr

    given = torch.load(inp, weights_only=False)
    E = rdist.n_data_nodes(mesh)
    out = {"ef": {}, "cohort": {}, "uneven": {}, "hier": {}}
    rows = rdist.node_rows(mesh, EF_N)
    span = (rows.start, rows.stop)
    for wire in EF_WIRES:
        case = given["ef"][wire]
        run = case["run"]
        st, metrics, wires = _steps(run, mesh,
                                    _local_state(case["state"], rows),
                                    case["batches"], EF_N, rows)
        out["ef"][wire] = {"tree": convert.train_tree(st, run.model),
                           "rows": span, "metrics": metrics,
                           "wires": wires}
        # the cohort: one superstep of K rounds with node EF_DROPPED out
        mem = Membership.full(EF_N).drop(EF_DROPPED)
        fn = tr.superstep_builder(run, mesh, n_nodes=EF_N, device="cpu")(
            case["B"], mem)
        batch = shard_batch({k: torch.from_numpy(v) for k, v in
                             case["cohort_batches"].items()}, mesh, EF_N,
                            node_axis=True, membership=mem)
        (st, m), w = _wires(lambda: fn(_local_state(case["state"], rows),
                                       rdist.local_ids(mesh, mem), batch))
        out["cohort"][wire] = {"tree": convert.train_tree(st, run.model),
                               "rows": span,
                               "table": rdist.cohort_rows(mesh, mem),
                               "loss": m["loss"].numpy(), "wires": [w]}
        if E == 2:
            urows = rdist.node_rows(mesh, EF_UNEVEN_N)
            whole = averaging.EF_CHUNK_ENTRIES
            averaging.EF_CHUNK_ENTRIES = UNEVEN_CHUNK_ENTRIES
            st, metrics, wires = _steps(
                run, mesh, _local_state(case["uneven_state"], urows),
                case["uneven_batches"], EF_UNEVEN_N, urows)
            averaging.EF_CHUNK_ENTRIES = whole
            out["uneven"][wire] = {"tree": convert.train_tree(st,
                                                              run.model),
                                   "rows": (urows.start, urows.stop),
                                   "metrics": metrics, "wires": wires}
    if E == 4:
        pmesh = make_mesh(*HIER_MESH)
        for label, case in given["hier"].items():
            run = case["run"]
            prow = rdist.node_rows(pmesh, case["n"])
            st, metrics, wires = _steps(run, pmesh,
                                        _local_state(case["state"], prow),
                                        case["batches"], case["n"], prow)
            out["hier"][label] = {"tree": convert.train_tree(st, run.model),
                                  "rows": (prow.start, prow.stop),
                                  "metrics": metrics, "wires": wires}
    return out


# ---------------------------------------------------------------------------
# Snapshots, resume and publication on the split node axis
# (tests/test_torch_shard_durability.py), on 2 ranks
# ---------------------------------------------------------------------------

DUR_N, DUR_B, DUR_S = 4, 8, 32
DUR_SUPERSTEPS, DUR_BACK = 4, 2  # resumed from the snapshot at DUR_BACK
DUR_PCA_N, DUR_PCA_SPEC, DUR_PCA_SUPERSTEPS = 4, "death:3@2-4", 6
DUR_SAVE_STEP = 7


def _lm_driver(mesh, run, state, root, *, mix=None, resume=None,
               publisher=None, every=1):
    """The reduced granite trainer (gossip, Adam) through the driver on
    this rank's rows of DUR_N nodes (mesh None: every row, its operator
    `mix`), K = 1, no prefetch, open loop, a blocking snapshot every
    `every` supersteps under `root` (None: none)."""
    from repro_torch.train import trainer as tr
    from repro_torch.train.driver import EngineConfig, StreamingDriver
    from repro_torch.train.snapshot import RunSnapshotter

    snap = (RunSnapshotter(root, every=every, keep_last=10, block=True,
                           overhead_budget=0.0) if root else None)
    builder = (tr.superstep_builder(run, None, n_nodes=DUR_N, mix=mix,
                                    device="cpu") if mesh is None else None)
    return StreamingDriver(
        run, mesh, state, lambda rng, n: lm_draw(rng, n, DUR_S),
        batch=DUR_B, n_nodes=DUR_N, device="cpu", superstep_builder=builder,
        snapshotter=snap, publisher=publisher, resume_from=resume,
        engine=EngineConfig(superstep=1, prefetch_depth=0, replan_every=0))


def shard_durability(mesh, inp):
    """(1) the state the parent gave, saved by the ranks as one checkpoint
    (`checkpoint.save(mesh=...)`), params f32 and bf16; (2) the LM driver
    uninterrupted for DUR_SUPERSTEPS supersteps with a snapshot every
    superstep and a publisher (rank 0's engine polls it), then resumed
    across a mesh change: rank 0 alone (one process) from the 2-rank
    snapshot at DUR_BACK for one superstep, writing its own snapshot, and
    both ranks from that one to the end; the publisher's and the
    snapshotter's messages against the planner; (3) the PCA driver (N =
    DUR_PCA_N, ring R = 2) under DUR_PCA_SPEC with snapshots, and resumed
    on the ranks from its middle snapshot."""
    import torch.distributed as dist

    from repro_torch import convert, dist as rdist
    from repro_torch.core.packing import map_tensors, tree_leaves, tree_map
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.publisher import SnapshotPublisher
    from repro_torch.train import checkpoint, trainer as tr

    given = torch.load(inp, weights_only=False)
    work = given["work"]
    run = given["run"]
    rows = rdist.node_rows(mesh, DUR_N)
    out = {"rows": (rows.start, rows.stop)}
    # (1) the split save
    local = _local_state(given["state"], rows)
    for label, state in (("f32", local), ("bf16", local._replace(
            params=tree_map(lambda t: t.to(torch.bfloat16),
                            local.params)))):
        (_, w) = _wires(lambda: checkpoint.save(
            os.path.join(work, f"split_{label}"), state, step=DUR_SAVE_STEP,
            meta={"case": label}, model=run.model, mesh=mesh, n_nodes=DUR_N))
        out[f"save_{label}"] = w
    # the split restore of the one-process checkpoint
    like = map_tensors(torch.zeros_like, local)
    restored = checkpoint.restore(os.path.join(work, "one_f32"), like,
                                  model=run.model, mesh=mesh, into=True,
                                  n_nodes=DUR_N)
    out["restored"] = convert.train_tree(restored, run.model)
    # (2) the LM driver with snapshots and publication
    uninterrupted = os.path.join(work, "lm_uninterrupted")
    pub = SnapshotPublisher(overhead_budget=0.0)
    with _lm_driver(mesh, run, _local_state(given["state"], rows),
                    uninterrupted, publisher=pub) as drv:
        st, hist = drv.run(DUR_SUPERSTEPS)
        out["lm"] = {"tree": convert.train_tree(st, run.model),
                     "versions": [r["published_version"] for r in hist],
                     "checkpoints": [r["checkpoint"] for r in hist],
                     "published": [p.numpy() for p in
                                   tree_leaves(pub.snapshot().params)],
                     "saves": drv._snapshotter.stats.saves,
                     "failures": drv._snapshotter.stats.failures,
                     "bytes_per_save": drv._snapshotter.stats.bytes_per_save}
        # one more publication and snapshot, with their messages
        _, w = _wires(lambda: pub.maybe_publish(drv.state, DUR_SUPERSTEPS,
                                                aux=drv._publish_aux()))
        out["publish_wire"] = w
        drv._snapshotter.every = 10 ** 6  # a skipped one: the verdict only
        _, w = _wires(lambda: drv._snapshotter.maybe_snapshot(drv))
        out["snapshot_wire"] = w
    if mesh.rank == 0:  # rank 0's engine serves the published params
        eng = ContinuousBatchingEngine(run.model, pub.snapshot().params,
                                       slots=1, max_len=16)
        out["polled"] = eng.poll(pub) and eng.version == pub.version
        rid = eng.submit(np.arange(5) % run.model.vocab_size, 4)
        eng.drain()
        out["tokens"] = list(eng.result(rid).tokens)
    # the mesh change: rank 0 alone, then both ranks
    one = os.path.join(work, "lm_one_process")
    back = checkpoint.step_dir(uninterrupted, DUR_BACK)
    if mesh.rank == 0:
        with _lm_driver(None, run, tr.replicate_for_nodes(
                tr.init_state(run, torch.Generator().manual_seed(1)), DUR_N),
                one, mix=given["mix"], resume=back) as drv:
            drv.run(1)
    dist.barrier()
    with _lm_driver(mesh, run, _local_state(given["state"], rows), None,
                    resume=checkpoint.step_dir(one, DUR_BACK + 1)) as drv:
        st, _ = drv.run(DUR_SUPERSTEPS - DUR_BACK - 1)
        out["lm_resumed"] = {"tree": convert.train_tree(st, run.model),
                             "from": drv.resumed_from}
    # (3) the PCA driver's snapshots and resume on the ranks
    from repro_torch.data.synthetic import make_pca_host_sampler

    data = given["pca"]
    ts = convert.pca_stream(data["cov"], data["sqrt_cov"], data["top"],
                            float(data["lambda1"]), float(data["eigengap"]),
                            device="cpu")
    root = os.path.join(work, "pca")
    out["pca"] = _pca_durable(mesh, data["w0"], make_pca_host_sampler(ts),
                              root, None)
    out["pca_resumed"] = _pca_durable(
        mesh, data["w0"], make_pca_host_sampler(ts), None,
        checkpoint.step_dir(root, DUR_PCA_SUPERSTEPS // 2))
    if mesh.rank == 0:  # tear the newest snapshot: rank 1's rows of w
        newest = checkpoint.step_dir(root, DUR_PCA_SUPERSTEPS)
        fname = checkpoint.load_manifest(newest)["leaves"][".w"]["file"]
        with open(os.path.join(newest, fname), "r+b") as f:
            f.seek(-4, os.SEEK_END)
            tail = f.read(4)
            f.seek(-4, os.SEEK_END)
            f.write(bytes(b ^ 0xFF for b in tail))
    dist.barrier()
    # resumed from the root: the torn one is skipped on every rank
    out["pca_torn"] = _pca_durable(mesh, data["w0"],
                                   make_pca_host_sampler(ts), None, root)
    out.update(_node_axis_rule(mesh, work))
    return out


def _node_axis_rule(mesh, work):
    """(4) At one node a rank (n_nodes = 2): an exact run's replicated
    [1, 3] leaf is saved whole (and restored); a decentralized state
    whose leaf is not the rank's rows fails to save on every rank; a
    restore whose CRC32s fail on rank 1's rows leaves rank 0's state as
    it was too."""
    import torch.distributed as dist

    from repro_torch import dist as rdist
    from repro_torch.train import checkpoint

    out = {}
    rep = {"c": torch.arange(3.0).reshape(1, 3), "t": 5}
    checkpoint.save(os.path.join(work, "rep_split"), rep, step=1, mesh=mesh)
    got = checkpoint.restore(os.path.join(work, "rep_split"),
                             {"c": torch.zeros(1, 3), "t": 0}, mesh=mesh)
    out["rep_restored"] = {"c": got["c"].numpy(), "t": got["t"]}
    rows = rdist.node_rows(mesh, 2)
    dec = {"w": torch.arange(6.0).reshape(2, 3)[rows].clone(), "t": 5}
    checkpoint.save(os.path.join(work, "dec_split"), dec, step=1, mesh=mesh,
                    n_nodes=2)
    try:
        checkpoint.save(os.path.join(work, "bad_split"),
                        dict(dec, c=torch.zeros(2, 3)), step=1, mesh=mesh,
                        n_nodes=2)
        out["bad_save"] = None
    except OSError as e:
        out["bad_save"] = str(e)
    dist.barrier()
    if mesh.rank == 0:  # flip the last bytes of "w": rank 1's row
        path = os.path.join(work, "dec_split")
        fname = checkpoint.load_manifest(path)["leaves"]["w"]["file"]
        with open(os.path.join(path, fname), "r+b") as f:
            f.seek(-4, os.SEEK_END)
            tail = f.read(4)
            f.seek(-4, os.SEEK_END)
            f.write(bytes(b ^ 0xFF for b in tail))
    dist.barrier()
    like = {"w": torch.full((1, 3), -1.0), "t": 0}
    try:
        checkpoint.restore(os.path.join(work, "dec_split"), like, into=True,
                           mesh=mesh, n_nodes=2)
        out["torn_restore"] = None
    except ValueError as e:
        out["torn_restore"] = str(e)
    out["torn_like"] = like["w"].numpy().copy()
    return out


def _pca_durable(mesh, w0, sample, root, resume):
    """The PCA driver (DUR_PCA_N nodes, ring R = 2, K = PCA_K) under
    DUR_PCA_SPEC on this rank's rows to DUR_PCA_SUPERSTEPS supersteps, a
    blocking snapshot every superstep under `root`, or resumed from
    `resume`."""
    from repro_torch.configs.base import (AveragingConfig, GovernorConfig,
                                          StreamConfig)
    from repro_torch.configs.paper_pca import PCARunConfig
    from repro_torch.core import faults as tfaults
    from repro_torch.core import krasulina
    from repro_torch.train.driver import EngineConfig, StreamingDriver
    from repro_torch.train.snapshot import RunSnapshotter

    n = DUR_PCA_N
    cfg = PCARunConfig(averaging=AveragingConfig(mode="gossip", rounds=2),
                       stream=StreamConfig())
    snap = (RunSnapshotter(root, every=1, keep_last=10, block=True,
                           overhead_budget=0.0) if root else None)
    with StreamingDriver(
            cfg, mesh, krasulina.init_krasulina_state(
                w0, cfg.averaging, n, device="cpu", mesh=mesh),
            sample, n_nodes=n, batch=2 * n, seed=1,
            superstep_builder=krasulina.krasulina_superstep_builder(
                cfg.averaging, n, lambda t: 10.0 / t, device="cpu",
                mesh=mesh),
            faults=tfaults.FaultSchedule.parse(DUR_PCA_SPEC, n),
            clock=FakeClock(1e-3), device="cpu", snapshotter=snap,
            resume_from=resume,
            engine=EngineConfig(superstep=PCA_K, prefetch_depth=0,
                                replan_every=1, warmup_supersteps=0,
                                warmup_per_bucket=0,
                                governor=GovernorConfig())) as drv:
        state, _ = drv.run(DUR_PCA_SUPERSTEPS - drv._supersteps_done)
    return {"w": state.w.numpy(), "t": state.t, "events": events(drv),
            "records": records(drv)[-(DUR_PCA_SUPERSTEPS // 2):],
            "from": drv.resumed_from}


CASES = {"rules": rules, "driver": driver, "trainer": trainer,
         "model_layers": model_layers, "model_trainer": model_trainer,
         "cohort_rules": cohort_rules, "elastic_driver": elastic_driver,
         "elastic_trainer": elastic_trainer, "shard_ef": shard_ef,
         "shard_durability": shard_durability, "model_heads": model_heads,
         "model_durability": model_durability}


def main():
    case, rank, world, store, out = sys.argv[1:6]
    rest = sys.argv[6:]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=int(rank),
        world_size=int(world), timeout=datetime.timedelta(seconds=120))
    try:
        res = CASES[case](make_host_mesh(), *rest)
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
