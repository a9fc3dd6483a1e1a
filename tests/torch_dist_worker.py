"""Rank code of the port's multi-rank tests (tests/test_torch_shard.py,
tests/test_torch_trainer_dist.py); not collected by pytest.

    python tests/torch_dist_worker.py CASE RANK WORLD STORE OUT [INPUT]

joins a gloo process group of WORLD CPU processes through the FileStore
at STORE (no TCP port, so parallel test workers never collide), builds
`make_host_mesh()` over the ranks, runs CASE on this rank's rows and saves
its results to OUT (`torch.save`). INPUT is a file the parent test wrote
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


def spawn(case: str, world: int, tmp_path, inp=None):
    """Run CASE on `world` ranks and return each rank's results. Every rank
    is joined under a deadline and must exit 0."""
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
    return [torch.load(out, weights_only=False) for _, out, _ in procs]


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
    # HIGHD's mix (n = 10, d = 3072, ring R = 8): the rule where 10 rows
    # split evenly, the gather-roll where they do not
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
    # a layout the rule does not cover: n not a multiple of the split
    n_small = 6 if E == 4 else 5
    ss = mixing.schedule("ring", n_small)
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
    per mode; (2) tests/test_trainer_dist.py's contracts, 12 Adam steps of
    16 x 64 tokens per mode (exact, gossip R = 2, gossip R = 8) from the
    port's own seeded init."""
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
            "step": state.opt.step, "metrics": metrics}
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


CASES = {"rules": rules, "driver": driver, "trainer": trainer}


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
