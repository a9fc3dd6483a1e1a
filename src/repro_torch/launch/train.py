"""Training launcher of the port, wired onto the superstep streaming engine
(`train.driver`): K-round supersteps, the prefetch ring onto the card, and
the closed-loop (B, mu) governor, over a `MarkovTokenStream`. Runs on the
CUDA card unless `--device cpu` is given; `--reduced` trains the
smoke-test-sized member of the architecture. Every decoder-only arch
trains, the ssm and hybrid families (mamba2-2.7b, recurrentgemma-9b)
included; an encoder-decoder (seamless-m4t-medium) raises ValueError, as
the reference's launcher cannot feed it either: the token stream carries
no frames (`train.trainer` and `StreamingDriver` train it with a
`sample_fn` that returns them).

One device is one node by default, as the reference's host mesh gives on
one device: `--averaging gossip` then mixes over a single node. `--nodes N`
emulates N nodes on the one device, as `StreamingDriver(..., n_nodes=N)`
does (the port's own flag: the reference reads its node count off the
mesh, and a fault schedule or a scenario over one node has nothing to
drop or mix).

Elastic membership and the scenario harness, as in the reference:
`--faults` scripts node faults (`core/faults.py`: death, slow, flaky) and
link faults; `--straggler-policy drop|deadline` evicts slow nodes;
`--scenario NAME` replaces --topology/--rounds with the scenario's
time-varying mixing schedule (re-rooted to the run's node count) and adds
its link model to the faults. All need `--averaging gossip`. Error
feedback has no flag, as in the reference: it is
`AveragingConfig(error_feedback="grads")` through
`train.trainer.superstep_builder` or `StreamingDriver`.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
      --reduced --device cpu --steps 4 --superstep 2 --averaging gossip \
      --rounds 2 --nodes 4 --faults death:1@1-2

Durability and publication, as in the reference: `--publish` attaches a
`serve.publisher.SnapshotPublisher` (its governor's budget
`--publish-budget`) that publishes the consensus iterate at superstep
boundaries; `--checkpoint DIR` saves the final state there, or with
`--checkpoint-every K` is the root of async snapshots every K supersteps
(`train.snapshot.RunSnapshotter`, `--keep-last`, `--checkpoint-budget`);
`--resume DIR` continues from the newest valid snapshot under DIR (or one
step directory). The checkpoints are in the reference's layout.

Under `torchrun` (WORLD_SIZE > 1) every rank runs this launcher: it joins
the process group (gloo on the CPU and where ranks share one card, nccl
where every rank has a card of its own), builds `make_host_mesh()` over
the ranks, as the reference's launcher does (or the reference's
production mesh with `--production-mesh`, which needs 256 ranks; its model
axis of 16 executes for a dense arch whose vocab 16 divides, granite-8b's
8 KV heads split in two included; `--model-axis M` gives the host mesh a
model axis of M) and trains its rows of the node axis, one node per rank
unless `--nodes` says otherwise:
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch granite-8b --reduced --device cpu --steps 4 --superstep 2 \
      --averaging gossip --rounds 2
`--faults`, `--scenario` and `--straggler-policy drop|deadline` run there
too, each rank on its rows of the cohort (`train.driver`):
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch granite-8b --reduced --device cpu --steps 6 --superstep 2 \
      --averaging gossip --rounds 2 --nodes 4 --faults death:1@1-2 \
      --scenario ring/lossy/iid_pca
`--publish`, `--checkpoint` and `--resume` run there too: each rank writes
its own rows of one checkpoint in the reference's layout, which any split
of the same run (or one process, or the JAX package) resumes from, and
rank 0's publisher decides for every rank (`train.driver`); over a model
axis each rank's blocks are joined into the same checkpoint, and a resume
cuts them again on any split:
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch granite-8b --reduced --device cpu --steps 4 --superstep 2 \
      --averaging exact --model-axis 2 --checkpoint /tmp/ck
Alone (no WORLD_SIZE) it runs as before.

`launch/env.py` is applied before `import torch` unless `--no-env-tuning`
is given; `--compilation-cache-dir DIR` is the directory the kernels are
built into (a restart that points at it skips the build).
"""
from __future__ import annotations

# perf hygiene before the torch import; `--no-env-tuning` skips it
from repro_torch.launch import env as _env

_env.apply_from_argv()

import argparse
import dataclasses
import datetime
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.configs.base import (SHAPES, AveragingConfig, GovernorConfig,
                                      PublishConfig, RunConfig, StreamConfig)
from repro_torch.core import scenarios as scenario_lib
from repro_torch.core.faults import FaultSchedule
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.device import resolve_device
from repro_torch.dist import n_data_nodes, n_local
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.serve.publisher import SnapshotPublisher
from repro_torch.train import checkpoint
from repro_torch.train.driver import EngineConfig, StreamingDriver
from repro_torch.train.snapshot import RunSnapshotter
from repro_torch.train.trainer import (init_state, replicate_for_nodes,
                                       state_placements, superstep_builder)

# how long a rank waits on a collective before the run fails
DIST_TIMEOUT_S = 600


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100,
                    help="total rounds (rounded up to whole supersteps)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--averaging", default="exact",
                    choices=["exact", "gossip", "hierarchical"])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--nodes", type=int, default=None,
                    help="nodes of the node axis (default: one per rank, "
                         "one on a single process; more emulate several "
                         "nodes per device)")
    ap.add_argument("--streaming-rate", type=float, default=0.0)
    ap.add_argument("--processing-rate", type=float, default=0.0)
    ap.add_argument("--comms-rate", type=float, default=0.0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--log-every", type=int, default=1,
                    help="log every this many supersteps")
    ap.add_argument("--superstep", type=int, default=8,
                    help="K: rounds folded into one superstep")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="async prefetch ring depth (0 = synchronous staging)")
    ap.add_argument("--replan-every", type=int, default=1,
                    help="supersteps between closed-loop (B, mu) re-plans; "
                         "0 disables the governor feedback")
    ap.add_argument("--buckets", default="",
                    help="comma-separated B bucket ladder for the adaptive "
                         "governor (e.g. '8,16,32'); empty pins B to --batch")
    ap.add_argument("--n-buckets", type=int, default=1,
                    help="auto geometric ladder size around the planned B "
                         "when --buckets is empty (1 = pinned B)")
    ap.add_argument("--bucket-hysteresis", type=int, default=2,
                    help="consecutive re-plans that must agree on a bucket "
                         "before the governor switches B")
    ap.add_argument("--no-rate-estimator", action="store_true",
                    help="disable the online least-squares (R_p, R_c) "
                         "estimator; fall back to the config comms constant")
    ap.add_argument("--horizon", type=float, default=0.0,
                    help="sample horizon t' for Theorem 4's B <= sqrt(t') "
                         "bucket ceiling (0 = no ceiling)")
    ap.add_argument("--faults", default="",
                    help="fault-injection spec for elastic membership, e.g. "
                         "'death:1@5-12,slow:0@3-9x4' (see core/faults.py; "
                         "needs --averaging gossip)")
    ap.add_argument("--scenario", default="",
                    help="named scenario from core/scenarios.py: replaces "
                         "--topology/--rounds with the scenario's "
                         "time-varying mixing schedule and adds its link "
                         "model (loss/bandwidth) to --faults; the stream "
                         "stays the LM token stream; needs --averaging "
                         "gossip")
    ap.add_argument("--straggler-policy", default="wait",
                    choices=["wait", "drop", "deadline"],
                    help="straggler handling: wait (lockstep), drop "
                         "(exclude nodes slower than --straggler-factor x "
                         "median), deadline (--straggler-deadline seconds)")
    ap.add_argument("--straggler-factor", type=float, default=2.0)
    ap.add_argument("--straggler-deadline", type=float, default=0.0)
    ap.add_argument("--no-rejoin-sync", action="store_true",
                    help="keep a rejoining node's stale iterate instead of "
                         "syncing it to the cohort mean")
    ap.add_argument("--publish", action="store_true",
                    help="publish consensus param snapshots at superstep "
                         "boundaries (serve/publisher.py) for a serving "
                         "replica to adopt")
    ap.add_argument("--publish-budget", type=float, default=0.05,
                    help="publish-governor overhead budget: max fraction of "
                         "train wall time spent on snapshot copies")
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint directory; with --checkpoint-every 0 a "
                         "single end-of-run save, otherwise the root for "
                         "step_NNNNNNNN/ async snapshots")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="async snapshot cadence in supersteps (0 = only the "
                         "end-of-run save); requires --checkpoint")
    ap.add_argument("--keep-last", type=int, default=3,
                    help="checkpoints retained under the root (the newest "
                         "VALID one is never pruned)")
    ap.add_argument("--checkpoint-budget", type=float, default=0.05,
                    help="snapshot-governor overhead budget: max fraction of "
                         "train wall time spent dispatching snapshot copies")
    ap.add_argument("--resume", default="",
                    help="resume from this checkpoint root (newest valid "
                         "step) or a specific step_NNNNNNNN directory")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="under torchrun, the host mesh's model extent: "
                         "(world / M) x M over (data, model)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's 16x16 mesh (needs 256 ranks; "
                         "its model axis of 16 executes for a dense arch "
                         "whose vocab it splits)")
    ap.add_argument("--no-env-tuning", action="store_true",
                    help="skip the launcher perf hygiene (launch/env.py); "
                         "applied at import time, declared here for --help")
    ap.add_argument("--compilation-cache-dir", default="",
                    help="directory the kernel libraries are built into and "
                         "loaded from (launch/env.py; applied at import "
                         "time)")
    return ap


def _join_group(device: Optional[str]) -> str:
    """Under torchrun: join the process group and return this rank's device
    name. gloo on the CPU and where ranks share a card (NCCL refuses two
    ranks on one device), nccl where every rank has a card of its own."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = "gloo"
    if not on_cpu:
        cards = torch.cuda.device_count()
        if cards >= local_world:
            backend = "nccl"
        device = f"cuda:{local % max(cards, 1)}"
        if cards:
            torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    return device


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    distributed = int(os.environ.get("WORLD_SIZE", 1)) > 1
    if distributed and not dist.is_initialized():
        args.device = _join_group(args.device)
    try:
        _train(ap, args, distributed)
    finally:
        if distributed and dist.is_initialized():
            dist.destroy_process_group()


def _train(ap, args, distributed: bool) -> None:
    mesh = None
    if distributed or args.production_mesh:
        mesh = make_production_mesh() if args.production_mesh \
            else make_host_mesh(model=args.model_axis)
    cfg = get_config(args.arch)
    if cfg.is_encdec:
        # the reference's launcher draws the same token stream, and its
        # encoder-decoder loss then finds no frames
        raise ValueError(
            f"{cfg.name}: the launcher's token stream carries no frames, and "
            f"an encoder-decoder trains on batch['frames']; train it through "
            f"train.trainer / StreamingDriver with a sample_fn that returns "
            f"'frames' beside 'tokens' and 'labels'")
    if args.reduced:
        cfg = reduce_cfg(cfg)
    dev = resolve_device(args.device)
    n_nodes = args.nodes or (n_data_nodes(mesh) if mesh is not None else 1)
    averaging = AveragingConfig(args.averaging, args.rounds, args.topology)
    scenario = None
    if args.scenario:
        if args.averaging != "gossip":
            ap.error("--scenario needs --averaging gossip")
        scenario = scenario_lib.get_scenario(args.scenario)
        if scenario.n_nodes != n_nodes:
            # scenarios are registered at their canonical size; re-root the
            # schedule on this run's node axis (link endpoints must fit)
            scenario = dataclasses.replace(scenario, n_nodes=n_nodes)
        averaging = scenario_lib.averaging_config(scenario)
    run = RunConfig(
        model=cfg, shape=SHAPES["train_4k"], averaging=averaging,
        stream=StreamConfig(args.streaming_rate, args.processing_rate,
                            args.comms_rate),
        optimizer=args.optimizer, learning_rate=args.lr,
        param_dtype=args.dtype)
    buckets = tuple(int(b) for b in args.buckets.split(",") if b.strip())
    governor = GovernorConfig(buckets=buckets, n_buckets=args.n_buckets,
                              hysteresis=args.bucket_hysteresis,
                              estimate_rates=not args.no_rate_estimator,
                              straggler_policy=args.straggler_policy,
                              straggler_slow_factor=args.straggler_factor,
                              straggler_deadline_s=args.straggler_deadline,
                              sync_on_rejoin=not args.no_rejoin_sync)
    # the scenario's link model rides the same fault schedule as any node
    # faults from --faults (link windows index consensus rounds, node
    # windows supersteps — core/faults.py)
    fault_spec = ",".join(
        s for s in (args.faults, scenario.links if scenario else "") if s)
    faults = (FaultSchedule.parse(fault_spec, n_nodes,
                                  seed=scenario.seed if scenario else 0)
              if fault_spec else None)
    builder = (superstep_builder(run, mesh, n_nodes=n_nodes, device=dev,
                                 mix=scenario_lib.build_mix(
                                     scenario, device=dev, mesh=mesh))
               if scenario is not None else None)
    engine = EngineConfig(superstep=args.superstep,
                          prefetch_depth=args.prefetch,
                          replan_every=args.replan_every, governor=governor)
    supersteps = -(-args.steps // engine.superstep)

    data = MarkovTokenStream(cfg.vocab_size, seed=0)
    sample_fn = lambda rng, n: _draw(data, rng, n, args.seq)

    publisher = None
    if args.publish:
        pub_cfg = PublishConfig(enabled=True,
                                overhead_budget=args.publish_budget)
        publisher = SnapshotPublisher(
            overhead_budget=pub_cfg.overhead_budget,
            min_interval_s=pub_cfg.min_interval_s, block=pub_cfg.block)
    snapshotter = None
    if args.checkpoint_every > 0:
        if not args.checkpoint:
            ap.error("--checkpoint-every needs --checkpoint DIR as the root")
        snapshotter = RunSnapshotter(args.checkpoint,
                                     every=args.checkpoint_every,
                                     keep_last=args.keep_last,
                                     overhead_budget=args.checkpoint_budget)

    # over a model axis, this rank's blocks of the state (`init_state`)
    state = init_state(run, torch.Generator(device=dev).manual_seed(run.seed),
                       mesh)
    if args.averaging != "exact":
        state = replicate_for_nodes(state, n_local(mesh, n_nodes))
    with StreamingDriver(run, mesh, state, sample_fn, engine=engine,
                         superstep_builder=builder, batch=args.batch,
                         n_nodes=n_nodes, horizon=args.horizon or None,
                         faults=faults, publisher=publisher,
                         snapshotter=snapshotter,
                         resume_from=args.resume or None,
                         device=dev) as driver:
        if driver.resumed_from:
            _say(f"resumed: {driver.resumed_from} "
                 f"(superstep {driver._supersteps_done})")
        plan = driver.pipeline.plan
        ranks = (f" rank={mesh.rank}/{mesh.size} "
                 f"local_nodes={n_local(mesh, n_nodes)}"
                 if mesh is not None else "")
        _say(f"plan: B={plan.B} mu={plan.mu} regime={plan.regime} "
             f"nodes={n_nodes} K={engine.superstep} "
             f"prefetch={engine.prefetch_depth} "
             f"buckets={list(driver.ladder.buckets)} device={dev}{ranks}")
        if scenario is not None:
            _say(f"scenario: {scenario.name} n={scenario.n_nodes} "
                 f"R={scenario.rounds} links={scenario.links or 'clean'}")
        if faults is not None:
            _say(f"faults: {faults}")
        state, _ = driver.run(supersteps, log_fn=_log,
                              log_every=args.log_every)
        for ev in driver.membership_events:
            _say(f"membership superstep {ev['superstep']}: "
                 f"{ev['to'].active_ids} B={ev['plan'].B}")
    if publisher is not None:
        st = publisher.stats
        stale = publisher.staleness(supersteps)
        _say(f"publisher: v{publisher.version} publishes={st.publishes} "
             f"skipped(budget={st.skipped_budget} "
             f"interval={st.skipped_interval}) "
             f"cost_ewma={st.cost_ewma_s * 1e3:.2f}ms "
             f"total_cost={st.total_cost_s:.3f}s "
             f"staleness={stale['supersteps']} supersteps "
             f"/ {stale['wall_s']:.2f}s")
    if snapshotter is not None:
        st = snapshotter.stats
        _say(f"snapshotter: saves={st.saves} "
             f"skipped(cadence={st.skipped_cadence} "
             f"budget={st.skipped_budget} busy={st.skipped_busy}) "
             f"failures={st.failures} "
             f"cost_ewma={st.cost_ewma_s * 1e3:.2f}ms "
             f"total_cost={st.total_cost_s:.3f}s -> {args.checkpoint}")
    elif args.checkpoint:
        # on a split node axis every rank writes its rows of one checkpoint
        checkpoint.save(args.checkpoint, state,
                        step=supersteps * engine.superstep,
                        meta={"arch": args.arch, "reduced": args.reduced},
                        model=cfg, mesh=mesh,
                        n_nodes=n_nodes if args.averaging != "exact"
                        else None,
                        specs=state_placements(run, mesh, state))
        _say(f"checkpoint -> {args.checkpoint}")


def _log(rec):
    m = rec["metrics"]
    c = rec["counters"]
    plan = rec.get("replanned", rec["plan"])
    gov = ""
    if "bucket_switch" in rec:
        gov += f" B:{rec['bucket_switch'][0]}->{rec['bucket_switch'][1]}"
    if "est_Rc" in rec:
        rc = rec["est_Rc"]
        gov += f" est_Rc={'inf' if rc <= 0 else f'{rc:.3g}'}"
    if "link_drops" in rec:
        gov += f" drops={list(rec['link_drops'])} bw={rec['bw_factor']:g}"
    _say(f"round {rec['round']:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
         f"consensus_err {m['consensus_err']:.2e} "
         f"nodes={rec['n_active']} "
         f"t'={c.samples_arrived} B={rec['bucket']} mu={plan.mu} "
         f"{plan.regime}{gov} "
         f"({rec['rounds_per_s']:.1f} rounds/s, "
         f"{rec['samples_per_s']:.0f} samples/s)")


def _say(line: str) -> None:
    """`line` and its newline in one write, flushed: under torchrun the
    ranks share stdout, and where it is unbuffered `print` writes the
    newline apart, so another rank's line could land before it."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _draw(data: MarkovTokenStream, rng: np.random.Generator, n: int, seq: int):
    toks = data.sample(rng, n, seq + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


if __name__ == "__main__":
    main()
