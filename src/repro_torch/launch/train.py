"""Training launcher of the port, wired onto the superstep streaming engine
(`train.driver`): K-round supersteps, the prefetch ring onto the card, and
the closed-loop (B, mu) governor, over a `MarkovTokenStream`. Runs on the
CUDA card unless `--device cpu` is given; `--reduced` trains the
smoke-test-sized member of the architecture.

One device is one node, as the reference's host mesh gives on one device:
`--averaging gossip` then mixes over a single node. Several nodes on one
card go through the API's `n_nodes` (`train.trainer.build_train_step`,
`StreamingDriver(..., n_nodes=N)`).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
      --reduced --device cpu --steps 4 --superstep 2 --averaging gossip \
      --rounds 2

The reference's flags of later slices are declared and raise
`NotImplementedError`: --faults, --scenario and a non-`wait`
--straggler-policy (elastic), --publish (serving), --checkpoint*, --resume
(durability) and --production-mesh (sharded). --compilation-cache-dir and
--no-env-tuning are not taken: they set up `launch/env.py`'s XLA flags and
compilation cache, which have no counterpart here.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.configs.base import (SHAPES, AveragingConfig, GovernorConfig,
                                      RunConfig, StreamConfig)
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.device import resolve_device
from repro_torch.train.driver import EngineConfig, StreamingDriver
from repro_torch.train.trainer import init_state, replicate_for_nodes

# flags of later slices: (dest, default, the slice they come with)
_LATER = (("faults", "", "elastic"), ("scenario", "", "elastic"),
          ("publish", False, "serving"), ("publish_budget", 0.05, "serving"),
          ("checkpoint", "", "durability"),
          ("checkpoint_every", 0, "durability"),
          ("keep_last", 3, "durability"),
          ("checkpoint_budget", 0.05, "durability"),
          ("resume", "", "durability"),
          ("production_mesh", False, "sharded"))


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
    ap.add_argument("--straggler-policy", default="wait",
                    choices=["wait", "drop", "deadline"],
                    help="straggler handling; only wait (lockstep) is "
                         "ported, drop and deadline come with the elastic "
                         "slice")
    ap.add_argument("--straggler-factor", type=float, default=2.0)
    ap.add_argument("--straggler-deadline", type=float, default=0.0)
    ap.add_argument("--no-rejoin-sync", action="store_true")
    # later slices (they raise)
    ap.add_argument("--faults", default="", help="elastic slice")
    ap.add_argument("--scenario", default="", help="elastic slice")
    ap.add_argument("--publish", action="store_true", help="serving slice")
    ap.add_argument("--publish-budget", type=float, default=0.05,
                    help="serving slice")
    ap.add_argument("--checkpoint", default="", help="durability slice")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="durability slice")
    ap.add_argument("--keep-last", type=int, default=3,
                    help="durability slice")
    ap.add_argument("--checkpoint-budget", type=float, default=0.05,
                    help="durability slice")
    ap.add_argument("--resume", default="", help="durability slice")
    ap.add_argument("--production-mesh", action="store_true",
                    help="sharded slice")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    for dest, default, slice_name in _LATER:
        if getattr(args, dest) != default:
            raise NotImplementedError(
                f"--{dest.replace('_', '-')} comes with the port's "
                f"{slice_name} slice")
    if args.straggler_policy != "wait":
        raise NotImplementedError("--straggler-policy drop/deadline comes "
                                  "with the port's elastic slice")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    dev = resolve_device(args.device)
    n_nodes = 1  # one device, one node
    run = RunConfig(
        model=cfg, shape=SHAPES["train_4k"],
        averaging=AveragingConfig(args.averaging, args.rounds, args.topology),
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
    engine = EngineConfig(superstep=args.superstep,
                          prefetch_depth=args.prefetch,
                          replan_every=args.replan_every, governor=governor)
    supersteps = -(-args.steps // engine.superstep)

    data = MarkovTokenStream(cfg.vocab_size, seed=0)
    sample_fn = lambda rng, n: _draw(data, rng, n, args.seq)

    state = init_state(run, torch.Generator(device=dev).manual_seed(run.seed))
    if args.averaging != "exact":
        state = replicate_for_nodes(state, n_nodes)
    with StreamingDriver(run, None, state, sample_fn, engine=engine,
                         batch=args.batch, n_nodes=n_nodes,
                         horizon=args.horizon or None,
                         device=dev) as driver:
        plan = driver.pipeline.plan
        print(f"plan: B={plan.B} mu={plan.mu} regime={plan.regime} "
              f"nodes={n_nodes} K={engine.superstep} "
              f"prefetch={engine.prefetch_depth} "
              f"buckets={list(driver.ladder.buckets)} device={dev}")
        driver.run(supersteps, log_fn=_log, log_every=args.log_every)


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
    print(f"round {rec['round']:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
          f"consensus_err {m['consensus_err']:.2e} "
          f"t'={c.samples_arrived} B={rec['bucket']} mu={plan.mu} "
          f"{plan.regime}{gov} "
          f"({rec['rounds_per_s']:.1f} rounds/s, "
          f"{rec['samples_per_s']:.0f} samples/s)", flush=True)


def _draw(data: MarkovTokenStream, rng: np.random.Generator, n: int, seq: int):
    toks = data.sample(rng, n, seq + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


if __name__ == "__main__":
    main()
