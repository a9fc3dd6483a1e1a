"""Serving launcher of the port: prefill a batch of prompts and decode with
the KV cache (static batch), or serve synthetic requests through the
continuous-batching engine (`--continuous`). Runs on the CUDA card unless
`--device cpu` is given; `--reduced` serves the smoke-test-sized member of
the architecture.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --reduced --device cpu --batch 4 --prompt-len 64 --gen 32

The reference's `--no-env-tuning` flag is not taken: it skips
`launch/env.py`, which sets XLA flags and has no counterpart here.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serve import engine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window-override", type=int, default=0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching decode loop (slot-based "
                         "admission, prefill-on-admit) instead of the static "
                         "batch generate path")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV slot pool size for --continuous")
    ap.add_argument("--requests", type=int, default=16,
                    help="synthetic requests to serve with --continuous")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    params = registry.init_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg, dtype,
                                  window_override=args.window_override)
    if args.continuous:
        _serve_continuous(cfg, params, args, dtype, dev)
        return
    prompt = registry.synth_batch(torch.Generator(device=dev).manual_seed(1),
                                  cfg, args.batch, args.prompt_len,
                                  mode="prefill")
    max_len = args.prompt_len + args.gen

    t0 = time.perf_counter()
    st = engine.init_serve(cfg, args.batch, max_len, dtype,
                           window_override=args.window_override, device=dev)
    st = engine.prefill(params, cfg, prompt, st,
                        window_override=args.window_override)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    toks = [st.last_tokens]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        st, t = engine.serve_step(params, cfg, st,
                                  window_override=args.window_override)
        toks.append(t)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    out = torch.cat(toks, dim=1)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={dev}")
    print(f"prefill: {t_prefill:.2f}s  decode: {t_decode:.2f}s "
          f"({args.batch * (args.gen - 1) / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample token ids:", out[0, :16].tolist())


def _serve_continuous(cfg, params, args, dtype, dev):
    """Continuous-batching loop over synthetic prompts (the production decode
    path)."""
    max_len = args.prompt_len + args.gen
    eng = engine.ContinuousBatchingEngine(
        cfg, params, slots=args.slots, max_len=max_len, dtype=dtype,
        window_override=args.window_override)
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, cfg.vocab_size, size=args.prompt_len),
                       args.gen) for _ in range(args.requests)]
    t0 = time.perf_counter()
    eng.drain()
    _sync(dev)
    wall = time.perf_counter() - t0
    done = [eng.result(r) for r in rids]
    toks = sum(len(r.tokens) for r in done)
    print(f"arch={cfg.name} slots={args.slots} requests={args.requests} "
          f"prompt={args.prompt_len} gen={args.gen} device={dev}")
    print(f"continuous decode: {wall:.2f}s  {toks} tokens "
          f"({toks / max(wall, 1e-9):.1f} tok/s, "
          f"{eng.decode_steps} decode steps)")
    print("sample token ids:", done[0].tokens[:16])


if __name__ == "__main__":
    main()
