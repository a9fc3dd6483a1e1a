#!/usr/bin/env python3
"""Which gossip_mix_quant design is faster on one NVIDIA card, by node count
and width: the cluster-tile kernel (a thread-block cluster per [n, block_d]
statistic tile) against the resident-tile kernel (one block per tile),
both launched through `kernels.consensus.gossip_mix_quant_cuda(...,
_design=...)`, int8 tiles of 512 columns.

For n = 3, 4, 8, 9, 10 and 16 nodes it times both designs, f32, at
d = 3072 (the PCA main path), 32768, 49152, 67584, 98304, 135168 (64 to
264 tiles, around the card's 132 SMs), 2^18, 2^20, 2^22 and 2^24, ring
R = 2 and R = 8, and bf16 at the trainer's d = 637,554,688 (granite-8b cut
to 2 layers), R = 2: CUDA-graph replays of 20 launches (5 replays, the
fastest of two) up to 2^22 columns, CUDA events around 3 calls beyond. It
checks that the two designs give the same bits at each shape, and prints
the card (`nvidia-smi`), one line per shape and, at the end, one JSON
object with every time (also written to FILE with `--out FILE`).

    python3 tools/quant_route_probe.py [--quick] [--out FILE]

`--quick` leaves out the trainer's width. Needs a CUDA card and nvcc;
exits non-zero without them.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES = (3, 4, 8, 9, 10, 16)
WIDTHS = (3072, 32768, 49152, 67584, 98304, 135168, 1 << 18, 1 << 20,
          1 << 22, 1 << 24)
TRAINER_D = 637_554_688
BLOCK_D = 512
DESIGNS = ("cluster-tile", "resident-tile")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("quant_route_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.mixing import schedule
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.consensus import (gossip_mix_quant_cuda,
                                               quant_design)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    _cuda.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def graph_ms(fn, calls=20, replays=5):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            fn()
        torch.cuda.current_stream().wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        best = float("inf")
        for _ in range(2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(replays):
                g.replay()
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b) / (calls * replays))
        return best

    def event_ms(fn, calls=3):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / calls

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    cases = [(n, d, torch.float32, r) for n in NODES for d in WIDTHS
             for r in (2, 8)]
    if not args.quick:
        cases += [(n, TRAINER_D, torch.bfloat16, 2) for n in NODES]
    rows = []
    t0 = time.perf_counter()
    for n, d, dtype, rounds in cases:
        sched = schedule("ring", n)
        x = torch.randn((n, d), generator=gen, device=dev, dtype=dtype)
        outs, times = {}, {}
        for design in DESIGNS:
            fn = lambda design=design: gossip_mix_quant_cuda(
                x, sched, rounds, "int8", block_d=BLOCK_D, _design=design)
            outs[design] = fn()
            times[design] = (graph_ms(fn) if d <= (1 << 22)
                             else event_ms(fn))
        same = torch.equal(outs["cluster-tile"], outs["resident-tile"])
        del outs
        routed = quant_design(n, d, BLOCK_D)
        faster = min(times, key=times.get)
        row = {"n": n, "d": d, "dtype": str(dtype).split(".")[1],
               "rounds": rounds, "cluster_tile_ms": times["cluster-tile"],
               "resident_tile_ms": times["resident-tile"],
               "routed": routed, "faster": faster, "same_bits": same}
        rows.append(row)
        print(f"quant_route n={n} d={d} {row['dtype']} R={rounds}: "
              f"cluster-tile {times['cluster-tile']:.5f} ms, resident-tile "
              f"{times['resident-tile']:.5f} ms; routed {routed}, faster "
              f"{faster}, same bits {same}", flush=True)
        del x
        torch.cuda.empty_cache()
    out = {"card": smi, "block_d": BLOCK_D, "quant": "int8", "rows": rows,
           "seconds": time.perf_counter() - t0}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if all(r["same_bits"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
