#!/usr/bin/env python3
"""Card time of granite-8b's batched prefill on one NVIDIA card: the (g1)
prefill of `chip_smoke.py` (batch 4 x 512 prompt tokens, bf16, 36 layers at
full width, seeded random weights), replayed from a CUDA graph, and the
flash_attention call that each of its 36 layers makes at that shape.

    python3 tools/prefill_card_time.py [--src DIR]

`--src` names the `src` directory whose `repro_torch` is imported (default:
this checkout's), so that two checkouts can be timed in turns on one card
(parent, change, change, parent). Prints one JSON line. Needs a CUDA card;
exits non-zero without one.
"""
import argparse
import json
import os
import subprocess
import sys


def time_ms(torch, fn, reps, replays):
    """Device time of one call: `reps` calls captured in a CUDA graph,
    replayed `replays` times between two events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("prefill_card_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.serve import engine

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = get_config("granite-8b")
    B, P, GEN = 4, 512, 32
    params = registry.init_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg, torch.bfloat16)
    prompt = registry.synth_batch(torch.Generator(device=dev).manual_seed(1),
                                  cfg, B, P, mode="prefill")
    st = engine.init_serve(cfg, B, P + GEN, torch.bfloat16, device=dev)
    ops.reset_launches()
    registry.prefill(params, cfg, prompt, st.cache)
    torch.cuda.synchronize()
    launches = ops.launches["flash_attention"]
    prefill = time_ms(torch, lambda: registry.prefill(params, cfg, prompt,
                                                      st.cache),
                      reps=2, replays=3)
    H, D = cfg.num_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn((B, H, P, D), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    flash = time_ms(torch, lambda: ops.attention(q, k, v, causal=True),
                    reps=20, replays=5)
    print(json.dumps({
        "src": args.src, "card": smi, "prefill_card_ms": prefill,
        "flash_attention_ms": flash, "flash_launches_per_prefill": launches,
        "flash_share_ms": flash * cfg.num_layers,
        "shape": f"granite-8b B={B} prompt={P} bf16, flash B={B} H={H} "
                 f"S={P} D={D} causal"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
