#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, then builds the kernel libraries
   from `src/repro_torch/kernels/csrc/` with nvcc (one per source, in
   parallel) and prints the build time.
2. (s0)-(s2), the sharded node axis: five rank processes share the card in
   one gloo group (NCCL refuses two ranks on one device; subgroups of 2
   and 4 carry the smaller worlds), each keeping its rows of the node axis
   on the card, the halo rows and reductions staged through pinned host
   buffers. (s0) the shard rules on each rank's rows against the plain
   per-round path over the whole axis on the card: exact gossip at
   tests/shard_worker.py's shape (n = 16, d = 4096, ring, R = 3) on 2 and
   4 ranks and at HIGHD's (n = 10, d = 3072, ring, R = 8) on 2 and 5, bit
   for bit; sign (bit for bit) and int8 (f32 round-off) per-node wires at
   block_d 512; xi + gossip at N = 10, Bn = 100 (one `krasulina_xi`
   launch a rank); n = 10 on 4 ranks through the gather-roll. (s1) the
   governed PCA driver at HIGHD on 2 ranks, 48 rounds on a fake clock,
   exact and int8 (per-node) wires, against the single-process card run
   forced to impl="roll" (the same plan history, sin^2 < 0.05, the exact
   wire's iterate within 1e-5 rel + 1e-5 of its largest entry). (s2a)
   the reduced granite trainer (f32, Adam), 4 ranks x 1 node, exact and
   gossip modes, 3 rounds, against the single-process card run at
   n_nodes = 4, impl="roll" ((h0)'s bounds; exact consensus error 0,
   gossip's above 0). (s2b) granite-8b at its published widths cut to 2
   layers, 4 ranks x 1 node, 2 x 512 tokens per node, R = 2, 2 rounds per
   mode through the `StreamingDriver` (training takes the plain attention,
   which has a backward: the sharded path launches no flash kernel, and
   (s2b) requires 0). Prints the time per call,
   rounds/s, the bytes staged per round, each rank's peak memory and
   launches, and the phases' seconds.
3. Holds each kernel against its plain PyTorch version on the card over a
   sweep of shapes and dtypes, printing the max error and the tolerance, and
   the whole PCA superstep on the card against the CPU's plain path;
   `krasulina_xi` through the design its shape routes to and through each
   design forced where it runs (cluster-slab, two-pass), the same bits from
   two launches;
   `gossip_mix` (one pass of the composed schedule) against the round-by-round
   plain version at n = 1, 5, 10, 16 and 64 nodes and R = 0, 1, 8, and (the
   one-round schedule R times on a resident tile) at 65, 100 and 256 nodes;
   `gossip_mix_quant` at every cluster size its picker chooses (1 to 16
   blocks per statistic tile, slices not multiples of 32, d not a multiple
   of block_d), bit for bit against the one-block-per-tile kernel too,
   and with valid_d inside one block's slice, and a [300, 48] tile routed to
   the resident-tile kernel; `krasulina_xi_gossip` on both
   sides of the one-read kernel's shared-memory limit (f32 and bf16, R = 0,
   1, 8, the same bits from two launches), and one-read launches on two
   streams at once;
   `flash_attention` at the cases of tests/test_kernels.py, granite-8b's
   prefill shapes, every mask kind at D = 128 with Sq and Sk not multiples of
   128, and a D = 96 case, f32 and bf16, each launch taking the kernel its
   shape routes to (bf16 D = 64/128/256: the wgmma kernel; other bf16 head
   dims: mma.sync; f32: FMAs); at D = 256 (recurrentgemma-9b's local
   attention: wgmma in bf16, the FMA kernel in f32) every mask kind with Sq
   and Sk not multiples of 64, Sq < Sk unmasked, unmasked over Sk = 200, a
   fully masked row and B*H = 150, each bf16 case also through the mma.sync
   kernel, forced; seamless-m4t-medium's encoder and cross-attention shapes
   at D = 64 (wgmma, unmasked) at 4096 and 200 frames; and recurrentgemma's
   own prefill shape (B = 2, H = 16, S = 4096, window 2048, its one KV head
   broadcast as the model's `_flash` does; wgmma, and mma.sync forced).
   These bf16 cases are held to the bound of bf16 rounding
   (`compare_bf16_attention`), the others to tests/test_kernels.py's
   tolerances.
4. Drives the port's main paths, each run with the launch counts set to 0
   just before it and read just after:
   (a)-(c) streaming PCA at the paper's Fig. 8 size (d = 3072, N = 10 nodes,
   B = 1000 samples per round, ring gossip R = 8): the governed
   `StreamingDriver` (fused `krasulina_xi_gossip`, every launch through the
   one-read kernel), `run_dm_krasulina`
   (`krasulina_xi`) and `run_d_krasulina(fuse_xi=False)` (`krasulina_xi`
   then `gossip_mix`), each ending finite with sin^2 < 0.05;
   (d) the governed driver with int8 tile-statistics gossip (`krasulina_xi`
   then `gossip_mix_quant`, 48 launches each, no fused launch, every quantized
   launch with clusters of 16 blocks), sin^2 < 0.05;
   (e) `run_d_krasulina` with sign tile-statistics gossip, sin^2 falling;
   every `krasulina_xi` launch of (b)-(e) through the cluster-slab kernel;
   (f) the convex track at the paper's Fig. 9 size: quantized D-SGD logistic
   regression (no quantization, int8 and sign tile statistics on the same
   draws; int8 within 5% and sign within 2x of the unquantized excess
   risk; the quantized wire's launches with one block per tile), `run_dmb` at
   Fig. 6, and D-SGD over a 6-regular expander beating local SGD.
   (g0) a 2-layer reduced granite-8b in f32 served on the card and on the
   CPU from the same parameters: prefill logits within 1e-3, and equal
   greedy tokens from `generate` and `ContinuousBatchingEngine` (5 requests
   of 24 tokens through 2 slots);
   (g) granite-8b at full width (36 layers, bf16, seeded random weights):
   (g1) static `generate`, batch 4, prompt 512, 32 new tokens; (g2)
   `ContinuousBatchingEngine`, 8 slots, 16 requests of 128-512 tokens (200
   among them), 32 new tokens each, one `swap_params` mid-traffic; every
   prefill of more than 16 tokens launches `flash_attention` once per
   layer through the wgmma kernel (72 launches in (g1), 576 in (g2)), and no
   other kernel runs. Prints tokens/s, ms per decode step and peak memory.
   (h0) the decentralized LM trainer (N = 4 nodes, ring R = 2, Adam) on a
   2-layer reduced granite-8b in f32, 3 rounds on the card and on the CPU
   from the same state and the same `MarkovTokenStream` draws, on the exact
   wire (`gossip_mix` once per round) and on the int8 tile wire
   (`gossip_mix_quant`): losses within rtol 1e-4, the parameters within
   1e-4 (99.9% of them; every one within 3 lr per round, Adam's reach on a
   gradient of float noise), each node's wq / wk / wv gradient nonzero and
   within 1e-4, and no `flash_attention` launch (training differentiates
   `blockwise_attention`);
   (h1) granite-8b at full width cut to 2 layers (637.55 M parameters per
   node, bf16 with f32 masters, Adam at 3e-4) trained by the
   `StreamingDriver` with the trainer's own builder: 4 supersteps of K = 2
   rounds, 8 sequences of 512 tokens per round, the packed [4, D] bf16
   gradient buffer mixed by `gossip_mix` once per round (8 launches, no
   other kernel); (h2) the same on the int8 tile wire (`gossip_mix_quant`
   8, `gossip_mix` 0). Each requires finite, falling losses, a consensus
   error > 0 and a peak under 80 GB, and prints rounds/s, samples/s,
   tokens/s, the host sampler's ms per round, the card's ms per staged
   superstep, the card's ms for each step of one more round (each node's
   forward and backward, the gradient copies, pack, mix, consensus error,
   Adam) and the peak memory.
   (i) elastic PCA at HIGHD (K = 4, 12 supersteps, ungoverned, numpy
   draws): the exact and int8 tile wires under `death:3@2-6,flaky:7@3-9p2`
   (cohorts of 10, 9 and 8 nodes) and the straggler policy "drop" under
   `slow:2@2-6x4`, each on the card and on the CPU: equal membership events
   and compiled signatures, each signature built once (a rejoin builds
   nothing), sin^2 < 0.05, the iterates and sin^2 card vs CPU within f32's
   bound (exact wire) or a compressor step (int8), launches by node count;
   (j) the eight registered scenarios through
   `krasulina_superstep_builder(mix=build_mix(scn))` and the driver with
   their link faults, card vs CPU: one build each, `krasulina_xi` only;
   (k0) the trainer's cohort superstep, error feedback (int8) and a
   scheduled mix on the reduced f32 config, card vs CPU at (h0)'s bounds;
   (k1) granite-8b at (h1)'s shape under `death:1@1-4` on the exact and
   int8 wires (the 3-node cohort in place, `gossip_mix` / `gossip_mix_quant`
   at n = 3, rejoin sync), peak memory < 80 GB; (k2) error feedback on the
   int8 wire (`ef_rel` printed); (k3) tv_rte/lossy at n = 4 through the
   scheduled matmul.
   (l0) durability on the main path: (a)'s governed driver at HIGHD
   (prefetch depth 2, a fake clock) on the exact and int8 wires, 6
   supersteps uninterrupted, then 3 with a `RunSnapshotter` and 3 from a
   fresh driver resumed from its root: the final iterate equal bit for bit,
   the counters and rounds equal, no failed save, the launches by design of
   (a) and (d); then (i)'s churn at prefetch depth 0, cut at superstep 4
   mid-shrink: bit-identical iterates, the same membership events, no
   superstep built twice after the resume. Prints the snapshot's dispatch
   ms, the writer's ms per save and the bytes per save.
   (l1) train-to-serve at (h1)'s shape with a governed `SnapshotPublisher`:
   after each superstep a `ContinuousBatchingEngine` (bf16, 4 slots) polls
   it and takes 2 requests of 128-512 prompt tokens, 16 new tokens each;
   versions strictly increasing, every request complete, the last
   published params within one bf16 step of the nodes' f32 mean,
   `gossip_mix` 8 and `flash_attention` once per layer per prefill (wgmma),
   peak < 80 GB; prints the publish's dispatch and card ms, the staleness
   and rounds/s beside (h1)'s.
   (l2) resume across devices: (h0)'s reduced f32 trainer snapshotted on
   the card at superstep 2 of 4, resumed on the CPU and on the card: the
   continuations within (h0)'s bounds, and the card resume equal to the
   uninterrupted card run bit for bit where two uninterrupted card runs
   repeat their bits.
   (m0) the six attention-based archs beside granite-8b (phi4-mini-3.8b,
   starcoder2-15b, chameleon-34b, minicpm3-4b, qwen2-moe-a2.7b,
   llama4-scout-17b-a16e; llama4 with 4 layers, its iRoPE period), reduced
   and in f32 with the same parameters on the card and on the CPU: prefill
   logits within 1e-3, greedy tokens equal over 8 steps, `loss_fn`'s ce and
   aux within rtol 1e-4, the f32 flash kernel once per layer per prefill
   (none for minicpm3, whose MLA attends through `blockwise_attention`);
   (m1) qwen2-moe-a2.7b at full width and depth (24 layers, 14.00 B
   parameters, bf16, seeded random weights): static `generate` at batch 4,
   prompt 512, 32 new tokens, then 16 requests through 8 slots of the
   continuous engine; 24 wgmma flash launches per prefill, finite logits,
   tokens in the vocabulary; prints prefill tokens/s, decode ms per step
   (wall, and the card's from a graph), peak GiB, and one prefill layer's
   attention and MoE FFN on the card;
   (m2) phi4-mini-3.8b (32 layers) and minicpm3-4b (62, no flash launch)
   at full depth, batch 4, prompt 512; starcoder2-15b cut to 2 layers,
   batch 1, prompt 4608, with the ring cache and with the full cache (the
   same greedy tokens over 16 decode steps); llama4-scout cut to 4 layers,
   batch 1, prompt 8704; chameleon-34b cut to 2 layers, batch 4, prompt
   512; each at full width in bf16, a wgmma flash launch per GQA layer per
   prefill;
   (m3) (h0)'s trainer on reduced qwen2-moe in f32 (4 nodes, ring R = 2,
   Adam, 3 rounds) on the card and on the CPU: (h0)'s bounds, 3
   `gossip_mix` launches, the router's aux loss > 0.
   (n0) the recurrent and encoder-decoder families reduced, in f32, the
   same parameters on the card and on the CPU (mamba2-2.7b 2 layers,
   recurrentgemma-9b 5: one (rglru, rglru, local attention) period and a
   tail, seamless-m4t-medium 2 + 2 over 200 frames): prefill logits
   within 1e-3, greedy tokens equal over 8 steps, the decoded tokens equal
   to the argmax of a prefill of the extended prompt, `loss_fn`'s ce
   within rtol 1e-4, the
   f32 flash kernel once per attention layer per prefill (none for
   mamba2; encoder, self and cross layers for seamless);
   (n1) recurrentgemma-9b whole (38 layers, 9.396 B tensors' entries,
   8.52 B by the reference's `param_count()`, bf16): a prefill of
   2 x 4096 tokens (past its 2048 window) with 12 wgmma flash launches
   at D = 256, 16 greedy decode steps, and 8 requests through 4 slots of
   the continuous engine; one prefill layer of each kind timed apart;
   (n2) mamba2-2.7b whole (64 layers, 4 x 512, 16 decode steps, 16
   requests through 8 slots, no flash launch) and seamless-m4t-medium
   whole (4 x 4096 frames, a 4 x 64 decoder prompt, 16 greedy steps
   through `generate`: 24 unmasked and 12 causal wgmma launches at D = 64
   per prefill). Each prints prefill ms on the card and on the wall,
   decode ms per step and peak memory.
5. Times every kernel at the main path's shapes and at a wide shape
   (N=16, d=32768; flash_attention at S = 512 and 4096, beside the mma.sync
   kernel at the same shapes, and at recurrentgemma-9b's prefill shape at
   D = 256, beside the mma.sync kernel there too) against its bound, its
   plain version and, where one PyTorch call computes the same function,
   that call; beside the redesigned kernels, their earlier designs in the
   same run
   (`gossip_mix_quant` also at R = 0, 1, 8 and at path (f)'s shape;
   `krasulina_xi` also cold, with a 64 MB buffer written between calls);
   `gossip_mix` and `gossip_mix_quant` also at the trainer's shape (the
   [4, D] bf16 buffer of (h), R = 2) and at (k1)'s 3-node cohort, routed,
   held against the plain version on their first and last columns
   (`gossip_mix_quant` also forced onto each design, which must give the
   same bits), and `gossip_mix` on one f32 error-feedback chunk of (k2),
   held whole; prints one `{"kernels": [...]}` JSON line, a row per kernel
   with its `design`, its launches by node count (the node-axis kernels)
   and, for the two gossip kernels, `trainer` and `n3` entries (and
   `ef_chunk` for `gossip_mix`); the ranks' `krasulina_xi` and
   `flash_attention` launches of (s0)-(s2) are in their `launches` and,
   by phase and rank, under an "s" key of `launches_by_nodes` and
   `launches_by_kernel`.

The line before the kernels line gives the run's seconds from the start
of the build. The last line is `{"ok": true, "device": {...}}`. Any
mismatch or fault raises and exits non-zero; there is no CPU path and no
fallback. Without a CUDA card, or without the repository around it, it
exits non-zero and prints no result.
"""
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 1e-3)}  # (rtol, atol)
# gossip_mix_quant: the f32 bound of tests/test_consensus_engine.py
QUANT_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (5e-2, 1e-3)}
HIGHD_N, HIGHD_B, HIGHD_R, HIGHD_K = 10, 1000, 8, 8
REPLACES = {
    "krasulina_xi": "src/repro/kernels/krasulina_update.py:59",
    "krasulina_xi_gossip": "src/repro/kernels/krasulina_update.py:132",
    "gossip_mix": "src/repro/kernels/consensus.py:52",
    "gossip_mix_quant": "src/repro/kernels/consensus.py:121",
    "flash_attention": "src/repro/kernels/flash_attention.py:92",
}
# tests/test_kernels.py:63 CASES, then granite-8b's prefill (H = 32, D = 128),
# every mask kind at D = 128 with Sq and Sk not multiples of the 128-row tiles,
# B*H > 132 SMs with Sq < Sk, and a head dim the wgmma kernel does not take:
# (B, H, Sq, Sk, D, causal, window, chunk)
FLASH_CASES = [
    (1, 2, 128, 128, 64, True, 0, 0),
    (2, 2, 256, 256, 64, True, 0, 0),
    (1, 1, 256, 256, 128, True, 64, 0),
    (1, 2, 256, 256, 64, True, 0, 128),
    (1, 1, 200, 200, 64, True, 0, 0),
    (1, 1, 128, 384, 64, True, 0, 0),
    (1, 32, 512, 512, 128, True, 0, 0),
    (1, 32, 200, 200, 128, True, 0, 0),
    (1, 8, 333, 333, 128, True, 0, 0),
    (1, 8, 333, 333, 128, True, 100, 0),
    (1, 8, 333, 333, 128, True, 0, 96),
    (1, 8, 190, 96, 128, False, 0, 0),
    (1, 150, 130, 300, 128, True, 0, 0),
    (1, 2, 64, 256, 96, False, 0, 0),
]
# their own generator's draws, so that the main path's stay the same: D =
# 256 (recurrentgemma-9b): every mask kind, ragged, Sq < Sk unmasked, and
# unmasked over a ragged key count; seamless-m4t-medium's encoder and
# cross-attention shapes, at 4096 frames and at 200 (ragged); D = 256 with
# fully masked rows (Sq > Sk under a window) and with B*H > 132 SMs
FLASH_CASES_NEW = [
    (1, 4, 333, 333, 256, True, 0, 0),
    (1, 4, 333, 333, 256, True, 100, 0),
    (1, 4, 333, 333, 256, True, 0, 96),
    (1, 4, 190, 96, 256, False, 0, 0),
    (2, 3, 72, 256, 256, False, 0, 0),
    (1, 4, 200, 200, 256, False, 0, 0),
    (2, 3, 72, 200, 256, False, 0, 0),
    (1, 16, 4096, 4096, 64, False, 0, 0),
    (4, 16, 64, 4096, 64, False, 0, 0),
    (2, 16, 200, 200, 64, False, 0, 0),
    (2, 16, 24, 200, 64, False, 0, 0),
    (1, 2, 96, 40, 256, True, 16, 0),
    (1, 150, 130, 300, 256, True, 0, 0),
]
# (n0)'s seamless frames: a count that is not a multiple of 64 or 128
N0_FRAMES = 200
# recurrentgemma-9b's prefill at D = 256: (B, H, S, window), one KV head
RG_FLASH = (2, 16, 4096, 2048)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # tests/test_kernels.py:85
# 64: the most the composed gossip_mix kernel takes; beyond, "rounds"
GOSSIP_NODES = (1, 5, 10, 16, 64)
GOSSIP_ROUNDS_NODES = (65, 100, 256)
GRANITE_LAYERS, GEN = 36, 32
# the attention model families (m0)-(m3): the six archs beside granite-8b,
# and (m2)'s (arch, layers or 0 for full depth, batch, prompt): prompts past
# starcoder2's 4096-token window and llama4's 8192-token chunk
M_ARCHS = ("phi4-mini-3.8b", "starcoder2-15b", "chameleon-34b", "minicpm3-4b",
           "qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
M2_CASES = [("phi4-mini-3.8b", 0, 4, 512), ("minicpm3-4b", 0, 4, 512),
            ("starcoder2-15b", 2, 1, 4608),
            ("llama4-scout-17b-a16e", 4, 1, 8704),
            ("chameleon-34b", 2, 4, 512)]
M2_GEN = 17  # the prefill's token and 16 decode steps
# the recurrent and encoder-decoder families (n0)-(n2): (n0)'s reduced
# depths (recurrentgemma: one period and a tail), and (n2)'s seamless
# shape (batch, frames, decoder prompt)
N_ARCHS = {"mamba2-2.7b": 2, "recurrentgemma-9b": 5, "seamless-m4t-medium": 2}
SEAMLESS_B, SEAMLESS_FRAMES, SEAMLESS_P = 4, 4096, 64
# the trainer path (h): 4 nodes, ring R = 2, K = 2 rounds per superstep,
# 4 supersteps, 8 sequences of 512 tokens per round, granite-8b cut to 2
# layers
TRAIN_N, TRAIN_R, TRAIN_K, TRAIN_SUPERSTEPS = 4, 2, 2, 4
TRAIN_B, TRAIN_S, TRAIN_LAYERS = 8, 512, 2
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu" for name in REPLACES}
# the main path's flash kernel (bf16, D = 64, 128 and 256); flash_attention.cu
# keeps the mma.sync and f32 kernels
SOURCES["flash_attention"] = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
DESIGN = {
    "krasulina_xi": "cluster-slab",
    "krasulina_xi_gossip": "one-read+composed",
    "gossip_mix": "composed",
    "gossip_mix_quant": "cluster-tile; resident-tile from 132 tiles at n<=16",
    "flash_attention": "wgmma+tma",
}
# gossip_mix_quant, (block_d, d, blocks per statistic tile): every cluster
# size the picker chooses; d is not a multiple of block_d, and the slices of
# 50, 50, 38 and 63 columns are not multiples of 32
QUANT_CLUSTER_CASES = [(24, 100, 1), (100, 250, 2), (200, 1000, 4),
                       (300, 1000, 8), (512, 3149, 16), (1000, 2500, 16)]
# krasulina_xi_gossip, (N, Bn, d, dtype, design): both sides of the one-read
# kernel's shared-memory limit at d = 3072 (f32: N = 17 fits, 18 does not;
# bf16: 33 and 34), the wide shape, and a row stride the TMA cannot take
XI_GOSSIP_DESIGN_CASES = [
    (10, 100, 3072, "float32", "one-read"),
    (17, 100, 3072, "float32", "one-read"),
    (18, 100, 3072, "float32", "two-pass"),
    (16, 4, 32768, "float32", "one-read"),
    (8, 3, 70, "float32", "two-pass"),
    (10, 100, 3072, "bfloat16", "one-read"),
    (33, 100, 3072, "bfloat16", "one-read"),
    (34, 100, 3072, "bfloat16", "two-pass"),
    (16, 4, 32768, "bfloat16", "one-read"),
]


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def compare(name, got, want, dtype_name, tol=TOL):
    """Max |kernel - plain|, held to rtol * max|plain| + atol."""
    rtol, atol = tol[dtype_name]
    err = (got.float() - want.float()).abs().max().item()
    limit = rtol * want.float().abs().max().item() + atol
    ok = math.isfinite(err) and err <= limit
    print(f"check {name}: max_abs_err={err:.3e} limit={limit:.3e} "
          f"(rtol={rtol}, atol={atol} of max|plain|) {'ok' if ok else 'FAIL'}")
    require(ok, f"{name} disagrees with its plain version")
    return err


def compare_close(name, got, want, tol):
    """|kernel - plain| <= tol + tol * |plain| element by element (the rule
    of numpy's assert_allclose with rtol = atol = tol)."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    excess = (diff - tol * want.float().abs()).max().item()
    ok = math.isfinite(err) and excess <= tol
    print(f"check {name}: max_abs_err={err:.3e} (rtol=atol={tol}, element "
          f"by element) {'ok' if ok else 'FAIL'}")
    require(ok, f"{name} disagrees with its plain version")
    return err


def compare_bf16_attention(name, got, q, k, v, masks):
    """bf16 attention held to the bound of bf16 rounding (unit roundoff u =
    2^-8), element by element: |kernel - plain| <= 2^-6 |plain| + 2^-8
    (P |v|). Each side rounds its output to bf16 (u |out| each: 2u, here
    taken twice over), and the kernel rounds each softmax weight p to bf16
    before the P V product, which moves an output by at most u sum_j p_j
    |v_j| (all roundings of one sign); P |v| is the plain attention of |v|
    in f32. Prints the largest error and its largest share of the limit."""
    import torch

    from repro_torch.kernels import ref
    want = ref.attention_ref(q, k, v, **masks).float()
    mag = ref.attention_ref(q, k, v.float().abs(), **masks)
    diff = (got.float() - want).abs()
    limit = 2.0 ** -6 * want.abs() + 2.0 ** -8 * mag
    err = diff.max().item()
    share = (diff / limit.clamp_min(torch.finfo(torch.float32).tiny)).max()
    ok = math.isfinite(err) and bool((diff <= limit).all())
    print(f"check {name}: max_abs_err={err:.3e}, largest share of the limit "
          f"2^-6|plain| + 2^-8 P|v| = {share.item():.3f} (bf16 rounding, "
          f"element by element) {'ok' if ok else 'FAIL'}")
    require(ok, f"{name} disagrees with its plain version")
    return err


# (s0)-(s2) the sharded node axis: S_WORLD rank processes share the card in
# one gloo group (NCCL refuses two ranks on one device), spawned once by
# `shard_phases`; subgroups of 2 and 4 ranks carry the smaller worlds. Each
# rank keeps its node rows and computes on the card; halo rows and
# reductions cross between ranks staged through pinned host buffers
S_WORLD, S_TIMEOUT = 5, 420
S_LR = 1e-4  # (s2a): (h0)'s Adam rate
S1_SUPERSTEPS, S1_DT = 6, 1e-3  # (s1): 48 rounds on a fake clock
# (s0): (label, ranks, n, d, R, topology self-weight, kind)
S0_CASES = [
    ("shard_worker", 2, 16, 4096, 3, 0.5, "exact"),
    ("shard_worker", 4, 16, 4096, 3, 0.5, "exact"),
    ("shard_worker", 4, 16, 4096, 3, 0.5, "sign"),
    ("shard_worker", 4, 16, 4096, 3, 0.5, "int8"),
    ("HIGHD", 2, HIGHD_N, 3072, HIGHD_R, 0.0, "exact"),
    ("HIGHD", 5, HIGHD_N, 3072, HIGHD_R, 0.0, "exact"),
    ("HIGHD", 2, HIGHD_N, 3072, HIGHD_R, 0.0, "sign"),
    ("HIGHD", 2, HIGHD_N, 3072, HIGHD_R, 0.0, "int8"),
    ("HIGHD", 2, HIGHD_N, 3072, HIGHD_R, 0.0, "xi_gossip"),
    ("HIGHD uncovered", 4, HIGHD_N, 3072, HIGHD_R, 0.0, "exact"),
]


def _s_decisions(history):
    return [(rec["bucket"], rec["plan"].mu, rec["plan"].regime,
             tuple(rec["counters"])) for rec in history]


class _SClock:
    """Advances dt per read: the governor reads the same round times in
    every run."""

    def __init__(self, dt):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def s_rank(rank: int, store: str, workdir: str) -> int:
    """One rank of (s0)-(s2): `python3 chip_smoke.py --s-rank RANK STORE
    DIR`. Saves its results to DIR/rank{RANK}.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    from repro_torch import convert, dist as rdist
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.paper_pca import HIGHD, PCARunConfig
    from repro_torch.core import krasulina, mixing, problems
    from repro_torch.core.packing import tree_leaves, tree_map
    from repro_torch.data.lm import MarkovTokenStream
    from repro_torch.data.synthetic import make_pca_host_sampler
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import trainer
    from repro_torch.train.driver import EngineConfig, StreamingDriver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=S_WORLD,
                            timeout=datetime.timedelta(seconds=180))
    groups = {2: dist.new_group([0, 1]), 4: dist.new_group([0, 1, 2, 3]),
              S_WORLD: None}
    meshes = {E: make_host_mesh(group=g) for E, g in groups.items()
              if rank < E}
    res = {"seconds": {}}

    def sync_ms(fn, reps=3):
        """Wall ms per call of fn, synchronized (the halo messages block the
        host, so a card-only timer would miss them), median of reps."""
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return sorted(runs)[reps // 2]

    # (s0) the shard rules on the card, each against the port's plain
    # per-round path over the whole node axis, this rank's rows
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    s0 = []
    for idx, (label, E, n, d, R, sw, kind) in enumerate(S0_CASES):
        if E not in meshes:
            continue
        mesh = meshes[E]
        rows = rdist.node_rows(mesh, n)
        sched = mixing.schedule("ring", n, sw)
        gen.manual_seed(100 + idx)
        x = torch.randn((n, d), generator=gen, device=dev)
        mine = x[rows].contiguous()
        if kind == "xi_gossip":
            w = torch.randn((n, d), generator=gen, device=dev)
            z = torch.randn((n, 100, d), generator=gen, device=dev)
            wl, zl = w[rows].contiguous(), z[rows].contiguous()
            call = lambda: ops.sharded_krasulina_xi_gossip(wl, zl, sched, R,
                                                           mesh)
            want = ref.gossip_mix_ref(ref.krasulina_xi_ref(w, z), sched,
                                      R)[rows]
            impl = "shard"
        else:
            quant = "none" if kind == "exact" else kind
            op = mixing.circulant_mix_op(
                sched, n, R, quantization=quant, stats="node", block_d=512,
                mesh=mesh, device=dev)
            impl = op.impl
            call = lambda: op(mine)
            want = (ref.gossip_mix_ref(x, sched, R) if quant == "none" else
                    ref.gossip_mix_quant_ref(x, sched, R, quant, block_d=512,
                                             per_node=True))[rows]
        ops.reset_launches()
        rdist.reset_stats()
        got = call()
        torch.cuda.synchronize()
        staged = rdist.stats["staged_bytes"] / max(R, 1)
        launches = dict(ops.launches)
        err = (got - want).abs().max().item()
        s0.append({"label": label, "ranks": E, "n": n, "d": d, "R": R,
                   "kind": kind, "impl": impl, "rows": (rows.start, rows.stop),
                   "equal": bool(torch.equal(got, want)), "max_abs_err": err,
                   "max_plain": want.abs().max().item(),
                   "staged_bytes_per_round": staged,
                   "ms": sync_ms(call), "launches": launches})
    res["s0"] = s0
    dist.barrier()
    res["seconds"]["s0"] = time.perf_counter() - t_phase

    # (s1) the governed PCA driver at HIGHD on 2 ranks, exact and int8
    # (per-node statistics, the shard rule's wire)
    t_phase = time.perf_counter()
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    if 2 in meshes:
        mesh = meshes[2]
        stream = convert.pca_stream(inp["cov"], inp["sqrt_cov"], inp["top"],
                                    HIGHD.lambda1, HIGHD.eigengap,
                                    device=dev)
        sin2 = lambda w: problems.sin2_error(w, stream.top_eigvec)
        res["s1"] = {}
        for wire, avg in s1_wires():
            cfg = PCARunConfig(pca=HIGHD, averaging=avg, stream=s1_stream())
            build = krasulina.krasulina_superstep_builder(
                avg, HIGHD_N, lambda t: 5.0 / t, metric=sin2, device=dev,
                mesh=mesh)
            state = krasulina.init_krasulina_state(inp["w0"], avg, HIGHD_N,
                                                   device=dev, mesh=mesh)
            ops.reset_launches()
            rdist.reset_stats()
            t0 = time.perf_counter()
            with StreamingDriver(cfg, mesh, state,
                                 make_pca_host_sampler(stream),
                                 superstep_builder=build, n_nodes=HIGHD_N,
                                 batch=HIGHD_B, clock=_SClock(S1_DT),
                                 device=dev,
                                 engine=EngineConfig(superstep=HIGHD_K,
                                                     prefetch_depth=2)) as drv:
                state, hist = drv.run(S1_SUPERSTEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res["s1"][wire] = {
                "decisions": _s_decisions(hist), "w": state.w.cpu(),
                "rows": (rdist.node_rows(mesh, HIGHD_N).start,
                         rdist.node_rows(mesh, HIGHD_N).stop),
                "sin2": hist[-1]["metrics"]["metric"],
                "consensus_err": hist[-1]["metrics"]["consensus_err"],
                "rounds": state.t, "rounds_per_s": state.t / wall,
                "launches": dict(ops.launches),
                "xi_by_design": dict(ops.xi_launches),
                "staged_bytes_per_round":
                    rdist.stats["staged_bytes"] / state.t,
                "finite": bool(torch.isfinite(state.w).all())}
        del stream
    dist.barrier()
    res["seconds"]["s1"] = time.perf_counter() - t_phase

    # (s2a) reduced granite-8b in f32, 4 ranks x 1 node, 3 rounds per mode
    t_phase = time.perf_counter()
    cfg_r = reduced(get_config("granite-8b"))
    if 4 in meshes:
        mesh = meshes[4]
        res["s2a"] = {}
        for mode in ("exact", "gossip"):
            run = s2_run(cfg_r, mode, "float32")
            st = trainer.init_state(run, torch.Generator().manual_seed(0))
            if mode == "gossip":
                st = trainer.replicate_for_nodes(st, 1)
            to = lambda tree: tree_map(lambda t: t.to(dev), tree)
            st = trainer.TrainState(to(st.params), st.opt._replace(
                m=to(st.opt.m), v=to(st.opt.v), master=to(st.opt.master)))
            step = trainer.build_train_step(run, mesh, device=dev)
            ops.reset_launches()
            losses, cerrs = [], []
            for b in s2a_batches(cfg_r):
                b = {k: torch.from_numpy(v) for k, v in b.items()}
                if mode == "gossip":
                    b = {k: v.reshape(4, 2, -1)[rank:rank + 1]
                         for k, v in b.items()}
                else:
                    b = {k: v[2 * rank:2 * rank + 2] for k, v in b.items()}
                st, m = step(st, {k: v.to(dev) for k, v in b.items()})
                losses.append(float(m["loss"]))
                cerrs.append(float(m["consensus_err"]))
            res["s2a"][mode] = {
                "losses": losses, "consensus_errs": cerrs,
                "params": [p.cpu() for p in tree_leaves(st.params)],
                "launches": dict(ops.launches)}
            del st
    dist.barrier()
    res["seconds"]["s2a"] = time.perf_counter() - t_phase

    # (s2b) granite-8b at its published widths, 2 layers, 4 ranks x 1
    # node, 2 x 512 tokens per node per round, through the StreamingDriver
    # with the trainer's builder (training takes the plain attention, which
    # has a backward: no flash launch)
    t_phase = time.perf_counter()
    if 4 in meshes:
        mesh = meshes[4]
        cfg_h = dataclasses.replace(get_config("granite-8b"),
                                    num_layers=TRAIN_LAYERS)
        data = MarkovTokenStream(cfg_h.vocab_size, seed=0)

        def sample(rng, n):
            toks = data.sample(rng, n, TRAIN_S + 1)
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

        res["s2b"] = {}
        for mode in ("exact", "gossip"):
            run = s2_run(cfg_h, mode, "bfloat16")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            st = trainer.init_state(run, torch.Generator(device=dev)
                                    .manual_seed(0))
            if mode == "gossip":
                # the rank's one node: views of the state just drawn (a
                # copy would hold the state twice while the four ranks
                # draw theirs at once)
                one = lambda tree: tree_map(lambda t: t.unsqueeze(0), tree)
                st = trainer.TrainState(one(st.params), st.opt._replace(
                    step=(st.opt.step,), m=one(st.opt.m), v=one(st.opt.v),
                    master=one(st.opt.master),
                    ef_residual=one(st.opt.ef_residual)))
            ops.reset_launches()
            rdist.reset_stats()
            t0 = time.perf_counter()
            with StreamingDriver(run, mesh, st, sample, batch=2 * 4,
                                 device=dev,
                                 engine=EngineConfig(superstep=1,
                                                     prefetch_depth=2,
                                                     replan_every=0)) as drv:
                st, hist = drv.run(2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            train_launches = dict(ops.launches)
            staged = rdist.stats["staged_bytes"] / len(hist)
            peak = torch.cuda.max_memory_allocated()
            n_params = sum(p[0].numel() if mode == "gossip" else p.numel()
                           for p in tree_leaves(st.params))
            res["s2b"][mode] = {
                "losses": [rec["metrics"]["loss"] for rec in hist],
                "consensus_errs": [rec["metrics"]["consensus_err"]
                                   for rec in hist],
                "round_s": [rec["wall_s"] for rec in hist],
                "rounds_per_s": hist[-1]["rounds_per_s"], "wall_s": wall,
                "peak_bytes": peak, "staged_bytes_per_round": staged,
                "n_params": n_params, "launches": train_launches}
            del st, drv
    dist.barrier()
    res["seconds"]["s2b"] = time.perf_counter() - t_phase
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def s1_wires():
    """(s1)'s wires: exact gossip, and int8 with per-node statistics."""
    from repro_torch.configs.base import AveragingConfig

    return (("exact", AveragingConfig(mode="gossip", rounds=HIGHD_R,
                                      topology="ring")),
            ("int8", AveragingConfig(mode="gossip", rounds=HIGHD_R,
                                     topology="ring", quantization="int8",
                                     quant_stats="node",
                                     quant_block_d=512)))


def s1_stream():
    """(a)'s stream rates."""
    from repro_torch.configs.base import StreamConfig

    return StreamConfig(streaming_rate=5e3, processing_rate=1e6,
                        comms_rate=1e4)


def s2_run(cfg, mode, dtype):
    """(s2)'s run: ring R = TRAIN_R, Adam; (s2a) f32 at (h0)'s rate, (s2b)
    bf16 with f32 masters at (h1)'s."""
    from repro_torch.configs.base import SHAPES, AveragingConfig, RunConfig

    lr = S_LR if dtype == "float32" else 3e-4
    return RunConfig(model=cfg, shape=SHAPES["train_4k"],
                     averaging=AveragingConfig(mode, TRAIN_R, "ring"),
                     optimizer="adam", learning_rate=lr, param_dtype=dtype,
                     master_weights=dtype != "float32")


def s2a_batches(cfg):
    """(s2a)'s 3 rounds of 8 x 64 tokens, (h0)'s draws."""
    from repro_torch.data.lm import MarkovTokenStream

    data, rng = MarkovTokenStream(cfg.vocab_size, seed=0), \
        np.random.default_rng(0)
    out = []
    for _ in range(3):
        toks = data.sample(rng, 8, 65)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def shard_phases(dev) -> dict:
    """(s0)-(s2) on the card: the single-process references first, then
    S_WORLD rank processes (`s_rank`), joined under a deadline; prints each
    check and returns the ranks' krasulina_xi and flash_attention launches
    by phase, for the kernels line."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.paper_pca import HIGHD, PCARunConfig
    from repro_torch.core import averaging, krasulina, problems
    from repro_torch.core.packing import tree_leaves, tree_map
    from repro_torch.data.synthetic import (make_pca_host_sampler,
                                            make_pca_stream)
    from repro_torch.train import trainer
    from repro_torch.train.driver import EngineConfig, StreamingDriver

    t_all = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, ".smoke_ckpt", "shard")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    stream = make_pca_stream(HIGHD, device=dev)
    sin2 = lambda w: problems.sin2_error(w, stream.top_eigvec)
    w0 = np.random.default_rng(7).standard_normal(HIGHD.dim).astype(
        np.float32)
    w0 /= np.linalg.norm(w0)
    torch.save({"cov": stream.cov.cpu(), "sqrt_cov": stream.sqrt_cov.cpu(),
                "top": stream.top_eigvec.cpu(), "w0": w0},
               os.path.join(work, "inputs.pt"))
    # (s1)'s single-process card run (exact wire forced to
    # impl="roll", the xi then the op), (s2a)'s at n_nodes = 4
    # (impl="roll")
    ref1 = {}
    for wire, avg in s1_wires():
        mix = (averaging.make_gossip_mix(avg, HIGHD_N, impl="roll",
                                         device=dev)
               if wire == "exact" else None)
        build = krasulina.krasulina_superstep_builder(
            avg, HIGHD_N, lambda t: 5.0 / t, metric=sin2, mix=mix,
            fuse_xi=False, device=dev)
        with StreamingDriver(
                PCARunConfig(pca=HIGHD, averaging=avg, stream=s1_stream()),
                None, krasulina.init_krasulina_state(w0, avg, HIGHD_N,
                                                     device=dev),
                make_pca_host_sampler(stream), superstep_builder=build,
                n_nodes=HIGHD_N, batch=HIGHD_B, clock=_SClock(S1_DT),
                device=dev, engine=EngineConfig(superstep=HIGHD_K,
                                                prefetch_depth=0)) as drv:
            state, hist = drv.run(S1_SUPERSTEPS)
        ref1[wire] = (_s_decisions(hist), state.w.cpu(),
                      hist[-1]["metrics"]["metric"])
    del stream, state
    cfg_r = reduced(get_config("granite-8b"))
    ref2 = {}
    for mode in ("exact", "gossip"):
        run = s2_run(cfg_r, mode, "float32")
        st = trainer.init_state(run, torch.Generator().manual_seed(0))
        mix = None
        if mode == "gossip":
            st = trainer.replicate_for_nodes(st, 4)
            mix = averaging.make_gossip_mix(run.averaging, 4, impl="roll",
                                            device=dev)
        to = lambda tree: tree_map(lambda t: t.to(dev), tree)
        st = trainer.TrainState(to(st.params), st.opt._replace(
            m=to(st.opt.m), v=to(st.opt.v), master=to(st.opt.master)))
        step = trainer.build_train_step(run, None, n_nodes=4, mix=mix,
                                        device=dev)
        losses, cerrs = [], []
        for b in s2a_batches(cfg_r):
            if mode == "gossip":
                b = trainer.make_node_batch(b, 4)
            st, m = step(st, {k: torch.from_numpy(v).to(dev)
                              for k, v in b.items()})
            losses.append(float(m["loss"]))
            cerrs.append(float(m["consensus_err"]))
        ref2[mode] = (losses, cerrs,
                      [t.cpu() for t in tree_leaves(st.params)])
        del st
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_all
    # the ranks
    store = os.path.join(work, "store")
    procs = []
    for r in range(S_WORLD):
        log = open(os.path.join(work, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--s-rank", str(r),
             store, work], stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + S_TIMEOUT
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    for r in failed:
        with open(os.path.join(work, f"rank{r}.log")) as f:
            tail = f.read()[-3000:]
        print(f"(s) rank {r} exited {procs[r][0].returncode}:\n{tail}")
    require(not failed, f"(s): ranks {failed} failed or overran "
                        f"{S_TIMEOUT} s")
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(S_WORLD)]
    t_ranks = time.perf_counter() - t_all - t_ref

    # (s0)
    by_case = {}
    for r, rr in enumerate(res):
        for case in rr["s0"]:
            key = (case["label"], case["ranks"], case["kind"])
            by_case.setdefault(key, []).append(case)
    for (label, E, kind), cases in by_case.items():
        c0 = cases[0]
        require(len(cases) == E, f"(s0) {label} {kind}: {len(cases)} ranks "
                                 f"reported, expected {E}")
        bit = all(c["equal"] for c in cases)
        err = max(c["max_abs_err"] for c in cases)
        scale = max(c["max_plain"] for c in cases)
        exact_bits = kind in ("exact", "sign") and c0["impl"] == "shard"
        limit = 0.0 if exact_bits else (
            QUANT_TOL["float32"][0] * scale + QUANT_TOL["float32"][1]
            if kind == "int8" else
            TOL["float32"][0] * scale + TOL["float32"][1])
        ok = bit if exact_bits else err <= limit
        print(f"check (s0) {label} {kind} ranks={E} n={c0['n']} d={c0['d']} "
              f"R={c0['R']} impl={c0['impl']}: bit for bit {bit}, "
              f"max_abs_err={err:.3e} limit={limit:.3e}; ms per call by rank "
              f"{[round(c['ms'], 3) for c in cases]}; bytes staged per round "
              f"by rank {[int(c['staged_bytes_per_round']) for c in cases]}; "
              f"krasulina_xi by rank "
              f"{[c['launches']['krasulina_xi'] for c in cases]} "
              f"{'ok' if ok else 'FAIL'}")
        require(ok, f"(s0) {label} {kind} ranks={E} disagrees with the "
                    f"plain per-round path")
        require(c0["impl"] == ("roll" if "uncovered" in label else "shard"),
                f"(s0) {label}: impl {c0['impl']}")
        require(all(c["launches"]["gossip_mix"] == 0 and
                    c["launches"]["gossip_mix_quant"] == 0 for c in cases),
                f"(s0) {label}: a node-axis kernel ran on the sharded path")
        if kind == "xi_gossip":
            require(all(c["launches"]["krasulina_xi"] == 1 for c in cases),
                    f"(s0) {label}: krasulina_xi launches by rank")

    # (s1)
    for wire, (want_dec, want_w, want_sin2) in ref1.items():
        runs = [rr["s1"][wire] for rr in res[:2]]
        same = all(r["decisions"] == want_dec for r in runs)
        w = torch.cat([r["w"] for r in sorted(runs, key=lambda r: r["rows"])])
        d = (w - want_w).abs()
        bound = 1e-5 * want_w.abs() + 1e-5 * want_w.abs().max()
        within = bool((d <= bound).all())
        print(f"main (s1) driver HIGHD N={HIGHD_N} B={HIGHD_B} ring "
              f"R={HIGHD_R} K={HIGHD_K} {wire} wire on 2 ranks: sin2 "
              f"{[round(r['sin2'], 5) for r in runs]} (single process "
              f"{want_sin2:.5f}), plan history equal to the single "
              f"process's: {same} ({len(want_dec)} supersteps, mu "
              f"{[dd[1] for dd in runs[0]['decisions']]}), iterate vs the "
              f"single-process roll run: max_abs_err {d.max().item():.3e}, "
              f"within 1e-5 rel + 1e-5 max: {within}; rounds_per_s by rank "
              f"{[round(r['rounds_per_s'], 2) for r in runs]}; krasulina_xi "
              f"launches by rank {[r['launches']['krasulina_xi'] for r in runs]}"
              f" {json.dumps(runs[0]['xi_by_design'])}; launches "
              f"{json.dumps(runs[0]['launches'])}; bytes staged per round by "
              f"rank {[int(r['staged_bytes_per_round']) for r in runs]}")
        require(same, f"(s1) {wire}: plan history differs from the single "
                      f"process's")
        require(all(r["finite"] and r["sin2"] < 0.05 for r in runs),
                f"(s1) {wire}: sin2 not < 0.05")
        require(all(r["launches"]["krasulina_xi"] == r["rounds"]
                    for r in runs), f"(s1) {wire}: krasulina_xi launches")
        if wire == "exact":
            require(within, "(s1) exact: the iterate disagrees with the "
                            "single-process run")

    # (s2a)
    for mode, (want_l, want_c, want_p) in ref2.items():
        runs = [rr["s2a"][mode] for rr in res[:4]]
        loss_err = max(abs(a - b) / abs(b) for r in runs
                       for a, b in zip(r["losses"], want_l))
        if mode == "gossip":  # rank r holds node r
            got = [torch.cat([r["params"][i] for r in runs])
                   for i in range(len(want_p))]
        else:
            got = runs[0]["params"]
        d = torch.cat([(a - b).abs().ravel() for a, b in zip(got, want_p)])
        within = float((d <= 1e-4).float().mean())
        cerr = runs[0]["consensus_errs"]
        print(f"main (s2a) reduced granite-8b f32, 4 ranks x 1 node, ring "
              f"R={TRAIN_R}, adam, {mode}: losses {json.dumps(runs[0]['losses'])}"
              f" (single process n_nodes=4 impl=roll "
              f"{json.dumps(want_l)}, max rel err {loss_err:.2e}, limit "
              f"1e-5); parameters within 1e-4: {within:.6f} (limit >= "
              f"0.999), max_abs_err {d.max().item():.3e}; consensus_err "
              f"{json.dumps(cerr)}; launches {json.dumps(runs[0]['launches'])}")
        require(loss_err <= 1e-5, f"(s2a) {mode}: losses disagree")
        require(within >= 0.999 and d.max().item() <= 3 * S_LR * 3,
                f"(s2a) {mode}: parameters disagree")
        require(all(c == 0 for c in cerr) if mode == "exact"
                else all(c > 0 for c in cerr),
                f"(s2a) {mode}: consensus error {cerr}")
        require(all(r["launches"]["gossip_mix"] == 0 for r in runs),
                f"(s2a) {mode}: gossip_mix ran on the sharded path")

    # (s2b)
    flash = []
    for mode in ("exact", "gossip"):
        runs = [rr["s2b"][mode] for rr in res[:4]]
        r0 = runs[0]
        finite = all(math.isfinite(x) for r in runs for x in r["losses"])
        print(f"main (s2b) granite-8b full width, {TRAIN_LAYERS} layers, "
              f"{r0['n_params']} parameters per node, 4 ranks x 1 node, "
              f"2 x {TRAIN_S} tokens per node per round, ring R={TRAIN_R}, "
              f"{mode}: losses {json.dumps(r0['losses'])}, consensus_err "
              f"{json.dumps(r0['consensus_errs'])}; s per round by rank "
              f"{[[round(x, 3) for x in r['round_s']] for r in runs]}; "
              f"rounds_per_s (last) by rank "
              f"{[round(r['rounds_per_s'], 4) for r in runs]}; peak memory "
              f"by rank GB {[round(r['peak_bytes'] / 1e9, 2) for r in runs]};"
              f" bytes staged per round by rank "
              f"{[int(r['staged_bytes_per_round']) for r in runs]}; "
              f"launches {json.dumps(r0['launches'])}")
        require(finite, f"(s2b) {mode}: losses not finite")
        require(all(r["launches"]["gossip_mix"] == 0 and
                    r["launches"]["gossip_mix_quant"] == 0 and
                    r["launches"]["flash_attention"] == 0 for r in runs),
                f"(s2b) {mode}: a kernel ran in training on the sharded "
                f"path")
        require(all(r["peak_bytes"] < 80e9 / 4 for r in runs),
                f"(s2b) {mode}: a rank's peak is a quarter of the card or "
                f"more")
        require(all(c > 0 for c in r0["consensus_errs"]) if mode == "gossip"
                else all(c == 0 for c in r0["consensus_errs"]),
                f"(s2b) {mode}: consensus error {r0['consensus_errs']}")
        flash.append([r["launches"]["flash_attention"] for r in runs])
    seconds = res[0]["seconds"]
    print(f"main (s) seconds: references {t_ref:.1f}, ranks "
          f"{t_ranks:.1f} (rank 0: " + ", ".join(
              f"{k} {v:.1f}" for k, v in seconds.items()) +
          f"), all {time.perf_counter() - t_all:.1f}")
    shutil.rmtree(work, ignore_errors=True)
    xi = {"s0": [sum(c["launches"]["krasulina_xi"] for c in rr["s0"])
                 for rr in res],
          "s1": [sum(rr["s1"][w]["launches"]["krasulina_xi"]
                     for w in rr["s1"]) if "s1" in rr else 0 for rr in res]}
    return {"krasulina_xi": xi,
            "flash_attention": {"s2": [sum(f[r] for f in flash)
                                       for r in range(4)]}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    import torch.nn.functional as F

    from repro_torch import convert
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import (SHAPES, AveragingConfig,
                                          GovernorConfig, RunConfig,
                                          StreamConfig)
    from repro_torch.configs.paper_logreg import FIG6, FIG9
    from repro_torch.configs.paper_pca import FIG7, HIGHD, PCARunConfig
    from repro_torch.core import (averaging, dmb, dsgd, krasulina, mixing,
                                  problems, scenarios)
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.core.mixing import Membership
    from repro_torch.core import packing
    from repro_torch.core.packing import tree_leaves, tree_map
    from repro_torch.core.quantize import tile_compress
    from repro_torch.data.lm import MarkovTokenStream
    from repro_torch.data.synthetic import (make_logreg_stream,
                                            make_pca_host_sampler,
                                            make_pca_stream)
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels.consensus import (gossip_mix_quant_cuda,
                                               quant_route)
    from repro_torch.kernels.flash_attention import flash_variant
    from repro_torch.kernels.flash_attention import route as flash_route
    from repro_torch.kernels.consensus import gossip_design
    from repro_torch.kernels.krasulina_update import (krasulina_xi_cuda,
                                                      krasulina_xi_gossip_cuda,
                                                      xi_clusters,
                                                      xi_gossip_route,
                                                      xi_route)
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import registry
    from repro_torch.serve import engine
    from repro_torch.optim import make_optimizer
    from repro_torch.train import trainer
    from repro_torch.train.driver import EngineConfig, StreamingDriver

    # a reference states and sets both: full f32 products everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = t_start = time.perf_counter()
    per_lib = _cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + " ".join(f"{k}={v:.1f}s" for k, v in per_lib.items()))
    # (s0)-(s2): the sharded node axis, rank processes sharing the card
    s_launches = shard_phases(dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---------------------------------------------------------- kernel checks
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        # one w [d] per call ("shared", also across a batch of groups) or
        # one per node ("nodes"); B = 300 and d = 257 are ragged
        cases = [("shared", (1000, 3072)), ("shared", (300, 257)),
                 ("shared", (5, 32768)), ("shared", (10, 100, 3072)),
                 ("nodes", (10, 100, 3072)), ("nodes", (16, 4, 32768))]
        for wkind, zshape in cases:
            z = randn(*zshape, dtype=dtype)
            d = zshape[-1]
            w = randn(zshape[0], d, dtype=dtype) if wkind == "nodes" \
                else randn(d, dtype=dtype)
            want = ref.krasulina_xi_ref(w, z)
            route = xi_route(w, z)
            # the routed launch (counted under its design), then each design
            # forced where it runs; two launches give the same bits
            ops.reset_launches()
            got = ops.krasulina_xi(w, z)
            require(ops.xi_launches[route] == 1,
                    f"krasulina_xi {dn} z{zshape} did not take {route}: "
                    f"{ops.xi_launches}")
            C = xi_clusters.get((*((1,) if len(zshape) == 2 else ()),
                                 *zshape, dtype)) if route == "cluster-slab" \
                else None
            e = compare(f"krasulina_xi {dn} w{tuple(w.shape)} z{zshape} "
                        f"{route}" + (f" C={C}" if C else ""), got, want, dn)
            if dn == "float32" and wkind == "nodes" and zshape[1] == 100:
                errs["krasulina_xi"] = e
            for design in ("cluster-slab", "two-pass"):
                if design == "cluster-slab" and route != design:
                    continue
                forced = krasulina_xi_cuda(w, z, _design=design)
                again = krasulina_xi_cuda(w, z, _design=design)
                compare(f"krasulina_xi {dn} w{tuple(w.shape)} z{zshape} "
                        f"{design} (forced)", forced, want, dn)
                same = torch.equal(forced, again)
                print(f"check krasulina_xi {dn} z{zshape} {design}: two "
                      f"launches give the same bits {'ok' if same else 'FAIL'}")
                require(same, f"krasulina_xi {design} is not deterministic")
    for N in (10, 16):
        for bn in (4, 100):
            for d in (70, 3072, 32768):
                w, z = randn(N, d), randn(N, bn, d)
                for topo in ("ring", "circulant2"):
                    sched = mixing.schedule(topo, N)
                    for R in (0, 1, 8):
                        e = compare(
                            f"krasulina_xi_gossip float32 N={N} Bn={bn} d={d} "
                            f"{topo} R={R} {xi_gossip_route(w, z)}",
                            ops.krasulina_xi_gossip(w, z, sched, R),
                            ref.krasulina_xi_gossip_ref(w, z, sched, R),
                            "float32")
                        if (N, bn, d, topo, R) == (10, 100, 3072, "ring", 8):
                            errs["krasulina_xi_gossip"] = e
    w, z = randn(10, 3072, dtype=torch.bfloat16), randn(10, 100, 3072,
                                                        dtype=torch.bfloat16)
    sched = mixing.schedule("ring", 10)
    compare("krasulina_xi_gossip bfloat16 N=10 Bn=100 d=3072 ring R=8",
            ops.krasulina_xi_gossip(w, z, sched, 8),
            ref.krasulina_xi_gossip_ref(w, z, sched, 8), "bfloat16")
    # the design boundary: each design as its picker names it, the same bits
    # from a second launch (the one-read reduction has a fixed order)
    for N, bn, d, dn, design in XI_GOSSIP_DESIGN_CASES:
        dtype = getattr(torch, dn)
        w, z = randn(N, d, dtype=dtype), randn(N, bn, d, dtype=dtype)
        sched = mixing.schedule("ring", N)
        for R in (0, 1, 8):
            ops.reset_launches()
            got = ops.krasulina_xi_gossip(w, z, sched, R)
            again = ops.krasulina_xi_gossip(w, z, sched, R)
            require(ops.xi_gossip_launches[design] == 2,
                    f"krasulina_xi_gossip N={N} Bn={bn} d={d} {dn} did not "
                    f"take {design}: {ops.xi_gossip_launches}")
            compare(f"krasulina_xi_gossip {dn} N={N} Bn={bn} d={d} ring R={R} "
                    f"{design}", got,
                    ref.krasulina_xi_gossip_ref(w, z, sched, R), dn)
            same = torch.equal(got, again)
            print(f"check krasulina_xi_gossip {dn} N={N} Bn={bn} d={d} R={R} "
                  f"{design}: two launches give the same bits "
                  f"{'ok' if same else 'FAIL'}")
            require(same, "krasulina_xi_gossip is not deterministic")
    # the two-pass design that the one-read kernel replaced on path (a),
    # forced
    w, z = randn(10, 3072), randn(10, 100, 3072)
    sched = mixing.schedule("ring", 10)
    compare("krasulina_xi_gossip float32 N=10 Bn=100 d=3072 ring R=8 two-pass "
            "(timed beside) against one-read",
            krasulina_xi_gossip_cuda(w, z, sched, 8, _design="two-pass"),
            ops.krasulina_xi_gossip(w, z, sched, 8), "float32")
    # one-read launches on two streams at once, each stream with its own
    # grid-barrier word; both grids (96 small blocks each) fit the card
    # together, so they can overlap
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    inputs = [(randn(4, 3072), randn(4, 8, 3072)) for _ in streams]
    sched = mixing.schedule("ring", 4)
    wants = [ref.krasulina_xi_gossip_ref(w, z, sched, 8) for w, z in inputs]
    require(all(xi_gossip_route(w, z) == "one-read" for w, z in inputs),
            "the two-stream case did not route to one-read")
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(50):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[k].append(ops.krasulina_xi_gossip(*inputs[k], sched, 8))
    torch.cuda.synchronize()
    for k in range(2):
        err = max((o - wants[k]).abs().max().item() for o in outs[k])
        limit = 1e-4 * wants[k].abs().max().item() + 1e-5
        ok = err <= limit
        print(f"check krasulina_xi_gossip one-read on stream {k + 1} of 2, "
              f"50 launches each, interleaved: max_abs_err={err:.3e} "
              f"limit={limit:.3e} {'ok' if ok else 'FAIL'}")
        require(ok, "one-read launches on two streams disagree")
    del outs, inputs
    # above 64 nodes: the one-round schedule R times on a resident tile
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for n in GOSSIP_ROUNDS_NODES:
            x = randn(n, 4099, dtype=dtype)
            for topo in ("ring", "circulant2", "torus"):
                sched = mixing.schedule(topo, n)
                ops.reset_launches()
                got = ops.gossip_mix(x, sched, 8)
                require(ops.gossip_launches == {"composed": 0, "rounds": 1},
                        f"gossip_mix n={n} did not take rounds: "
                        f"{ops.gossip_launches}")
                compare(f"gossip_mix {dn} n={n} d=4099 {topo} R=8 "
                        f"{gossip_design(n)}", got,
                        ref.gossip_mix_ref(x, sched, 8), dn)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for n in GOSSIP_NODES:
            for d in (33, 3072, 32773):
                x = randn(n, d, dtype=dtype)
                for topo in ("ring", "circulant2"):
                    sched = mixing.schedule(topo, n)
                    for R in (0, 1, 8):
                        e = compare(f"gossip_mix {dn} n={n} d={d} {topo} R={R}",
                                    ops.gossip_mix(x, sched, R),
                                    ref.gossip_mix_ref(x, sched, R), dn)
                        if (dn, n, d, topo, R) == ("float32", 10, 3072,
                                                   "ring", 8):
                            errs["gossip_mix"] = e
        # path (f)'s wire: N = 16 nodes, d = 21 (Fig. 9's 20 weights and a
        # bias), ring R = 2
        x = randn(16, 21, dtype=dtype)
        sched = mixing.schedule("ring", 16)
        compare(f"gossip_mix {dn} n=16 d=21 ring R=2",
                ops.gossip_mix(x, sched, 2), ref.gossip_mix_ref(x, sched, 2), dn)
        for quant in ("sign", "int8"):
            compare(f"gossip_mix_quant {quant} {dn} n=16 d=21 block_d=8 ring "
                    f"R=2", ops.quant_gossip_mix(x, sched, 2, quant, block_d=8),
                    ref.gossip_mix_quant_ref(x, sched, 2, quant, block_d=8),
                    dn, QUANT_TOL)
    for quant in ("sign", "int8"):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            for n in (5, 10, 16):
                for d in (33, 3072, 32773):
                    x = randn(n, d, dtype=dtype)
                    for bd in (16, 512):
                        for topo in ("ring", "circulant2"):
                            sched = mixing.schedule(topo, n)
                            for R in (1, 8):
                                e = compare(
                                    f"gossip_mix_quant {quant} {dn} n={n} "
                                    f"d={d} block_d={bd} {topo} R={R}",
                                    ops.quant_gossip_mix(x, sched, R, quant,
                                                         block_d=bd),
                                    ref.gossip_mix_quant_ref(x, sched, R, quant,
                                                             block_d=bd),
                                    dn, QUANT_TOL)
                                if (quant, dn, n, d, bd, topo, R) == (
                                        "int8", "float32", 10, 3072, 512,
                                        "ring", 8):
                                    errs["gossip_mix_quant"] = e
    # every cluster size, against the plain version and bit for bit against
    # the resident-tile kernel of one block per tile (both round every
    # operation alike)
    for block_d, d, cluster in QUANT_CLUSTER_CASES:
        for quant in ("sign", "int8"):
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[1]
                x = randn(10, d, dtype=dtype)
                sched = mixing.schedule("ring", 10)
                ops.reset_launches()
                got = ops.quant_gossip_mix(x, sched, 8, quant, block_d=block_d)
                require(ops.quant_launches[cluster] == 1,
                        f"gossip_mix_quant block_d={block_d} did not take "
                        f"{cluster} blocks per tile: {ops.quant_launches}")
                label = (f"gossip_mix_quant {quant} {dn} n=10 d={d} "
                         f"block_d={block_d} cluster={cluster} ring R=8")
                compare(label, got, ref.gossip_mix_quant_ref(
                    x, sched, 8, quant, block_d=block_d), dn, QUANT_TOL)
                same = torch.equal(got, gossip_mix_quant_cuda(
                    x, sched, 8, quant, block_d=block_d,
                    _design="resident-tile"))
                print(f"check {label}: equals resident-tile bit for bit "
                      f"{'ok' if same else 'FAIL'}")
                require(same, f"{label}: cluster-tile and resident-tile differ")
    # valid_d = 612 inside block 3 of tile 1's cluster of 16 (32 columns each)
    for quant in ("sign", "int8"):
        x = randn(10, 1024)
        x[:, 612:] = 0
        sched = mixing.schedule("ring", 10)
        compare(f"gossip_mix_quant {quant} float32 n=10 d=1024 valid_d=612 "
                f"(inside a block's slice) block_d=512 ring R=8",
                ops.quant_gossip_mix(x, sched, 8, quant, block_d=512,
                                     valid_d=612),
                ref.gossip_mix_quant_ref(x, sched, 8, quant, block_d=512,
                                         valid_d=612), "float32", QUANT_TOL)
    # a [300, 48] tile: one block per tile, 64 padded columns x 19 groups of
    # 16 rows is more than a cluster-tile block's 1,024 threads, so the
    # route takes the resident-tile kernel (two f32 copies, 115 KB)
    for quant in ("sign", "int8"):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            x = randn(300, 1000, dtype=dtype)
            sched = mixing.schedule("ring", 300)
            ops.reset_launches()
            got = ops.quant_gossip_mix(x, sched, 8, quant, block_d=48)
            require(ops.quant_launches["resident-tile"] == 1,
                    f"gossip_mix_quant [300, 48] did not take resident-tile: "
                    f"{ops.quant_launches}")
            label = (f"gossip_mix_quant {quant} {dn} n=300 d=1000 block_d=48 "
                     f"ring R=8 resident-tile (routed)")
            compare(label, got, ref.gossip_mix_quant_ref(
                x, sched, 8, quant, block_d=48), dn, QUANT_TOL)
            same = torch.equal(got, gossip_mix_quant_cuda(
                x, sched, 8, quant, block_d=48, _design="resident-tile"))
            print(f"check {label}: equals the forced run bit for bit "
                  f"{'ok' if same else 'FAIL'}")
            require(same, f"{label}: routed and forced runs differ")
    # pad columns past valid_d (zero) stay out of every tile statistic; the
    # unmasked sign kernel would count them into the mean
    for quant in ("sign", "int8"):
        n, d, pad = 8, 40, 9
        x = randn(n, d + pad)
        x[:, d:] = 0
        sched = mixing.schedule("circulant2", n)
        got = ops.quant_gossip_mix(x, sched, 2, quant, block_d=16, valid_d=d)
        compare(f"gossip_mix_quant {quant} float32 n={n} d={d + pad} "
                f"valid_d={d} block_d=16 circulant2 R=2", got,
                ref.gossip_mix_quant_ref(x, sched, 2, quant, block_d=16,
                                         valid_d=d), "float32", QUANT_TOL)
        if quant == "sign":
            unmasked = ops.quant_gossip_mix(x, sched, 2, quant, block_d=16)
            differs = not torch.allclose(got[:, :d], unmasked[:, :d], atol=1e-6)
            print(f"check gossip_mix_quant sign valid_d: unmasked differs "
                  f"from masked {'ok' if differs else 'FAIL'}")
            require(differs, "valid_d did not change the sign statistics")
    # the whole superstep on the card agrees with the CPU's plain path on a
    # small input (exact, fused gossip, unfused gossip, quantized gossip)
    quant_small = dict(mode="gossip", rounds=3, quant_stats="tile",
                       quant_block_d=16)
    for label, avg, fuse in (
            ("exact", AveragingConfig(mode="exact"), None),
            ("gossip fused", AveragingConfig(mode="gossip", rounds=3), True),
            ("gossip unfused", AveragingConfig(mode="gossip", rounds=3), False),
            ("gossip sign tile", AveragingConfig(quantization="sign",
                                                 **quant_small), None),
            ("gossip int8 tile", AveragingConfig(quantization="int8",
                                                 **quant_small), None)):
        zs = randn(3, 4, 5, 70)
        w0 = randn(70)
        outs = []
        for d_ in (dev, torch.device("cpu")):
            step = krasulina.build_krasulina_superstep(
                avg, 4, lambda t: 0.5 / t, fuse_xi=fuse, device=d_)
            st = krasulina.init_krasulina_state(w0.to(d_), avg, 4, device=d_)
            zb = zs.to(d_) if avg.mode != "exact" else zs.reshape(3, 20, 70).to(d_)
            outs.append(step(st, {"z": zb})[0].w.cpu())
        compare(f"superstep {label} card vs CPU plain path (N=4, Bn=5, d=70, "
                f"K=3)", outs[0], outs[1], "float32")
    def mma_sync_attention(q, k, v, causal=True, window=0, chunk=0):
        """bf16 attention through the mma.sync kernel's own entry point,
        whatever the shape routes to."""
        out = torch.empty_like(q)
        B, H, Sq, D = q.shape
        _cuda.call("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), B * H, Sq, k.shape[2], D, int(causal),
                   window, chunk, 1 / math.sqrt(D), _cuda.DTYPE_CODES[q.dtype],
                   1, _cuda.stream_of(q))
        return out

    gen_new = torch.Generator(device=dev).manual_seed(22)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for case in FLASH_CASES + FLASH_CASES_NEW:
            B, H, Sq, Sk, D, causal, window, chunk = case
            g_ = gen if case in FLASH_CASES else gen_new
            q, k, v = (torch.randn((B, H, S, D), generator=g_, device=dev)
                       .to(dtype) for S in (Sq, Sk, Sk))
            masks = dict(causal=causal, window=window, chunk=chunk)
            want = flash_variant(dtype, D, True)
            ops.reset_launches()
            got = ops.attention(q, k, v, **masks)
            require(ops.flash_launches[want] == 1, f"flash_attention {dn} D={D} "
                    f"did not take the {want} kernel: {ops.flash_launches}")
            label = (f"flash_attention {want} {dn} B={B} H={H} Sq={Sq} "
                     f"Sk={Sk} D={D} causal={causal} window={window} "
                     f"chunk={chunk}")
            if case in FLASH_CASES_NEW and dtype == torch.bfloat16:
                e = compare_bf16_attention(label, got, q, k, v, masks)
                if D == 256:
                    compare_bf16_attention(
                        label.replace(f" {want} ", " mma_sync (forced) "),
                        mma_sync_attention(q, k, v, **masks), q, k, v, masks)
            else:
                e = compare_close(label, got, ref.attention_ref(
                    q, k, v, **masks), FLASH_TOL[dn])
            if (dn, H, Sq) == ("bfloat16", 32, 512):
                errs["flash_attention"] = e

    # -------------------------------------------------------------- main path
    stream = make_pca_stream(HIGHD, device=dev)
    sin2 = lambda w: problems.sin2_error(w, stream.top_eigvec)
    step5 = lambda t: 5.0 / t
    w0 = randn(HIGHD.dim)
    w0 /= w0.norm()
    gossip = AveragingConfig(mode="gossip", rounds=HIGHD_R, topology="ring")
    launches = {k: 0 for k in ops.launches}
    flash_total = {k: 0 for k in ops.flash_launches}  # by kernel
    by_design = {k: 0 for k in ops.xi_gossip_launches}
    by_cluster = {k: 0 for k in ops.quant_launches}
    xi_by_design = {k: 0 for k in ops.xi_launches}
    gossip_by_design = {k: 0 for k in ops.gossip_launches}

    def spread_of(w_nodes):
        wbar = w_nodes.mean(0)
        return (torch.linalg.vector_norm(w_nodes - wbar, dim=1).max()
                / torch.linalg.vector_norm(wbar)).item()

    def take_counts(label, expect, exact=None):
        """Read the launch counts of the run just driven, add them to the
        main-path totals, and require the expected kernels."""
        counts = dict(ops.launches)
        for k, v in counts.items():
            launches[k] += v
        for k, v in ops.flash_launches.items():
            flash_total[k] += v
        for k, v in ops.xi_gossip_launches.items():
            by_design[k] += v
        for k, v in ops.quant_launches.items():
            by_cluster[k] += v
        for k, v in ops.xi_launches.items():
            xi_by_design[k] += v
        for k, v in ops.gossip_launches.items():
            gossip_by_design[k] += v
        for k in expect:
            require(counts[k] > 0, f"{label}: kernel {k} was never launched")
        for k, v in (exact or {}).items():
            require(counts[k] == v, f"{label}: kernel {k} launched "
                                    f"{counts[k]} times, expected {v}")
        # launches of the kernels by design and by blocks per tile
        if counts["krasulina_xi"]:
            counts["xi_by_design"] = dict(ops.xi_launches)
        if counts["krasulina_xi_gossip"]:
            counts["xi_gossip_by_design"] = dict(ops.xi_gossip_launches)
        if counts["gossip_mix"]:
            counts["gossip_by_design"] = dict(ops.gossip_launches)
        if counts["gossip_mix_quant"]:
            counts["quant_by_cluster"] = dict(ops.quant_launches)
        return counts

    def require_slab(label, n):
        """Every krasulina_xi launch of the run just read went through the
        cluster-slab kernel."""
        require(ops.xi_launches == {"cluster-slab": n, "two-pass": 0},
                f"{label}: krasulina_xi launches by design "
                f"{ops.xi_launches}, expected all {n} cluster-slab")

    def finish(label, w, w_nodes, sin2_final, rounds, seconds, expect,
               exact=None, sin2_below=0.05):
        counts = take_counts(label, expect, exact)
        finite = bool(torch.isfinite(w_nodes).all())
        spread = spread_of(w_nodes)
        print(f"main {label}: sin2={sin2_final:.5f} consensus_err={spread:.3e} "
              f"rounds_per_s={rounds / seconds:.2f} "
              f"samples_per_s={rounds * HIGHD_B / seconds:.1f} "
              f"launches={json.dumps(counts)}")
        require(finite and tuple(w.shape) == (HIGHD.dim,),
                f"{label}: state not finite or of the wrong shape")
        require(sin2_final < sin2_below,
                f"{label}: sin2={sin2_final} not < {sin2_below}")

    def superstep_ms(build, avg, supersteps=25, repeats=3):
        """Time of one round of the superstep on the card, the batch already
        staged: CUDA events around `supersteps` back-to-back supersteps (the
        gaps between launches included), the median of `repeats` runs."""
        step = build(HIGHD_B)
        probe = krasulina.init_krasulina_state(w0, avg, HIGHD_N, device=dev)
        probe, _ = step(probe, staged)
        torch.cuda.synchronize()
        runs = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(supersteps):
                probe, _ = step(probe, staged)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / (supersteps * HIGHD_K))
        return sorted(runs)[repeats // 2]

    # (a) governed driver, fused krasulina_xi_gossip
    run_cfg = PCARunConfig(pca=HIGHD, averaging=gossip,
                           stream=StreamConfig(streaming_rate=5e3,
                                               processing_rate=1e6,
                                               comms_rate=1e4))
    builder = krasulina.krasulina_superstep_builder(
        gossip, HIGHD_N, step5, metric=sin2, device=dev)
    state = krasulina.init_krasulina_state(w0, gossip, HIGHD_N, device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    with StreamingDriver(run_cfg, None, state, make_pca_host_sampler(stream),
                         superstep_builder=builder, n_nodes=HIGHD_N,
                         batch=HIGHD_B, device=dev,
                         engine=EngineConfig(superstep=HIGHD_K,
                                             prefetch_depth=2)) as drv:
        state, history = drv.run(6)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for rec in history:
        print(f"  superstep {rec['superstep']}: B={rec['bucket']} "
              f"mu={rec['plan'].mu} {rec['plan'].regime} "
              f"sin2={rec['metrics']['metric']:.5f} "
              f"consensus_err={rec['metrics']['consensus_err']:.3e} "
              f"rounds_per_s={rec['rounds_per_s']:.2f} "
              f"samples_per_s={rec['samples_per_s']:.1f}")
    finish("driver gossip fused", state.w.mean(0), state.w,
           history[-1]["metrics"]["metric"], state.t, seconds,
           ["krasulina_xi_gossip"])
    require(ops.xi_gossip_launches == {"one-read": state.t, "two-pass": 0},
            f"(a): krasulina_xi_gossip launches by design "
            f"{ops.xi_gossip_launches}, expected all {state.t} one-read")
    # where the driver's time goes: host synthesis of one round's samples vs
    # one round of the superstep on the card (batch already staged)
    sample = make_pca_host_sampler(stream)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    host = [sample(rng, HIGHD_B)["z"] for _ in range(HIGHD_K)]
    host_ms = (time.perf_counter() - t0) / HIGHD_K * 1e3
    staged = {"z": torch.from_numpy(np.stack(host)).reshape(
        HIGHD_K, HIGHD_N, HIGHD_B // HIGHD_N, HIGHD.dim).to(dev)}
    device_ms = superstep_ms(builder, gossip)
    print(f"driver time per round: host sampler {host_ms:.3f} ms "
          f"({HIGHD_B} samples, d={HIGHD.dim}), superstep on the card "
          f"{device_ms:.4f} ms (launch gaps included), "
          f"measured wall {seconds / state.t * 1e3:.3f} ms")

    # (b) exact DM-Krasulina, krasulina_xi, draws on the card
    ops.reset_launches()
    t0 = time.perf_counter()
    res = krasulina.run_dm_krasulina(stream.draw, w0, N=HIGHD_N, B=HIGHD_B,
                                     steps=50, stepsize=step5,
                                     trace_metric=sin2, seed=2, device=dev)
    torch.cuda.synchronize()
    finish("run_dm_krasulina exact", res.w, res.w[None],
           res.trace_metric[-1].item(), 50, time.perf_counter() - t0,
           ["krasulina_xi"])
    require_slab("(b)", 50)

    # (c) unfused gossip D-Krasulina: krasulina_xi then gossip_mix
    ops.reset_launches()
    t0 = time.perf_counter()
    res = krasulina.run_d_krasulina(stream.draw, w0, N=HIGHD_N, B=HIGHD_B,
                                    steps=50, stepsize=step5, averaging=gossip,
                                    trace_metric=sin2, fuse_xi=False, seed=3,
                                    device=dev)
    torch.cuda.synchronize()
    finish("run_d_krasulina gossip unfused", res.w, res.w_nodes,
           res.trace_metric[-1].item(), 50, time.perf_counter() - t0,
           ["krasulina_xi", "gossip_mix"])
    require_slab("(c)", 50)

    # (d) governed driver, int8 tile-statistics gossip: krasulina_xi then
    # gossip_mix_quant every round, never the fused (exact-wire) kernel
    int8_tile = AveragingConfig(mode="gossip", rounds=HIGHD_R, topology="ring",
                                quantization="int8", quant_stats="tile",
                                quant_block_d=512)
    builder_q = krasulina.krasulina_superstep_builder(
        int8_tile, HIGHD_N, step5, metric=sin2, device=dev)
    state = krasulina.init_krasulina_state(w0, int8_tile, HIGHD_N, device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    with StreamingDriver(PCARunConfig(pca=HIGHD, averaging=int8_tile,
                                      stream=run_cfg.stream),
                         None, state, make_pca_host_sampler(stream),
                         superstep_builder=builder_q, n_nodes=HIGHD_N,
                         batch=HIGHD_B, device=dev,
                         engine=EngineConfig(superstep=HIGHD_K,
                                             prefetch_depth=2)) as drv:
        state, history = drv.run(6)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for rec in history:
        print(f"  superstep {rec['superstep']}: B={rec['bucket']} "
              f"mu={rec['plan'].mu} {rec['plan'].regime} "
              f"sin2={rec['metrics']['metric']:.5f} "
              f"consensus_err={rec['metrics']['consensus_err']:.3e} "
              f"rounds_per_s={rec['rounds_per_s']:.2f} "
              f"samples_per_s={rec['samples_per_s']:.1f}")
    require(state.t == 6 * HIGHD_K, f"driver int8 ran {state.t} rounds")
    finish("driver gossip int8 tile", state.w.mean(0), state.w,
           history[-1]["metrics"]["metric"], state.t, seconds,
           ["krasulina_xi", "gossip_mix_quant"],
           exact={"krasulina_xi": state.t, "gossip_mix_quant": state.t,
                  "krasulina_xi_gossip": 0})
    require(ops.quant_launches == {c: state.t * (c == 16)
                                   for c in ops.quant_launches},
            f"(d): gossip_mix_quant launches by blocks per tile "
            f"{ops.quant_launches}, expected all {state.t} with 16")
    require_slab("(d)", state.t)
    # the int8 superstep against the fused one of (a), in the order a, d, d, a
    per = {"a": [], "d": []}
    for key in ("a", "d", "d", "a"):
        per[key].append(superstep_ms(*((builder, gossip) if key == "a"
                                       else (builder_q, int8_tile))))
    print(f"driver int8 tile time per round: superstep on the card "
          f"{sum(per['d']) / 2:.4f} ms (runs {per['d'][0]:.4f}, "
          f"{per['d'][1]:.4f}) against the fused superstep of (a) "
          f"{sum(per['a']) / 2:.4f} ms (runs {per['a'][0]:.4f}, "
          f"{per['a'][1]:.4f}), launch gaps included; measured wall "
          f"{seconds / state.t * 1e3:.3f} ms")

    # (e) D-Krasulina with sign tile-statistics gossip, draws on the card:
    # slow and noisy (the reference ends between 0.20 and 0.75 over seeds),
    # so it is held to falling, not to a band
    sign_tile = AveragingConfig(mode="gossip", rounds=HIGHD_R, topology="ring",
                                quantization="sign", quant_stats="tile",
                                quant_block_d=512)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = krasulina.run_d_krasulina(stream.draw, w0, N=HIGHD_N, B=HIGHD_B,
                                    steps=48, stepsize=step5,
                                    averaging=sign_tile, trace_metric=sin2,
                                    seed=4, device=dev)
    torch.cuda.synchronize()
    first = res.trace_metric[0].item()
    print(f"  sign tile: sin2 after round 1 {first:.5f}, after round 48 "
          f"{res.trace_metric[-1].item():.5f}")
    finish("run_d_krasulina gossip sign tile", res.w, res.w_nodes,
           res.trace_metric[-1].item(), 48, time.perf_counter() - t0,
           ["krasulina_xi", "gossip_mix_quant"],
           exact={"krasulina_xi_gossip": 0}, sin2_below=first)
    require(ops.quant_launches == {c: 48 * (c == 16)
                                   for c in ops.quant_launches},
            f"(e): gossip_mix_quant launches by blocks per tile "
            f"{ops.quant_launches}, expected all 48 with 16")
    require_slab("(e)", 48)

    # (f) the convex track at Fig. 9: quantized decentralized logistic
    # regression (N = 16, B = 64, ring R = 2, tile width 8, 400 steps,
    # stepsize 0.5/sqrt(t)), the same draws for every wire
    n9, b9, r9 = 16, 64, 2
    lr9 = make_logreg_stream(FIG9, device=dev)
    xe, ye = lr9.draw(torch.Generator(device=dev).manual_seed(99), 20_000)
    bayes = problems.logistic_loss(lr9.w_star, xe, ye)
    excess = lambda w: problems.logistic_loss(w, xe, ye) - bayes
    w0c = torch.zeros(FIG9.dim + 1, device=dev)
    risks = {}
    for quant in ("none", "int8", "sign"):
        wire = AveragingConfig(mode="gossip", rounds=r9, topology="ring",
                               quantization=quant, quant_stats="tile",
                               quant_block_d=8)
        mix = averaging.make_gossip_mix(wire, n9, device=dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        res = dsgd.run_dsgd(problems.logistic_grad, lr9.draw, w0c, np.eye(n9),
                            B=b9, rounds=r9, steps=400,
                            stepsize=lambda t: 0.5 / math.sqrt(t), mix=mix,
                            seed=7, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = take_counts(f"convex {quant}", ["gossip_mix"] if quant ==
                             "none" else ["gossip_mix_quant"])
        if quant != "none":
            require(ops.quant_launches == {c: 400 * (c == 1)
                                           for c in ops.quant_launches},
                    f"convex {quant}: gossip_mix_quant launches by blocks per "
                    f"tile {ops.quant_launches}, expected all 400 with 1")
        risks[quant] = excess(res.w.mean(0)).item()
        cerr = averaging.consensus_error({"w": res.w}).item()
        print(f"main convex D-SGD fig9 wire={quant} tile block_d=8: "
              f"excess_risk={risks[quant]:.5f} consensus_err={cerr:.4f} "
              f"steps_per_s={400 / seconds:.1f} launches={json.dumps(counts)}")
        require(bool(torch.isfinite(res.w).all()) and math.isfinite(
            risks[quant]), f"convex {quant}: not finite")
    ratio8, ratio1 = risks["int8"] / risks["none"], risks["sign"] / risks["none"]
    print(f"main convex quantized wire: int8/none={ratio8:.4f} (limit within "
          f"5%), sign/none={ratio1:.4f} (limit 2)")
    require(risks["none"] > 0, "convex: unquantized excess risk not > 0")
    require(abs(ratio8 - 1.0) <= 0.05, "convex: int8 not within 5%")
    require(ratio1 <= 2.0, "convex: sign more than 2x the unquantized risk")
    # DMB at Fig. 6 (N = 10, B = 100)
    lr6 = make_logreg_stream(FIG6, device=dev)
    t0 = time.perf_counter()
    res6 = dmb.run_dmb(problems.logistic_grad, lr6.draw,
                       torch.zeros(FIG6.dim + 1, device=dev), N=10, B=100,
                       steps=200, stepsize=lambda t: 2.0 / math.sqrt(t),
                       trace_metric=lambda w: ((w - lr6.w_star) ** 2).sum(),
                       seed=1, device=dev)
    err6 = res6.trace_metric
    print(f"main convex DMB fig6 N=10 B=100: |w - w*|^2 {err6[0].item():.4f} "
          f"-> {err6[-1].item():.5f} after 200 rounds "
          f"({200 / (time.perf_counter() - t0):.1f} rounds/s)")
    require(bool(torch.isfinite(err6).all()) and err6[-1] < err6[0],
            "DMB fig6 did not end finite and closer to w*")
    # D-SGD over a 6-regular expander against local SGD (the Fig. 9 N^2
    # regime of benchmarks/bench_dsgd.py, with R = 2)
    A = mixing.random_regular_expander(n9, deg=6, seed=0)
    t_prime = n9 ** 2 * 64
    bn = max(1, math.ceil(0.1 * math.log(t_prime)
                          / (0.5 * math.log(1 / mixing.lambda2(A)))))
    kw = dict(B=bn * n9, steps=t_prime // (bn * n9),
              stepsize=lambda t: 2.5 / math.sqrt(t), trace_metric=excess,
              seed=3, device=dev)
    rd = dsgd.run_dsgd(problems.logistic_grad, lr9.draw, w0c, A, rounds=2,
                       **kw)
    rl = dsgd.run_local_sgd(problems.logistic_grad, lr9.draw, w0c, N=n9, **kw)
    dsgd_risk, local_risk = rd.trace_metric[-1].item(), rl.trace_metric[-1].item()
    print(f"main convex D-SGD fig9 expander deg 6 R=2 B={kw['B']} "
          f"steps={kw['steps']}: excess_risk={dsgd_risk:.5f}, local SGD "
          f"{local_risk:.5f}")
    require(math.isfinite(dsgd_risk) and dsgd_risk < local_risk,
            "D-SGD did not beat local SGD")

    def time_ms(fn, reps=20, replays=5, flush=None):
        """Device time of one call: `reps` calls captured in a CUDA graph,
        replayed `replays` times between two events (no host launch gaps);
        with `flush`, each call follows one of it in the graph."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            for _ in range(reps):
                if flush is not None:
                    flush()
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

    # ------------------------------------------------- the serving path (g)
    del staged, host, res, res6, rd, rl, xe, ye
    torch.cuda.empty_cache()
    cpu = torch.device("cpu")

    # (g0) reduced granite-8b in f32, the same parameters on the card and on
    # the CPU's plain path
    cfg_r = reduced(get_config("granite-8b"))
    p_cpu = registry.init_params(torch.Generator().manual_seed(0), cfg_r)
    p_dev = convert.tree_map(lambda t: t.to(dev), p_cpu)
    prompts = np.random.default_rng(0).integers(0, cfg_r.vocab_size, (5, 24))
    runs = {}
    for side, d_, params_ in (("card", dev, p_dev), ("cpu", cpu, p_cpu)):
        toks = torch.from_numpy(prompts).to(d_)
        ops.reset_launches()
        logits, _ = registry.prefill(params_, cfg_r, {"tokens": toks},
                                     registry.init_cache(cfg_r, 5, 32,
                                                         torch.float32,
                                                         device=d_))
        counts = dict(ops.launches, flash_by_kernel=dict(ops.flash_launches))
        gen_toks = engine.generate(params_, cfg_r, {"tokens": toks}, 32, 8,
                                   dtype=torch.float32).tolist()
        eng = engine.ContinuousBatchingEngine(cfg_r, params_, slots=2,
                                              max_len=32)
        rids = [eng.submit(p, 8) for p in prompts]
        eng.drain()
        runs[side] = (logits.cpu(), gen_toks,
                         [eng.result(r).tokens for r in rids], counts)
    err = (runs["card"][0] - runs["cpu"][0]).abs().max().item()
    same = {"generate": runs["card"][1] == runs["cpu"][1],
            "engine": runs["card"][2] == runs["cpu"][2],
            "engine=generate": runs["card"][2] == runs["card"][1]}
    print(f"main (g0) reduced granite-8b f32 (2 layers) card vs CPU: prefill "
          f"logits max_abs_err={err:.3e} (limit 1e-3); greedy tokens equal "
          f"{json.dumps(same)}; card prefill launches "
          f"{json.dumps(runs['card'][3])}")
    require(err <= 1e-3, "(g0) prefill logits: card and CPU disagree")
    require(all(same.values()), "(g0) greedy tokens differ")
    require(runs["card"][3]["flash_attention"] == cfg_r.num_layers
            and runs["card"][3]["flash_by_kernel"]["f32"] == cfg_r.num_layers,
            "(g0) the card's f32 prefill did not launch the f32 flash kernel "
            "per layer")
    del p_cpu, p_dev, runs, eng

    # (g) granite-8b at full width: 36 layers, bf16, seeded random weights
    cfg = get_config("granite-8b")
    require(cfg.num_layers == GRANITE_LAYERS, "granite-8b depth changed")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.init_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg, torch.bfloat16)
    torch.cuda.synchronize()
    leaves = []
    convert.tree_map(leaves.append, params)
    n_params = sum(t.numel() for t in leaves)
    del leaves
    print(f"main (g) granite-8b: {n_params / 1e9:.3f} B parameters, bf16, "
          f"{n_params * 2 / 1e9:.2f} GB, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; card {smi}")
    V, others = cfg.vocab_size, [k for k in ops.launches
                                 if k != "flash_attention"]

    def serve_counts(label, prefills):
        """Every prefill launches the wgmma flash kernel once per layer, and
        nothing else runs."""
        want = {"flash_attention": GRANITE_LAYERS * prefills}
        want.update({k: 0 for k in others})
        variants = dict(ops.flash_launches)
        require(variants == {"wgmma": GRANITE_LAYERS * prefills,
                             "mma_sync": 0, "f32": 0},
                f"{label}: flash launches by kernel {variants}")
        counts = take_counts(label, ["flash_attention"], want)
        return dict(counts, flash_by_kernel=variants)

    # (g1) static generate: batch 4, prompt 512, 32 new tokens; then the same
    # steps timed apart (prefill, then each decode step)
    B1, P1 = 4, 512
    prompt = registry.synth_batch(torch.Generator(device=dev).manual_seed(1),
                                  cfg, B1, P1, mode="prefill")
    ops.reset_launches()
    t0 = time.perf_counter()
    out = engine.generate(params, cfg, prompt, P1 + GEN, GEN,
                          dtype=torch.bfloat16)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    st = engine.init_serve(cfg, B1, P1 + GEN, torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = registry.prefill(params, cfg, prompt, st.cache)
    st = engine.ServeState(cache, logits[:, -1:].argmax(-1), P1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    del logits
    toks = [st.last_tokens]
    t0 = time.perf_counter()
    for _ in range(GEN - 1):
        st, t = engine.serve_step(params, cfg, st)
        toks.append(t)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    last, _ = registry.decode_step(params, cfg, st.last_tokens, st.cache,
                                   st.index)
    finite = finite and bool(torch.isfinite(last).all())
    counts = serve_counts("(g1)", 2)
    again = torch.cat(toks, dim=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the card's own time for the same work: one prefill and one decode step
    # replayed from a CUDA graph (no host launch gaps); the rest of the wall
    # time is the host issuing eager operations
    dev_prefill = time_ms(lambda: registry.prefill(params, cfg, prompt,
                                                   st.cache), reps=2,
                          replays=3)
    dev_step = time_ms(lambda: registry.decode_step(
        params, cfg, st.last_tokens, st.cache, st.index), reps=5, replays=3)
    print(f"main (g1) static generate B={B1} prompt={P1} gen={GEN}: "
          f"generate {gen_s:.3f} s; prefill {prefill_s * 1e3:.2f} ms "
          f"({B1 * P1 / prefill_s:.1f} tokens/s; card {dev_prefill:.2f} ms), "
          f"decode {decode_s / (GEN - 1) * 1e3:.3f} ms per step "
          f"({B1 * (GEN - 1) / decode_s:.1f} tokens/s; card {dev_step:.3f} "
          f"ms); peak memory {peak:.2f} GiB; logits finite {finite}; repeat "
          f"equals generate {torch.equal(again, out)}; "
          f"launches={json.dumps(counts)}")
    require(finite, "(g1) logits not finite")
    require(tuple(out.shape) == (B1, GEN) and bool(((out >= 0) & (out < V))
                                                   .all()),
            "(g1) tokens of the wrong shape or outside the vocabulary")
    del st, cache, toks, last

    # (g2) continuous batching: 8 slots, 16 requests, one swap mid-traffic
    rng = np.random.default_rng(2)
    lens = rng.integers(128, 513, size=16)
    lens[3] = 200
    prompts = [rng.integers(0, V, size=int(n)) for n in lens]
    swapped = dict(params, blocks=list(params["blocks"]))
    swapped["blocks"][0] = dict(swapped["blocks"][0], attn=dict(
        swapped["blocks"][0]["attn"], wo=-params["blocks"][0]["attn"]["wo"]))
    eng = engine.ContinuousBatchingEngine(cfg, params, slots=8,
                                          max_len=P1 + GEN,
                                          dtype=torch.bfloat16)
    ops.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, GEN) for p in prompts]
    while eng.n_active or eng.n_queued:
        eng.step()
        if eng.decode_steps == 16 and eng.swaps == 0:
            eng.swap_params(swapped)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = serve_counts("(g2)", len(prompts))
    done = [eng.result(r) for r in rids]
    ok = all(len(r.tokens) == GEN and all(0 <= t < V for t in r.tokens)
             and r.versions == sorted(r.versions) for r in done)
    spanning = sum(len(set(r.versions)) > 1 for r in done)
    print(f"main (g2) continuous batching slots=8 requests={len(prompts)} "
          f"prompts {int(lens.min())}-{int(lens.max())} (sum "
          f"{int(lens.sum())}) gen={GEN}: {wall:.3f} s, "
          f"{len(prompts) * GEN / wall:.1f} generated tokens/s, "
          f"{int(lens.sum()) / wall:.1f} prompt tokens/s, "
          f"{eng.decode_steps} decode steps "
          f"({wall / eng.decode_steps * 1e3:.3f} ms per step, prefills "
          f"included), swaps={eng.swaps}, requests "
          f"spanning the swap {spanning}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches={json.dumps(counts)}")
    require(ok, "(g2) a request lost tokens, left the vocabulary or saw "
                "non-monotone versions")
    require(eng.swaps == 1 and spanning >= 1, "(g2) the swap did not land "
                                              "mid-traffic")
    del params, swapped, eng, prompt, out
    torch.cuda.empty_cache()

    # ------------------------------------------------ the training path (h)
    # the decentralized LM trainer: N = 4 nodes on the card, ring gossip of
    # the packed gradient buffer, R = 2, Adam
    def on_device(state, d_):
        """A copy of a TrainState on d_."""
        to = lambda tree: tree_map(lambda t: t.to(d_, copy=True), tree)
        return trainer.TrainState(to(state.params), state.opt._replace(
            m=to(state.opt.m), v=to(state.opt.v),
            master=to(state.opt.master),
            ef_residual=to(state.opt.ef_residual)))

    def draw_tokens(data, rng, n, seq):
        toks = data.sample(rng, n, seq + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def attn_grads(run, state, batch, ids=None):
        """Each node's wq / wk / wv gradient of every layer at `state` (the
        nodes `ids`, batch row j for node ids[j]; default all)."""
        out = []
        for j, i in enumerate(range(TRAIN_N) if ids is None else ids):
            _, _, grads = trainer.loss_and_grad(
                run, tree_map(lambda p: p[i], state.params),
                {k: v[j] for k, v in batch.items()})
            out.append([blk["attn"][w] for blk in grads["blocks"]
                        for w in ("wq", "wk", "wv")])
        return out

    def round_phases(run, state, batch):
        """Card ms of the steps of one train step on `state`, each between
        two CUDA events, in the trainer's order: each node's forward +
        backward, its gradients into the [N, ...] tree, the pack, the mix,
        the consensus error, the optimizer update. Every result is dropped
        once timed (a second optimizer state would not fit)."""
        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = fn()
            end.record()
            torch.cuda.synchronize()
            return result, start.elapsed_time(end)

        params, ms = state.params, {}
        grads = tree_map(torch.empty_like, params)
        ms["node_loss_grad"], ms["grad_copy"] = [], []
        for i in range(TRAIN_N):
            (_, _, g), t = timed(lambda: trainer.loss_and_grad(
                run, tree_map(lambda p: p[i], params),
                {k: v[i] for k, v in batch.items()}))
            ms["node_loss_grad"].append(t)
            ms["grad_copy"].append(timed(lambda: [
                buf[i].copy_(gi) for buf, gi in
                zip(tree_leaves(grads), tree_leaves(g))])[1])
            del g
        (bufs, spec), ms["pack"] = timed(lambda: packing.pack_tree(grads))
        del grads
        mix = averaging.make_gossip_mix(run.averaging, TRAIN_N, device=dev)
        outs, ms["mix"] = timed(lambda: tuple(mix(b) for b in bufs))
        del bufs
        pools = trainer.layer_pools(params, run.model)
        ms["consensus_error"] = timed(lambda: averaging.
                                      _packed_consensus_error(outs, spec,
                                                              pools))[1]
        mixed = packing.unpack_tree(outs, spec)
        update = make_optimizer(run.optimizer, run.learning_rate)
        # every node at one step: one update on the stacked leaves, as the
        # trainer runs it
        opt = state.opt._replace(step=state.opt.step[0])
        ms["adam"] = timed(lambda: update(mixed, opt, params))[1]
        return ms

    quant_tile = dict(quantization="int8", quant_stats="tile",
                      quant_block_d=512)
    wires = (("exact", {}), ("int8", quant_tile))
    # (h0) reduced granite-8b in f32 on the card and on the CPU from the same
    # state and the same MarkovTokenStream draws: 3 rounds, Adam at 1e-4
    H0_LR, H0_ROUNDS = 1e-4, 3
    for wire, quant in wires:
        run = RunConfig(model=cfg_r, shape=SHAPES["train_4k"],
                        averaging=AveragingConfig("gossip", TRAIN_R, "ring",
                                                  **quant),
                        optimizer="adam", learning_rate=H0_LR,
                        param_dtype="float32")
        base = trainer.replicate_for_nodes(
            trainer.init_state(run, torch.Generator().manual_seed(0)),
            TRAIN_N)
        data, rng = MarkovTokenStream(cfg_r.vocab_size, seed=0), \
            np.random.default_rng(0)
        batches = [trainer.make_node_batch(draw_tokens(data, rng, 8, 64),
                                           TRAIN_N)
                   for _ in range(H0_ROUNDS)]
        runs = {}
        for side, d_ in (("card", dev), ("cpu", cpu)):
            st = on_device(base, d_)
            bs = [{k: torch.from_numpy(v).to(d_) for k, v in b.items()}
                  for b in batches]
            step = trainer.build_train_step(run, None, n_nodes=TRAIN_N,
                                            device=d_)
            ops.reset_launches()
            grads = attn_grads(run, st, bs[0])
            losses = []
            for b in bs:
                st, m = step(st, b)
                losses.append(float(m["loss"]))
            counts = (take_counts(
                f"(h0) {wire}", [],
                {"gossip_mix": H0_ROUNDS * (wire == "exact"),
                 "gossip_mix_quant": H0_ROUNDS * (wire == "int8"),
                 "flash_attention": 0, "krasulina_xi": 0,
                 "krasulina_xi_gossip": 0})
                      if side == "card" else None)
            runs[side] = (losses, st, grads, counts)
        (lc, sc, gc, counts), (lp, sp, gp, _) = runs["card"], runs["cpu"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
        d = torch.cat([(a.cpu() - b).abs().ravel() for a, b in
                       zip(tree_leaves(sc.params), tree_leaves(sp.params))])
        within = float((d <= 1e-4).float().mean())
        grad_err = max(float((a.cpu() - b).abs().max() / b.abs().max())
                       for ga, gb in zip(gc, gp) for a, b in zip(ga, gb))
        grad_min = min(float(b.abs().max()) for gb in gp for b in gb)
        grad_card_min = min(float(a.abs().max()) for ga in gc for a in ga)
        print(f"main (h0) reduced granite-8b f32 (2 layers) N={TRAIN_N} ring "
              f"R={TRAIN_R} adam {wire} wire, card vs CPU over {H0_ROUNDS} "
              f"rounds: losses {json.dumps(lc)} (CPU {json.dumps(lp)}, max "
              f"rel err {loss_err:.2e}, limit 1e-4); parameters within 1e-4: "
              f"{within:.6f} (limit >= 0.999), max_abs_err "
              f"{float(d.max()):.3e} (limit {3 * H0_LR * H0_ROUNDS:.1e}, "
              f"3 lr per round); wq/wk/wv gradients per node: smallest "
              f"max|g| card {grad_card_min:.3e} CPU {grad_min:.3e}, max rel "
              f"err {grad_err:.2e} (limit 1e-4); launches={json.dumps(counts)}")
        require(loss_err <= 1e-4, f"(h0) {wire}: losses disagree")
        require(within >= 0.999 and float(d.max()) <= 3 * H0_LR * H0_ROUNDS,
                f"(h0) {wire}: parameters disagree")
        require(grad_card_min > 0 and grad_min > 0,
                f"(h0) {wire}: a node's wq/wk/wv gradient is zero")
        require(grad_err <= 1e-4, f"(h0) {wire}: wq/wk/wv gradients disagree")
    del base, runs, sc, sp, gc, gp, st

    # (h1)/(h2) granite-8b at full width, depth cut to 2 layers: bf16 params
    # with f32 masters, Adam at 3e-4, K = 2 rounds per superstep, 4
    # supersteps, 2 sequences of 512 tokens per node per round, through the
    # StreamingDriver with the trainer's own builder
    cfg_h = dataclasses.replace(get_config("granite-8b"),
                                num_layers=TRAIN_LAYERS)
    tokens_per_round = TRAIN_B * TRAIN_S
    flops_per_round = None
    finals, h_rounds, h_peak = {}, {}, {}
    for label, wire, quant in (("(h1)", "exact", {}),
                               ("(h2)", "int8", quant_tile)):
        run = RunConfig(model=cfg_h, shape=SHAPES["train_4k"],
                        averaging=AveragingConfig("gossip", TRAIN_R, "ring",
                                                  **quant),
                        optimizer="adam", learning_rate=3e-4,
                        param_dtype="bfloat16", master_weights=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tstate = trainer.replicate_for_nodes(trainer.init_state(
            run, torch.Generator(device=dev).manual_seed(0)), TRAIN_N)
        torch.cuda.synchronize()
        n_node = sum(t[0].numel() for t in tree_leaves(tstate.params))
        flops_per_round = 8 * n_node * tokens_per_round  # 6 P T + remat
        print(f"main {label} granite-8b full width, {TRAIN_LAYERS} layers: "
              f"{n_node} parameters per node, {TRAIN_N} nodes, state drawn "
              f"and replicated on the card in {time.perf_counter() - t0:.2f} "
              f"s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        data = MarkovTokenStream(cfg_h.vocab_size, seed=0)
        sample = lambda rng, n: draw_tokens(data, rng, n, TRAIN_S)
        ops.reset_launches()
        t0 = time.perf_counter()
        with StreamingDriver(run, None, tstate, sample, batch=TRAIN_B,
                             n_nodes=TRAIN_N, device=dev,
                             engine=EngineConfig(superstep=TRAIN_K,
                                                 prefetch_depth=2,
                                                 replan_every=0)) as drv:
            tstate, history = drv.run(TRAIN_SUPERSTEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        other = {k: 0 for k in ops.launches}
        kernel = "gossip_mix" if wire == "exact" else "gossip_mix_quant"
        other[kernel] = TRAIN_K * TRAIN_SUPERSTEPS
        counts = take_counts(label, [kernel], other)
        if wire == "exact":
            require(ops.gossip_launches == {"composed": other[kernel],
                                            "rounds": 0},
                    f"{label}: gossip_mix launches by design "
                    f"{ops.gossip_launches}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        # the last round of each superstep, as the driver records it
        losses = [rec["metrics"]["loss"] for rec in history]
        cerrs = [rec["metrics"]["consensus_err"] for rec in history]
        for rec in history:
            print(f"  superstep {rec['superstep']} round {rec['round']}: "
                  f"loss {rec['metrics']['loss']:.5f} consensus_err "
                  f"{rec['metrics']['consensus_err']:.4e} "
                  f"wall {rec['wall_s']:.4f} s "
                  f"rounds_per_s={rec['rounds_per_s']:.3f} "
                  f"samples_per_s={rec['samples_per_s']:.2f}")
        # steady state: the supersteps after the first (allocator warm-up)
        steady = history[1:]
        steady_s = sum(rec["wall_s"] for rec in steady)
        rounds_s = len(steady) * TRAIN_K / steady_s
        # the host's share: the token sampler for one round
        rng = np.random.default_rng(1)
        t0 = time.perf_counter()
        for _ in range(TRAIN_K):
            sample(rng, TRAIN_B)
        host_ms = (time.perf_counter() - t0) / TRAIN_K * 1e3
        # the card's time for one staged superstep (CUDA events around it)
        sup = trainer.build_superstep(run, None, n_nodes=TRAIN_N, device=dev)
        staged = {k: torch.from_numpy(np.stack([
            trainer.make_node_batch(sample(rng, TRAIN_B), TRAIN_N)[k]
            for _ in range(TRAIN_K)])).to(dev) for k in ("tokens", "labels")}
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tstate, _ = sup(tstate, staged)
        end.record()
        torch.cuda.synchronize()
        card_ms = start.elapsed_time(end)
        # one more round, cut into its steps
        phases = round_phases(run, tstate, {k: v[0] for k, v in
                                            staged.items()})
        phases["sum"] = sum(sum(v) if isinstance(v, list) else v
                            for v in phases.values())
        print(f"main {label} round phases on the card, ms: "
              f"{json.dumps(phases)}")
        finite = all(math.isfinite(x) for x in losses + cerrs)
        finals[label] = losses[-1]
        h_rounds[label], h_peak[label] = rounds_s, peak
        card_tflops = flops_per_round / (card_ms / TRAIN_K * 1e-3) / 1e12
        print(f"main {label} {wire} wire: {TRAIN_K * len(history)} rounds "
              f"in {wall:.3f} s; loss at round {history[0]['round']} "
              f"{losses[0]:.5f}, at round {history[-1]['round']} "
              f"{losses[-1]:.5f}; consensus_err last {cerrs[-1]:.3e}; "
              f"steady {rounds_s:.4f} rounds/s, "
              f"{rounds_s * TRAIN_B:.3f} samples/s, "
              f"{rounds_s * tokens_per_round:.1f} tokens/s; host sampler "
              f"{host_ms:.3f} ms per round; card {card_ms:.3f} ms per "
              f"superstep of {TRAIN_K} rounds (CUDA events, batch staged), "
              f"{card_ms / TRAIN_K:.3f} ms per round = "
              f"{card_ms / TRAIN_K / (1e3 / rounds_s):.3f} of the steady "
              f"round; {flops_per_round / 1e12:.2f} TFLOP per round "
              f"(8 P T), {card_tflops:.1f} TFLOP/s on the card; peak "
              f"memory {peak:.2f} GB; "
              f"card {smi}; launches={json.dumps(counts)}")
        require(finite, f"{label}: a loss or consensus error is not finite")
        require(losses[-1] < losses[0], f"{label}: the loss did not fall")
        require(max(cerrs) > 0, f"{label}: consensus_err is 0")
        require(peak < 80, f"{label}: peak memory {peak:.2f} GB")
        del tstate, drv, sup, staged
        torch.cuda.empty_cache()
    print(f"main (h2) final loss {finals['(h2)']:.5f} beside (h1) "
          f"{finals['(h1)']:.5f}")
    train_d = n_node  # the packed gradient buffer's width per node

    # ------------------------------ the elastic and scenario paths (i)-(k)
    nodes_total = {k: {} for k in ops.node_launches}

    def take_nodes(label):
        """The launches of the run just read by node count, added to the
        main-path totals; printed with the phase."""
        counts = {k: dict(sorted(v.items())) for k, v in
                  ops.node_launches.items() if v}
        for k, v in counts.items():
            for n, c in v.items():
                nodes_total[k][n] = nodes_total[k].get(n, 0) + c
        return counts

    class FakeClock:
        """Advances dt per read: the straggler policy then reads the same
        round times on the card and on the CPU."""

        def __init__(self, dt):
            self.t, self.dt = 0.0, dt

        def __call__(self):
            self.t += self.dt
            return self.t

    def counting(builder, builds):
        """`builder` that records the (B, cohort size) of every build."""
        def build(B, membership=None):
            builds.append((B, HIGHD_N if membership is None
                           else membership.n_active))
            return builder(B, membership)
        return build

    stream_cpu = dataclasses.replace(
        stream, cov=stream.cov.cpu(), top_eigvec=stream.top_eigvec.cpu(),
        sqrt_cov=stream.sqrt_cov.cpu())
    events_of = lambda drv: [(e["superstep"], e["to"].active_ids,
                              e["plan"].B) for e in drv.membership_events]

    # (i) elastic PCA at HIGHD (N = 10, B = 1000, ring R = 8), ungoverned so
    # the plans are the same on the card and on the CPU, numpy host draws
    # (the same sqrt_cov on both sides), K = 4, 12 supersteps, no prefetch
    # (the swaps land on a fixed superstep): the exact wire and the int8
    # tile wire under a death and a flaky node, and the straggler policy
    # "drop" under a 4x slowdown (a fake clock on both sides)
    ELASTIC_K, ELASTIC_STEPS = 4, 12
    for label, avg, spec, gov in (
            ("(i) exact wire", gossip, "death:3@2-6,flaky:7@3-9p2", {}),
            ("(i) int8 tile wire", int8_tile, "death:3@2-6,flaky:7@3-9p2",
             {}),
            ("(i) straggler drop", gossip, "slow:2@2-6x4",
             dict(straggler_policy="drop", straggler_slow_factor=2.0,
                  straggler_patience=2))):
        sides = {}
        for side, d_, st in (("card", dev, stream), ("cpu", cpu, stream_cpu)):
            builds = []
            metric = lambda w, st=st: problems.sin2_error(w, st.top_eigvec)
            builder = counting(krasulina.krasulina_superstep_builder(
                avg, HIGHD_N, step5, metric=metric, device=d_), builds)
            est = krasulina.init_krasulina_state(w0.to(d_), avg, HIGHD_N,
                                                 device=d_)
            ops.reset_launches()
            t0 = time.perf_counter()
            with StreamingDriver(
                    PCARunConfig(pca=HIGHD, averaging=avg,
                                 stream=StreamConfig()),
                    None, est, make_pca_host_sampler(st),
                    superstep_builder=builder, n_nodes=HIGHD_N,
                    batch=HIGHD_B, device=d_,
                    faults=FaultSchedule.parse(spec, HIGHD_N),
                    clock=FakeClock(0.05) if gov else time.perf_counter,
                    engine=EngineConfig(superstep=ELASTIC_K,
                                        prefetch_depth=0, replan_every=0,
                                        governor=GovernorConfig(**gov))
                    ) as drv:
                est, hist = drv.run(ELASTIC_STEPS)
            if d_.type == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = nodes = None
            if side == "card":
                kernels = (["krasulina_xi_gossip"] if avg is gossip
                           else ["krasulina_xi", "gossip_mix_quant"])
                counts = take_counts(label, kernels, {
                    k: 0 for k in ("gossip_mix", "flash_attention")})
                nodes = take_nodes(label)
            sides[side] = dict(state=est, hist=hist, events=events_of(drv),
                               sigs=drv.compiled_signatures, builds=builds,
                               counts=counts, nodes=nodes, seconds=seconds)
        c, p = sides["card"], sides["cpu"]
        sin2_c = [r["metrics"]["metric"] for r in c["hist"]]
        sin2_p = [r["metrics"]["metric"] for r in p["hist"]]
        cohorts = sorted({r["n_active"] for r in c["hist"]})
        print(f"main {label} HIGHD N={HIGHD_N} B={HIGHD_B} R={HIGHD_R} "
              f"K={ELASTIC_K}, {ELASTIC_STEPS} supersteps in "
              f"{c['seconds']:.3f} s on the card ({p['seconds']:.3f} s on "
              f"the CPU): membership events {json.dumps(c['events'])}, "
              f"compiled signatures {list(c['sigs'])}, builds "
              f"{c['builds']}, cohort sizes run {cohorts}; sin2 by "
              f"superstep card {json.dumps([round(x, 6) for x in sin2_c])} "
              f"CPU {json.dumps([round(x, 6) for x in sin2_p])}; "
              f"launches={json.dumps(c['counts'])} by nodes "
              f"{json.dumps(c['nodes'])}")
        require(c["events"] == p["events"] and c["events"],
                f"{label}: membership events differ or none: {c['events']} "
                f"vs {p['events']}")
        require(c["sigs"] == p["sigs"], f"{label}: compiled signatures "
                                        f"differ: {c['sigs']} {p['sigs']}")
        require(len(c["builds"]) == len(set(c["builds"])) == len(c["sigs"]),
                f"{label}: a signature was built twice: {c['builds']}")
        require(len(cohorts) > 1 and (HIGHD_B, HIGHD_N) in c["sigs"],
                f"{label}: the run never left or never had full membership")
        require(c["hist"][-1]["n_active"] == HIGHD_N,
                f"{label}: the run did not rejoin to full membership")
        require(c["state"].t == p["state"].t == ELASTIC_STEPS * ELASTIC_K,
                f"{label}: rounds {c['state'].t} vs {p['state'].t}")
        require(max(sin2_c[-1], sin2_p[-1]) < 0.05,
                f"{label}: sin2 {sin2_c[-1]} (CPU {sin2_p[-1]}) not < 0.05")
        if avg is gossip:
            # the exact wire: kernels and plain versions differ by f32
            # reassociation only
            compare(f"{label} iterates card vs CPU", c["state"].w,
                    p["state"].w.to(dev), "float32")
            compare(f"{label} sin2 by superstep card vs CPU",
                    torch.tensor(sin2_c), torch.tensor(sin2_p), "float32")
            require(set(c["nodes"].get("krasulina_xi_gossip", {})) == set(cohorts),
                    f"{label}: fused launches by nodes {c['nodes']}")
        else:
            # the int8 wire: float noise between the card's and the CPU's xi
            # moves a value across a rounding boundary now and then, and the
            # wire value by one step (1/127 of its tile's max), so the
            # iterates are held to 1e-2 of their largest entry and sin2 to
            # 5e-3 absolute
            compare(f"{label} iterates card vs CPU", c["state"].w,
                    p["state"].w.to(dev), "float32", tol={"float32":
                                                          (1e-2, 1e-5)})
            err = max(abs(a - b) for a, b in zip(sin2_c, sin2_p))
            print(f"check {label} sin2 by superstep card vs CPU: max_abs_err="
                  f"{err:.3e} limit=5e-3 {'ok' if err <= 5e-3 else 'FAIL'}")
            require(err <= 5e-3, f"{label}: sin2 card vs CPU {err}")
            require(set(c["nodes"].get("gossip_mix_quant", {})) == set(cohorts),
                    f"{label}: quantized launches by nodes {c['nodes']}")

    # (j) the eight registered scenarios (FIG7, N = 8, ring R = 2 as
    # registered) through krasulina_superstep_builder(mix=build_mix(scn)):
    # the scheduled operator never fuses, so every round runs krasulina_xi
    # and then the operator's matmul; the scenario's link faults ride the
    # driver (non-elastic); card against CPU on the same numpy draws. The
    # logreg scenario's operator mixes the FIG7 PCA stream (the PCA
    # superstep takes z)
    fig7 = make_pca_stream(FIG7, device=dev)
    fig7_cpu = dataclasses.replace(
        fig7, cov=fig7.cov.cpu(), top_eigvec=fig7.top_eigvec.cpu(),
        sqrt_cov=fig7.sqrt_cov.cpu())
    w7 = randn(FIG7.dim)
    w7 /= w7.norm()
    for name in scenarios.scenario_names():
        scn = scenarios.get_scenario(name)
        avg = scenarios.averaging_config(scn)
        links = scenarios.fault_schedule(scn)
        sides = {}
        for side, d_, st in (("card", dev, fig7), ("cpu", cpu, fig7_cpu)):
            sample = (scenarios.build_stream(scn, pca=st).sample
                      if scn.stream in ("iid_pca", "drift_pca")
                      else make_pca_host_sampler(st))
            metric = lambda w, st=st: problems.sin2_error(w, st.top_eigvec)
            builds = []
            mix_j = scenarios.build_mix(scn, device=d_)
            n_phases = mix_j.n_phases
            base = krasulina.krasulina_superstep_builder(
                avg, scn.n_nodes, lambda t: 10.0 / t, metric=metric,
                mix=mix_j, device=d_)
            ops.reset_launches()
            with StreamingDriver(
                    PCARunConfig(pca=FIG7, averaging=avg,
                                 stream=StreamConfig()),
                    None, krasulina.init_krasulina_state(
                        w7.to(d_), avg, scn.n_nodes, device=d_),
                    sample, superstep_builder=lambda B, mem=None, b=base,
                    builds=builds: builds.append(B) or b(B, mem),
                    n_nodes=scn.n_nodes, batch=10 * scn.n_nodes,
                    faults=links, device=d_,
                    engine=EngineConfig(superstep=4, prefetch_depth=0,
                                        replan_every=0)) as drv:
                jst, hist = drv.run(8)
            counts = (take_counts(f"(j) {name}", ["krasulina_xi"], {
                k: 0 for k in ops.launches if k != "krasulina_xi"})
                      if side == "card" else None)
            sides[side] = (jst, hist, builds, counts)
        (jc, hc, bc, counts), (jp, hp, bp, _) = sides["card"], sides["cpu"]
        drops = sum(len(r.get("link_drops", ())) for r in hc)
        print(f"main (j) scenario {name}: period {scenarios.scenario_period(scn)}"
              f" rounds, {n_phases} phases, 32 rounds, sin2 "
              f"{hc[-1]['metrics']['metric']:.5f} (CPU "
              f"{hp[-1]['metrics']['metric']:.5f}), consensus_err "
              f"{hc[-1]['metrics']['consensus_err']:.3e}, link drops seen "
              f"{drops}, builds {bc}; launches={json.dumps(counts)}")
        require(bc == bp == [10 * scn.n_nodes],
                f"(j) {name}: built {bc} (CPU {bp}), expected one build")
        require([r.get("link_drops") for r in hc]
                == [r.get("link_drops") for r in hp],
                f"(j) {name}: link drops differ card vs CPU")
        compare(f"(j) {name} iterates card vs CPU", jc.w, jp.w.to(dev),
                "float32")
        require(math.isfinite(hc[-1]["metrics"]["metric"]),
                f"(j) {name}: sin2 not finite")

    # (k) the trainer's elastic, error-feedback and scheduled paths
    lossy4 = scenarios.make_scenario("tv_rte", "lossy", "iid_pca",
                                     n_nodes=TRAIN_N, rounds=TRAIN_R)
    # (k0) reduced granite-8b in f32 on the card and on the CPU from the
    # same state and draws, 3 rounds of each path, at (h0)'s tolerances:
    # the cohort superstep (node 1 dropped, exact wire), error feedback on
    # the int8 wire, and the scheduled mix of tv_rte/lossy at n = 4
    cohort_ids = (0, 2, 3)
    for path in ("cohort", "error feedback", "scheduled"):
        quant = dict(quant_tile, error_feedback="grads") \
            if path == "error feedback" else {}
        run = RunConfig(model=cfg_r, shape=SHAPES["train_4k"],
                        averaging=AveragingConfig("gossip", TRAIN_R, "ring",
                                                  **quant),
                        optimizer="adam", learning_rate=H0_LR,
                        param_dtype="float32")
        base = trainer.replicate_for_nodes(
            trainer.init_state(run, torch.Generator().manual_seed(0)),
            TRAIN_N)
        data, rng = MarkovTokenStream(cfg_r.vocab_size, seed=0), \
            np.random.default_rng(0)
        m = len(cohort_ids) if path == "cohort" else TRAIN_N
        batches = {k: np.stack([trainer.make_node_batch(
            draw_tokens(data, rng, 2 * m, 64), m)[k]
            for _ in range(H0_ROUNDS)]) for k in ("tokens", "labels")}
        runs = {}
        for side, d_ in (("card", dev), ("cpu", cpu)):
            st = on_device(base, d_)
            bs = {k: torch.from_numpy(v).to(d_) for k, v in batches.items()}
            if path == "scheduled":
                build = trainer.superstep_builder(
                    run, None, n_nodes=TRAIN_N, device=d_,
                    mix=scenarios.build_mix(lossy4, device=d_))
            else:
                build = trainer.superstep_builder(run, None, n_nodes=TRAIN_N,
                                                  device=d_)
            ops.reset_launches()
            if path == "cohort":
                grads = attn_grads(run, st, {k: v[0] for k, v in bs.items()},
                                   cohort_ids)
                fn = build(2 * m, Membership.full(TRAIN_N).drop(1))
                st, mets = fn(st, cohort_ids, bs)
            else:
                grads = attn_grads(run, st, {k: v[0] for k, v in bs.items()})
                st, mets = build(2 * m)(st, bs)
            counts = (take_counts(
                f"(k0) {path}", [],
                {"gossip_mix": H0_ROUNDS * (path != "scheduled"),
                 "gossip_mix_quant": 0, "flash_attention": 0,
                 "krasulina_xi": 0, "krasulina_xi_gossip": 0})
                      if side == "card" else None)
            nodes = take_nodes(f"(k0) {path}") if side == "card" else None
            runs[side] = ([float(x) for x in mets["loss"]], st, grads,
                          counts, nodes, mets)
        (lc, sc, gc, counts, nodes, mc), (lp, sp, gp, _, _, mp) = \
            runs["card"], runs["cpu"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
        d = torch.cat([(a.cpu() - b).abs().ravel() for a, b in
                       zip(tree_leaves(sc.params), tree_leaves(sp.params))])
        within = float((d <= 1e-4).float().mean())
        grad_err = max(float((a.cpu() - b).abs().max() / b.abs().max())
                       for ga, gb in zip(gc, gp) for a, b in zip(ga, gb))
        grad_min = min(float(b.abs().max()) for gb in gp for b in gb)
        extra = ""
        if path == "error feedback":
            extra = (f"; ef_rel card {json.dumps([float(x) for x in mc['ef_rel']])}"
                     f" CPU {json.dumps([float(x) for x in mp['ef_rel']])}")
        print(f"main (k0) reduced granite-8b f32 N={TRAIN_N} {path}, card vs "
              f"CPU over {H0_ROUNDS} rounds: losses {json.dumps(lc)} (CPU "
              f"{json.dumps(lp)}, max rel err {loss_err:.2e}, limit 1e-4); "
              f"parameters within 1e-4: {within:.6f} (limit >= 0.999), "
              f"max_abs_err {float(d.max()):.3e} (limit "
              f"{3 * H0_LR * H0_ROUNDS:.1e}); wq/wk/wv gradients: smallest "
              f"max|g| {grad_min:.3e}, max rel err {grad_err:.2e} (limit "
              f"1e-4){extra}; launches={json.dumps(counts)} by nodes "
              f"{json.dumps(nodes)}")
        require(loss_err <= 1e-4, f"(k0) {path}: losses disagree")
        require(within >= 0.999 and float(d.max()) <= 3 * H0_LR * H0_ROUNDS,
                f"(k0) {path}: parameters disagree")
        require(grad_min > 0 and grad_err <= 1e-4,
                f"(k0) {path}: wq/wk/wv gradients zero or disagree")
        if path == "cohort":
            require(nodes.get("gossip_mix") == {len(cohort_ids): H0_ROUNDS},
                    f"(k0) cohort: gossip_mix by nodes {nodes}")
            same = all(torch.equal(a[1].cpu(), b[1].cpu()) for a, b in zip(
                tree_leaves(sc.params), tree_leaves(base.params)))
            require(same, "(k0) cohort: the dropped node's row changed")
    del base, runs, sc, sp, gc, gp, st

    def full_width_run(label, quant, *, spec=None, mix_scn=None,
                       supersteps=TRAIN_SUPERSTEPS):
        """granite-8b at full width cut to 2 layers, N = 4, through the
        driver (no prefetch, so membership swaps land on fixed supersteps);
        returns the history, the peak memory and the launch counts."""
        run = RunConfig(model=cfg_h, shape=SHAPES["train_4k"],
                        averaging=AveragingConfig("gossip", TRAIN_R, "ring",
                                                  **quant),
                        optimizer="adam", learning_rate=3e-4,
                        param_dtype="bfloat16", master_weights=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tstate = trainer.replicate_for_nodes(trainer.init_state(
            run, torch.Generator(device=dev).manual_seed(0)), TRAIN_N)
        data = MarkovTokenStream(cfg_h.vocab_size, seed=0)
        sample = lambda rng, n: draw_tokens(data, rng, n, TRAIN_S)
        faults = None
        builder = None
        if spec is not None:
            faults = FaultSchedule.parse(spec, TRAIN_N)
        if mix_scn is not None:
            faults = scenarios.fault_schedule(mix_scn)
            builder = trainer.superstep_builder(
                run, None, n_nodes=TRAIN_N, device=dev,
                mix=scenarios.build_mix(mix_scn, device=dev))
        ops.reset_launches()
        t0 = time.perf_counter()
        with StreamingDriver(run, None, tstate, sample, batch=TRAIN_B,
                             n_nodes=TRAIN_N, device=dev, faults=faults,
                             superstep_builder=builder,
                             engine=EngineConfig(superstep=TRAIN_K,
                                                 prefetch_depth=0,
                                                 replan_every=0)) as drv:
            tstate, history = drv.run(supersteps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        events = events_of(drv)
        del tstate, drv, builder
        torch.cuda.empty_cache()
        losses = [r["metrics"]["loss"] for r in history]
        for r in history:
            extra = "".join(f" {k} {r['metrics'][k]:.4e}" for k in
                            ("ef_norm", "ef_rel") if k in r["metrics"])
            if "link_drops" in r:
                extra += f" link_drops {list(r['link_drops'])}"
            print(f"  superstep {r['superstep']} round {r['round']}: nodes "
                  f"{r['n_active']} B={r['bucket']} loss "
                  f"{r['metrics']['loss']:.5f} consensus_err "
                  f"{r['metrics']['consensus_err']:.4e}{extra} wall "
                  f"{r['wall_s']:.4f} s")
        require(all(math.isfinite(x) for x in losses),
                f"{label}: a loss is not finite")
        require(losses[-1] < losses[0], f"{label}: the loss did not fall")
        steady = history[1:]
        rounds_s = len(steady) * TRAIN_K / sum(r["wall_s"] for r in steady)
        return history, peak, wall, rounds_s, events

    # (k1) the exact and int8 wires under death:1@1-4 with rejoin sync:
    # supersteps 1-3 train the 3-node cohort in place (gossip_mix and
    # gossip_mix_quant at n = 3), superstep 4 rejoins node 1 at the
    # cohort's mean
    for wire, quant, kernel in (("exact", {}, "gossip_mix"),
                                ("int8", quant_tile, "gossip_mix_quant")):
        label = f"(k1) {wire} wire death:1@1-4"
        hist, peak, wall, rounds_s, events = full_width_run(
            label, quant, spec="death:1@1-4", supersteps=5)
        other = {k: 0 for k in ops.launches}
        other[kernel] = 5 * TRAIN_K
        counts = take_counts(label, [kernel], other)
        nodes = take_nodes(label)
        print(f"main {label}: granite-8b full width, {TRAIN_LAYERS} layers, "
              f"N={TRAIN_N}; membership events {json.dumps(events)}; "
              f"{5 * TRAIN_K} rounds in {wall:.3f} s, steady "
              f"{rounds_s:.4f} rounds/s; peak memory {peak:.2f} GB (limit "
              f"80); launches={json.dumps(counts)} by nodes "
              f"{json.dumps(nodes)}; card {smi}")
        require(nodes.get(kernel) == {3: 3 * TRAIN_K, TRAIN_N: 2 * TRAIN_K},
                f"{label}: {kernel} launches by nodes {nodes}")
        require([e[:2] for e in events] == [(1, cohort_ids),
                                            (4, (0, 1, 2, 3))],
                f"{label}: membership events {events}")
        require(peak < 80, f"{label}: peak memory {peak:.2f} GB")

    # (k2) error feedback on the int8 wire at full membership: one
    # compression per round outside the operator, the linear mix of the
    # compressed buffer through gossip_mix a column chunk at a time
    label = "(k2) error feedback int8"
    hist, peak, wall, rounds_s, _ = full_width_run(
        label, dict(quant_tile, error_feedback="grads"), supersteps=3)
    counts = take_counts(label, ["gossip_mix"], {
        "gossip_mix_quant": 0, "flash_attention": 0, "krasulina_xi": 0,
        "krasulina_xi_gossip": 0})
    nodes = take_nodes(label)
    ef_rel = [r["metrics"]["ef_rel"] for r in hist]
    print(f"main {label}: ef_rel by superstep {json.dumps(ef_rel)}; "
          f"{3 * TRAIN_K} rounds in {wall:.3f} s, steady {rounds_s:.4f} "
          f"rounds/s; peak memory {peak:.2f} GB; launches="
          f"{json.dumps(counts)} by nodes {json.dumps(nodes)}")
    require(all(0 < x < 1 for x in ef_rel), f"{label}: ef_rel {ef_rel}")

    # (k3) tv_rte/lossy re-rooted to n = 4: the scheduled operator's matmul
    # (a phase per round picked on the card), the link drops in the records
    label = "(k3) scenario tv_rte/lossy n=4"
    hist, peak, wall, rounds_s, _ = full_width_run(label, {},
                                                   mix_scn=lossy4,
                                                   supersteps=3)
    counts = take_counts(label, [], {k: 0 for k in ops.launches})
    print(f"main {label}: {3 * TRAIN_K} rounds in {wall:.3f} s, steady "
          f"{rounds_s:.4f} rounds/s; peak memory {peak:.2f} GB; "
          f"launches={json.dumps(counts)} (the scheduled matmul is a "
          f"library call, as in the reference)")
    require(all("link_drops" in r for r in hist),
            f"{label}: the records carry no link drops")

    # ---------------------- durability and train-to-serve publication (l)
    from repro_torch.serve.publisher import SnapshotPublisher
    from repro_torch.train import checkpoint
    from repro_torch.train.snapshot import RunSnapshotter

    ck_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ".smoke_ckpt")
    shutil.rmtree(ck_root, ignore_errors=True)

    def advanced(dt, reads):
        """A fake clock where an uninterrupted run's stood after `reads`
        reads (the driver reads it twice per superstep)."""
        clk = FakeClock(dt)
        for _ in range(reads):
            clk()
        return clk

    def snap_line(sn):
        """The snapshotter's training-thread dispatch ms, writer ms per
        save and bytes per save."""
        st = sn.stats
        return (f"snapshot dispatch {st.total_cost_s / st.dispatches * 1e3:.3f}"
                f" ms, writer {st.write_s / max(st.saves, 1) * 1e3:.3f} ms "
                f"per save, {st.bytes_per_save} bytes per save, saves "
                f"{st.saves}, failures {st.failures}")

    # (l0) resume on the main path at HIGHD: (a)'s governed driver (K = 8,
    # prefetch depth 2) on a fake clock, on the exact and int8 wires: 6
    # supersteps uninterrupted, then 3 with a blocking snapshot each, the
    # driver dropped, and 3 more from a fresh driver resumed from the root
    L0_TOTAL, L0_CUT, L0_DT = 6, 3, 1e-3
    for wire, avg, kernels in (("exact", gossip, ["krasulina_xi_gossip"]),
                               ("int8", int8_tile, ["krasulina_xi",
                                                    "gossip_mix_quant"])):
        label = f"(l0) {wire} wire"
        root = os.path.join(ck_root, f"l0_{wire}")
        l_builder = krasulina.krasulina_superstep_builder(
            avg, HIGHD_N, step5, metric=sin2, device=dev)
        l_cfg = PCARunConfig(pca=HIGHD, averaging=avg, stream=run_cfg.stream)

        def l0_driver(clock, **kw):
            return StreamingDriver(
                l_cfg, None,
                krasulina.init_krasulina_state(w0, avg, HIGHD_N, device=dev),
                make_pca_host_sampler(stream), superstep_builder=l_builder,
                n_nodes=HIGHD_N, batch=HIGHD_B, device=dev, clock=clock,
                engine=EngineConfig(superstep=HIGHD_K, prefetch_depth=2), **kw)

        ops.reset_launches()
        with l0_driver(FakeClock(L0_DT)) as drv:
            ref_state, ref_hist = drv.run(L0_TOTAL)
        sn = RunSnapshotter(root, every=1, overhead_budget=0, block=True)
        with l0_driver(FakeClock(L0_DT), snapshotter=sn) as drv:
            drv.run(L0_CUT)
        with l0_driver(advanced(L0_DT, 2 * L0_CUT),
                       resume_from=root) as drv:
            resumed_from = drv.resumed_from
            res_state, res_hist = drv.run(L0_TOTAL - L0_CUT)
        torch.cuda.synchronize()
        rounds = (L0_TOTAL + L0_TOTAL) * HIGHD_K
        exact = ({"krasulina_xi_gossip": rounds, "krasulina_xi": 0,
                  "gossip_mix_quant": 0} if wire == "exact" else
                 {"krasulina_xi": rounds, "gossip_mix_quant": rounds,
                  "krasulina_xi_gossip": 0})
        exact.update(gossip_mix=0, flash_attention=0)
        counts = take_counts(label, kernels, exact)
        nodes = take_nodes(label)
        if wire == "exact":
            require(ops.xi_gossip_launches == {"one-read": rounds,
                                               "two-pass": 0},
                    f"{label}: launches by design {ops.xi_gossip_launches}")
        else:
            require_slab(label, rounds)
            require(ops.quant_launches == {c: rounds * (c == 16)
                                           for c in ops.quant_launches},
                    f"{label}: launches by cluster {ops.quant_launches}")
        same = torch.equal(res_state.w, ref_state.w)
        tail = [(r["round"], tuple(r["counters"]), r["plan"].mu)
                for r in ref_hist[L0_CUT:]]
        got = [(r["round"], tuple(r["counters"]), r["plan"].mu)
               for r in res_hist]
        print(f"main {label} HIGHD N={HIGHD_N} B={HIGHD_B} R={HIGHD_R} "
              f"K={HIGHD_K} prefetch 2, governed, fake clock: resumed from "
              f"{os.path.basename(resumed_from)} at superstep {L0_CUT} of "
              f"{L0_TOTAL}; final iterate equals the uninterrupted run bit "
              f"for bit: {same}; (round, counters, mu) after the cut "
              f"{json.dumps(got)}; sin2 {res_hist[-1]['metrics']['metric']:.5f};"
              f" {snap_line(sn)}; launches={json.dumps(counts)} by nodes "
              f"{json.dumps(nodes)}; card {smi}")
        require(same, f"{label}: the resumed iterate differs")
        require(got == tail, f"{label}: counters or rounds differ: {got} vs "
                             f"{tail}")
        require(res_state.t == ref_state.t == L0_TOTAL * HIGHD_K,
                f"{label}: rounds {res_state.t} vs {ref_state.t}")
        require(sn.stats.failures == 0 and sn.stats.saves == L0_CUT,
                f"{label}: snapshotter {sn.stats}")

    # (l0) under (i)'s churn at prefetch depth 0, cut at superstep 4 while
    # node 3 is out (the 9-node cohort), both wires
    L0C_TOTAL, L0C_CUT = 8, 4
    spec = "death:3@2-6,flaky:7@3-9p2"
    for wire, avg in (("exact", gossip), ("int8", int8_tile)):
        label = f"(l0) {wire} wire under {spec}"
        root = os.path.join(ck_root, f"l0c_{wire}")

        def l0c_driver(clock, builds, **kw):
            builder = counting(krasulina.krasulina_superstep_builder(
                avg, HIGHD_N, step5, metric=sin2, device=dev), builds)
            return StreamingDriver(
                PCARunConfig(pca=HIGHD, averaging=avg, stream=StreamConfig()),
                None,
                krasulina.init_krasulina_state(w0, avg, HIGHD_N, device=dev),
                make_pca_host_sampler(stream), superstep_builder=builder,
                n_nodes=HIGHD_N, batch=HIGHD_B, device=dev, clock=clock,
                faults=FaultSchedule.parse(spec, HIGHD_N),
                engine=EngineConfig(superstep=ELASTIC_K, prefetch_depth=0,
                                    replan_every=0), **kw)

        ops.reset_launches()
        ref_builds, cut_builds, res_builds = [], [], []
        with l0c_driver(FakeClock(L0_DT), ref_builds) as drv:
            ref_state, ref_hist = drv.run(L0C_TOTAL)
            ref_events = events_of(drv)
        sn = RunSnapshotter(root, every=1, overhead_budget=0, block=True)
        with l0c_driver(FakeClock(L0_DT), cut_builds, snapshotter=sn) as drv:
            drv.run(L0C_CUT)
            cut_cohort = drv.membership.n_active
        with l0c_driver(advanced(L0_DT, 2 * L0C_CUT), res_builds,
                        resume_from=root) as drv:
            res_state, res_hist = drv.run(L0C_TOTAL - L0C_CUT)
            res_events = events_of(drv)
        torch.cuda.synchronize()
        counts = take_counts(label, ["krasulina_xi_gossip"] if avg is gossip
                             else ["krasulina_xi", "gossip_mix_quant"],
                             {"gossip_mix": 0, "flash_attention": 0})
        nodes = take_nodes(label)
        same = torch.equal(res_state.w, ref_state.w)
        want_events = [e for e in ref_events if e[0] >= L0C_CUT]
        eras = [(r["bucket"], r["n_active"]) for r in res_hist]
        print(f"main {label} HIGHD K={ELASTIC_K}: cut at superstep "
              f"{L0C_CUT} with {cut_cohort} nodes active; resumed iterate "
              f"equals the uninterrupted run bit for bit: {same}; "
              f"membership events after the cut {json.dumps(res_events)} "
              f"(uninterrupted {json.dumps(want_events)}); eras "
              f"{json.dumps(eras)}; builds uninterrupted {ref_builds}, "
              f"before the cut {cut_builds}, after it {res_builds}; "
              f"{snap_line(sn)}; launches={json.dumps(counts)} by nodes "
              f"{json.dumps(nodes)}")
        require(cut_cohort < HIGHD_N, f"{label}: the cut is not mid-shrink")
        require(same, f"{label}: the resumed iterate differs")
        require(res_events == want_events and res_events,
                f"{label}: membership events differ")
        require(eras == [(r["bucket"], r["n_active"])
                         for r in ref_hist[L0C_CUT:]], f"{label}: eras")
        require(len(res_builds) == len(set(res_builds)),
                f"{label}: a superstep was built twice after the resume: "
                f"{res_builds}")
        require(sn.stats.failures == 0, f"{label}: snapshotter {sn.stats}")

    # (l1) train-to-serve at (h1)'s shape: granite-8b full width, 2 layers,
    # bf16 with f32 masters, N = 4, ring R = 2, K = 2, 4 supersteps, Adam,
    # the exact wire, a governed SnapshotPublisher (budget 0.05); after each
    # superstep a ContinuousBatchingEngine on the card polls it and takes 2
    # new requests of 128-512 prompt tokens and 16 new tokens each
    label = "(l1) train-to-serve"
    L1_GEN, L1_SLOTS = 16, 4
    run = RunConfig(model=cfg_h, shape=SHAPES["train_4k"],
                    averaging=AveragingConfig("gossip", TRAIN_R, "ring"),
                    optimizer="adam", learning_rate=3e-4,
                    param_dtype="bfloat16", master_weights=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tstate = trainer.replicate_for_nodes(trainer.init_state(
        run, torch.Generator(device=dev).manual_seed(0)), TRAIN_N)
    data = MarkovTokenStream(cfg_h.vocab_size, seed=0)
    sample = lambda rng, n: draw_tokens(data, rng, n, TRAIN_S)
    rng = np.random.default_rng(4)
    lens = rng.integers(128, 513, size=2 * TRAIN_SUPERSTEPS)
    prompts = [rng.integers(0, cfg_h.vocab_size, size=int(n)) for n in lens]
    pub = SnapshotPublisher(overhead_budget=0.05)
    eng, rids, versions, staleness = None, [], [], []
    ops.reset_launches()
    t0 = time.perf_counter()
    with StreamingDriver(run, None, tstate, sample, batch=TRAIN_B,
                         n_nodes=TRAIN_N, device=dev, publisher=pub,
                         engine=EngineConfig(superstep=TRAIN_K,
                                             prefetch_depth=2,
                                             replan_every=0)) as drv:
        for i in range(TRAIN_SUPERSTEPS):
            tstate, history = drv.run(1)
            versions.append(history[-1]["published_version"])
            staleness.append(pub.staleness(drv._supersteps_done))
            if eng is None:
                eng = engine.ContinuousBatchingEngine(
                    cfg_h, pub.snapshot().params, slots=L1_SLOTS,
                    max_len=512 + L1_GEN, dtype=torch.bfloat16)
            eng.poll(pub)
            rids += [eng.submit(p, L1_GEN) for p in prompts[2 * i:2 * i + 2]]
            for _ in range(L1_GEN // 2):
                eng.step()
        mask = drv._publish_aux()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    other = {k: 0 for k in ops.launches}
    other.update(gossip_mix=TRAIN_K * TRAIN_SUPERSTEPS,
                 flash_attention=TRAIN_LAYERS * len(prompts))
    counts = take_counts(label, ["gossip_mix", "flash_attention"], other)
    counts["flash_by_kernel"] = dict(ops.flash_launches)
    nodes = take_nodes(label)
    require(ops.flash_launches == {"wgmma": TRAIN_LAYERS * len(prompts),
                                   "mma_sync": 0, "f32": 0},
            f"{label}: flash launches by kernel {ops.flash_launches}")
    done = [eng.result(r) for r in rids]
    complete = all(r is not None and len(r.tokens) == L1_GEN and all(
        0 <= t < cfg_h.vocab_size for t in r.tokens) for r in done)
    spanning = sum(len(set(r.versions)) > 1 for r in done)
    published = [v for v in versions if v is not None]
    # the last published params against the plain f32 mean of the nodes,
    # cast to bf16: within one bf16 step (ordered bit patterns)
    def ordered(t):
        b = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(b < 0, -(b & 0x7FFF), b)

    steps = max(int((ordered(p) - ordered(
        (q.float().sum(0) / TRAIN_N).to(torch.bfloat16))).abs().max())
        for p, q in zip(tree_leaves(pub.snapshot().params),
                        tree_leaves(tstate.params)))
    # the publish's card time (events) for the same extract and copy
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    extra = pub._copy(tstate, mask)
    end.record()
    torch.cuda.synchronize()
    pub_card_ms = start.elapsed_time(end)
    del extra
    steady = history  # drv.run(1) returns the whole history
    steady_rs = (len(steady) - 1) * TRAIN_K / sum(r["wall_s"]
                                                   for r in steady[1:])
    print(f"main {label} granite-8b full width, {TRAIN_LAYERS} layers, "
          f"N={TRAIN_N}, {TRAIN_SUPERSTEPS} supersteps: published versions "
          f"{json.dumps(versions)} (publisher v{pub.version}, engine "
          f"v{eng.version}, swaps {eng.swaps}); staleness after each "
          f"superstep {json.dumps([s['supersteps'] for s in staleness])} "
          f"supersteps; publish dispatch "
          f"{pub.stats.total_cost_s / pub.stats.publishes * 1e3:.3f} ms (EWMA "
          f"{pub.stats.cost_ewma_s * 1e3:.3f}), card {pub_card_ms:.3f} ms "
          f"(CUDA events); last published params vs the f32 node mean in "
          f"bf16: at most {steps} bf16 step(s); {len(done)} requests, "
          f"prompts {int(lens.min())}-{int(lens.max())}, all {L1_GEN} tokens "
          f"each: {complete}, spanning a swap {spanning}; steady "
          f"{steady_rs:.4f} rounds/s (h1 in this run "
          f"{h_rounds['(h1)']:.4f}); {wall:.3f} s in all; peak memory "
          f"{peak:.2f} GB (h1 {h_peak['(h1)']:.2f}); "
          f"launches={json.dumps(counts)} by nodes {json.dumps(nodes)}; "
          f"card {smi}")
    require(published and all(b > a for a, b in zip(published,
                                                     published[1:])),
            f"{label}: versions not strictly increasing: {versions}")
    require(eng.version == pub.version, f"{label}: engine at v{eng.version}, "
                                        f"publisher at v{pub.version}")
    require(versions[-1] is not None, f"{label}: the last superstep was not "
                                      f"published")
    require(complete, f"{label}: a request lost tokens")
    require(steps <= 1, f"{label}: published params {steps} bf16 steps from "
                        f"the node mean")
    require(peak < 80, f"{label}: peak memory {peak:.2f} GB")
    del tstate, drv, eng, pub
    torch.cuda.empty_cache()

    # (l2) resume across devices: the reduced f32 granite of (h0), N = 4,
    # ring R = 2, Adam at 1e-4, K = 1, 8 x 64 tokens per round; a
    # RunSnapshotter on the card writes superstep 2 of 4, and a CPU driver
    # and a card driver each resume from it
    label = "(l2) resume across devices"
    L2_TOTAL, L2_CUT = 4, 2
    root = os.path.join(ck_root, "l2")
    run = RunConfig(model=cfg_r, shape=SHAPES["train_4k"],
                    averaging=AveragingConfig("gossip", TRAIN_R, "ring"),
                    optimizer="adam", learning_rate=H0_LR,
                    param_dtype="float32")
    base = trainer.replicate_for_nodes(
        trainer.init_state(run, torch.Generator().manual_seed(0)), TRAIN_N)
    data = MarkovTokenStream(cfg_r.vocab_size, seed=0)
    sample = lambda rng, n: draw_tokens(data, rng, n, 64)

    def l2_driver(d_, **kw):
        return StreamingDriver(run, None, on_device(base, d_), sample,
                               batch=8, n_nodes=TRAIN_N, device=d_,
                               engine=EngineConfig(superstep=1,
                                                   prefetch_depth=0,
                                                   replan_every=0), **kw)

    ops.reset_launches()
    whole = []
    for _ in range(2):
        with l2_driver(dev) as drv:
            st, hist = drv.run(L2_TOTAL)
        whole.append((st, [r["metrics"]["loss"] for r in hist]))
    sn = RunSnapshotter(root, every=1, overhead_budget=0, block=True)
    with l2_driver(dev, snapshotter=sn) as drv:
        drv.run(L2_CUT)
    res = {}
    for side, d_ in (("card", dev), ("cpu", cpu)):
        with l2_driver(d_, resume_from=root) as drv:
            st, hist = drv.run(L2_TOTAL - L2_CUT)
        res[side] = (st, [r["metrics"]["loss"] for r in hist])
    torch.cuda.synchronize()
    counts = take_counts(label, ["gossip_mix"], {
        "gossip_mix": 2 * L2_TOTAL + L2_CUT + (L2_TOTAL - L2_CUT),
        "gossip_mix_quant": 0, "flash_attention": 0})
    nodes = take_nodes(label)

    def agree(a, b):
        """(h0)'s bounds: (max rel loss err, share of parameters within
        1e-4, max abs err)."""
        (sa, la), (sb, lb) = a, b
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(la, lb))
        d = torch.cat([(x.cpu() - y.cpu()).abs().ravel() for x, y in
                       zip(tree_leaves(sa.params), tree_leaves(sb.params))])
        return loss_err, float((d <= 1e-4).float().mean()), float(d.max())

    repeat = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(whole[0][0].params), tree_leaves(whole[1][0].params)))
    card_cpu = agree(res["card"], res["cpu"])
    same_card = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(res["card"][0].params), tree_leaves(whole[0][0].params)))
    card_whole = agree(res["card"], (whole[0][0], whole[0][1][L2_CUT:]))
    print(f"main {label} reduced granite-8b f32 N={TRAIN_N} ring R={TRAIN_R} "
          f"adam, snapshot at superstep {L2_CUT} of {L2_TOTAL} on the card: "
          f"two uninterrupted card runs give the same bits: {repeat}; card "
          f"resume vs CPU resume: losses {json.dumps(res['card'][1])} (CPU "
          f"{json.dumps(res['cpu'][1])}), max rel err {card_cpu[0]:.2e} "
          f"(limit 1e-4), parameters within 1e-4 {card_cpu[1]:.6f} (limit "
          f">= 0.999), max_abs_err {card_cpu[2]:.3e}; card resume vs the "
          f"uninterrupted card run: same bits {same_card}, max rel loss err "
          f"{card_whole[0]:.2e}, within 1e-4 {card_whole[1]:.6f}; "
          f"{snap_line(sn)}; launches={json.dumps(counts)} by nodes "
          f"{json.dumps(nodes)}")
    require(card_cpu[0] <= 1e-4 and card_cpu[1] >= 0.999,
            f"{label}: the card and CPU continuations disagree")
    if repeat:
        require(same_card, f"{label}: the card resume differs from the "
                           f"uninterrupted card run, which repeats bit for bit")
    else:
        print(f"note {label}: two uninterrupted card runs differ in their "
              f"bits, so the card resume is held to (h0)'s bounds")
        require(card_whole[0] <= 1e-4 and card_whole[1] >= 0.999,
                f"{label}: the card resume and the uninterrupted run disagree")
    require(sn.stats.failures == 0, f"{label}: snapshotter {sn.stats}")
    del base, whole, res, st
    shutil.rmtree(ck_root, ignore_errors=True)

    # ------------------------------- the attention model families (m0)-(m3)
    def model_params(params):
        return sum(t.numel() for t in tree_leaves(params))

    def layers_flash(cfg_):
        """Flash launches of one prefill of more than 16 tokens: one per GQA
        layer (MLA attends through `blockwise_attention`)."""
        return 0 if cfg_.mla is not None else cfg_.num_layers

    # (m0) each arch reduced, in f32, the same parameters on the card and on
    # the CPU's plain path (llama4: 4 layers, its iRoPE period, so that the
    # NoPE global layer runs)
    for arch in M_ARCHS:
        cfg_m = reduced(get_config(arch), layers=4 if arch.startswith(
            "llama4") else 2)
        p_cpu = registry.init_params(torch.Generator().manual_seed(0), cfg_m)
        p_dev = convert.tree_map(lambda t: t.to(dev), p_cpu)
        batch = registry.synth_batch(torch.Generator().manual_seed(1), cfg_m,
                                     2, 24, mode="train")
        runs = {}
        for side, d_, params_ in (("card", dev, p_dev), ("cpu", cpu, p_cpu)):
            b = {k: v.to(d_) for k, v in batch.items()}
            ops.reset_launches()
            logits, _ = registry.prefill(
                params_, cfg_m, {"tokens": b["tokens"]},
                registry.init_cache(cfg_m, 2, 32, torch.float32, device=d_))
            toks = engine.generate(params_, cfg_m, {"tokens": b["tokens"]},
                                   32, 8, dtype=torch.float32).tolist()
            _, met = registry.loss_fn(params_, cfg_m, b)
            flash = (layers_flash(cfg_m) * 2, dict(ops.flash_launches))
            counts = (take_counts(f"(m0) {arch}", [], {
                "flash_attention": flash[0], "gossip_mix": 0,
                "gossip_mix_quant": 0, "krasulina_xi": 0,
                "krasulina_xi_gossip": 0}) if side == "card" else None)
            runs[side] = (logits.cpu(), toks, float(met["ce"]),
                          float(met["aux"]), counts, flash)
        (lc, tc_, cc, ac, counts, flash), (lp, tp_, cp, ap, _, _) = \
            runs["card"], runs["cpu"]
        err = (lc - lp).abs().max().item()
        ce_err, aux_err = abs(cc - cp) / abs(cp), abs(ac - ap) / max(
            abs(ap), 1e-30)
        print(f"main (m0) {arch} reduced f32 ({cfg_m.num_layers} layers) card "
              f"vs CPU: prefill logits max_abs_err={err:.3e} (limit 1e-3); "
              f"greedy tokens equal over 8 steps {tc_ == tp_}; loss ce "
              f"{cc:.6f} (CPU {cp:.6f}, rel err {ce_err:.2e}) aux {ac:.6f} "
              f"(CPU {ap:.6f}, rel err {aux_err:.2e}) (limit 1e-4); flash "
              f"launches {counts['flash_attention']} = "
              f"{layers_flash(cfg_m)} x 2 prefills, by kernel "
              f"{json.dumps(flash[1])}")
        require(err <= 1e-3, f"(m0) {arch}: prefill logits disagree")
        require(tc_ == tp_, f"(m0) {arch}: greedy tokens differ")
        require(ce_err <= 1e-4 and aux_err <= 1e-4,
                f"(m0) {arch}: loss_fn disagrees")
        require(flash[1]["f32"] == flash[0], f"(m0) {arch}: flash launches "
                                             f"by kernel {flash[1]}")
        require((ac > 0) == (cfg_m.moe is not None), f"(m0) {arch}: aux {ac}")
        del p_cpu, p_dev, runs

    def serve_arch(label, cfg_s, B, P, gen, *, dtype=torch.bfloat16,
                   card_time=False, params=None, flash=None, prompt=None):
        """Seeded random weights, a static prefill of B prompts of P tokens
        (or `prompt`) and gen - 1 greedy decode steps (the `generate` path,
        timed apart); the prefill launches the flash kernel `flash` = (n,
        kernel) times, by default the wgmma kernel once per GQA layer, and
        nothing else runs. Returns (params, tokens [B, gen], stats)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if params is None:
            params = registry.init_params(
                torch.Generator(device=dev).manual_seed(0), cfg_s, dtype)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = model_params(params)
        if prompt is None:
            prompt = registry.synth_batch(torch.Generator(
                device=dev).manual_seed(1), cfg_s, B, P, mode="prefill")
        ops.reset_launches()
        st = engine.init_serve(cfg_s, B, P + gen, dtype, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = registry.prefill(params, cfg_s, prompt, st.cache)
        st = engine.ServeState(cache, logits[:, -1:].argmax(-1), P)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        del logits
        toks = [st.last_tokens]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            st, t = engine.serve_step(params, cfg_s, st)
            toks.append(t)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        out = torch.cat(toks, dim=1)
        n_flash, kind = flash or (layers_flash(cfg_s), "wgmma")
        variants = dict(ops.flash_launches)
        counts = take_counts(label, ["flash_attention"] if n_flash else [], {
            "flash_attention": n_flash, "gossip_mix": 0,
            "gossip_mix_quant": 0, "krasulina_xi": 0,
            "krasulina_xi_gossip": 0})
        require(variants == {k: n_flash if k == kind else 0
                             for k in variants},
                f"{label}: flash launches by kernel {variants}")
        stats = {"params_B": n_params / 1e9, "init_s": init_s,
                 "prefill_ms": prefill_s * 1e3,
                 "prefill_tokens_per_s": B * P / prefill_s,
                 "decode_ms_per_step": decode_s / max(gen - 1, 1) * 1e3,
                 "decode_tokens_per_s": B * (gen - 1) / decode_s,
                 "flash_by_kernel": variants, "launches": counts}
        if card_time:
            # the card's own time: one prefill and one decode step replayed
            # from a CUDA graph (no host launch gaps)
            stats["card_prefill_ms"] = time_ms(lambda: registry.prefill(
                params, cfg_s, prompt, st.cache), reps=2, replays=3)
            stats["card_decode_ms"] = time_ms(lambda: registry.decode_step(
                params, cfg_s, st.last_tokens, st.cache, st.index), reps=5,
                replays=3)
            ops.reset_launches()  # the graph's captures are timing, not path
        stats["peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
        ok_toks = tuple(out.shape) == (B, gen) and bool(
            ((out >= 0) & (out < cfg_s.vocab_size)).all())
        require(finite, f"{label}: prefill logits not finite")
        require(ok_toks, f"{label}: tokens of the wrong shape or outside the "
                         f"vocabulary")
        del st, cache, toks, prompt
        return params, out, stats

    def fmt(stats):
        return " ".join(f"{k}={v:.6g}" if isinstance(v, float) else
                        f"{k}={json.dumps(v)}" for k, v in stats.items())

    def serve_engine(label, cfg_e, params, slots, prompts, per_prefill, kind,
                     gen=M2_GEN):
        """`prompts` through `slots` slots of the continuous engine (bf16),
        `gen` tokens each (the prefill's, then decode steps); every prefill
        launches the flash kernel `kind` `per_prefill` times."""
        torch.cuda.reset_peak_memory_stats()
        eng = engine.ContinuousBatchingEngine(
            cfg_e, params, slots=slots,
            max_len=max(len(p) for p in prompts) + gen,
            dtype=torch.bfloat16)
        ops.reset_launches()
        t0 = time.perf_counter()
        rids = [eng.submit(p, gen) for p in prompts]
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = per_prefill * len(prompts)
        variants = dict(ops.flash_launches)
        counts = take_counts(label, ["flash_attention"] if n else [], {
            "flash_attention": n, "gossip_mix": 0, "gossip_mix_quant": 0,
            "krasulina_xi": 0, "krasulina_xi_gossip": 0})
        done = [eng.result(r) for r in rids]
        ok = all(len(r.tokens) == gen and all(
            0 <= t < cfg_e.vocab_size for t in r.tokens) for r in done)
        lens = [len(p) for p in prompts]
        print(f"main {label}: slots={slots} requests={len(prompts)} prompts "
              f"{min(lens)}-{max(lens)} (sum {sum(lens)}) gen={gen}: "
              f"{wall:.3f} s, {len(prompts) * gen / wall:.1f} generated "
              f"tokens/s, {eng.decode_steps} decode steps "
              f"({wall / eng.decode_steps * 1e3:.3f} ms per step, prefills "
              f"included); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches={json.dumps(counts)} by kernel "
              f"{json.dumps(variants)}")
        require(ok, f"{label}: a request lost tokens or left the vocabulary")
        require(variants == {k: n if k == kind else 0 for k in variants},
                f"{label}: flash launches by kernel {variants}")
        del eng, done
        return counts

    def engine_prompts(cfg_e, n, seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, cfg_e.vocab_size, size=int(m))
                for m in rng.integers(128, 513, size=n)]

    # (m1) qwen2-moe-a2.7b at full width and depth, bf16, seeded weights:
    # static generate, then the continuous engine
    cfg_q = get_config("qwen2-moe-a2.7b")
    require(cfg_q.num_layers == 24, "qwen2-moe-a2.7b depth changed")
    params, out, stats = serve_arch("(m1) static", cfg_q, 4, 512, GEN,
                                    card_time=True)
    print(f"main (m1) qwen2-moe-a2.7b: {stats['params_B']:.3f} B "
          f"parameters, bf16, {cfg_q.num_layers} layers, static generate B=4 "
          f"prompt=512 gen={GEN}: {fmt(stats)}; card {smi}")
    require(abs(stats["params_B"] - 14.004) < 0.01,
            f"(m1) {stats['params_B']} B parameters, expected 14.00")
    # where one prefill's time goes: layer 0's attention and MoE FFN at the
    # prefill's shape, and the vocab projection, each replayed from a graph
    blk = params["blocks"][0]
    h = torch.randn(4, 512, cfg_q.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    pos = torch.arange(512, device=dev)[None].expand(4, 512)
    phases = {
        "attention": time_ms(lambda: L.apply_attention(blk["attn"], cfg_q, h,
                                                       pos), reps=5),
        "moe": time_ms(lambda: M.apply_moe(blk["ffn"], cfg_q, h), reps=5),
        "norms": 2 * time_ms(lambda: L.apply_norm(blk["norm1"], h,
                                                  cfg_q.norm), reps=5),
        "unembed": time_ms(lambda: L.unembed_logits(
            params.get("unembed", params["embed"]), h), reps=2),
    }
    # the MoE FFN cut into its parts: the router (logits, softmax, top-k),
    # the routed experts' three batched matmuls over every capacity slot,
    # and the shared experts; the rest of `apply_moe` dispatches and
    # combines
    ffn, m_q = blk["ffn"], cfg_q.moe
    T = 4 * 512
    E, K, G = m_q.num_experts, m_q.top_k, T // M.group_size(T)
    C = M.capacity(m_q, M.group_size(T))
    xt = h.reshape(T, cfg_q.d_model)
    xe = torch.randn(E, G * C, cfg_q.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    parts = {
        "router": time_ms(lambda: torch.topk(torch.softmax(
            xt.float() @ ffn["router"].to(h.dtype).float(), -1), K, -1),
            reps=5),
        "experts": time_ms(lambda: torch.bmm(F.silu(torch.bmm(
            xe, ffn["we_gate"])) * torch.bmm(xe, ffn["we_up"]),
            ffn["we_down"]), reps=5),
        "shared": time_ms(lambda: L.apply_ffn(ffn["shared"], h, "swiglu"),
                          reps=5),
    }
    parts["dispatch_combine"] = phases["moe"] - sum(parts.values())
    eff = m_q.expert_d_ff
    expert_flops = 2 * 3 * E * G * C * cfg_q.d_model * eff
    ops.reset_launches()
    layer_ms = phases["attention"] + phases["moe"] + phases["norms"]
    print(f"main (m1) prefill phases on the card, ms (B=4 S=512, one layer of "
          f"24; CUDA graph replays): {json.dumps(phases)}; per layer "
          f"{layer_ms:.4f}, x 24 + unembed = "
          f"{24 * layer_ms + phases['unembed']:.3f} against the card's "
          f"prefill {stats['card_prefill_ms']:.3f}; the MoE FFN's parts "
          f"{json.dumps(parts)} (C={C} slots of {E} experts for {T * K} "
          f"assignments; the experts' matmuls {expert_flops / 1e9:.1f} GFLOP, "
          f"{expert_flops / parts['experts'] / 1e9:.1f} TFLOP/s, bound "
          f"{expert_flops / BF16_FLOPS_PER_S * 1e3:.4f} ms)")
    del h, pos, blk, ffn, xt, xe
    serve_engine("(m1) continuous batching", cfg_q, params, 8,
                 engine_prompts(cfg_q, 16, 2), 24, "wgmma", gen=GEN)
    del params, out
    torch.cuda.empty_cache()

    # (m2) the other five at full width: phi4-mini and minicpm3 at full
    # depth, starcoder2 (ring and full cache), llama4-scout (one iRoPE
    # period) and chameleon cut in depth, each prompt past its window or
    # chunk
    for arch, layers, B, P in M2_CASES:
        cfg_s = get_config(arch)
        if layers:
            cfg_s = dataclasses.replace(cfg_s, num_layers=layers)
        label = f"(m2) {arch}"
        params, out, stats = serve_arch(label, cfg_s, B, P, M2_GEN)
        print(f"main {label}: {cfg_s.num_layers} layers, "
              f"{stats['params_B']:.3f} B parameters, bf16, B={B} prompt={P} "
              f"gen={M2_GEN}: {fmt(stats)}")
        if arch == "starcoder2-15b":
            ring_cfg = dataclasses.replace(cfg_s, ring_buffer_cache=True)
            _, ring_out, ring_stats = serve_arch(f"{label} ring", ring_cfg,
                                                 B, P, M2_GEN, params=params)
            cache_len = registry.init_cache(ring_cfg, 1, P + M2_GEN,
                                            device=dev)[0]["k"].shape[1]
            same = torch.equal(ring_out, out)
            print(f"main {label} ring cache ({cache_len} slots of "
                  f"{P + M2_GEN}): {fmt(ring_stats)}; greedy tokens equal to "
                  f"the full cache's over {M2_GEN} steps: {same}")
            require(cache_len == cfg_s.sliding_window,
                    f"{label}: ring of {cache_len} slots")
            require(same, f"{label}: the ring and the full cache give "
                          f"different tokens")
            del ring_out
        del params, out
        torch.cuda.empty_cache()

    # (m3) the decentralized trainer on reduced qwen2-moe in f32: (h0)'s run
    # (4 nodes, ring R = 2, Adam at 1e-4, 3 rounds) on the card and on the
    # CPU from the same state and draws, on the exact wire
    cfg_r3 = reduced(get_config("qwen2-moe-a2.7b"))
    run = RunConfig(model=cfg_r3, shape=SHAPES["train_4k"],
                    averaging=AveragingConfig("gossip", TRAIN_R, "ring"),
                    optimizer="adam", learning_rate=H0_LR,
                    param_dtype="float32")
    base = trainer.replicate_for_nodes(
        trainer.init_state(run, torch.Generator().manual_seed(0)), TRAIN_N)
    data, rng = MarkovTokenStream(cfg_r3.vocab_size, seed=0), \
        np.random.default_rng(0)
    batches = [trainer.make_node_batch(draw_tokens(data, rng, 8, 64), TRAIN_N)
               for _ in range(H0_ROUNDS)]
    runs = {}
    for side, d_ in (("card", dev), ("cpu", cpu)):
        st = on_device(base, d_)
        step = trainer.build_train_step(run, None, n_nodes=TRAIN_N, device=d_)
        ops.reset_launches()
        losses, auxes = [], []
        for b in batches:
            st, m = step(st, {k: torch.from_numpy(v).to(d_)
                              for k, v in b.items()})
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
        counts = (take_counts("(m3)", ["gossip_mix"], {
            "gossip_mix": H0_ROUNDS, "gossip_mix_quant": 0,
            "flash_attention": 0, "krasulina_xi": 0,
            "krasulina_xi_gossip": 0}) if side == "card" else None)
        if side == "card":
            counts["by_nodes"] = take_nodes("(m3)")
        runs[side] = (losses, auxes, st, counts)
    (lc, ac, sc, counts), (lp, ap, sp, _) = runs["card"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    d = torch.cat([(a.cpu() - b).abs().ravel() for a, b in
                   zip(tree_leaves(sc.params), tree_leaves(sp.params))])
    within = float((d <= 1e-4).float().mean())
    print(f"main (m3) reduced qwen2-moe f32 (2 layers) N={TRAIN_N} ring "
          f"R={TRAIN_R} adam exact wire, card vs CPU over {H0_ROUNDS} rounds: "
          f"losses {json.dumps(lc)} (CPU {json.dumps(lp)}, max rel err "
          f"{loss_err:.2e}, limit 1e-4); aux {json.dumps(ac)}; parameters "
          f"within 1e-4: {within:.6f} (limit >= 0.999), max_abs_err "
          f"{float(d.max()):.3e} (limit {3 * H0_LR * H0_ROUNDS:.1e}); "
          f"launches={json.dumps(counts)}")
    require(loss_err <= 1e-4, "(m3) losses disagree")
    require(within >= 0.999 and float(d.max()) <= 3 * H0_LR * H0_ROUNDS,
            "(m3) parameters disagree")
    require(min(ac) > 0, "(m3) the router's aux loss is not > 0")
    del base, runs, sc, sp, st

    # ----------- the recurrent and encoder-decoder families (n0)-(n2)
    def n_flash(cfg_):
        """(flash launches of one prefill of more than 16 tokens, the
        kernel) for these families in bf16: one per local-attention layer
        (recurrentgemma, D = 256: wgmma), three per decoder layer pair
        of encoder, self and cross attention (seamless, D = 64: wgmma),
        none for the SSD."""
        if cfg_.is_encdec:
            return cfg_.encoder_layers + 2 * cfg_.num_layers, "wgmma"
        if cfg_.rglru is not None:
            from repro_torch.models.transformer import layer_specs
            return sum(sp.kind == "attn" for sp in layer_specs(cfg_)), \
                "wgmma"
        return 0, "wgmma"

    # (n0) each family reduced, in f32, the same parameters on the card and
    # on the CPU's plain path; the decoded tokens against a prefill of the
    # extended prompt
    for arch, layers in N_ARCHS.items():
        cfg_n = reduced(get_config(arch), layers=layers)
        p_cpu = registry.init_params(torch.Generator().manual_seed(0), cfg_n)
        p_dev = convert.tree_map(lambda t: t.to(dev), p_cpu)
        g_n = torch.Generator().manual_seed(1)
        batch = registry.synth_batch(g_n, cfg_n, 2, 24, mode="train")
        if cfg_n.is_encdec:  # unmasked attention over a ragged key count
            batch["frames"] = torch.randn(
                (2, N0_FRAMES, cfg_n.frontend_embed_dim), generator=g_n)
        runs = {}
        for side, d_, params_ in (("card", dev, p_dev), ("cpu", cpu, p_cpu)):
            b = {k: v.to(d_) for k, v in batch.items()}
            prompt = {k: v for k, v in b.items() if k != "labels"}
            ops.reset_launches()
            logits, _ = registry.prefill(
                params_, cfg_n, prompt,
                registry.init_cache(cfg_n, 2, 32, torch.float32, device=d_))
            toks = engine.generate(params_, cfg_n, prompt, 32, 8,
                                   dtype=torch.float32)
            ext = dict(prompt, tokens=torch.cat([prompt["tokens"], toks], 1))
            ext_logits, _ = registry.prefill(
                params_, cfg_n, ext,
                registry.init_cache(cfg_n, 2, 32, torch.float32, device=d_))
            same = torch.equal(ext_logits[:, 23:31].argmax(-1), toks)
            _, met = registry.loss_fn(params_, cfg_n, b)
            per_prefill = n_flash(cfg_n)[0]
            flash = (per_prefill * 3, dict(ops.flash_launches))
            counts = (take_counts(f"(n0) {arch}", [], {
                "flash_attention": flash[0], "gossip_mix": 0,
                "gossip_mix_quant": 0, "krasulina_xi": 0,
                "krasulina_xi_gossip": 0}) if side == "card" else None)
            runs[side] = (logits.cpu(), toks.tolist(), same,
                          float(met["ce"]), counts, flash)
        (lc, tc_, sc_, cc, counts, flash), (lp, tp_, sp_, cp, _, _) = \
            runs["card"], runs["cpu"]
        err = (lc - lp).abs().max().item()
        ce_err = abs(cc - cp) / abs(cp)
        print(f"main (n0) {arch} reduced f32 ({cfg_n.num_layers} layers) card "
              f"vs CPU: prefill logits max_abs_err={err:.3e} (limit 1e-3); "
              f"greedy tokens equal over 8 steps {tc_ == tp_}; decoded "
              f"tokens = the extended prompt's prefill argmax: card {sc_}, "
              f"CPU {sp_}; loss ce {cc:.6f} (CPU {cp:.6f}, rel err "
              f"{ce_err:.2e}, limit 1e-4); flash launches "
              f"{counts['flash_attention']} = {n_flash(cfg_n)[0]} x 3 "
              f"prefills, by kernel {json.dumps(flash[1])}")
        require(err <= 1e-3, f"(n0) {arch}: prefill logits disagree")
        require(tc_ == tp_, f"(n0) {arch}: greedy tokens differ")
        require(sc_ and sp_, f"(n0) {arch}: decode differs from the prefill "
                             f"of the extended prompt")
        require(ce_err <= 1e-4, f"(n0) {arch}: loss_fn disagrees")
        require(flash[1]["f32"] == flash[0], f"(n0) {arch}: flash launches "
                                             f"by kernel {flash[1]}")
        del p_cpu, p_dev, runs

    # (n1) recurrentgemma-9b whole: a 2 x 4096 prefill past its 2048-token
    # window, 16 greedy steps, then 8 requests through 4 slots
    cfg_g = get_config("recurrentgemma-9b")
    require(cfg_g.num_layers == 38, "recurrentgemma-9b depth changed")
    params, out, stats = serve_arch("(n1) static", cfg_g, 2, 4096, M2_GEN,
                                    card_time=True, flash=n_flash(cfg_g))
    # (n1)'s flash launches, all at D = 256, for the kernels line
    d256_launches = stats["launches"]["flash_attention"]
    print(f"main (n1) recurrentgemma-9b: {stats['params_B']:.3f} B "
          f"parameters, bf16, {cfg_g.num_layers} layers, static generate B=2 "
          f"prompt=4096 gen={M2_GEN}: {fmt(stats)}; card {smi}")
    # every tensor counted: 9.396 B; the reference's `param_count()` (8.52)
    # leaves out the RG-LRU's two [W, W] gate matrices
    require(abs(stats["params_B"] - 9.396) < 0.001,
            f"(n1) {stats['params_B']} B parameters, expected 9.396 "
            f"(param_count() {cfg_g.param_count() / 1e9:.3f})")
    # where one prefill's time goes: an RG-LRU layer's mixer (its doubling
    # scan apart), a local-attention layer's (the flash kernel inside), the
    # GeGLU FFN and the vocab projection, each replayed from a graph at the
    # prefill's shape
    from repro_torch.models import rglru as R
    blk_r, blk_a = params["blocks"][0], params["blocks"][2]
    h = torch.randn(2, 4096, cfg_g.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    pos = torch.arange(4096, device=dev)[None].expand(2, 4096)
    xf = torch.randn(2, 4096, cfg_g.d_model, generator=gen, device=dev)
    gates = torch.rand(2, 4096, cfg_g.d_model, generator=gen, device=dev)
    phases = {
        "rglru": time_ms(lambda: R.apply_rglru(blk_r["attn"], cfg_g, h),
                         reps=2),
        "rglru_scan": time_ms(lambda: R._rglru_scan(
            xf, gates, gates, blk_r["attn"]["lam"], None), reps=2),
        "attention": time_ms(lambda: L.apply_attention(
            blk_a["attn"], cfg_g, h, pos, attn_mode="window",
            window=cfg_g.rglru.local_window), reps=2),
        "ffn": time_ms(lambda: L.apply_ffn(blk_r["ffn"], h, cfg_g.ffn),
                       reps=2),
        "unembed": time_ms(lambda: L.unembed_logits(params["embed"], h),
                           reps=1),
    }
    ops.reset_launches()  # the graphs' captures are timing, not path
    layers_ms = 26 * (phases["rglru"] + phases["ffn"]) + 12 * (
        phases["attention"] + phases["ffn"])
    print(f"main (n1) prefill phases on the card, ms (B=2 S=4096, one layer "
          f"each; CUDA graph replays): {json.dumps(phases)}; 26 RG-LRU and "
          f"12 attention layers with their FFNs + unembed = "
          f"{layers_ms + phases['unembed']:.3f} against the card's prefill "
          f"{stats['card_prefill_ms']:.3f}")
    del h, pos, xf, gates, blk_r, blk_a
    torch.cuda.empty_cache()
    d256_launches += serve_engine("(n1) continuous", cfg_g, params, 4,
                                  engine_prompts(cfg_g, 8, 3),
                                  *n_flash(cfg_g))["flash_attention"]
    del params, out
    torch.cuda.empty_cache()

    # (n2) mamba2-2.7b whole (4 x 512, 16 steps, 16 requests through 8
    # slots), then seamless-m4t-medium whole (4 x 4096 frames, a 4 x 64
    # decoder prompt, 16 greedy steps, then `generate` itself)
    cfg_b = get_config("mamba2-2.7b")
    require(cfg_b.num_layers == 64, "mamba2-2.7b depth changed")
    params, out, stats = serve_arch("(n2) mamba2 static", cfg_b, 4, 512,
                                    M2_GEN, card_time=True,
                                    flash=n_flash(cfg_b))
    print(f"main (n2) mamba2-2.7b: {stats['params_B']:.3f} B parameters, "
          f"bf16, {cfg_b.num_layers} layers, static generate B=4 prompt=512 "
          f"gen={M2_GEN}: {fmt(stats)}")
    require(abs(stats["params_B"] - 2.703) < 0.001,
            f"(n2) {stats['params_B']} B parameters, expected 2.703 "
            f"(param_count() {cfg_b.param_count() / 1e9:.3f})")
    serve_engine("(n2) mamba2 continuous", cfg_b, params, 8,
                 engine_prompts(cfg_b, 16, 4), *n_flash(cfg_b))
    del params, out
    torch.cuda.empty_cache()
    cfg_e = get_config("seamless-m4t-medium")
    require((cfg_e.encoder_layers, cfg_e.num_layers) == (12, 12),
            "seamless-m4t-medium depth changed")
    g_e = torch.Generator(device=dev).manual_seed(1)
    prompt = {"frames": torch.randn(
                  (SEAMLESS_B, SEAMLESS_FRAMES, cfg_e.frontend_embed_dim),
                  generator=g_e, device=dev),
              "tokens": torch.randint(0, cfg_e.vocab_size,
                                      (SEAMLESS_B, SEAMLESS_P), generator=g_e,
                                      device=dev)}
    params, out, stats = serve_arch(
        "(n2) seamless static", cfg_e, SEAMLESS_B, SEAMLESS_P, M2_GEN,
        card_time=True, flash=n_flash(cfg_e), prompt=prompt)
    print(f"main (n2) seamless-m4t-medium: {stats['params_B']:.3f} B "
          f"parameters, bf16, {cfg_e.encoder_layers} + {cfg_e.num_layers} "
          f"layers, B={SEAMLESS_B} frames={SEAMLESS_FRAMES} decoder "
          f"prompt={SEAMLESS_P} gen={M2_GEN}: {fmt(stats)}")
    # every tensor counted: 0.615 B; `param_count()` (0.564) leaves out the
    # cross-attention's weights
    require(abs(stats["params_B"] - 0.615) < 0.001,
            f"(n2) {stats['params_B']} B parameters, expected 0.615 "
            f"(param_count() {cfg_e.param_count() / 1e9:.3f})")
    ops.reset_launches()
    gen_toks = engine.generate(params, cfg_e, prompt,
                               SEAMLESS_P + M2_GEN, M2_GEN)
    torch.cuda.synchronize()
    counts = take_counts("(n2) seamless generate", ["flash_attention"], {
        "flash_attention": n_flash(cfg_e)[0], "gossip_mix": 0,
        "gossip_mix_quant": 0, "krasulina_xi": 0, "krasulina_xi_gossip": 0})
    variants = dict(ops.flash_launches)
    # the 12 causal launches are the decoder's self-attention prefill
    print(f"main (n2) seamless generate: tokens equal to the static path's "
          f"{torch.equal(gen_toks, out)}; launches={json.dumps(counts)} by "
          f"kernel {json.dumps(variants)} ({cfg_e.encoder_layers} encoder + "
          f"{cfg_e.num_layers} cross unmasked, {cfg_e.num_layers} causal)")
    require(torch.equal(gen_toks, out), "(n2) seamless: generate differs "
                                        "from the static path")
    require(variants["wgmma"] == n_flash(cfg_e)[0],
            f"(n2) seamless generate: flash launches by kernel {variants}")
    del params, out, gen_toks, prompt
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- timing
    def bound(bytes_moved, flops, flops_per_s):
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / flops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def measure(name, shape, kernel, plain, bytes_moved, flops, library=None,
                flops_per_s=F32_FLOPS_PER_S):
        b_ms, b_by = bound(bytes_moved, flops, flops_per_s)
        out = {"shape": shape, "ms": time_ms(kernel),
               "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": time_ms(library) if library else None}
        print(f"time {name} {shape}: " + json.dumps(out))
        return out

    # cold: a 64 MB buffer (more than the 50 MB L2) written before each call
    # in the graph, its own time taken off
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    scrub_fill = lambda: scrub.fill_(1)
    scrub_ms = time_ms(lambda: None, flush=scrub_fill)

    def cold_ms(fn):
        return time_ms(fn, flush=scrub_fill) - scrub_ms

    rows = []
    for name in ("krasulina_xi", "krasulina_xi_gossip", "gossip_mix"):
        timed = []
        for N, bn, d in ((HIGHD_N, HIGHD_B // HIGHD_N, HIGHD.dim),
                         (16, 4, 32768)):
            sched = mixing.schedule("ring", N)
            w, z, x = randn(N, d), randn(N, bn, d), randn(N, d)
            shape = {"krasulina_xi": f"G={N} B={bn} d={d}",
                     "krasulina_xi_gossip": f"N={N} Bn={bn} d={d} R={HIGHD_R}",
                     "gossip_mix": f"n={N} d={d} R={HIGHD_R}"}[name]
            terms = len(sched)
            if name == "krasulina_xi":
                timed.append(measure(
                    name, shape, lambda: ops.krasulina_xi(w, z),
                    lambda: ref.krasulina_xi_ref(w, z),
                    4 * (N * bn * d + 2 * N * d), 4 * N * bn * d))
                # cold, and the two-pass design, forced, in the same run
                two_pass = lambda: krasulina_xi_cuda(w, z, _design="two-pass")
                timed[-1].update(
                    design=xi_route(w, z),
                    cluster=xi_clusters[(N, bn, d, torch.float32)],
                    cold_ms=cold_ms(lambda: ops.krasulina_xi(w, z)),
                    two_pass_ms=time_ms(two_pass),
                    two_pass_cold_ms=cold_ms(two_pass))
                t = timed[-1]
                print(f"time krasulina_xi {shape}: {t['design']} with "
                      f"clusters of {t['cluster']} {t['ms']:.5f} ms warm, "
                      f"{t['cold_ms']:.5f} ms cold; two-pass kernel "
                      f"{t['two_pass_ms']:.5f} ms warm, "
                      f"{t['two_pass_cold_ms']:.5f} ms cold")
            elif name == "krasulina_xi_gossip":
                timed.append(measure(
                    name, shape,
                    lambda: ops.krasulina_xi_gossip(w, z, sched, HIGHD_R),
                    lambda: ref.krasulina_xi_gossip_ref(w, z, sched, HIGHD_R),
                    4 * (N * bn * d + 2 * N * d),
                    4 * N * bn * d + 2 * terms * HIGHD_R * N * d))
                # the two-pass design, forced, in the same run
                timed[-1]["design"] = xi_gossip_route(w, z)
                timed[-1]["two_pass_ms"] = time_ms(
                    lambda: krasulina_xi_gossip_cuda(w, z, sched, HIGHD_R,
                                                     _design="two-pass"))
                print(f"time krasulina_xi_gossip two-pass kernel {shape}: "
                      f"{timed[-1]['two_pass_ms']:.5f} ms "
                      f"({timed[-1]['design']} {timed[-1]['ms']:.5f} ms)")
            else:
                fused = mixing.compose_schedule(sched, HIGHD_R, N)
                A = torch.as_tensor(mixing.schedule_matrix(fused, N),
                                    dtype=torch.float32, device=dev)
                timed.append(measure(
                    name, shape, lambda: ops.gossip_mix(x, sched, HIGHD_R),
                    lambda: ref.gossip_mix_ref(x, sched, HIGHD_R),
                    # one multiply-add per tap of the composed schedule
                    4 * 2 * N * d, 2 * len(fused) * N * d,
                    library=lambda: torch.matmul(A, x.reshape(N, -1))))
        main_shape, wide = timed
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": errs[name], "ms": main_shape["ms"],
                     "plain_ms": main_shape["plain_ms"],
                     "bound_ms": main_shape["bound_ms"],
                     "bound_by": main_shape["bound_by"],
                     "library_ms": main_shape["library_ms"],
                     "shape": main_shape["shape"], "wide": wide})
        if name == "krasulina_xi_gossip":
            rows[-1]["two_pass_ms"] = main_shape["two_pass_ms"]
            rows[-1]["launches_by_design"] = dict(by_design)
        if name == "krasulina_xi":
            for key in ("cluster", "cold_ms", "two_pass_ms",
                        "two_pass_cold_ms"):
                rows[-1][key] = main_shape[key]
            rows[-1]["launches_by_design"] = dict(xi_by_design)
        if name == "gossip_mix":
            rows[-1]["launches_by_design"] = dict(gossip_by_design)
    del scrub
    # gossip_mix_quant: the cluster kernel, and the one-block-per-tile
    # kernel in the same run, at the main path's shape (paths d, e), the wide
    # one, R = 0, 1, 8 at the main shape (the fixed load and store against
    # the cost per round) and path (f)'s shape (800 of its launches)
    def quant_ms(x, sched, R, quant, block_d, design):
        return time_ms(lambda: gossip_mix_quant_cuda(
            x, sched, R, quant, block_d=block_d, _design=design))

    timed = {}
    for quant in ("int8", "sign"):
        timed[quant] = []
        for N, d, R, bd in ((HIGHD_N, HIGHD.dim, HIGHD_R, 512),
                            (16, 32768, HIGHD_R, 512), (16, 21, 2, 8)):
            sched = mixing.schedule("ring", N)
            x = randn(N, d)
            timed[quant].append(measure(
                f"gossip_mix_quant {quant}", f"n={N} d={d} R={R} "
                f"block_d={bd}",
                lambda: ops.quant_gossip_mix(x, sched, R, quant, block_d=bd),
                lambda: ref.gossip_mix_quant_ref(x, sched, R, quant,
                                                 block_d=bd),
                # compression plus (deg + 1) multiply-adds per element-round
                4 * 2 * N * d, (2 * len(sched) + 4) * R * N * d))
            timed[quant][-1]["resident_tile_ms"] = quant_ms(
                x, sched, R, quant, bd, "resident-tile")
            print(f"time gossip_mix_quant {quant} resident-tile kernel "
                  f"{timed[quant][-1]['shape']}: "
                  f"{timed[quant][-1]['resident_tile_ms']:.5f} ms "
                  f"(cluster-tile {timed[quant][-1]['ms']:.5f} ms)")
        x = randn(HIGHD_N, HIGHD.dim)
        sched = mixing.schedule("ring", HIGHD_N)
        split = {design: {R: quant_ms(x, sched, R, quant, 512, design)
                          for R in (0, 1, 8)}
                 for design in ("cluster-tile", "resident-tile")}
        timed[quant][0]["r_split"] = split
        print(f"time gossip_mix_quant {quant} R-split n={HIGHD_N} "
              f"d={HIGHD.dim} block_d=512 ms by R: {json.dumps(split)}")
    main_shape, wide, f_shape = timed["int8"]
    rows.append({"name": "gossip_mix_quant", "route": "cuda",
                 "source": SOURCES["gossip_mix_quant"],
                 "replaces": REPLACES["gossip_mix_quant"],
                 "launches": launches["gossip_mix_quant"],
                 "max_abs_err": errs["gossip_mix_quant"], "ms": main_shape["ms"],
                 "plain_ms": main_shape["plain_ms"],
                 "bound_ms": main_shape["bound_ms"],
                 "bound_by": main_shape["bound_by"], "library_ms": None,
                 "resident_tile_ms": main_shape["resident_tile_ms"],
                 "shape": "int8 " + main_shape["shape"], "wide": wide,
                 "f_shape": f_shape, "r_split": main_shape["r_split"],
                 "sign": timed["sign"][0], "sign_wide": timed["sign"][1],
                 "sign_f_shape": timed["sign"][2],
                 "launches_by_cluster": dict(by_cluster)})
    # flash_attention, bf16 causal at granite-8b's heads: a 512-token prefill
    # (the main path's shape) and a 4096-token one; the causal products are
    # 2 B H S^2 D operations, the bytes q, k, v read and out written once.
    # Beside it, in this run, the mma.sync kernel that the wgmma kernel
    # replaced on this path, launched through its own entry point.

    timed = []
    for S in (512, 4096):
        q, k, v = (randn(1, 32, S, 128, dtype=torch.bfloat16) for _ in range(3))
        compare_close(f"flash_attention mma_sync bfloat16 B=1 H=32 Sq={S} "
                      f"Sk={S} D=128 causal=True (timed beside)",
                      mma_sync_attention(q, k, v),
                      ops.attention(q, k, v, causal=True), FLASH_TOL["bfloat16"])
        timed.append(measure(
            "flash_attention", f"bf16 causal B=1 H=32 S={S} D=128",
            lambda: ops.attention(q, k, v, causal=True),
            lambda: ref.attention_ref(q, k, v, causal=True),
            4 * 32 * S * 128 * 2, 2 * 32 * S * S * 128,
            library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True),
            flops_per_s=BF16_FLOPS_PER_S))
        timed[-1]["mma_sync_ms"] = time_ms(lambda: mma_sync_attention(q, k, v))
        print(f"time flash_attention mma_sync kernel S={S}: "
              f"{timed[-1]['mma_sync_ms']:.5f} ms (wgmma "
              f"{timed[-1]['ms']:.5f} ms)")
        del q, k, v
        torch.cuda.empty_cache()
    main_shape, wide = timed
    # recurrentgemma-9b's prefill at D = 256 (the wgmma kernel): its one KV
    # head broadcast as the model's `_flash` does, causal with a window of
    # 2048 over 4096 tokens; beside it the mma.sync kernel, forced, held to
    # the same bound and timed. The operations are 4 B H D per live (q, k)
    # pair; the bytes the kernel's q, k, v read and out written once. SDPA
    # takes the window as a boolean mask.
    B_, H_, S_, W_ = RG_FLASH
    q = randn(B_, S_, H_, 256, dtype=torch.bfloat16)
    k1, v1 = (randn(B_, S_, 1, 256, dtype=torch.bfloat16) for _ in range(2))
    qh, kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(H_ // t.shape[2], 1)
                  .contiguous() for t in (q, k1, v1))
    rg_masks = dict(causal=True, window=W_)
    shape = (f"bfloat16 B={B_} H={H_} Sq={S_} Sk={S_} D=256 causal=True "
             f"window={W_} (recurrentgemma-9b prefill")
    ops.reset_launches()
    got = L._flash(q, k1, v1, window=W_).permute(0, 2, 1, 3)
    require(ops.flash_launches["wgmma"] == 1 and flash_route(qh, kh, vh)
            == "wgmma", f"recurrentgemma's shape did not take the wgmma "
                        f"kernel: {ops.flash_launches}")
    e = compare_bf16_attention(f"flash_attention wgmma {shape}, the model's "
                               f"MQA broadcast)", got, qh, kh, vh, rg_masks)
    compare_bf16_attention(f"flash_attention mma_sync (forced) {shape})",
                           mma_sync_attention(qh, kh, vh, **rg_masks), qh, kh,
                           vh, rg_masks)
    del got
    pos = torch.arange(S_, device=dev)
    band = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - W_)
    pairs = int(band.sum())
    d256 = measure(
        "flash_attention", f"bf16 causal window={W_} B={B_} H={H_} S={S_} "
        f"D=256 (recurrentgemma-9b)",
        lambda: ops.attention(qh, kh, vh, **rg_masks),
        lambda: ref.attention_ref(qh, kh, vh, **rg_masks),
        4 * qh.numel() * 2, 4 * B_ * H_ * 256 * pairs,
        library=lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       attn_mask=band),
        flops_per_s=BF16_FLOPS_PER_S)
    d256["mma_sync_ms"] = time_ms(lambda: mma_sync_attention(qh, kh, vh,
                                                             **rg_masks))
    print(f"time flash_attention D=256 (recurrentgemma-9b): wgmma "
          f"{d256['ms']:.5f} ms, mma.sync {d256['mma_sync_ms']:.5f} ms, SDPA "
          f"{d256['library_ms']:.5f} ms, bound {d256['bound_ms']:.5f} ms "
          f"({d256['bound_by']})")
    d256.update(kernel=flash_route(qh, kh, vh),
                design="wgmma+tma, 64-key tiles",
                source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                max_abs_err=e, launches=d256_launches,
                launches_by_kernel=dict(flash_total))
    del q, k1, v1, qh, kh, vh, band
    torch.cuda.empty_cache()
    rows.append({"name": "flash_attention", "route": "cuda",
                 "source": SOURCES["flash_attention"],
                 "replaces": REPLACES["flash_attention"],
                 "launches": launches["flash_attention"],
                 "max_abs_err": errs["flash_attention"],
                 "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
                 "bound_ms": main_shape["bound_ms"],
                 "bound_by": main_shape["bound_by"],
                 "library_ms": main_shape["library_ms"],
                 "shape": main_shape["shape"], "wide": wide,
                 "mma_sync_ms": main_shape["mma_sync_ms"], "d256": d256,
                 "launches_by_kernel": dict(flash_total)})
    # both gossip kernels at the trainer's shape (h): the packed bf16
    # gradient buffer of 4 nodes, and of (k1)'s 3-node cohort (its first 3
    # rows). CUDA events around a few calls (one call moves 10 GB, so launch
    # gaps are noise, and a graph of many calls would hold their outputs);
    # the plain version on the whole buffer too, its error on the first and
    # the last columns (past element 2^31 of the buffer), cut at tile
    # boundaries
    def event_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    cuts = (slice(0, 1 << 20),
            slice((train_d - (1 << 20)) // 512 * 512, train_d))

    def at_shape(name, xs, cols=cuts, note="trainer shape"):
        """`name` on the n nodes' rows xs (ring R = TRAIN_R; int8 tiles of
        512 columns for gossip_mix_quant), routed, against its plain version
        on the columns `cols`; timed beside the plain version on all of xs
        and, for gossip_mix, the matmul by the composed operator. For
        gossip_mix_quant also forced onto each design, which must give the
        same bits."""
        n, dt = xs.shape[0], str(xs.dtype).split(".")[-1]
        sched = mixing.schedule("ring", n)
        if name == "gossip_mix":
            fused = mixing.compose_schedule(sched, TRAIN_R, n)
            A = torch.as_tensor(mixing.schedule_matrix(fused, n),
                                dtype=xs.dtype, device=dev)
            kern = lambda: ops.gossip_mix(xs, sched, TRAIN_R)
            plain = lambda part: ref.gossip_mix_ref(part, sched, TRAIN_R)
            library = lambda: torch.matmul(A, xs)
            flops, tol, wire = 2 * len(fused) * xs.numel(), TOL, ""
        else:
            kern = lambda: ops.quant_gossip_mix(xs, sched, TRAIN_R, "int8",
                                                block_d=512)
            plain = lambda part: ref.gossip_mix_quant_ref(
                part, sched, TRAIN_R, "int8", block_d=512)
            library = None
            flops = (2 * len(sched) + 4) * TRAIN_R * xs.numel()
            tol, wire = QUANT_TOL, " int8 block_d=512"
        shape = f"{dt} n={n} d={xs.shape[1]} R={TRAIN_R}{wire}"
        got = kern()
        err = max(compare(f"{name} {shape} columns {c.start}:{c.stop} "
                          f"({note})", got[:, c],
                          plain(xs[:, c].contiguous()), dt, tol)
                  for c in cols)
        del got
        b_ms, b_by = bound(2 * xs.numel() * xs.element_size(), flops,
                           F32_FLOPS_PER_S)
        timed = {"shape": shape, "ms": event_ms(kern),
                 "plain_ms": event_ms(lambda: plain(xs), reps=1),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": event_ms(library) if library else None,
                 "max_abs_err": err}
        if name == "gossip_mix_quant":
            timed["route"] = quant_route(xs, 512)
            out = {}
            for design in ("resident-tile", "cluster-tile"):
                fn = lambda: gossip_mix_quant_cuda(
                    xs, sched, TRAIN_R, "int8", block_d=512, _design=design)
                timed[design.replace("-", "_") + "_ms"] = event_ms(fn)
                out[design] = fn()
            same = torch.equal(out["resident-tile"], out["cluster-tile"])
            del out
            print(f"check gossip_mix_quant {shape} ({note}) resident-tile "
                  f"vs cluster-tile: {'same bits' if same else 'DIFFER'}")
            require(same, f"gossip_mix_quant {shape}: the two designs give "
                          f"different bits")
        torch.cuda.empty_cache()
        print(f"time {name} {note} {shape}: " + json.dumps(timed))
        return timed

    x = torch.randn((TRAIN_N, train_d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    for name in ("gossip_mix", "gossip_mix_quant"):
        row = next(r for r in rows if r["name"] == name)
        row["trainer"] = at_shape(name, x)
        row["n3"] = at_shape(name, x[:3])
    del x
    torch.cuda.empty_cache()
    # (k2)'s linear mix: one error-feedback column chunk, f32 [4, width],
    # holding the int8 tile wire's values, held whole against the plain
    # version
    width = averaging.ef_chunk_width(TRAIN_N, train_d, 512)
    q = tile_compress(torch.randn((TRAIN_N, width), generator=gen,
                                  device=dev), "int8", 512,
                      per_node=True).contiguous()
    next(r for r in rows if r["name"] == "gossip_mix")["ef_chunk"] = \
        at_shape("gossip_mix", q, cols=(slice(0, width),),
                 note="error-feedback chunk")
    del q
    torch.cuda.empty_cache()
    for row in rows:
        row["design"] = DESIGN[row["name"]]
        if row["name"] in nodes_total:
            row["launches_by_nodes"] = {
                str(n): c for n, c in sorted(nodes_total[row["name"]].items())}
    # the ranks' launches of (s0)-(s2), by phase and rank, under "s"
    for row in rows:
        by_phase = s_launches.get(row["name"])
        if by_phase is None:
            continue
        row["launches"] += sum(sum(v) for v in by_phase.values())
        key = ("launches_by_kernel" if row["name"] == "flash_attention"
               else "launches_by_nodes")
        row.setdefault(key, {})["s"] = by_phase
    # the per-round metric: the excess risk reads the [d, d] covariance, the
    # alignment error two vectors
    wbar = state.w.mean(0)
    for label, fn in (("pca_excess_risk", lambda: problems.pca_excess_risk(
                          wbar, stream.cov, stream.lambda1)),
                      ("sin2_error", lambda: sin2(wbar))):
        print(f"time metric {label} d={HIGHD.dim}: {time_ms(fn):.5f} ms")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the "
          f"start of the build")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--s-rank"]:
        sys.exit(s_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
