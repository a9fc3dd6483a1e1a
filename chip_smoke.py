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
   launch a rank); n = 10 on 4 ranks (3, 3, 2, 2 rows) through the halo
   rule too, bit for bit. (s1) the
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
   (v0)-(v4), elastic membership on the sharded node axis, after the
   model axis's ranks (t): four rank processes in one gloo group (a
   subgroup of 2 for the 2-rank phases), a cohort's active rows split over
   them as contiguous, uneven runs (`dist.cohort_rows`; a rank may hold
   none). (v0) the cohort shard rules at HIGHD's mix (n = 10, d = 3072,
   ring R = 8) on 2 and 4 ranks (3/3/2/2) with node 0 out, nodes 3 and 4
   out and every row of one rank out, exact and sign bit for bit, int8
   at f32 round-off against the plain per-round path over the m cohort
   rows, and one round's table of ring/lossy/iid_pca's scheduled op within
   1e-6 of its largest entry; (v1) (s1)'s governed PCA driver on 2 ranks
   under (i)'s faults (the exact and int8 tile wires under
   `death:3@2-6,flaky:7@3-9p2`, `slow:2@2-6x4` under the policy "drop"):
   equal events, signatures and plan histories, sin^2 < 0.05, the exact
   wire's iterate within 1e-5 rel + 1e-5 max, `krasulina_xi` (and
   `gossip_mix_quant` on the gathered cohort) once a round a rank; (v2)
   tv_rte/ratelimited/drift_pca and geometric/lossy/skew_logreg on 2
   ranks, N = 8, their scheduled operators gathering the node rows; (v3)
   the reduced granite trainer, 4 ranks x 1 node, under `death:1@1-2`
   with and without rejoin sync, at (h0)'s bounds; (v4) granite-8b at its
   published widths cut to 2 layers, (s2b)'s node on each of 4 ranks,
   under `death:1@1-2` with rejoin sync, one round a superstep (one round
   at full membership, one in the cohort, one rejoining): the dead node's rows
   unchanged bit for bit while out, within one bf16 step of the donors'
   mean after the rejoin, the planned wire equal to the ranks' to the
   byte; prints s per round at full membership and in the cohort, bytes
   by route, each rank's peak, the launches and (v)'s seconds.
   (w0)-(w4), error feedback, the hierarchical mode, snapshots, resume and
   publication on the sharded node axis, after (v): four rank processes,
   one node each, the pod mesh ("pod", "data", "model") = (2, 2, 1) and
   the snapshot writers' group made at set-up. (w0) the reduced granite
   trainer (f32, Adam): error feedback on the sign and int8 wires, bit
   for bit the single-process card run with the plain per-round operator
   at full membership, and under `death:1@1-2` at (h0)'s bounds; the
   hierarchical mode, exact and int8 (128-column tiles: the lanes gossip
   their blocks apart), bit for bit the single-process run at pods = 2,
   its wire equal to the plan; the int8 run's snapshot restored on one
   process and the single-process snapshot restored on the ranks, each
   continued one superstep bit for bit; the published params within f32
   reassociation of the single process's extract; the governed PCA
   driver at HIGHD resumed on the ranks bit for bit (`krasulina_xi` on
   every rank). (w1) granite-8b at its published widths cut to 2 layers,
   (s2b)'s node on each rank, int8 error feedback for two rounds: s per
   round, bytes staged a round equal to the plan, `ef_rel` in (0, 1),
   each peak under a quarter of the card, and the same rounds on one
   process after the ranks exit within (h0)'s bounds on the f32 masters.
   (w2) (w1)'s ranks publish after round 1; rank 0's engine greedy-decodes
   through the wgmma flash kernel, the tokens of a single-process engine
   on the same weights. (w3) the ranks snapshot (w1)'s state after round
   1, each its own rows, restore it in place and repeat round 2 bit for
   bit. (w4) the hierarchical mode at full width on the pod mesh, one
   round, its bytes staged equal to the plan.
   (x0)-(x1), the dense archs on the production mesh's model axis, after
   (w): heads and KV heads split inside a head, leaves the extent does
   not divide kept whole, and durable model-axis runs. (x0) four ranks,
   reduced granite-8b at d_model 512 in f32: on 1 x 4 the loss and every
   gradient of three head cases (2 KV heads: half a KV head a rank; 6
   heads, 2 KV heads: 1.5 heads a rank; d_ff 1022: the FFN whole) against
   the single-process card run at (t0)'s bounds; the gossip trainer with
   2 KV heads at (t1)'s (`gossip_mix` on every rank); the exact mode
   (FSDP + ZeRO-1) on 2 x 2 through the driver, 3 rounds, a blocking
   snapshot after round 2 byte for byte the one-process save of the
   gathered state, resumed on 2 x 2 bit for bit, and on 1 x 4 and one
   process (the single-process card driver, while (x1)'s ranks run): the
   restored state bit for bit, round 3 at (t1)'s bounds. (x1) sixteen
   ranks, the production mesh's model extent: granite-8b at its
   published widths cut to 2 layers on 1 x 16 (each of its 8 KV heads
   cut in two), 4 nodes, gossip R = 2, bf16 with f32 masters, 2 rounds:
   round 1 within 1e-2 of one process's, the bytes at rest, messages and
   bytes staged by axis equal to the planner's trace, each peak within
   15% of the plan's; prints s per round and (x)'s seconds.
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
   decode ms per step and peak memory (and the prefill's own peak).
   (u) the last three families through the trainer: (u0) each reduced,
   in f32 (mamba2-2.7b 2 layers at S = 128, recurrentgemma-9b 5 at S =
   160, seamless-m4t-medium 2 + 2 at S = 64 over 64 frames), 4 nodes,
   ring R = 2, Adam, 3 rounds of the exact and the gossip mode on the card
   and on the CPU from the same state and draws: (h0)'s bounds (the
   99.9% share within 1e-4 in each leaf too), the consensus errors
   within 1e-4 relative, `gossip_mix` once per packed buffer per gossip
   round; (u1) mamba2-2.7b at its published widths cut to 4 layers, 4 nodes, on the
   gossip_mix and the int8 tile wires; (u2) recurrentgemma-9b cut to 3
   layers (one period: both RG-LRU layers and the local attention train),
   2 nodes, the ring's self weight 0.6 (at its default 1/2 two nodes mix
   to the exact mean); (u3) seamless-m4t-medium whole, 4 nodes, each
   sample with a [512, 160] standard-normal frame block. Each in bf16
   with f32 masters (dropped where the round's plan passes 75 GB), Adam
   at 3e-4 (1e-3 for (u3)), 2 x 512 tokens a node a round, K = 2, 4
   supersteps through the `StreamingDriver`: finite, falling losses (and
   one held batch's loss, before the rounds and after, falling by more
   than 0.026, the spread of (u3)'s superstep losses in an earlier run), a
   consensus error above 0, a peak under 80 GB, `gossip_mix` (or
   `gossip_mix_quant`) K x supersteps x packed buffers (2 where the
   SSD's or the RG-LRU's f32 leaves make a second buffer) and no
   `flash_attention`. Before the driver, round 1's gradients, packed as
   the trainer packs them, go through the wire's kernel and its plain
   version on the card: each buffer at the kernel checks' bound, the two
   consensus errors within 1e-3 relative (the kernel checks add (u2)'s
   2-node ring at self weight 0.6). Prints parameters a node, the
   state's GB, rounds/s, tokens/s, the host sampler's and the card's ms a round, the
   round's phases, the peaks and the phase's seconds.
   (p) the planner against the card (`launch/dryrun.py`, meta traces on
   the host, no card work, no kernel launch): (p1) the plans on a 1 x 1
   mesh of (h1)'s round (2 layers, 4 nodes, 2 x 512 tokens a node, Adam
   with f32 masters, gossip R = 2), of (u1)-(u3)'s rounds (traced in (u))
   and of (g1)'s, (m1)'s and (n1)'s prefills beside the peak their phases
   measured ((h1): the phase; (u1)-(u3): their driver runs; the serving
   phases: the prefill's own, their phase peak printed beside), each
   within 15%; (p2) (s2b)'s planned node-axis wire on a
   4 x 1 mesh, exact and gossip, counted as `dist.stats` counts it,
   within 1% of what each rank staged; (p3) the H100 roofline's step
   bound and implied MFU of (h1)'s round and (g1)'s prefill beside their
   card times (printed only).
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
# the last three families through the trainer (u): (u0)'s reduced forms,
# arch: (layers, tokens a sample, frames a sample or 0); the full-width runs,
# (label, arch, layers or 0 for all, nodes, wires, the ring's self weight or
# 0 for its default, Adam's rate). Ring gossip over 2 nodes at the default
# self weight (1/2) is the exact mean, so (u2) weighs its own row 0.6; at
# 3e-4 seamless's loss, from near ln(vocab), falls by less than its
# supersteps' own spread in 8 rounds, so (u3) steps at 1e-3.
U0_CASES = {"mamba2-2.7b": (2, 128, 0), "recurrentgemma-9b": (5, 160, 0),
            "seamless-m4t-medium": (2, 64, 64)}
U2_SELF_WEIGHT = 0.6
U_RUNS = [("(u1)", "mamba2-2.7b", 4, 4, ("exact", "int8"), 0.0, 3e-4),
          ("(u2)", "recurrentgemma-9b", 3, 2, ("exact",), U2_SELF_WEIGHT,
           3e-4),
          ("(u3)", "seamless-m4t-medium", 0, 4, ("exact",), 0.0, 1e-3)]
# each full-width run's loss on one held batch must fall by more than this
# over its rounds: the spread of (u3)'s four superstep losses at Adam 3e-4
# (12.63960 to 12.66556 on an H100, PERF.md section 6)
U_LOSS_MARGIN = 0.026
# the packed buffers' mix held against its plain version in column chunks
# of this many (whole int8 tiles); the two consensus errors within
# U_CERR_RTOL of each other. Each side rounds its output to bf16 once; at
# (u2)'s 2 nodes the mix is near the exact mean, so those roundings are a
# larger share of the deviations the consensus error reads. A wrong weight
# moves it by its whole size.
U_MIX_CHUNK, U_CERR_RTOL = 1 << 26, 1e-3
# (u2) drops its f32 masters where its plan's peak passes this many GB
U_MASTERS_GB = 75
# (p1): each plan's peak within this share of the measured (PERF.md, section 6)
P1_BOUND = 0.15
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


def compare(name, got, want, dtype_name, tol=TOL, chunk=0):
    """Max |kernel - plain|, held to rtol * max|plain| + atol; with `chunk`,
    over that many columns at a time (f32 copies of a chunk, not of the
    whole)."""
    rtol, atol = tol[dtype_name]
    if chunk:
        err = scale = 0.0
        for c in range(0, got.shape[-1], chunk):
            w = want[..., c:c + chunk].float()
            err = max(err, (got[..., c:c + chunk].float() - w).abs().max()
                      .item())
            scale = max(scale, w.abs().max().item())
    else:
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
    limit = rtol * scale + atol
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
    ("HIGHD uneven", 4, HIGHD_N, 3072, HIGHD_R, 0.0, "exact"),
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
        require(c0["impl"] == "shard", f"(s0) {label}: impl {c0['impl']}")
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
                                       for r in range(4)]},
            # (p2) holds the planned gossip wire against these
            "s2b_staged": {mode: [rr["s2b"][mode]["staged_bytes_per_round"]
                                  for rr in res[:4]]
                           for mode in ("exact", "gossip")}}


# (t) the model axis: T_WORLD rank processes share the card in one gloo
# group (`model_axis_phases`, spawned after (s)'s ranks have exited), on a
# 2 x 2 mesh (2 node shards; tensor-parallel and, in the exact mode, ZeRO-1
# over 2) and a 1 x 4 one (tensor-parallel over 4, every node local); the
# model and data groups are subgroups of it
T_WORLD, T_TIMEOUT = 4, 420
T_MESHES = {"gossip": (1, 4), "exact": (2, 2)}  # (t1), (t2): mode -> mesh
T2_ROUNDS = 2
T0_TOL, T2_LOSS_TOL = 1e-5, 1e-2


def t_cfgs():
    """(t0)'s reduced granite-8b at d_model 512 (8 heads, 2 KV heads);
    (t1)'s, with 4 KV heads (one a rank on 1 x 4: (x0) runs the 2, each
    cut in two); (t2)'s granite-8b at its published widths cut to
    TRAIN_LAYERS layers."""
    from repro_torch.configs import get_config, reduced

    granite = get_config("granite-8b")
    r = reduced(granite, d_model=512)
    return (r, dataclasses.replace(r, num_kv_heads=4),
            dataclasses.replace(granite, num_layers=TRAIN_LAYERS))


def t_tokens(cfg, rounds, batch, seq, seed):
    """`rounds` batches of `batch` x `seq` tokens (numpy)."""
    from repro_torch.data.lm import MarkovTokenStream

    data, rng = MarkovTokenStream(cfg.vocab_size, seed=0), \
        np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        toks = data.sample(rng, batch, seq + 1)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def t_rank(rank: int, store: str, workdir: str) -> int:
    """One rank of (t0)-(t2): `python3 chip_smoke.py --t-rank RANK STORE
    DIR`. Saves its results to DIR/rank{RANK}.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    from repro_torch import dist as rdist
    from repro_torch.core.packing import tree_leaves, tree_map
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.models import transformer
    from repro_torch.models.common import mesh_rules
    from repro_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=T_WORLD,
                            timeout=datetime.timedelta(seconds=180))
    meshes = {shape: make_host_mesh(model=shape[1])
              for shape in sorted(set(T_MESHES.values()))}
    cfg0, cfg1, cfg2 = t_cfgs()
    res = {"seconds": {}}
    to_dev = lambda tree: tree_map(lambda t: t.to(dev), tree)

    def on_card(st):
        return trainer.TrainState(to_dev(st.params), st.opt._replace(
            m=to_dev(st.opt.m), v=to_dev(st.opt.v),
            master=to_dev(st.opt.master)))

    def batch_of(b, mesh, mode):
        """This rank's part of a [B, S] batch (the node axis split for
        the gossip mode), on the card."""
        b = {k: torch.from_numpy(v)[None] for k, v in b.items()}
        if mode != "exact":
            b = trainer.make_node_batch(b, TRAIN_N, axis=1)
        b = shard_batch(b, mesh, TRAIN_N, node_axis=mode != "exact")
        return {k: v[0].to(dev) for k, v in b.items()}

    # (t0) the tensor-parallel layers over a model axis of 2: the loss,
    # the logits (gathered over the vocab) and every gradient (gathered)
    t_phase = time.perf_counter()
    mesh = meshes[(2, 2)]
    spec = trainer.rest_specs(cfg0, mesh, exact=False)
    whole = registry.init_params(torch.Generator().manual_seed(0), cfg0,
                                 torch.float32)
    local = to_dev(shlib.shard_tree(whole, spec, mesh))
    del whole
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in t_tokens(cfg0, 1, 2, 64, 5)[0].items()}
    live = [p.detach().requires_grad_() for p in tree_leaves(local)]
    it = iter(live)
    params = tree_map(lambda _: next(it), local)
    rdist.reset_stats()
    with mesh_rules(mesh):
        loss, _ = registry.loss_fn(params, cfg0, batch, remat=True)
        grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            logits = transformer.forward(params, cfg0, batch, train=True)[0]
    it = iter(grads)
    grads = shlib.gather_tree(tree_map(lambda _: next(it), local), spec,
                              mesh)
    res["t0"] = {"loss": float(loss.detach()),
                 "logits": rdist.all_gather_dim(logits.contiguous(), mesh,
                                                2, "model").cpu(),
                 "grads": [g.cpu() for g in tree_leaves(grads)],
                 "model_messages": rdist.stats["model_messages"]}
    del params, live, grads, logits, local
    dist.barrier()
    res["seconds"]["t0"] = time.perf_counter() - t_phase

    # (t1) the reduced granite trainer in f32, 3 rounds a mode
    t_phase = time.perf_counter()
    res["t1"] = {}
    for mode, shape in T_MESHES.items():
        mesh = meshes[shape]
        run = s2_run(cfg1, mode, "float32")
        st = on_card(trainer.init_state(run, torch.Generator().manual_seed(0),
                                        mesh))
        if mode != "exact":
            st = trainer.replicate_for_nodes(st, rdist.n_local(mesh, TRAIN_N))
        step = trainer.build_train_step(run, mesh, n_nodes=TRAIN_N,
                                        device=dev)
        ops.reset_launches()
        losses, cerrs = [], []
        for b in s2a_batches(cfg1):
            st, m = step(st, batch_of(b, mesh, mode))
            losses.append(float(m["loss"]))
            cerrs.append(float(m["consensus_err"]))
        launches = dict(ops.launches)
        params = shlib.gather_tree(st.params, trainer.rest_specs(
            cfg1, mesh, mode == "exact", node_axis=mode != "exact"), mesh)
        res["t1"][mode] = {
            "losses": losses, "consensus_errs": cerrs,
            "rows": (rdist.node_rows(mesh, TRAIN_N).start,
                     rdist.node_rows(mesh, TRAIN_N).stop),
            "params": [p.cpu() for p in tree_leaves(params)],
            "launches": launches}
        del st, step, params
    dist.barrier()
    res["seconds"]["t1"] = time.perf_counter() - t_phase

    # (t2) granite-8b at its published widths, TRAIN_LAYERS layers, bf16
    # with f32 masters, 2 x TRAIN_S tokens a node, T2_ROUNDS rounds a mode
    t_phase = time.perf_counter()
    res["t2"] = {}
    for mode, shape in T_MESHES.items():
        mesh = meshes[shape]
        run = s2_run(cfg2, mode, "bfloat16")
        torch.cuda.empty_cache()
        st = trainer.init_state(run, torch.Generator(device=dev)
                                .manual_seed(0), mesh)
        if mode != "exact":
            st = trainer.replicate_for_nodes(st, rdist.n_local(mesh, TRAIN_N))
        opt = st.opt
        at_rest = sum(t.numel() * t.element_size()
                      for tree in (st.params, opt.m, opt.v, opt.master)
                      for t in tree_leaves(tree))
        step = trainer.build_train_step(run, mesh, n_nodes=TRAIN_N,
                                        device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        rounds = []
        for b in t_tokens(cfg2, T2_ROUNDS, TRAIN_B, TRAIN_S, 2):
            b = batch_of(b, mesh, mode)
            rdist.reset_stats()
            t0 = time.perf_counter()
            st, m = step(st, b)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            rounds.append({"s": time.perf_counter() - t0, "loss": loss,
                           "stats": dict(rdist.stats)})
        res["t2"][mode] = {"rounds": rounds, "at_rest": at_rest,
                           "peak_bytes": torch.cuda.max_memory_allocated(),
                           "launches": dict(ops.launches)}
        del st, step, opt
    dist.barrier()
    res["seconds"]["t2"] = time.perf_counter() - t_phase
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def model_axis_phases(dev) -> dict:
    """(t0)-(t2) on the card: the single-process references and the
    plans first, then T_WORLD rank processes (`t_rank`), joined under a
    deadline; prints each check and returns the ranks' gossip_mix
    launches by phase, for the kernels line."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.packing import tree_leaves, tree_map
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import registry, transformer
    from repro_torch.train import trainer

    t_all = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, ".smoke_ckpt", "model_axis")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg0, cfg1, cfg2 = t_cfgs()
    to_dev = lambda tree: tree_map(lambda t: t.to(dev), tree)
    # (t0)'s whole model on one process
    params = to_dev(registry.init_params(torch.Generator().manual_seed(0),
                                         cfg0, torch.float32))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in t_tokens(cfg0, 1, 2, 64, 5)[0].items()}
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    loss, _ = registry.loss_fn(tree, cfg0, batch, remat=True)
    ref0 = {"loss": float(loss.detach()),
            "grads": [g.cpu() for g in torch.autograd.grad(loss, live)]}
    with torch.no_grad():
        ref0["logits"] = transformer.forward(tree, cfg0, batch,
                                             train=True)[0].cpu()
    del params, live, tree, loss
    # (t1)'s single-process card run at n_nodes = 4
    ref1 = {}
    for mode in T_MESHES:
        run = s2_run(cfg1, mode, "float32")
        st = trainer.init_state(run, torch.Generator().manual_seed(0))
        if mode != "exact":
            st = trainer.replicate_for_nodes(st, TRAIN_N)
        st = trainer.TrainState(to_dev(st.params), st.opt._replace(
            m=to_dev(st.opt.m), v=to_dev(st.opt.v),
            master=to_dev(st.opt.master)))
        step = trainer.build_train_step(run, None, n_nodes=TRAIN_N,
                                        device=dev)
        losses = []
        for b in s2a_batches(cfg1):
            if mode != "exact":
                b = trainer.make_node_batch(b, TRAIN_N)
            st, m = step(st, {k: torch.from_numpy(v).to(dev)
                              for k, v in b.items()})
            losses.append(float(m["loss"]))
        ref1[mode] = (losses, [t.cpu() for t in tree_leaves(st.params)])
        del st, step
    # (t2)'s first-round loss on one process from the same draws: the
    # mean of each node's loss (gossip), the batch's loss (exact)
    params = registry.init_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg2, torch.bfloat16)
    first = t_tokens(cfg2, 1, TRAIN_B, TRAIN_S, 2)[0]
    ref2 = {}
    with torch.no_grad():
        b = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
        ref2["exact"] = float(registry.loss_fn(params, cfg2, b)[0])
        nodes = trainer.make_node_batch(b, TRAIN_N)
        ref2["gossip"] = float(torch.stack([registry.loss_fn(
            params, cfg2, {k: v[j] for k, v in nodes.items()})[0]
            for j in range(TRAIN_N)]).mean())
    del params, b, nodes
    torch.cuda.empty_cache()
    # (t2)'s plans: bytes at rest, peak, messages by axis (meta traces)
    plans = {}
    for mode, shape in T_MESHES.items():
        amesh = abstract_mesh(shape, ("data", "model"))
        kw = dict(cfg=cfg2, shape=ShapeConfig("(t2)", TRAIN_S, TRAIN_B,
                                              "train"),
                  n_nodes=TRAIN_N, microbatches=1)
        low = dryrun.build_lowerable("granite-8b", "train_4k", amesh, mode,
                                     TRAIN_R, **kw)
        rec = dryrun.plan("granite-8b", "train_4k", amesh, averaging=mode,
                          rounds=TRAIN_R, master_weights=True, **kw)
        count = lambda coll: sum(v for k, v in coll.items()
                                 if k.endswith(".count"))
        model = rec["collectives_model"]
        plans[mode] = {
            "at_rest": shlib.local_bytes(low.planned[0], low.specs[0], amesh),
            "peak": rec["memory"]["peak_gib"] * 2 ** 30,
            "model_messages": count(model),
            "model_bytes": dryrun.staged_bytes(model),
            "data_messages": count(rec["collectives"]) - count(model),
            "data_bytes": rec["staged_bytes"] - dryrun.staged_bytes(model),
            "unsplit": rec["temp_unsplit_over_model"]}
        del low
    t_ref = time.perf_counter() - t_all
    # the ranks
    store = os.path.join(work, "store")
    procs = []
    for r in range(T_WORLD):
        log = open(os.path.join(work, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--t-rank", str(r),
             store, work], stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + T_TIMEOUT
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
        print(f"(t) rank {r} exited {procs[r][0].returncode}:\n{tail}")
    require(not failed, f"(t): ranks {failed} failed or overran "
                        f"{T_TIMEOUT} s")
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(T_WORLD)]
    t_ranks = time.perf_counter() - t_all - t_ref

    def within_leaf(got, want, tol):
        """max |got - want| over tol x the leaf's largest |want|, leaf by
        leaf (the worst)."""
        return max(((a - b).abs().max() / (tol * b.abs().max())).item()
                   for a, b in zip(got, want, strict=True))

    # (t0)
    for r, rr in enumerate(res):
        got = rr["t0"]
        loss_err = abs(got["loss"] - ref0["loss"]) / abs(ref0["loss"])
        share = within_leaf(got["grads"] + [got["logits"]],
                            ref0["grads"] + [ref0["logits"]], T0_TOL)
        print(f"main (t0) reduced granite-8b d_model 512 f32, the "
              f"tensor-parallel layers over a model axis of 2 (rank {r}): "
              f"loss {got['loss']:.7f} (one process {ref0['loss']:.7f}, rel "
              f"err {loss_err:.2e}); logits and {len(got['grads'])} "
              f"gradients, worst share of {T0_TOL} x the leaf's largest "
              f"entry {share:.3f}; model-axis messages "
              f"{got['model_messages']}")
        require(loss_err <= T0_TOL and share <= 1.0,
                f"(t0) rank {r}: the tensor-parallel layers disagree with "
                f"the whole model")

    # (t1)
    for mode, (want_l, want_p) in ref1.items():
        runs = [rr["t1"][mode] for rr in res]
        loss_err = max(abs(a - b) / abs(b) for r in runs
                       for a, b in zip(r["losses"], want_l))
        by_rows = {}
        for r in runs:
            by_rows.setdefault(r["rows"], r["params"])
        parts = [by_rows[k] for k in sorted(by_rows)]
        got = [torch.cat(p) for p in zip(*parts)] if mode != "exact" \
            else parts[0]
        d = torch.cat([(a - b).abs().ravel() for a, b in zip(got, want_p)])
        within = float((d <= 1e-4).float().mean())
        cerr = runs[0]["consensus_errs"]
        launches = [r["launches"]["gossip_mix"] for r in runs]
        print(f"main (t1) reduced granite-8b d_model 512 (4 KV heads) f32, "
              f"adam, {TRAIN_N} nodes, ring R={TRAIN_R}, {mode} on "
              f"{'x'.join(map(str, T_MESHES[mode]))}: losses "
              f"{json.dumps(runs[0]['losses'])} (one process "
              f"{json.dumps(want_l)}, max rel err {loss_err:.2e}, limit "
              f"1e-4); parameters within 1e-4: {within:.6f} (limit >= "
              f"0.999), max_abs_err {d.max().item():.3e}; consensus_err "
              f"{json.dumps(cerr)}; gossip_mix launches by rank {launches}")
        require(loss_err <= 1e-4, f"(t1) {mode}: losses disagree")
        require(within >= 0.999, f"(t1) {mode}: parameters disagree")
        if mode == "exact":
            require(all(c == 0 for c in cerr), f"(t1) exact: consensus "
                                               f"error {cerr}")
        else:
            require(all(n > 0 for n in launches),
                    f"(t1) gossip: gossip_mix launches by rank {launches}")

    # (t2)
    for mode, plan in plans.items():
        runs = [rr["t2"][mode] for rr in res]
        first = [r["rounds"][0]["loss"] for r in runs]
        loss_err = max(abs(x - ref2[mode]) / abs(ref2[mode]) for x in first)
        per = lambda key: [[rd["stats"][key] for rd in r["rounds"]]
                           for r in runs]
        peaks = [r["peak_bytes"] for r in runs]
        peak_ratio = [plan["peak"] / p for p in peaks]
        print(f"main (t2) granite-8b full width, {TRAIN_LAYERS} layers, bf16 "
              f"+ f32 masters, adam, {TRAIN_N} nodes x 2 x {TRAIN_S} tokens, "
              f"ring R={TRAIN_R}, {mode} on "
              f"{'x'.join(map(str, T_MESHES[mode]))}: losses by rank "
              f"{[[round(rd['loss'], 5) for rd in r['rounds']] for r in runs]}"
              f" (round 1 on one process {ref2[mode]:.5f}, max rel err "
              f"{loss_err:.2e}, limit {T2_LOSS_TOL}); s per round by rank "
              f"{[[round(rd['s'], 3) for rd in r['rounds']] for r in runs]}; "
              f"bytes staged per round, model axis {per('model_staged_bytes')}"
              f" (planned {int(plan['model_bytes'])}), data axis "
              f"{per('data_staged_bytes')} (planned "
              f"{int(plan['data_bytes'])}); messages per round, model axis "
              f"{per('model_messages')} (planned {plan['model_messages']}), "
              f"data axis {per('data_messages')} (planned "
              f"{plan['data_messages']}); bytes at rest by rank "
              f"{[r['at_rest'] for r in runs]} (planned {plan['at_rest']}); "
              f"peak memory by rank GB {[round(p / 1e9, 3) for p in peaks]}, "
              f"plan over measured {[round(x, 4) for x in peak_ratio]}; "
              f"launches by rank "
              f"{[json.dumps(r['launches']) for r in runs]}")
        require(all(math.isfinite(rd["loss"]) for r in runs
                    for rd in r["rounds"]), f"(t2) {mode}: losses not finite")
        require(loss_err <= T2_LOSS_TOL, f"(t2) {mode}: round 1's loss "
                                         f"disagrees with one process's")
        require(not plan["unsplit"], f"(t2) {mode}: the plan kept the model "
                                     f"axis unsplit")
        require(all(r["at_rest"] == plan["at_rest"] for r in runs),
                f"(t2) {mode}: bytes at rest differ from the plan's")
        require(all(abs(x - 1) <= P1_BOUND for x in peak_ratio),
                f"(t2) {mode}: a rank's peak is not within {P1_BOUND} of "
                f"the plan's")
        for key, want in (("model_messages", plan["model_messages"]),
                          ("model_staged_bytes", plan["model_bytes"]),
                          ("data_messages", plan["data_messages"]),
                          ("data_staged_bytes", plan["data_bytes"])):
            require(all(x == want for xs in per(key) for x in xs),
                    f"(t2) {mode}: {key} {per(key)} differ from the "
                    f"plan's {want}")
        if mode != "exact":
            require(all(r["launches"]["gossip_mix"] > 0 for r in runs),
                    f"(t2) {mode}: gossip_mix did not launch on every rank")
    seconds = res[0]["seconds"]
    print(f"main (t) seconds: references and plans {t_ref:.1f}, ranks "
          f"{t_ranks:.1f} (rank 0: " + ", ".join(
              f"{k} {v:.1f}" for k, v in seconds.items()) +
          f"), all {time.perf_counter() - t_all:.1f}")
    shutil.rmtree(work, ignore_errors=True)
    return {"gossip_mix": {
        phase: [sum(rr[phase][m]["launches"]["gossip_mix"] for m in T_MESHES)
                for rr in res] for phase in ("t1", "t2")}}


# (v0)-(v4) elastic membership and the scenario harness on the sharded node
# axis: V_WORLD rank processes share the card in one gloo group
# (`elastic_shard_phases`, spawned after (t)'s ranks have exited); a
# subgroup of 2 ranks carries the 2-rank phases, and (v1)'s runs go to
# ranks {0, 1} and {2, 3} at once. A cohort's active rows
# split over the ranks as contiguous, uneven runs (`dist.cohort_rows`; a
# rank may hold none)
V_WORLD, V_TIMEOUT = 4, 600
# (v0): (ranks, nodes dropped) at HIGHD's mix (n = 10, d = 3072, ring,
# R = 8); on 2 ranks dropping 5..9 puts every cohort row on rank 0 (the
# ring over them wraps onto its own rows: the op gathers)
V0_COHORTS = [(2, (0,)), (2, (3, 4)), (2, (5, 6, 7, 8, 9)),
              (4, (0,)), (4, (3, 4)), (4, (6, 7))]
V0_KINDS = ("exact", "sign", "int8")
V0_SCN, V0_T = "ring/lossy/iid_pca", 3  # (v0)'s scheduled op and round
# (v1): (label, wire, fault spec, governor) on (s1)'s clock and stream;
# V1_PAIRS: the runs of ranks {0, 1} (which then run (v2)) and of {2, 3}
V1_PAIRS = (("exact",), ("int8 tile", "straggler drop"))
V1_RUNS = [("exact", "exact", "death:3@2-6,flaky:7@3-9p2", {}),
           ("int8 tile", "int8", "death:3@2-6,flaky:7@3-9p2", {}),
           ("straggler drop", "exact", "slow:2@2-6x4",
            dict(straggler_policy="drop", straggler_slow_factor=2.0,
                 straggler_patience=2))]
# (v2): scenario -> supersteps of V2_K rounds, and whether sin^2 < 0.05 is
# held: the drifting stream's top direction moves away from the fixed
# eigenvector the metric reads (its single-process sin^2 rises from 0.12 at
# 32 rounds to 0.61 at 128), so only its agreement is held
V2_SCENARIOS = {"tv_rte/ratelimited/drift_pca": (8, False),
                "geometric/lossy/skew_logreg": (32, True)}
V2_K = 4
V3_SPEC, V3_SUPERSTEPS = "death:1@1-2", 3
# (v4): node 1 out at superstep V4_LEAVE, back at V4_REJOIN, V4_K rounds a
# superstep: the fewest full-width rounds its checks need (one at full
# membership, one in the cohort, one rejoining; each costs ~10 s of staged
# halo bytes), so that (v) stays under 120 s
V4_LEAVE, V4_REJOIN, V4_K = 1, 2, 1
V4_SPEC, V4_SUPERSTEPS = f"death:1@{V4_LEAVE}-{V4_REJOIN}", V4_REJOIN + 1


def v_wires():
    """(v1)'s wires: exact gossip and (i)'s int8 tile wire."""
    from repro_torch.configs.base import AveragingConfig

    return {"exact": AveragingConfig(mode="gossip", rounds=HIGHD_R,
                                     topology="ring"),
            "int8": AveragingConfig(mode="gossip", rounds=HIGHD_R,
                                    topology="ring", quantization="int8",
                                    quant_stats="tile", quant_block_d=512)}


def v_pca_run(dev, mesh, stream, w0, label, wire, spec, gov):
    """(v1)'s run `label` on `mesh` (None: the single-process reference,
    its exact wire forced to impl="roll"): (decisions, events, the
    iterate, the history, the driver, seconds)."""
    import torch

    from repro_torch.configs.base import GovernorConfig
    from repro_torch.configs.paper_pca import HIGHD, PCARunConfig
    from repro_torch.core import averaging, krasulina, problems
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.data.synthetic import make_pca_host_sampler
    from repro_torch.train.driver import EngineConfig, StreamingDriver

    avg = v_wires()[wire]
    sin2 = lambda w: problems.sin2_error(w, stream.top_eigvec)
    mix = None
    if mesh is None and wire == "exact":
        mix = averaging.make_gossip_mix(avg, HIGHD_N, impl="roll",
                                        device=dev)
    build = krasulina.krasulina_superstep_builder(
        avg, HIGHD_N, lambda t: 5.0 / t, metric=sin2, mix=mix,
        fuse_xi=False if mesh is None else None, device=dev, mesh=mesh)
    t0 = time.perf_counter()
    with StreamingDriver(
            PCARunConfig(pca=HIGHD, averaging=avg, stream=s1_stream()),
            mesh, krasulina.init_krasulina_state(w0, avg, HIGHD_N,
                                                 device=dev, mesh=mesh),
            make_pca_host_sampler(stream), superstep_builder=build,
            n_nodes=HIGHD_N, batch=HIGHD_B, clock=_SClock(S1_DT), device=dev,
            faults=FaultSchedule.parse(spec, HIGHD_N),
            engine=EngineConfig(superstep=HIGHD_K, prefetch_depth=0,
                                governor=GovernorConfig(**gov))) as drv:
        state, hist = drv.run(S1_SUPERSTEPS)
    torch.cuda.synchronize()
    events = [(e["superstep"], e["to"].active_ids, e["plan"].B)
              for e in drv.membership_events]
    return (_s_decisions(hist), events, state.w.cpu(), hist,
            drv.compiled_signatures, time.perf_counter() - t0)


def v_scenario_run(dev, mesh, fig7, w7, name):
    """(v2)'s scenario `name` (N = 8, ring R = 2 as registered) on `mesh`
    (None: the single-process reference), (j)'s settings: (history, the
    iterate, seconds)."""
    import torch

    from repro_torch.configs.base import StreamConfig
    from repro_torch.configs.paper_pca import FIG7, PCARunConfig
    from repro_torch.core import krasulina, problems, scenarios
    from repro_torch.data.synthetic import make_pca_host_sampler
    from repro_torch.train.driver import EngineConfig, StreamingDriver

    scn = scenarios.get_scenario(name)
    avg = scenarios.averaging_config(scn)
    sample = (scenarios.build_stream(scn, pca=fig7).sample
              if scn.stream in ("iid_pca", "drift_pca")
              else make_pca_host_sampler(fig7))
    metric = lambda w: problems.sin2_error(w, fig7.top_eigvec)
    build = krasulina.krasulina_superstep_builder(
        avg, scn.n_nodes, lambda t: 10.0 / t, metric=metric,
        mix=scenarios.build_mix(scn, device=dev, mesh=mesh), device=dev,
        mesh=mesh)
    supersteps = V2_SCENARIOS[name][0]
    t0 = time.perf_counter()
    with StreamingDriver(
            PCARunConfig(pca=FIG7, averaging=avg, stream=StreamConfig()),
            mesh, krasulina.init_krasulina_state(w7, avg, scn.n_nodes,
                                                 device=dev, mesh=mesh),
            sample, superstep_builder=build, n_nodes=scn.n_nodes,
            batch=10 * scn.n_nodes, faults=scenarios.fault_schedule(scn),
            device=dev, engine=EngineConfig(superstep=V2_K, prefetch_depth=0,
                                            replan_every=0)) as drv:
        state, hist = drv.run(supersteps)
    torch.cuda.synchronize()
    return hist, state.w.cpu(), time.perf_counter() - t0


def v3_run(dev, mesh, sync: bool, state):
    """(v3)'s reduced granite-8b (f32, Adam) under V3_SPEC through the
    driver (K = 1, no prefetch, open loop), 8 x 64 tokens a round, from
    `state` (this rank's node on `mesh`; every node without one, where the
    exact wire is forced to impl="roll"): (history, events, state)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import GovernorConfig
    from repro_torch.core import averaging
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.data.lm import MarkovTokenStream
    from repro_torch.train import trainer
    from repro_torch.train.driver import EngineConfig, StreamingDriver

    cfg = reduced(get_config("granite-8b"))
    run = s2_run(cfg, "gossip", "float32")
    data = MarkovTokenStream(cfg.vocab_size, seed=0)

    def sample(rng, n):
        toks = data.sample(rng, n, 65)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    builder = None
    if mesh is None:
        builder = trainer.superstep_builder(
            run, None, n_nodes=TRAIN_N, device=dev,
            mix=averaging.make_gossip_mix(run.averaging, TRAIN_N,
                                          impl="roll", device=dev))
    with StreamingDriver(run, mesh, state, sample, batch=8, n_nodes=TRAIN_N,
                         superstep_builder=builder, device=dev,
                         faults=FaultSchedule.parse(V3_SPEC, TRAIN_N),
                         engine=EngineConfig(superstep=1, prefetch_depth=0,
                                             replan_every=0,
                                             governor=GovernorConfig(
                                                 sync_on_rejoin=sync))
                         ) as drv:
        state, hist = drv.run(V3_SUPERSTEPS)
    events = [(e["superstep"], e["to"].active_ids)
              for e in drv.membership_events]
    return hist, events, state


def v3_state(dev, n_rows: int):
    """(s2a)'s reduced granite state (f32, Adam, seed 0) at n_rows nodes on
    the card."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.packing import tree_map
    from repro_torch.train import trainer

    run = s2_run(reduced(get_config("granite-8b")), "gossip", "float32")
    st = trainer.replicate_for_nodes(trainer.init_state(
        run, torch.Generator().manual_seed(0)), n_rows)
    to = lambda tree: tree_map(lambda t: t.to(dev), tree)
    return trainer.TrainState(to(st.params), st.opt._replace(
        m=to(st.opt.m), v=to(st.opt.v), master=to(st.opt.master)))


def v_rank(rank: int, store: str, workdir: str) -> int:
    """One rank of (v0)-(v4): `python3 chip_smoke.py --v-rank RANK STORE
    DIR`. Saves its results to DIR/rank{RANK}.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    from repro_torch import convert, dist as rdist
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_pca import FIG7, HIGHD
    from repro_torch.core import mixing, scenarios
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.core.mixing import Membership
    from repro_torch.core.packing import tree_leaves, tree_map
    from repro_torch.data.lm import MarkovTokenStream
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.models.common import MetaGenerator
    from repro_torch.train import trainer
    from repro_torch.train.driver import EngineConfig, StreamingDriver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=V_WORLD,
                            timeout=datetime.timedelta(seconds=180))
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups = {2: pairs[0], V_WORLD: None}
    meshes = {E: make_host_mesh(group=g) for E, g in groups.items()
              if rank < E}
    # (v1)'s runs are dealt over the two pairs of ranks (V1_PAIRS), which
    # run at once
    pair = rank // 2
    pair_mesh = make_host_mesh(group=pairs[pair])
    res = {"seconds": {}}
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)

    def launches():
        out = dict(ops.launches)
        ops.reset_launches()
        return out

    # (v0) the cohort shard rules on this rank's active rows, each against
    # the plain per-round path over the m cohort rows on the card
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    v0 = []
    for idx, (E, dropped) in enumerate(V0_COHORTS):
        if E not in meshes:
            continue
        mesh = meshes[E]
        mem = Membership.full(HIGHD_N).drop(*dropped)
        m = mem.n_active
        table = rdist.cohort_rows(mesh, mem)
        a, b = table[rdist.node_index(mesh)]
        sched = mixing.schedule("ring", m)
        gen.manual_seed(300 + idx)
        x = torch.randn((m, 3072), generator=gen, device=dev)
        mine = x[a:b].contiguous()
        for kind in V0_KINDS:
            quant = "none" if kind == "exact" else kind
            op = mixing.circulant_mix_op(
                sched, m, HIGHD_R, quantization=quant, stats="node",
                block_d=512, mesh=mesh, rows=table, device=dev)
            want = (ref.gossip_mix_ref(x, sched, HIGHD_R) if quant == "none"
                    else ref.gossip_mix_quant_ref(
                        x, sched, HIGHD_R, quant, block_d=512,
                        per_node=True))[a:b]
            ops.reset_launches()
            rdist.reset_stats()
            got = op(mine)
            torch.cuda.synchronize()
            v0.append({"ranks": E, "dropped": dropped, "kind": kind,
                       "impl": op.impl, "table": table, "rows": (a, b),
                       "equal": bool(torch.equal(got, want)),
                       "max_abs_err": (got - want).abs().max().item()
                       if b > a else 0.0,
                       "max_plain": want.abs().max().item() if b > a
                       else 0.0,
                       "staged": rdist.stats["staged_bytes"],
                       "launches": launches()})
    # the scheduled op of V0_SCN (n = 8) on 2 and 4 ranks, one round's
    # table, against the one-process product on the card
    scn = scenarios.get_scenario(V0_SCN)
    gen.manual_seed(399)
    xs = torch.randn((scn.n_nodes, 3072), generator=gen, device=dev)
    whole = scenarios.build_mix(scn, device=dev)(xs, t=V0_T)
    for E, mesh in meshes.items():
        rows = rdist.node_rows(mesh, scn.n_nodes)
        got = scenarios.build_mix(scn, device=dev, mesh=mesh)(
            xs[rows].contiguous(), t=V0_T)
        v0.append({"ranks": E, "dropped": (), "kind": "scheduled",
                   "impl": "gather", "rows": (rows.start, rows.stop),
                   "max_abs_err": (got - whole[rows]).abs().max().item(),
                   "max_plain": whole.abs().max().item(),
                   "launches": launches()})
    res["v0"] = v0
    dist.barrier()
    res["seconds"]["v0"] = time.perf_counter() - t_phase

    # (v1) the governed PCA driver at HIGHD on 2 ranks under faults
    t_phase = time.perf_counter()
    stream = convert.pca_stream(inp["cov"], inp["sqrt_cov"], inp["top"],
                                HIGHD.lambda1, HIGHD.eigengap, device=dev)
    res["v1"] = {}
    for label, wire, spec, gov in V1_RUNS:
        if label not in V1_PAIRS[pair]:
            continue
        ops.reset_launches()
        rdist.reset_stats()
        dec, events, w, hist, sigs, secs = v_pca_run(
            dev, pair_mesh, stream, inp["w0"], label, wire, spec, gov)
        rows = rdist.node_rows(pair_mesh, HIGHD_N)
        res["v1"][label] = {
            "decisions": dec, "events": events, "w": w,
            "rows": (rows.start, rows.stop), "signatures": sigs,
            "sin2": hist[-1]["metrics"]["metric"],
            "finite": bool(torch.isfinite(w).all()),
            "rounds": len(hist) * HIGHD_K, "seconds": secs,
            "staged_per_round": rdist.stats["staged_bytes"]
            / (len(hist) * HIGHD_K),
            "launches": launches()}
    del stream
    res["seconds"]["v1"] = time.perf_counter() - t_phase

    # (v2) two registered scenarios on the PCA driver, 2 ranks, N = 8,
    # on ranks {0, 1} while {2, 3} finish (v1)
    t_phase = time.perf_counter()
    fig7 = convert.pca_stream(inp["fig7_cov"], inp["fig7_sqrt_cov"],
                              inp["fig7_top"], FIG7.lambda1, FIG7.eigengap,
                              device=dev)
    if 2 in meshes:
        mesh = meshes[2]
        res["v2"] = {}
        for name in V2_SCENARIOS:
            ops.reset_launches()
            rdist.reset_stats()
            hist, w, secs = v_scenario_run(dev, mesh, fig7,
                                           inp["w7"].to(dev), name)
            rows = rdist.node_rows(mesh, 8)
            res["v2"][name] = {
                "w": w, "rows": (rows.start, rows.stop), "seconds": secs,
                "sin2": hist[-1]["metrics"]["metric"],
                "consensus_err": [r["metrics"]["consensus_err"]
                                  for r in hist],
                "drops": [r.get("link_drops") for r in hist],
                "bw": [r.get("bw_factor") for r in hist],
                "staged_per_round": rdist.stats["staged_bytes"]
                / (len(hist) * V2_K),
                "launches": launches()}
    del fig7
    dist.barrier()
    res["seconds"]["v2"] = time.perf_counter() - t_phase

    # (v3) the reduced granite trainer, 4 ranks x 1 node, under V3_SPEC
    t_phase = time.perf_counter()
    mesh = meshes[V_WORLD]
    res["v3"] = {}
    for sync in (True, False):
        ops.reset_launches()
        hist, events, st = v3_run(dev, mesh, sync, v3_state(dev, 1))
        res["v3"][sync] = {
            "losses": [r["metrics"]["loss"] for r in hist],
            "n_active": [r["n_active"] for r in hist], "events": events,
            "steps": st.opt.step,
            "params": [p.cpu() for p in tree_leaves(st.params)],
            "launches": launches()}
        del st
    dist.barrier()
    res["seconds"]["v3"] = time.perf_counter() - t_phase

    # (v4) granite-8b at its published widths, 2 layers, (s2b)'s node on
    # each of 4 ranks, under V4_SPEC with rejoin sync
    t_phase = time.perf_counter()
    cfg_h = dataclasses.replace(get_config("granite-8b"),
                                num_layers=TRAIN_LAYERS)
    run = s2_run(cfg_h, "gossip", "bfloat16")
    data = MarkovTokenStream(cfg_h.vocab_size, seed=0)

    def sample(rng, n):
        toks = data.sample(rng, n, TRAIN_S + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st = trainer.init_state(run, torch.Generator(device=dev).manual_seed(0))
    one = lambda tree: tree_map(lambda t: t.unsqueeze(0), tree)
    st = trainer.TrainState(one(st.params), st.opt._replace(
        step=(st.opt.step,), m=one(st.opt.m), v=one(st.opt.v),
        master=one(st.opt.master), ef_residual=one(st.opt.ef_residual)))
    # 4096 entries a leaf, spread over it: the rows held against the
    # donors' mean after the rejoin
    # (integer steps: an f32 linspace rounds a 201 M-entry leaf's last
    # index past its end)
    picks = [torch.arange(4096, device=dev) * (p[0].numel() - 1) // 4095
             for p in tree_leaves(st.params)]
    sampled = lambda state: torch.cat([
        p[0].reshape(-1)[i].double().cpu()
        for p, i in zip(tree_leaves(state.params), picks)])
    v4 = {"per_superstep": [], "frozen_equal": None, "sync": None}
    frozen = {}

    class Driver(StreamingDriver):
        def _sync_rejoined(self, prev, new):
            donors = [i for i in prev.active_ids if new.active[i]]
            mine = sampled(self.state) if rank in donors else None
            total = (mine if mine is not None else torch.zeros(
                sum(len(i) for i in picks), dtype=torch.float64))
            dist.all_reduce(total, group=mesh.group)
            super()._sync_rejoined(prev, new)
            if rank == 1:  # node 1 rejoins: within one bf16 step of the mean
                mean = total / len(donors)
                got = sampled(self.state)
                step = (mean.abs().float().to(torch.bfloat16).float()
                        .clamp_min(2.0 ** -126) * 2.0 ** -7).double()
                v4["sync"] = {"max_steps": float(((got - mean).abs()
                                                  / step).max()),
                              "donors": donors}

    def log_fn(rec):
        k = rec["superstep"]
        # node 1's rows as it leaves, kept on the card (two 2.5 GB host
        # copies would hold every rank up at the next exchange)
        if rank == 1 and k == V4_LEAVE - 1:
            frozen["rows"] = [p.clone()
                              for p in tree_leaves(drv.state.params)]
        if rank == 1 and k == V4_REJOIN - 1:  # the last superstep it is out
            v4["frozen_equal"] = all(
                torch.equal(a, p) for a, p in
                zip(frozen.pop("rows"), tree_leaves(drv.state.params)))
        v4["per_superstep"].append({
            "superstep": k, "n_active": rec["n_active"],
            "loss": rec["metrics"]["loss"], "wall_s": rec["wall_s"],
            "staged": rdist.stats["staged_bytes"],
            "wire": rdist.stats["wire_bytes"],
            "log": {f"{ax} {kind}": list(v)
                    for (ax, kind), v in rdist.log.items()}})
        rdist.reset_stats()

    ops.reset_launches()
    rdist.reset_stats()
    t0 = time.perf_counter()
    with Driver(run, mesh, st, sample, batch=2 * TRAIN_N, n_nodes=TRAIN_N,
                device=dev, faults=FaultSchedule.parse(V4_SPEC, TRAIN_N),
                engine=EngineConfig(superstep=V4_K, prefetch_depth=0,
                                    replan_every=0)) as drv:
        st, hist = drv.run(V4_SUPERSTEPS, log_fn=log_fn)
    torch.cuda.synchronize()
    v4["wall_s"] = time.perf_counter() - t0
    v4["events"] = [(e["superstep"], e["to"].active_ids, e["plan"].B)
                    for e in drv.membership_events]
    v4["peak_bytes"] = torch.cuda.max_memory_allocated()
    v4["launches"] = launches()
    # the planner's wire of one round at full membership and in the
    # cohort, for this rank
    meta = tree_map(lambda t: t[None], registry.init_params(
        MetaGenerator(), cfg_h, torch.bfloat16))
    plans = {label: dryrun.node_axis_collectives(run, meta, mesh, TRAIN_N,
                                                  membership=mem)
             for label, mem in (("full", None), ("cohort", Membership.full(
                 TRAIN_N).drop(1)))}
    v4["planned"] = {label: dryrun.staged_bytes(coll)
                     for label, coll in plans.items()}
    v4["planned_messages"] = {
        label: sum(v for k, v in coll.items() if k.endswith(".count"))
        for label, coll in plans.items()}
    res["v4"] = v4
    del st, drv
    dist.barrier()
    res["seconds"]["v4"] = time.perf_counter() - t_phase
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def elastic_shard_phases(dev) -> dict:
    """(v0)-(v4) on the card: the single-process references first, then
    V_WORLD rank processes (`v_rank`), joined under a deadline; prints each
    check and (v)'s seconds, and returns the ranks' launches by phase and
    rank, for the kernels line."""
    import torch

    from repro_torch.configs.paper_pca import FIG7, HIGHD
    from repro_torch.core.packing import tree_leaves
    from repro_torch.data.synthetic import make_pca_stream

    t_all = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, ".smoke_ckpt", "elastic_shard")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    stream = make_pca_stream(HIGHD, device=dev)
    fig7 = make_pca_stream(FIG7, device=dev)
    rng = np.random.default_rng(7)
    w0 = rng.standard_normal(HIGHD.dim).astype(np.float32)
    w0 /= np.linalg.norm(w0)
    w7 = torch.from_numpy(rng.standard_normal(FIG7.dim).astype(np.float32))
    w7 /= w7.norm()
    torch.save({"cov": stream.cov.cpu(), "sqrt_cov": stream.sqrt_cov.cpu(),
                "top": stream.top_eigvec.cpu(), "w0": w0,
                "fig7_cov": fig7.cov.cpu(),
                "fig7_sqrt_cov": fig7.sqrt_cov.cpu(),
                "fig7_top": fig7.top_eigvec.cpu(), "w7": w7},
               os.path.join(work, "inputs.pt"))
    # the ranks, started first: the single-process references run while
    # they do
    store = os.path.join(work, "store")
    # two BLAS threads a rank: (v1)'s ranks each draw the whole stream on
    # the host (numpy), beside the references, and share the host's cores
    env = dict(os.environ, OMP_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2",
               MKL_NUM_THREADS="2")
    procs = []
    for r in range(V_WORLD):
        log = open(os.path.join(work, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--v-rank", str(r),
             store, work], stdout=log, stderr=subprocess.STDOUT, env=env),
            log))
    deadline = time.monotonic() + V_TIMEOUT
    try:
        # the single-process card runs: (v1) with the exact wire forced to
        # impl="roll", (v2), (v3) at n_nodes = 4 with impl="roll"
        ref1 = {label: v_pca_run(dev, None, stream, w0, label, wire, spec,
                                 gov)
                for label, wire, spec, gov in V1_RUNS}
        ref2 = {name: v_scenario_run(dev, None, fig7, w7.to(dev), name)
                for name in V2_SCENARIOS}
        ref3 = {}
        for sync in (True, False):
            hist, events, st = v3_run(dev, None, sync,
                                      v3_state(dev, TRAIN_N))
            ref3[sync] = ([r["metrics"]["loss"] for r in hist], events,
                          st.opt.step,
                          [p.cpu() for p in tree_leaves(st.params)])
            del st
        del stream, fig7
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t_all
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
        print(f"(v) rank {r} exited {procs[r][0].returncode}:\n{tail}")
    require(not failed, f"(v): ranks {failed} failed or overran "
                        f"{V_TIMEOUT} s")
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(V_WORLD)]
    t_ranks = time.perf_counter() - t_all

    # (v0)
    by_case = {}
    for rr in res:
        for case in rr["v0"]:
            key = (case["ranks"], case["dropped"], case["kind"])
            by_case.setdefault(key, []).append(case)
    for (E, dropped, kind), cases in by_case.items():
        c0 = cases[0]
        require(len(cases) == E, f"(v0) ranks={E} out={dropped} {kind}: "
                                 f"{len(cases)} ranks reported")
        err = max(c["max_abs_err"] for c in cases)
        scale = max(c["max_plain"] for c in cases)
        if kind == "scheduled":
            bit, limit = False, 1e-6 * scale
        else:
            bit = all(c["equal"] for c in cases)
            # bit for bit, except the exact wire on the gather route
            # (impl="roll"): it applies the R rounds composed into one
            # circulant (`compose_schedule`), whose sums round apart from
            # the R sequential rounds of the plain path
            limit = (0.0 if kind == "sign" or (kind == "exact"
                                               and c0["impl"] == "shard")
                     else QUANT_TOL["float32"][0] * scale
                     + QUANT_TOL["float32"][1] if kind == "int8"
                     else TOL["float32"][0] * scale + TOL["float32"][1])
        ok = bit if limit == 0.0 else err <= limit
        print(f"check (v0) HIGHD cohort ranks={E} out={list(dropped)} {kind}"
              f" impl={c0['impl']} rows by rank "
              f"{[c['rows'] for c in cases]}: bit for bit {bit}, "
              f"max_abs_err={err:.3e} limit={limit:.3e}; bytes staged by "
              f"rank {[c.get('staged') for c in cases]} "
              f"{'ok' if ok else 'FAIL'}")
        require(ok, f"(v0) ranks={E} out={dropped} {kind} disagrees with "
                    f"the plain per-round path over the cohort")
        require(all(c["launches"]["gossip_mix"] == 0 and
                    c["launches"]["gossip_mix_quant"] == 0 for c in cases),
                f"(v0) {kind}: a node-axis kernel ran on the sharded path")
    require(any(c["equal"] and c["rows"][0] == c["rows"][1]
                for cs in by_case.values() for c in cs
                if c["kind"] == "exact" and c["impl"] == "shard"),
            "(v0): no covered cohort left a rank without a row")

    # (v1)
    v_launches = {k: {} for k in ("krasulina_xi", "gossip_mix_quant")}
    for label, wire, spec, _ in V1_RUNS:
        want_dec, want_ev, want_w, want_hist, want_sigs, want_s = ref1[label]
        held = [r for r, rr in enumerate(res) if label in rr["v1"]]
        runs = [res[r]["v1"][label] for r in held]
        same = len(runs) == 2 and all(
            r["decisions"] == want_dec and r["events"] == want_ev
            and r["signatures"] == want_sigs for r in runs)
        w = torch.cat([r["w"] for r in sorted(runs, key=lambda r: r["rows"])])
        d = (w - want_w).abs()
        bound = 1e-5 * want_w.abs() + 1e-5 * want_w.abs().max()
        within = bool((d <= bound).all())
        kernel = "gossip_mix_quant" if wire == "int8" else "krasulina_xi"
        print(f"main (v1) HIGHD N={HIGHD_N} B={HIGHD_B} R={HIGHD_R} "
              f"K={HIGHD_K} {label} under {spec} on 2 ranks: membership "
              f"events {json.dumps(runs[0]['events'])} (single process "
              f"{json.dumps(want_ev)}), signatures {list(runs[0]['signatures'])}"
              f", plan history and events equal: {same}; sin2 "
              f"{[round(r['sin2'], 5) for r in runs]} (single process "
              f"{want_hist[-1]['metrics']['metric']:.5f}); iterate vs the "
              f"single-process card run: max_abs_err {d.max().item():.3e}, "
              f"within 1e-5 rel + 1e-5 max: {within}; s by rank "
              f"{[round(r['seconds'], 3) for r in runs]} (single process "
              f"{want_s:.3f}); bytes staged per round by rank "
              f"{[int(r['staged_per_round']) for r in runs]}; launches "
              f"{json.dumps(runs[0]['launches'])}")
        require(same, f"(v1) {label}: plans, events or signatures differ")
        require(runs[0]["events"], f"(v1) {label}: no membership event")
        require(all(r["finite"] and r["sin2"] < 0.05 for r in runs),
                f"(v1) {label}: sin2 not < 0.05")
        if wire == "exact":
            require(within, f"(v1) {label}: the iterate disagrees with the "
                            f"single-process run")
        require(all(r["launches"][kernel] == r["rounds"] for r in runs),
                f"(v1) {label}: {kernel} launches "
                f"{[r['launches'][kernel] for r in runs]}")
        for k in v_launches:
            v_launches[k].setdefault("v1", [0] * V_WORLD)
            for r, run in zip(held, runs):
                v_launches[k]["v1"][r] += run["launches"][k]

    # (v2)
    for name in V2_SCENARIOS:
        want_hist, want_w, want_s = ref2[name]
        runs = [rr["v2"][name] for rr in res[:2]]
        w = torch.cat([r["w"] for r in sorted(runs, key=lambda r: r["rows"])])
        d = (w - want_w).abs()
        bound = 1e-5 * want_w.abs() + 1e-5 * want_w.abs().max()
        within = bool((d <= bound).all())
        want_c = np.asarray([r["metrics"]["consensus_err"]
                             for r in want_hist])
        cerr = max(float(np.abs(np.asarray(r["consensus_err"]) - want_c).max()
                         / want_c.max()) for r in runs)
        drops = all(r["drops"] == [x.get("link_drops") for x in want_hist]
                    and r["bw"] == [x.get("bw_factor") for x in want_hist]
                    for r in runs)
        supersteps, held = V2_SCENARIOS[name]
        print(f"main (v2) scenario {name} N=8 on 2 ranks, {supersteps} "
              f"supersteps of K={V2_K}: sin2 "
              f"{[round(r['sin2'], 5) for r in runs]} (single process "
              f"{want_hist[-1]['metrics']['metric']:.5f}); iterate max_abs_err"
              f" {d.max().item():.3e}, within 1e-5 rel + 1e-5 max: {within};"
              f" consensus errors max rel err {cerr:.2e} (limit 1e-4); link "
              f"records equal: {drops}; s by rank "
              f"{[round(r['seconds'], 3) for r in runs]} (single process "
              f"{want_s:.3f}); bytes staged per round by rank "
              f"{[int(r['staged_per_round']) for r in runs]}; launches "
              f"{json.dumps(runs[0]['launches'])}")
        require(within and cerr <= 1e-4 and drops,
                f"(v2) {name}: disagrees with the single-process run")
        require(all(math.isfinite(r["sin2"]) and (r["sin2"] < 0.05
                                                  or not held)
                    for r in runs), f"(v2) {name}: sin2 not < 0.05")
        rounds = supersteps * V2_K
        require(all(r["launches"]["krasulina_xi"] == rounds for r in runs),
                f"(v2) {name}: krasulina_xi launches")
        v_launches["krasulina_xi"].setdefault("v2", [0] * V_WORLD)
        for r, run in enumerate(runs):
            v_launches["krasulina_xi"]["v2"][r] += run["launches"][
                "krasulina_xi"]

    # (v3)
    for sync, (want_l, want_ev, want_steps, want_p) in ref3.items():
        runs = [rr["v3"][sync] for rr in res]
        loss_err = max(abs(a - b) / abs(b) for r in runs
                       for a, b in zip(r["losses"], want_l))
        got = [torch.cat([r["params"][i] for r in runs])
               for i in range(len(want_p))]
        d = torch.cat([(a - b).abs().ravel() for a, b in zip(got, want_p)])
        within = float((d <= 1e-4).float().mean())
        steps = tuple(s for r in runs for s in r["steps"])
        print(f"main (v3) reduced granite-8b f32 4 ranks x 1 node under "
              f"{V3_SPEC}, rejoin sync {sync}: membership events "
              f"{json.dumps(runs[0]['events'])} (single process "
              f"{json.dumps(want_ev)}), nodes by round {runs[0]['n_active']},"
              f" steps {steps} (single process {want_steps}); losses "
              f"{json.dumps(runs[0]['losses'])} max rel err {loss_err:.2e} "
              f"(limit 1e-5); parameters within 1e-4: {within:.6f} (limit "
              f">= 0.999), max_abs_err {d.max().item():.3e}; launches "
              f"{json.dumps(runs[0]['launches'])}")
        require(all(r["events"] == want_ev for r in runs) and
                runs[0]["n_active"] == [4, 3, 4] and steps == want_steps,
                f"(v3) sync {sync}: membership or steps differ")
        require(loss_err <= 1e-5, f"(v3) sync {sync}: losses disagree")
        require(within >= 0.999 and d.max().item() <= 3 * S_LR * 3,
                f"(v3) sync {sync}: parameters disagree")
        require(all(r["launches"]["gossip_mix"] == 0 for r in runs),
                f"(v3) sync {sync}: gossip_mix ran on the sharded path")

    # (v4)
    runs = [rr["v4"] for rr in res]
    r1 = runs[1]
    full = [s for s in r1["per_superstep"] if s["n_active"] == TRAIN_N]
    cohort = [s for s in r1["per_superstep"] if s["n_active"] < TRAIN_N]
    per_round = lambda recs: [round(s["wall_s"] / V4_K, 3) for s in recs]
    losses = [s["loss"] for s in runs[0]["per_superstep"]]
    wire_ok = all(
        s["wire"] == V4_K * r["planned"]["full" if s["n_active"] == TRAIN_N
                                     else "cohort"]
        for r in runs for s in r["per_superstep"]
        if s["superstep"] < V4_REJOIN)  # the rejoin adds the sync's sum
    routes = {label: runs[0]["per_superstep"][k]["log"]
              for label, k in (("full", 0), ("cohort", V4_LEAVE))}
    print(f"main (v4) granite-8b full width, {TRAIN_LAYERS} layers, 4 ranks "
          f"x 1 node, 2 x {TRAIN_S} tokens a node, ring R={TRAIN_R}, "
          f"K={V4_K}, under {V4_SPEC} with rejoin sync: membership events "
          f"{json.dumps(runs[0]['events'])}; losses {json.dumps(losses)}; "
          f"node 1's rows unchanged while out: {r1['frozen_equal']}; after "
          f"the rejoin within {r1['sync']['max_steps']:.3f} bf16 steps of the "
          f"donors' mean (limit 1); s per round at full membership "
          f"{per_round(full)}, in the cohort {per_round(cohort)} (rank 1); "
          f"bytes staged per superstep by rank "
          f"{[[s['staged'] for s in r['per_superstep']] for r in runs]}; "
          f"planned a round by rank {[r['planned'] for r in runs]} "
          f"(messages {[r['planned_messages'] for r in runs]}), equal to the "
          f"wire of supersteps 0-{V4_REJOIN - 1}: {wire_ok}; rank 0's "
          f"[messages, bytes] "
          f"of a superstep by route {json.dumps(routes)}; peak memory by "
          f"rank GB "
          f"{[round(r['peak_bytes'] / 1e9, 2) for r in runs]}; wall "
          f"{runs[0]['wall_s']:.1f} s; launches "
          f"{json.dumps(runs[0]['launches'])}")
    require([e[:2] for e in runs[0]["events"]] == [(V4_LEAVE, (0, 2, 3)),
                                                   (V4_REJOIN, (0, 1, 2, 3))]
            and all(r["events"] == runs[0]["events"] for r in runs),
            f"(v4) membership events {runs[0]['events']}")
    require(r1["frozen_equal"], "(v4): node 1's rows changed while out")
    require(r1["sync"]["max_steps"] <= 1.0,
            "(v4): the rejoined rows are not the donors' mean")
    require(all(math.isfinite(x) for x in losses), "(v4): losses not finite")
    require(wire_ok, "(v4): the planned wire differs from the ranks'")
    require(all(r["peak_bytes"] < 80e9 / 4 for r in runs),
            "(v4): a rank's peak is a quarter of the card or more")
    seconds = res[0]["seconds"]
    total = time.perf_counter() - t_all
    print(f"main (v) seconds: references {t_ref:.1f} (while the ranks "
          f"run), ranks {t_ranks:.1f} "
          f"(rank 0: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"), all {total:.1f} (target < 120)")
    shutil.rmtree(work, ignore_errors=True)
    require(all(v_launches[k] and any(sum(x) for x in v_launches[k].values())
                for k in v_launches), f"(v): launches {v_launches}")
    return v_launches


# ---------------------------------------------------------------------------
# (w) error feedback, the hierarchical mode, snapshots, resume and
# publication on the sharded node axis: W_WORLD rank processes share the
# card in one gloo group (`durable_shard_phases`, spawned after (v)'s ranks
# have exited), four nodes, one a rank; the pod mesh's pod and lane groups
# and the snapshot writers' group are made at set-up
W_WORLD, W_TIMEOUT = 4, 900
W_POD_MESH = ((2, 2, 1), ("pod", "data", "model"))
W_SELF_WEIGHT = 0.6  # the ring between 2 pods (at 1/2: the exact mean)
W0_WIRES = ("sign", "int8")
W0_SPEC, W0_SUPERSTEPS, W0_FULL = "death:1@1-2", 3, 2
W0_HIER = ("none", "int8")
W0_PCA_SUPERSTEPS, W0_PCA_BACK = 2, 1
# (w1): one round, from the state (w3) snapshots, which (w3)'s resumed
# round must give again; (w2): greedy requests of W2_PROMPT tokens
W1_ROUNDS = 1
W2_PROMPTS, W2_PROMPT, W2_GEN = 3, 64, 8


def w_run(cfg, wire, dtype, mode="gossip"):
    """(s2)'s run with error feedback on `wire` (gossip), or the
    hierarchical mode's ring between the pods at W_SELF_WEIGHT."""
    from repro_torch.configs.base import AveragingConfig

    run = s2_run(cfg, mode, dtype)
    if mode == "hierarchical":
        # 128-column tiles divide the reduced config's lane blocks (623,232
        # columns): its int8 wire gossips the lanes apart
        return dataclasses.replace(run, averaging=AveragingConfig(
            mode, TRAIN_R, "ring", self_weight=W_SELF_WEIGHT,
            quantization=wire, quant_stats="tile", quant_block_d=128))
    return dataclasses.replace(run, averaging=AveragingConfig(
        mode, TRAIN_R, "ring", quantization=wire, error_feedback="grads"))


def w_state(dev, run, n_rows: int):
    """`run`'s state drawn from seed 0 (on the CPU for a reduced config,
    the card at full width), n_rows copies of the node, on the card."""
    import torch

    from repro_torch.core.packing import map_tensors
    from repro_torch.train import trainer

    st = trainer.init_state(run, torch.Generator(device=dev).manual_seed(0))
    return map_tensors(lambda t: t.to(dev),
                       trainer.replicate_for_nodes(st, n_rows))


def w_one_mix(dev, run, n: int, shards: int):
    """The one-process operator whose numbers `shards` ranks' split of n
    rows gives: the plain per-round loop where the shard rule covers the
    split, else the fused roll (a linear wire; None for a quantized
    one)."""
    from repro_torch import dist as rdist
    from repro_torch.core import mixing
    from repro_torch.kernels import ops

    avg = run.averaging
    if avg.quantization != "none" and avg.error_feedback == "off":
        return None
    sched = mixing.schedule(avg.topology, n, avg.self_weight)
    mesh = rdist.Mesh((shards, 1), ("data", "model"))
    covered = ops.node_shard_info(mesh, n, sched,
                                  rdist.row_table(mesh, n)) is not None
    return mixing.circulant_mix_op(sched, n, avg.rounds, fuse=not covered,
                                   impl="roll", device=dev)


def w_wait(marker: str) -> None:
    """Wait for the file `marker` (written by the parent process), at most
    W_TIMEOUT seconds."""
    deadline = time.monotonic() + W_TIMEOUT
    while not os.path.exists(marker):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{marker} did not appear")
        time.sleep(0.05)


def w_sample(vocab: int, seq: int):
    from repro_torch.data.lm import MarkovTokenStream

    data = MarkovTokenStream(vocab, seed=0)

    def sample(rng, n):
        toks = data.sample(rng, n, seq + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return sample


def w_lm_driver(dev, mesh, run, state, *, seq, supersteps, mix=None,
                spec=None, publisher=None, resume=None, root=None):
    """The LM trainer through the driver, K = 1, no prefetch, open loop,
    8 sequences a round: on `mesh` (this rank's node) or on one process
    (every node; `mix` at full membership), a blocking snapshot every
    superstep under `root`: (history, state, driver, events)."""
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.train import trainer
    from repro_torch.train.driver import EngineConfig, StreamingDriver
    from repro_torch.train.snapshot import RunSnapshotter

    builder = (trainer.superstep_builder(run, None, n_nodes=TRAIN_N, mix=mix,
                                         device=dev)
               if mesh is None else None)
    snap = (RunSnapshotter(root, every=1, keep_last=8, block=True,
                           overhead_budget=0.0) if root else None)
    with StreamingDriver(
            run, mesh, state, w_sample(run.model.vocab_size, seq),
            batch=2 * TRAIN_N, n_nodes=TRAIN_N, device=dev,
            superstep_builder=builder, publisher=publisher,
            snapshotter=snap, resume_from=resume,
            faults=FaultSchedule.parse(spec, TRAIN_N) if spec else None,
            engine=EngineConfig(superstep=1, prefetch_depth=0,
                                replan_every=0)) as drv:
        state, hist = drv.run(supersteps - drv._supersteps_done)
    events = [(e["superstep"], e["to"].active_ids)
              for e in drv.membership_events]
    return hist, state, drv, events


def w_pca(dev, mesh, stream, w0, *, root=None, resume=None):
    """(s1)'s governed PCA driver (HIGHD, exact wire) to W0_PCA_SUPERSTEPS
    supersteps on this rank's rows, a blocking snapshot every superstep
    under `root`, or resumed from `resume`: (iterate, records, seconds)."""
    import torch

    from repro_torch.configs.paper_pca import HIGHD, PCARunConfig
    from repro_torch.core import krasulina, problems
    from repro_torch.data.synthetic import make_pca_host_sampler
    from repro_torch.train.driver import EngineConfig, StreamingDriver
    from repro_torch.train.snapshot import RunSnapshotter

    avg = v_wires()["exact"]
    build = krasulina.krasulina_superstep_builder(
        avg, HIGHD_N, lambda t: 5.0 / t, device=dev, mesh=mesh,
        metric=lambda w: problems.sin2_error(w, stream.top_eigvec))
    snap = (RunSnapshotter(root, every=1, keep_last=8, block=True,
                           overhead_budget=0.0) if root else None)
    t0 = time.perf_counter()
    with StreamingDriver(
            PCARunConfig(pca=HIGHD, averaging=avg, stream=s1_stream()),
            mesh, krasulina.init_krasulina_state(w0, avg, HIGHD_N,
                                                 device=dev, mesh=mesh),
            make_pca_host_sampler(stream), superstep_builder=build,
            n_nodes=HIGHD_N, batch=HIGHD_B, clock=_SClock(S1_DT),
            device=dev, snapshotter=snap, resume_from=resume,
            engine=EngineConfig(superstep=HIGHD_K, prefetch_depth=0)) as drv:
        state, hist = drv.run(W0_PCA_SUPERSTEPS - drv._supersteps_done)
    torch.cuda.synchronize()
    return (state.w.cpu(), [(r["bucket"], r["plan"].to_json(),
                             r["metrics"]["metric"]) for r in hist],
            time.perf_counter() - t0)


def w_sampled(state, every: int = 61):
    """Every `every`-th entry of each parameter and f32 master of a
    TrainState (its node rows), as f32 copies on the host: what (w1)
    holds against one process."""
    import torch

    from repro_torch.core.packing import tree_leaves

    pick = lambda tree: [t.reshape(t.shape[0], -1)[:, ::every].to(
        "cpu", torch.float32, copy=True) for t in tree_leaves(tree)]
    return {"params": pick(state.params), "master": pick(state.opt.master)}


def w_fingerprint(state):
    """Two int64 sums over every tensor of a TrainState's bits (plain and
    position-weighted), per leaf, on the card: equal states give equal
    lists, and a moved bit moves them."""
    import torch

    from repro_torch.core.packing import tree_leaves

    out = []
    opt = state.opt
    step = 1 << 24  # entries a chunk: int64 temporaries of 128 MB
    for tree in (state.params, opt.m, opt.v, opt.master, opt.ef_residual):
        for t in (tree_leaves(tree) if tree != () else ()):
            flat = t.reshape(-1).view(torch.int16 if t.element_size() == 2
                                      else torch.int32)
            plain = weighted = 0
            for a in range(0, flat.numel(), step):
                bits = flat[a:a + step].long()
                pos = (torch.arange(a, a + bits.numel(),
                                    device=bits.device) % 65521)
                plain += int(bits.sum())
                weighted += int((bits * pos).sum())
            out.append((plain, weighted))
    return out


def w_rank(rank: int, store: str, workdir: str) -> int:
    """One rank of (w0)-(w4): `python3 chip_smoke.py --w-rank RANK STORE
    DIR`. Saves its results to DIR/rank{RANK}.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    from repro_torch import convert, dist as rdist
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.paper_pca import HIGHD
    from repro_torch.core.packing import map_tensors, tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import registry
    from repro_torch.models.common import MetaGenerator
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.publisher import SnapshotPublisher
    from repro_torch.train import checkpoint, trainer
    from repro_torch.train.snapshot import RunSnapshotter, restore_driver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=W_WORLD,
                            timeout=datetime.timedelta(seconds=300))
    # every group at set-up, in one order on every rank: the pod mesh's,
    # and the snapshot writer's of (w3)
    mesh = make_host_mesh()
    pod_mesh = make_mesh(*W_POD_MESH)
    # (w3)'s snapshot blocks until it is written, so that (w1)'s round is
    # timed alone (a write beside a round slowed it from ~18 to ~32 s)
    w3_snap = RunSnapshotter(os.path.join(workdir, "w3"), every=1,
                             keep_last=1, block=True, overhead_budget=0.0)
    w3_snap.bind(mesh)
    rows = rdist.node_rows(mesh, TRAIN_N)
    res = {"seconds": {}, "rows": (rows.start, rows.stop)}
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)

    def launches():
        out = dict(ops.launches)
        ops.reset_launches()
        return out

    def mine(state):
        """This rank's node of an all-node state (its rows, copied)."""
        take = lambda t: t[rows].clone()
        opt = state.opt
        return type(state)(tree_map(take, state.params), opt._replace(
            step=tuple(opt.step[rows]), m=tree_map(take, opt.m),
            v=tree_map(take, opt.v), master=tree_map(take, opt.master),
            ef_residual=tree_map(take, opt.ef_residual)))

    def params_of(state):
        return [p.to("cpu", copy=True) for p in tree_leaves(state.params)]

    # (w0) reduced granite-8b (f32, Adam), one node a rank, against the
    # one-process port on the card
    t_phase = time.perf_counter()
    cfg = reduced(get_config("granite-8b"))
    w0 = {"ef": {}, "hier": {}}
    ops.reset_launches()
    for wire in W0_WIRES:
        run = w_run(cfg, wire, "float32")
        start = w_state(dev, run, TRAIN_N)
        full = w_lm_driver(dev, mesh, run, mine(start), seq=64,
                           supersteps=W0_FULL,
                           root=(os.path.join(workdir, "w0_split")
                                 if wire == "int8" else None),
                           publisher=(SnapshotPublisher(overhead_budget=0.0)
                                      if wire == "int8" else None))
        hist, st, drv, _ = full
        rec = {"losses": [r["metrics"]["loss"] for r in hist],
               "ef_rel": [r["metrics"]["ef_rel"] for r in hist],
               "params": params_of(st),
               "fingerprint": w_fingerprint(st)}
        if wire == "int8":
            rec["published"] = [p.cpu() for p in tree_leaves(
                drv._publisher.snapshot().params)]
            rec["version"] = drv._publisher.version
            # the reverse: the ranks resume from the one process's
            # snapshot of superstep 1 (written beside the ranks' first
            # runs) and continue one superstep
            w_wait(inp["w0_one_root"] + ".ready")
            _, st2, drv2, _ = w_lm_driver(
                dev, mesh, run, mine(w_state(dev, run, TRAIN_N)), seq=64,
                supersteps=W0_FULL,
                resume=checkpoint.step_dir(inp["w0_one_root"], 1))
            rec["resumed_fingerprint"] = w_fingerprint(st2)
            rec["resumed_from"] = drv2.resumed_from
            del st2, drv2
        hist, st, _, events = w_lm_driver(
            dev, mesh, run, mine(start), seq=64, supersteps=W0_SUPERSTEPS,
            spec=W0_SPEC)
        rec["death"] = {"losses": [r["metrics"]["loss"] for r in hist],
                        "n_active": [r["n_active"] for r in hist],
                        "events": events, "params": params_of(st),
                        "steps": st.opt.step}
        w0["ef"][wire] = rec
        del start, st, drv
    for wire in W0_HIER:
        run = w_run(cfg, wire, "float32", "hierarchical")
        st = mine(w_state(dev, run, TRAIN_N))
        step = trainer.build_train_step(run, pod_mesh, n_nodes=TRAIN_N,
                                        device=dev)
        losses, wires = [], []
        for b in inp["w0_batches"]:
            rdist.reset_stats()
            st, m = step(st, {k: v[rows].to(dev) for k, v in b.items()})
            losses.append(float(m["loss"]))
            wires.append(rdist.stats["wire_bytes"])
        meta = tree_map(lambda t: t[None], registry.init_params(
            MetaGenerator(), cfg, torch.float32))
        w0["hier"][wire] = {
            "losses": losses, "params": params_of(st), "wire": wires,
            "planned": dryrun.staged_bytes(dryrun.node_axis_collectives(
                run, meta, rdist.Mesh(*W_POD_MESH, rank=rank), TRAIN_N))}
        del st
    w0["lm_launches"] = launches()
    # the PCA driver's snapshots and resume on the ranks (HIGHD, exact)
    stream = convert.pca_stream(inp["cov"], inp["sqrt_cov"], inp["top"],
                                HIGHD.lambda1, HIGHD.eigengap, device=dev)
    pca_root = os.path.join(workdir, "w0_pca")
    w_all, recs, secs = w_pca(dev, mesh, stream, inp["w0"], root=pca_root)
    w_back, recs_back, _ = w_pca(
        dev, mesh, stream, inp["w0"],
        resume=checkpoint.step_dir(pca_root, W0_PCA_BACK))
    w0["pca"] = {"equal": bool(torch.equal(w_all, w_back)),
                 "records_equal": recs[W0_PCA_BACK:] == recs_back,
                 "sin2": recs[-1][2], "seconds": secs,
                 "launches": launches()}
    del stream
    res["w0"] = w0
    dist.barrier()
    res["seconds"]["w0"] = time.perf_counter() - t_phase

    # (w1) granite-8b at its published widths, 2 layers, (s2b)'s node on
    # each rank (bf16, Adam, R = 2), the int8 wire with error feedback,
    # one round; (w2) it publishes after it; (w3) the state it starts
    # from is snapshotted first, and its round is what the resumed round
    # must give
    t_phase = time.perf_counter()
    cfg_h = dataclasses.replace(get_config("granite-8b"),
                                num_layers=TRAIN_LAYERS)
    run = w_run(cfg_h, "int8", "bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st = trainer.init_state(run, torch.Generator(device=dev).manual_seed(0))
    one = lambda tree: tree_map(lambda t: t.unsqueeze(0), tree)
    st = trainer.TrainState(one(st.params), st.opt._replace(
        step=(st.opt.step,), m=one(st.opt.m), v=one(st.opt.v),
        master=one(st.opt.master), ef_residual=one(st.opt.ef_residual)))

    class Publisher(SnapshotPublisher):
        """Keeps the bytes its publications stage apart from the
        round's."""

        staged = 0

        def maybe_publish(self, tree, superstep, *, aux=None):
            before = rdist.stats["staged_bytes"]
            t0 = time.perf_counter()
            snap = super().maybe_publish(tree, superstep, aux=aux)
            torch.cuda.synchronize()
            if snap is not None:
                self.staged += rdist.stats["staged_bytes"] - before
                self.synced_s = time.perf_counter() - t0
            return snap

    pub = Publisher(overhead_budget=0.0, min_interval_s=1e9)  # once
    w1 = {"per_superstep": []}

    def log_fn(rec):
        k = rec["superstep"]
        # the round's bytes: the superstep's, less its publication's
        published = pub.staged - sum(s["published"]
                                     for s in w1["per_superstep"])
        w1["per_superstep"].append({
            "superstep": k, "loss": rec["metrics"]["loss"],
            "ef_rel": rec["metrics"]["ef_rel"], "wall_s": rec["wall_s"],
            "staged": rdist.stats["staged_bytes"] - published,
            "published": published})
        rdist.reset_stats()

    from repro_torch.train.driver import EngineConfig, StreamingDriver

    ops.reset_launches()
    rdist.reset_stats()
    sample = w_sample(cfg_h.vocab_size, TRAIN_S)
    with StreamingDriver(run, mesh, st, sample, batch=2 * TRAIN_N,
                         n_nodes=TRAIN_N, device=dev, publisher=pub,
                         engine=EngineConfig(superstep=1, prefetch_depth=0,
                                             replan_every=0)) as drv:
        t0 = time.perf_counter()  # (w3) the snapshot of the first state
        w3_snap.maybe_snapshot(drv)
        w1["snapshot_s"] = time.perf_counter() - t0
        rdist.reset_stats()
        st, hist = drv.run(W1_ROUNDS, log_fn=log_fn)
    torch.cuda.synchronize()
    for name in ("write_s", "bytes_per_save", "saves", "last_error"):
        w1["snapshot_" + name] = getattr(w3_snap.stats, name)
    w3_snap.close()
    w3_snap._pinned.clear()  # the host copies go before the restore,
    torch._C._host_emptyCache()  # back from the pinned cache to the host
    w1["peak_bytes"] = torch.cuda.max_memory_allocated()
    w1["launches"] = launches()
    meta = tree_map(lambda t: t[None], registry.init_params(
        MetaGenerator(), cfg_h, torch.bfloat16))
    w1["planned"] = dryrun.staged_bytes(dryrun.node_axis_collectives(
        run, meta, rdist.Mesh((W_WORLD, 1), ("data", "model"), rank=rank),
        TRAIN_N))
    w1["publish_planned"] = dryrun.staged_bytes(dryrun.publish_collectives(
        meta, rdist.Mesh((W_WORLD, 1), ("data", "model"), rank=rank)))
    w1["sampled"] = w_sampled(st)
    w1["fingerprint"] = w_fingerprint(st)
    res["w1"] = w1
    res["seconds"]["w1"] = time.perf_counter() - t_phase

    # (w2) the publication: rank 0's engine greedy-decodes from the
    # published params through the flash kernel
    t_phase = time.perf_counter()
    snap = pub.snapshot()
    w2 = {"version": snap.version, "superstep": snap.superstep,
          "staleness": pub.staleness(W1_ROUNDS)["supersteps"],
          "cost_s": pub.stats.total_cost_s,
          "synced_s": getattr(pub, "synced_s", None),
          "staged": pub.staged, "planned": w1["publish_planned"]}
    if rank == 0:
        torch.save(map_tensors(lambda t: t.cpu(), snap.params),
                   os.path.join(workdir, "published.pt"))
        eng = ContinuousBatchingEngine(cfg_h, snap.params, slots=W2_PROMPTS,
                                       max_len=W2_PROMPT + W2_GEN,
                                       dtype=torch.bfloat16)
        ids = [eng.submit(p, W2_GEN) for p in inp["w2_prompts"]]
        eng.drain()
        w2["tokens"] = [list(eng.result(i).tokens) for i in ids]
        del eng
        w2["launches"] = launches()
    del snap, pub
    res["w2"] = w2
    dist.barrier()
    res["seconds"]["w2"] = time.perf_counter() - t_phase

    # (w3) the snapshot of (w1)'s first state restored into the state in
    # place, and (w1)'s round again
    t_phase = time.perf_counter()
    path = checkpoint.step_dir(os.path.join(workdir, "w3"), 0)
    t0 = time.perf_counter()
    drv = StreamingDriver(run, mesh, st, sample, batch=2 * TRAIN_N,
                          n_nodes=TRAIN_N, device=dev,
                          engine=EngineConfig(superstep=1, prefetch_depth=0,
                                              replan_every=0))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restore_driver(drv, path)
    torch.cuda.synchronize()
    w3 = {"restore_s": time.perf_counter() - t0, "build_s": build_s,
          "snapshot_s": w1["snapshot_s"], "write_s": w1["snapshot_write_s"],
          "bytes": w1["snapshot_bytes_per_save"],
          "saves": w1["snapshot_saves"], "error": w1["snapshot_last_error"]}
    with drv:
        st, hist = drv.run(1)
    w3["loss"] = hist[-1]["metrics"]["loss"]
    w3["equal"] = w_fingerprint(st) == w1["fingerprint"]
    w3["launches"] = launches()
    res["w3"] = w3
    del drv
    dist.barrier()
    res["seconds"]["w3"] = time.perf_counter() - t_phase

    # (w4) the hierarchical mode at full width on the 2 x 2 pod mesh, one
    # superstep, from (w1)'s parameters and moments
    t_phase = time.perf_counter()
    run_h = w_run(cfg_h, "none", "bfloat16", "hierarchical")
    st = trainer.TrainState(st.params, st.opt._replace(ef_residual=()))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = trainer.build_train_step(run_h, pod_mesh, n_nodes=TRAIN_N,
                                    device=dev)
    batch = trainer.make_node_batch(
        {k: torch.from_numpy(v) for k, v in sample(
            np.random.default_rng(9), 2 * TRAIN_N).items()}, TRAIN_N)
    batch = {k: v[rows].to(dev) for k, v in batch.items()}
    rdist.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, m = step(st, batch)
    torch.cuda.synchronize()
    w4 = {"round_s": time.perf_counter() - t0,
          "staged": rdist.stats["staged_bytes"],
          "loss": float(m["loss"]), "consensus_err": float(
              m["consensus_err"]),
          "planned": dryrun.staged_bytes(dryrun.node_axis_collectives(
              run_h, meta, rdist.Mesh(*W_POD_MESH, rank=rank), TRAIN_N)),
          "log": {f"{ax} {kind}": list(v)
                  for (ax, kind), v in rdist.log.items()},
          "peak_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches()}
    res["w4"] = w4
    del st, step
    dist.barrier()
    res["seconds"]["w4"] = time.perf_counter() - t_phase
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def durable_shard_phases(dev) -> dict:
    """(w0)-(w4) on the card: W_WORLD rank processes (`w_rank`), joined
    under a deadline; beside them (w0)'s one-process snapshot first (the
    ranks wait for its marker before they resume from it), then the other
    one-process references, and the full-width ones after they exit;
    prints each check and (w)'s seconds, and returns the ranks' launches
    by phase and rank, for the kernels line."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.paper_pca import HIGHD
    from repro_torch.core.packing import map_tensors, tree_leaves
    from repro_torch.data.synthetic import make_pca_stream
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.train import checkpoint, trainer

    t_all = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, ".smoke_ckpt", "durable_shard")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = reduced(get_config("granite-8b"))
    cfg_h = dataclasses.replace(get_config("granite-8b"),
                                num_layers=TRAIN_LAYERS)
    one_root = os.path.join(work, "w0_one")
    host = lambda tree: [p.to("cpu", copy=True) for p in tree_leaves(tree)]
    stream = make_pca_stream(HIGHD, device=dev)
    rng = np.random.default_rng(11)
    w0 = rng.standard_normal(HIGHD.dim).astype(np.float32)
    w0 /= np.linalg.norm(w0)
    sample = w_sample(cfg.vocab_size, 64)
    batches = [{k: torch.from_numpy(v) for k, v in trainer.make_node_batch(
        sample(rng, 2 * TRAIN_N), TRAIN_N).items()} for _ in range(2)]
    prompts = rng.integers(0, cfg_h.vocab_size, (W2_PROMPTS, W2_PROMPT))
    torch.save({"cov": stream.cov.cpu(), "sqrt_cov": stream.sqrt_cov.cpu(),
                "top": stream.top_eigvec.cpu(), "w0": w0,
                "w0_one_root": one_root, "w0_batches": batches,
                "w2_prompts": prompts}, os.path.join(work, "inputs.pt"))
    del stream
    store = os.path.join(work, "store")
    procs = []
    for r in range(W_WORLD):
        log = open(os.path.join(work, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--w-rank", str(r),
             store, work], stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + W_TIMEOUT
    try:
        # (w0)'s int8 error-feedback run on one process: its snapshot of
        # superstep 1 is the ranks' resume (they wait for the marker)
        run8 = w_run(cfg, "int8", "float32")
        hist, st, _, _ = w_lm_driver(
            dev, None, run8, w_state(dev, run8, TRAIN_N), seq=64,
            supersteps=W0_FULL, mix=w_one_mix(dev, run8, TRAIN_N, W_WORLD),
            root=one_root)
        open(one_root + ".ready", "w").close()
        refs = {("ef", "int8"): ([r["metrics"]["loss"] for r in hist],
                                 host(st.params)),
                "published": [p.cpu() for p in tree_leaves(
                    trainer.publish_extract(TRAIN_N)(
                        st, torch.ones(TRAIN_N, device=dev)))]}
        # the other one-process card runs of (w0): the sign wire at full
        # membership (its per-round operator), both wires under W0_SPEC,
        # the hierarchical mode at pods = 2
        run = w_run(cfg, "sign", "float32")
        hist, st, _, _ = w_lm_driver(
            dev, None, run, w_state(dev, run, TRAIN_N), seq=64,
            supersteps=W0_FULL, mix=w_one_mix(dev, run, TRAIN_N, W_WORLD))
        refs["ef", "sign"] = ([r["metrics"]["loss"] for r in hist],
                              host(st.params))
        for wire in W0_WIRES:
            run = w_run(cfg, wire, "float32")
            hist, st, _, events = w_lm_driver(
                dev, None, run, w_state(dev, run, TRAIN_N), seq=64,
                supersteps=W0_SUPERSTEPS, spec=W0_SPEC)
            refs["death", wire] = ([r["metrics"]["loss"] for r in hist],
                                   host(st.params), events, st.opt.step)
        for wire in W0_HIER:
            run = w_run(cfg, wire, "float32", "hierarchical")
            st = w_state(dev, run, TRAIN_N)
            step = trainer.build_train_step(
                run, None, n_nodes=TRAIN_N, pods=2, device=dev,
                mix=w_one_mix(dev, run, 2, 2))
            losses = []
            for b in batches:
                st, m = step(st, {k: v.to(dev) for k, v in b.items()})
                losses.append(float(m["loss"]))
            refs["hier", wire] = (losses, host(st.params))
        del st
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t_all
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
        print(f"(w) rank {r} exited {procs[r][0].returncode}:\n{tail}")
    require(not failed, f"(w): ranks {failed} failed or overran "
                        f"{W_TIMEOUT} s")
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(W_WORLD)]
    t_ranks = time.perf_counter() - t_all
    stitch = lambda lists: [torch.cat(parts) for parts in zip(*lists)]

    def same(got, want):
        return all(torch.equal(a, b) for a, b in zip(got, want, strict=True))

    # (w0) error feedback
    for wire in W0_WIRES:
        runs = [rr["w0"]["ef"][wire] for rr in res]
        want_l, want_p = refs["ef", wire]
        got = stitch([r["params"] for r in runs])
        bit = same(got, want_p)
        loss_err = max(abs(a - b) / abs(b) for r in runs
                       for a, b in zip(r["losses"], want_l))
        ef_rel = [x for r in runs for x in r["ef_rel"]]
        dl, dp, dev_ev, dsteps = refs["death", wire]
        death = [r["death"] for r in runs]
        gd = stitch([r["params"] for r in death])
        d = torch.cat([(a - b).abs().ravel() for a, b in zip(gd, dp)])
        within = float((d <= 1e-4).float().mean())
        dloss = max(abs(a - b) / abs(b) for r in death
                    for a, b in zip(r["losses"], dl))
        steps = tuple(s for r in death for s in r["steps"])
        print(f"main (w0) reduced granite-8b f32 error feedback, {wire} "
              f"wire, 4 ranks x 1 node: {W0_FULL} supersteps at full "
              f"membership, parameters bit for bit the one-process card "
              f"run (its per-round operator): {bit}; losses max rel err "
              f"{loss_err:.2e}; ef_rel {[round(x, 4) for x in ef_rel]}; "
              f"under {W0_SPEC}: events {json.dumps(death[0]['events'])} "
              f"(one process {json.dumps(dev_ev)}), nodes by round "
              f"{death[0]['n_active']}, steps {steps} (one process "
              f"{dsteps}), losses max rel err {dloss:.2e} (limit 1e-5), "
              f"parameters within 1e-4: {within:.6f} (limit >= 0.999), "
              f"max_abs_err {d.max().item():.3e}")
        require(bit, f"(w0) EF {wire}: the split run's parameters are not "
                     f"the one process's")
        require(loss_err <= 1e-5, f"(w0) EF {wire}: losses disagree")
        require(all(0 < x < 1 for x in ef_rel), f"(w0) EF {wire}: ef_rel")
        require(all(r["events"] == dev_ev for r in death)
                and death[0]["n_active"] == [4, 3, 4] and steps == dsteps,
                f"(w0) EF {wire}: membership or steps differ")
        require(dloss <= 1e-5 and within >= 0.999
                and d.max().item() <= 3 * S_LR * 3,
                f"(w0) EF {wire} under {W0_SPEC}: parameters disagree")
    r8 = [rr["w0"]["ef"]["int8"] for rr in res]
    # the snapshot of the split run, restored on one process
    run8 = w_run(cfg, "int8", "float32")
    _, st, drv, _ = w_lm_driver(
        dev, None, run8, w_state(dev, run8, TRAIN_N), seq=64,
        supersteps=W0_FULL, mix=w_one_mix(dev, run8, TRAIN_N, W_WORLD),
        resume=checkpoint.step_dir(os.path.join(work, "w0_split"), 1))
    one_from_split = same(host(st.params), stitch([r["params"] for r in r8]))
    del st, drv
    reverse = all(r["resumed_fingerprint"] == r["fingerprint"] for r in r8)
    pub = r8[0]["published"]
    pub_err = max((a - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(pub, refs["published"]))
    pub_same = all(same(r["published"], pub) for r in r8)
    print(f"main (w0) snapshots and publication of the split int8 EF run: "
          f"the ranks' snapshot of superstep 1 restored on one process and "
          f"continued one superstep: bit for bit the uninterrupted ranks' "
          f"{one_from_split}; the one process's snapshot restored on the "
          f"ranks ({r8[0]['resumed_from']}) and continued: bit for bit "
          f"{reverse}; published version {r8[0]['version']} on every rank, "
          f"the same params on every rank: {pub_same}, against the one "
          f"process's extract max rel err {pub_err:.2e} (f32 "
          f"reassociation, limit 1e-6)")
    require(one_from_split and reverse, "(w0): a resume across the mesh "
                                        "change is not bit for bit")
    require(pub_same and pub_err <= 1e-6
            and all(r["version"] == W0_FULL for r in r8),
            "(w0): the published params disagree")
    # (w0) the hierarchical mode
    for wire in W0_HIER:
        runs = [rr["w0"]["hier"][wire] for rr in res]
        want_l, want_p = refs["hier", wire]
        got = stitch([r["params"] for r in runs])
        bit = same(got, want_p)
        loss_err = max(abs(a - b) / abs(b) for r in runs
                       for a, b in zip(r["losses"], want_l))
        planned = all(w == r["planned"] for r in runs for w in r["wire"])
        print(f"main (w0) reduced granite-8b f32 hierarchical, {wire} wire, "
              f"pods x lanes = 2 x 2 ranks: parameters bit for bit the "
              f"one-process card run at pods = 2: {bit}; losses max rel "
              f"err {loss_err:.2e}; wire bytes a step by rank "
              f"{[r['wire'] for r in runs]}, planned "
              f"{[r['planned'] for r in runs]}: equal {planned}")
        require(bit and loss_err <= 1e-5,
                f"(w0) hierarchical {wire}: disagrees with one process")
        require(planned, f"(w0) hierarchical {wire}: the planned wire "
                         f"differs from the ranks'")
    pca = [rr["w0"]["pca"] for rr in res]
    print(f"main (w0) the governed PCA driver (HIGHD, exact) on 4 ranks, "
          f"{W0_PCA_SUPERSTEPS} supersteps of K={HIGHD_K}, resumed from the "
          f"snapshot of superstep {W0_PCA_BACK}: iterate bit for bit "
          f"{[p['equal'] for p in pca]}, records equal "
          f"{[p['records_equal'] for p in pca]}; sin2 {pca[0]['sin2']:.5f};"
          f" s by rank {[round(p['seconds'], 2) for p in pca]}; launches "
          f"{json.dumps(pca[0]['launches'])}")
    require(all(p["equal"] and p["records_equal"] for p in pca),
            "(w0): the PCA driver's resume differs")
    require(all(p["launches"]["krasulina_xi"] > 0 for p in pca),
            "(w0): krasulina_xi did not launch on the ranks")

    # (w1) full width, the error-feedback wire
    w1 = [rr["w1"] for rr in res]
    per_round = [[round(s["wall_s"], 3) for s in r["per_superstep"]]
                 for r in w1]
    staged = [[s["staged"] for s in r["per_superstep"]] for r in w1]
    ef_rel = [s["ef_rel"] for r in w1 for s in r["per_superstep"]]
    planned = all(s == r["planned"] for r, ss in zip(w1, staged)
                  for s in ss)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = w_run(cfg_h, "int8", "bfloat16")
    t0 = time.perf_counter()
    hist, st, _, _ = w_lm_driver(
        dev, None, run, w_state(dev, run, TRAIN_N), seq=TRAIN_S,
        supersteps=W1_ROUNDS, mix=w_one_mix(dev, run, TRAIN_N, W_WORLD))
    one_s = time.perf_counter() - t0
    one = w_sampled(st)
    one_l = [r["metrics"]["loss"] for r in hist]
    del st, hist
    torch.cuda.empty_cache()
    # (h0)'s bounds on the f32 masters (the bf16 parameters are their
    # rounding), every 61st entry of each leaf
    bit = all(same(stitch([r["sampled"][k] for r in w1]), one[k])
              for k in ("params", "master"))
    d = torch.cat([(a - b).abs().ravel() for a, b in zip(
        stitch([r["sampled"]["master"] for r in w1]), one["master"])])
    within = float((d <= 1e-4).float().mean())
    loss_err = max(abs(s["loss"] - b) / abs(b) for r in w1
                   for s, b in zip(r["per_superstep"], one_l))
    print(f"main (w1) granite-8b full width, {TRAIN_LAYERS} layers, 4 ranks x "
          f"1 node, bf16, Adam, ring R={TRAIN_R}, int8 wire with error "
          f"feedback, {W1_ROUNDS} rounds: s per round by rank {per_round}; "
          f"bytes staged a round by rank {staged}, planned "
          f"{[r['planned'] for r in w1]}: equal {planned}; ef_rel "
          f"{[round(x, 4) for x in ef_rel]}; peak memory by rank GB "
          f"{[round(r['peak_bytes'] / 1e9, 2) for r in w1]}; against the "
          f"same rounds on one process ({one_s:.1f} s, after the ranks): "
          f"losses max rel err {loss_err:.2e} (limit 1e-4), f32 masters "
          f"within 1e-4: {within:.6f} (limit >= 0.999, every 61st entry), "
          f"parameters and masters bit for bit {bit}; "
          f"launches {json.dumps(w1[0]['launches'])}")
    require(planned, "(w1): the planned wire differs from the ranks'")
    require(all(0 < x < 1 for x in ef_rel), "(w1): ef_rel not in (0, 1)")
    require(all(r["peak_bytes"] < 80e9 / W_WORLD for r in w1),
            "(w1): a rank's peak is a quarter of the card or more")
    require(loss_err <= 1e-4 and within >= 0.999,
            "(w1): disagrees with the same rounds on one process")

    # (w2) the publication and rank 0's engine
    w2 = [rr["w2"] for rr in res]
    params = map_tensors(lambda t: t.to(dev), torch.load(
        os.path.join(work, "published.pt"), weights_only=False))
    eng = ContinuousBatchingEngine(cfg_h, params, slots=W2_PROMPTS,
                                   max_len=W2_PROMPT + W2_GEN,
                                   dtype=torch.bfloat16)
    ids = [eng.submit(p, W2_GEN) for p in prompts]
    eng.drain()
    tokens = [list(eng.result(i).tokens) for i in ids]
    del eng, params
    torch.cuda.empty_cache()
    print(f"main (w2) publication after (w1)'s first superstep: version "
          f"{[w['version'] for w in w2]}, staleness at the end "
          f"{w2[0]['staleness']} superstep(s); publish cost on the training "
          f"thread by rank s {[round(w['cost_s'], 3) for w in w2]} "
          f"(synchronized {[round(w['synced_s'], 3) for w in w2]}); bytes "
          f"staged {[w['staged'] for w in w2]}, planned "
          f"{[w['planned'] for w in w2]}; rank 0's engine, {W2_PROMPTS} "
          f"greedy requests of {W2_PROMPT} + {W2_GEN} tokens through the "
          f"flash kernel: tokens equal to a one-process engine's on the "
          f"published weights: {w2[0]['tokens'] == tokens}; launches "
          f"{json.dumps(w2[0]['launches'])}")
    require(all(w["version"] == 1 and w["staleness"] == W1_ROUNDS - 1
                for w in w2), "(w2): version or staleness")
    require(all(w["staged"] == w["planned"] for w in w2),
            "(w2): the planned publication differs from the ranks'")
    require(w2[0]["tokens"] == tokens, "(w2): the served tokens differ")
    require(w2[0]["launches"]["flash_attention"] > 0,
            "(w2): the flash kernel did not serve")

    # (w3) the snapshot at full width, restored and continued
    w3 = [rr["w3"] for rr in res]
    total = sum(w["bytes"] for w in w3)
    print(f"main (w3) snapshot of the state (w1) starts from: {total} B "
          f"({total / 1e9:.2f} GB), bytes by rank {[w['bytes'] for w in w3]}"
          f"; s by rank on the training thread (blocking) "
          f"{[round(w['snapshot_s'], 2) for w in w3]}, of them in the "
          f"writer {[round(w['write_s'], 2) for w in w3]}; a driver built "
          f"in {[round(w['build_s'], 2) for w in w3]} s and restored into "
          f"in place (CRC32s checked first) in "
          f"{[round(w['restore_s'], 2) for w in w3]} s by rank; "
          f"(w1)'s round again from the restored state: bit for bit the "
          f"uninterrupted round {[w['equal'] for w in w3]}")
    require(all(w["saves"] == 1 and w["error"] is None for w in w3),
            f"(w3): the snapshot failed: {[w['error'] for w in w3]}")
    require(all(w["equal"] for w in w3), "(w3): the resume is not bit for "
                                         "bit")

    # (w4) the hierarchical mode at full width
    w4 = [rr["w4"] for rr in res]
    print(f"main (w4) granite-8b full width, hierarchical on pods x lanes = "
          f"2 x 2 ranks, ring between the pods at self weight "
          f"{W_SELF_WEIGHT}, one round: s by rank "
          f"{[round(w['round_s'], 3) for w in w4]}; bytes staged by rank "
          f"{[w['staged'] for w in w4]}, planned "
          f"{[w['planned'] for w in w4]}; loss {w4[0]['loss']:.4f}, "
          f"consensus_err {w4[0]['consensus_err']:.3e}; rank 0's [messages,"
          f" bytes] by route {json.dumps(w4[0]['log'])}; peak memory by "
          f"rank GB {[round(w['peak_bytes'] / 1e9, 2) for w in w4]}")
    require(all(w["staged"] == w["planned"] for w in w4),
            "(w4): the planned wire differs from the ranks'")
    require(all(math.isfinite(w["loss"]) and w["consensus_err"] > 0
                for w in w4), "(w4): loss or consensus error")
    seconds = res[0]["seconds"]
    print(f"main (w) seconds: references {t_ref:.1f} (while the ranks run),"
          f" ranks {t_ranks:.1f} (rank 0: " + ", ".join(
              f"{k} {v:.1f}" for k, v in seconds.items())
          + f"), all {time.perf_counter() - t_all:.1f} (target < 150)")
    shutil.rmtree(work, ignore_errors=True)
    out = {}
    for name in ("krasulina_xi", "gossip_mix_quant", "flash_attention"):
        by = {}
        for phase, get in (("w0", lambda rr: rr["w0"]["lm_launches"]),
                           ("w0 pca", lambda rr: rr["w0"]["pca"]
                            ["launches"]),
                           ("w2", lambda rr: rr["w2"].get("launches", {}))):
            counts = [get(rr).get(name, 0) for rr in res]
            if any(counts):
                by[phase] = counts
        if by:
            out[name] = by
    return out


# ---------------------------------------------------------------------------
# (x) the dense archs on the production mesh's model axis: heads and KV
# heads split inside a head, leaves the extent does not divide kept whole,
# and durable model-axis runs. Rank processes share the card in one gloo
# group, as (t)'s (`model_axis_heads_phases`, spawned after (w)'s ranks
# have exited): (x0) X0_WORLD ranks on 1 x 4 and 2 x 2, reduced granite-8b
# at d_model 512 in f32; (x1) X1_WORLD ranks on 1 x X1_WORLD, X1_ARCH at
# its published widths cut to TRAIN_LAYERS layers: the production mesh's
# model extent, which cuts each of granite-8b's 8 KV heads in two
X0_WORLD, X_TIMEOUT = 4, 300
X1_ARCH, X1_WORLD, X1_ROUNDS = "granite-8b", 16, 2
# (x0)'s head cases on 1 x 4: name -> changes to reduced granite-8b at
# d_model 512 (8 heads, 2 KV heads, head dim 64, d_ff 1024)
X0_CASES = {
    "2 KV heads (half a KV head a rank)": {},
    "6 heads, 2 KV heads (1.5 heads a rank)": {"num_heads": 6,
                                               "head_dim": 64},
    "d_ff 1022 (the FFN kept whole)": {"d_ff": 1022},
}
# (x0)'s exact-mode driver on 2 x 2: X0_STEPS rounds of 8 x X0_SEQ tokens,
# a blocking snapshot after round X0_BACK, resumed from it on 2 x 2, 1 x 4
# and one process
X0_STEPS, X0_BACK, X0_SEQ = 3, 2, 64


def x_cfgs():
    """(x0)'s head cases by name (the first: 2 KV heads) and (x1)'s
    X1_ARCH at its published widths cut to TRAIN_LAYERS layers."""
    from repro_torch.configs import get_config, reduced

    r = reduced(get_config("granite-8b"), d_model=512)
    return ({name: dataclasses.replace(r, **changes)
             for name, changes in X0_CASES.items()},
            dataclasses.replace(get_config(X1_ARCH), num_layers=TRAIN_LAYERS))


def x_driver(dev, mesh, run, state, *, root=None, resume=None):
    """(x0)'s exact-mode trainer through the driver on `mesh` (None: one
    process), TRAIN_N nodes, 8 sequences of X0_SEQ tokens a round, K = 1,
    no prefetch, open loop; a blocking snapshot every X0_BACK supersteps
    under `root`."""
    from repro_torch.train.driver import EngineConfig, StreamingDriver
    from repro_torch.train.snapshot import RunSnapshotter

    snap = (RunSnapshotter(root, every=X0_BACK, keep_last=2, block=True,
                           overhead_budget=0.0) if root else None)
    return StreamingDriver(
        run, mesh, state, w_sample(run.model.vocab_size, X0_SEQ),
        batch=2 * TRAIN_N, n_nodes=TRAIN_N, device=dev, snapshotter=snap,
        resume_from=resume, engine=EngineConfig(
            superstep=1, prefetch_depth=0, replan_every=0))


def x_tensors(state) -> list:
    """A TrainState's tensors: the parameters, moments and masters."""
    from repro_torch.core.packing import tree_leaves

    opt = state.opt
    return [t for tree in (state.params, opt.m, opt.v, opt.master)
            if tree != () for t in tree_leaves(tree)]


def x_gathered(state, run, mesh):
    """A rank's TrainState with its blocks gathered over the model axis
    (and the exact mode's data axis), on the CPU: the state one process
    holds (every node's rows are local on the meshes (x0) gathers)."""
    from repro_torch.core.packing import map_tensors
    from repro_torch.launch import sharding as shlib
    from repro_torch.train import trainer

    specs = trainer.state_placements(run, mesh, state)
    join = lambda tree, spec: (shlib.gather_tree(tree, spec, mesh)
                               if tree != () else tree)
    opt = state.opt
    whole = trainer.TrainState(join(state.params, specs.params), opt._replace(
        m=join(opt.m, specs.opt.m), v=join(opt.v, specs.opt.v),
        master=join(opt.master, specs.opt.master)))
    return map_tensors(lambda t: t.to("cpu", copy=True), whole)


def x_same_files(a: str, b: str) -> bool:
    """Whether checkpoints a and b hold the same manifest entries for
    their leaves and the same bytes in each leaf file."""
    import filecmp

    from repro_torch.train import checkpoint

    la = checkpoint.load_manifest(a)["leaves"]
    return la == checkpoint.load_manifest(b)["leaves"] and all(
        filecmp.cmp(os.path.join(a, e["file"]), os.path.join(b, e["file"]),
                    shallow=False) for e in la.values())


def x_within(got, want) -> tuple:
    """(share of entries within 1e-4, max abs err) of two lists of leaves:
    (t1)'s parameter bound."""
    import torch

    d = torch.cat([(a.float() - b.float()).abs().ravel()
                   for a, b in zip(got, want, strict=True)])
    return float((d <= 1e-4).float().mean()), float(d.max())


def x_rank(phase: str, rank: int, world: int, store: str,
           workdir: str) -> int:
    """One rank of (x0) or (x1): `python3 chip_smoke.py --x-rank PHASE
    RANK WORLD STORE DIR`. Saves its results to DIR/PHASE_rank{RANK}.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    t0 = time.perf_counter()
    if phase == "x0":
        res = x0_rank(dev, workdir, make_host_mesh(model=4),
                      make_host_mesh(model=2))
    else:
        res = x1_rank(dev, make_host_mesh(model=world))
    res["seconds"] = time.perf_counter() - t0
    torch.save(res, os.path.join(workdir, f"{phase}_rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def x_batch(dev, b, mesh, mode):
    """This rank's part of a [B, S] numpy batch (the node axis split for
    the gossip mode), on the card."""
    import torch

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.train import trainer

    b = {k: torch.from_numpy(v)[None] for k, v in b.items()}
    if mode != "exact":
        b = trainer.make_node_batch(b, TRAIN_N, axis=1)
    b = shard_batch(b, mesh, TRAIN_N, node_axis=mode != "exact")
    return {k: v[0].to(dev) for k, v in b.items()}


def x0_rank(dev, workdir: str, m14, m22) -> dict:
    """(x0) on one rank: each head case's loss and gradients on 1 x 4;
    the gossip trainer with 2 KV heads on 1 x 4, 3 rounds; the exact-mode
    driver on 2 x 2 with its snapshot, the one-process save of the
    gathered state beside it, and the resumes on 2 x 2 and 1 x 4."""
    import torch
    import torch.distributed as dist

    from repro_torch import dist as rdist
    from repro_torch.core.packing import map_tensors, tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shlib
    from repro_torch.models import registry
    from repro_torch.models.common import mesh_rules
    from repro_torch.train import checkpoint, trainer

    cases, _ = x_cfgs()
    first = m14.rank == 0
    to_dev = lambda tree: map_tensors(lambda t: t.to(dev), tree)
    out = {"heads": {}}
    # the head cases: (t0)'s batch, every gradient gathered
    for name, cfg in cases.items():
        spec = trainer.rest_specs(cfg, m14, exact=False)
        local = to_dev(shlib.shard_tree(registry.init_params(
            torch.Generator().manual_seed(0), cfg, torch.float32), spec, m14))
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in t_tokens(cfg, 1, 2, 64, 5)[0].items()}
        live = [p.detach().requires_grad_() for p in tree_leaves(local)]
        it = iter(live)
        params = tree_map(lambda _: next(it), local)
        rdist.reset_stats()
        with mesh_rules(m14):
            loss, _ = registry.loss_fn(params, cfg, batch, remat=True)
            grads = torch.autograd.grad(loss, live)
        log = {f"{a} {k}": list(v) for (a, k), v in rdist.log.items()}
        it = iter(grads)
        whole = shlib.gather_tree(tree_map(lambda _: next(it), local), spec,
                                  m14)
        out["heads"][name] = {
            "loss": float(loss.detach()), "log": log,
            "grads": [g.cpu() for g in tree_leaves(whole)] if first
            else None}
        del params, live, grads, whole, local
    cfg = next(iter(cases.values()))  # 2 KV heads
    # the gossip trainer on 1 x 4: (t1)'s rounds with the KV heads cut
    run = s2_run(cfg, "gossip", "float32")
    st = to_dev(trainer.replicate_for_nodes(trainer.init_state(
        run, torch.Generator().manual_seed(0), m14),
        rdist.n_local(m14, TRAIN_N)))
    step = trainer.build_train_step(run, m14, n_nodes=TRAIN_N, device=dev)
    ops.reset_launches()
    losses = []
    for b in s2a_batches(cfg):
        st, m = step(st, x_batch(dev, b, m14, "gossip"))
        losses.append(float(m["loss"]))
    params = shlib.gather_tree(st.params, trainer.rest_specs(
        cfg, m14, False, node_axis=True), m14)  # every rank sends
    out["gossip"] = {"losses": losses, "launches": dict(ops.launches),
                     "params": [p.cpu() for p in tree_leaves(params)]
                     if first else None}
    del st, step
    # the exact-mode driver on 2 x 2 (FSDP + ZeRO-1), its snapshot after
    # round X0_BACK, rank 0's one-process save of the gathered state
    run = s2_run(cfg, "exact", "float32")
    blocks = lambda mesh: to_dev(trainer.init_state(
        run, torch.Generator().manual_seed(0), mesh))
    root = os.path.join(workdir, "x0_snapshots")
    ops.reset_launches()
    with x_driver(dev, m22, run, blocks(m22), root=root) as drv:
        drv.run(X0_BACK)
        at_back = x_gathered(drv.state, run, m22)
        one = os.path.join(workdir, "x0_one_process")
        if m22.rank == 0:
            checkpoint.save(one, at_back, step=X0_BACK, model=cfg)
        dist.barrier()
        back = checkpoint.step_dir(root, X0_BACK)
        same = x_same_files(back, one) if m22.rank == 0 else None
        drv.run(X0_STEPS - X0_BACK)
        losses = [r["metrics"]["loss"] for r in drv.history]
        final = [t.clone() for t in x_tensors(drv.state)]
        final_gathered = x_gathered(drv.state, run, m22)
        snap = drv._snapshotter.stats
    out["exact"] = {"losses": losses,
                    "same_files": same, "saves": snap.saves,
                    "failures": snap.failures, "error": snap.last_error,
                    "write_s": snap.write_s, "launches": dict(ops.launches),
                    "at_back": x_tensors(at_back) if first else None,
                    "final": x_tensors(final_gathered) if first else None}
    # resumed on 2 x 2 from zeroed blocks: the last round bit for bit
    zero = map_tensors(torch.zeros_like, blocks(m22))
    with x_driver(dev, m22, run, zero, resume=back) as drv:
        _, h = drv.run(X0_STEPS - X0_BACK)
        out["exact"]["resumed"] = {
            "from": drv.resumed_from, "losses": [r["metrics"]["loss"]
                                                 for r in h],
            "bitwise": all(torch.equal(a, b) for a, b in zip(
                x_tensors(drv.state), final, strict=True))}
    # resumed on 1 x 4: the restored state bit for bit, the last round
    # within (t1)'s bounds
    zero = map_tensors(torch.zeros_like, blocks(m14))
    t0 = time.perf_counter()
    with x_driver(dev, m14, run, zero, resume=back) as drv:
        restore_s = time.perf_counter() - t0
        restored = x_tensors(x_gathered(drv.state, run, m14))
        _, h = drv.run(X0_STEPS - X0_BACK)
        out["exact"]["other"] = {
            "from": drv.resumed_from, "restore_s": restore_s,
            "losses": [r["metrics"]["loss"] for r in h],
            "restored_bitwise": all(torch.equal(a, b) for a, b in zip(
                restored, x_tensors(at_back), strict=True)),
            "within": x_within(x_tensors(x_gathered(drv.state, run, m14)),
                               x_tensors(final_gathered))}
    return out


def x1_rank(dev, mesh) -> dict:
    """(x1) on one rank: (t2)'s gossip round at the model extent of
    `mesh`, X1_ROUNDS rounds: each round's loss, s, messages and bytes by
    axis; the bytes at rest, the peak and the launches."""
    import torch

    from repro_torch import dist as rdist
    from repro_torch.core.packing import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.train import trainer

    _, cfg = x_cfgs()
    run = s2_run(cfg, "gossip", "bfloat16")
    st = trainer.replicate_for_nodes(trainer.init_state(
        run, torch.Generator(device=dev).manual_seed(0), mesh),
        rdist.n_local(mesh, TRAIN_N))
    opt = st.opt
    at_rest = sum(t.numel() * t.element_size()
                  for tree in (st.params, opt.m, opt.v, opt.master)
                  for t in tree_leaves(tree))
    del opt
    step = trainer.build_train_step(run, mesh, n_nodes=TRAIN_N, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rounds = []
    for b in t_tokens(cfg, X1_ROUNDS, TRAIN_B, TRAIN_S, 2):
        b = x_batch(dev, b, mesh, "gossip")
        rdist.reset_stats()
        t0 = time.perf_counter()
        st, m = step(st, b)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        rounds.append({"s": time.perf_counter() - t0, "loss": loss,
                       "stats": dict(rdist.stats),
                       "log": {f"{a} {k}": list(v)
                               for (a, k), v in rdist.log.items()}})
    return {"rounds": rounds, "at_rest": at_rest,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": dict(ops.launches)}


def x_spawn(phase: str, world: int, work: str):
    """Start `world` rank processes of `phase`; returns them with their
    logs."""
    store = os.path.join(work, f"{phase}_store")
    procs = []
    for r in range(world):
        log = open(os.path.join(work, f"{phase}_rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--x-rank", phase,
             str(r), str(world), store, work], stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def x_join(phase: str, procs, work: str, deadline: float) -> list:
    """Wait for `phase`'s ranks until `deadline`; a rank that failed or
    overran fails the run. Returns the ranks' results."""
    import torch

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
        with open(os.path.join(work, f"{phase}_rank{r}.log")) as f:
            tail = f.read()[-3000:]
        print(f"({phase}) rank {r} exited {procs[r][0].returncode}:\n{tail}")
    require(not failed, f"({phase}): ranks {failed} failed or overran "
                        f"{X_TIMEOUT} s")
    return [torch.load(os.path.join(work, f"{phase}_rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def model_axis_heads_phases(dev) -> dict:
    """(x0)-(x1) on the card: (x0)'s ranks spawned first, its one-process
    references and (x1)'s reference and plan computed while they run;
    then (x1)'s ranks, and (x0)'s one-process resume from their snapshot
    while those run. Prints each check and (x)'s seconds; returns the
    ranks' gossip_mix launches by phase and rank, for the kernels line."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.packing import map_tensors, tree_leaves, tree_map
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import registry
    from repro_torch.train import checkpoint, trainer

    t_all = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, ".smoke_ckpt", "model_axis_heads")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cases, cfg1 = x_cfgs()
    cfg = next(iter(cases.values()))
    procs = x_spawn("x0", X0_WORLD, work)
    deadline = time.monotonic() + X_TIMEOUT
    # (x0)'s one-process references on the card, while its ranks run
    to_dev = lambda tree: map_tensors(lambda t: t.to(dev), tree)
    ref_heads = {}
    for name, c in cases.items():
        params = to_dev(registry.init_params(
            torch.Generator().manual_seed(0), c, torch.float32))
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in t_tokens(c, 1, 2, 64, 5)[0].items()}
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(live)
        loss, _ = registry.loss_fn(tree_map(lambda _: next(it), params), c,
                                   batch, remat=True)
        ref_heads[name] = (float(loss.detach()),
                           [g.cpu() for g in torch.autograd.grad(loss, live)])
        del params, live, loss
    run = s2_run(cfg, "gossip", "float32")
    st = to_dev(trainer.replicate_for_nodes(trainer.init_state(
        run, torch.Generator().manual_seed(0)), TRAIN_N))
    step = trainer.build_train_step(run, None, n_nodes=TRAIN_N, device=dev)
    ref_losses = []
    for b in s2a_batches(cfg):
        st, m = step(st, {k: torch.from_numpy(v).to(dev) for k, v in
                          trainer.make_node_batch(b, TRAIN_N).items()})
        ref_losses.append(float(m["loss"]))
    ref_gossip = (ref_losses, [p.cpu() for p in tree_leaves(st.params)])
    del st, step
    # (x1)'s round-1 loss on one process from the same draws (the mean of
    # each node's) and its plan on a 1 x X1_WORLD mesh
    params = registry.init_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg1, torch.bfloat16)
    with torch.no_grad():
        b = {k: torch.from_numpy(v).to(dev) for k, v in
             t_tokens(cfg1, 1, TRAIN_B, TRAIN_S, 2)[0].items()}
        nodes = trainer.make_node_batch(b, TRAIN_N)
        ref1 = float(torch.stack([registry.loss_fn(
            params, cfg1, {k: v[j] for k, v in nodes.items()})[0]
            for j in range(TRAIN_N)]).mean())
    del params, b, nodes
    torch.cuda.empty_cache()
    amesh = abstract_mesh((1, X1_WORLD), ("data", "model"))
    kw = dict(cfg=cfg1, shape=ShapeConfig("(x1)", TRAIN_S, TRAIN_B, "train"),
              n_nodes=TRAIN_N, microbatches=1)
    low = dryrun.build_lowerable(X1_ARCH, "train_4k", amesh, "gossip",
                                 TRAIN_R, **kw)
    rec = dryrun.plan(X1_ARCH, "train_4k", amesh, averaging="gossip",
                      rounds=TRAIN_R, master_weights=True, **kw)
    count = lambda coll: sum(v for k, v in coll.items()
                             if k.endswith(".count"))
    model = rec["collectives_model"]
    plan = {"at_rest": shlib.local_bytes(low.planned[0], low.specs[0], amesh),
            "peak": rec["memory"]["peak_gib"] * 2 ** 30,
            "model_messages": count(model),
            "model_bytes": dryrun.staged_bytes(model),
            "data_messages": count(rec["collectives"]) - count(model),
            "data_bytes": rec["staged_bytes"] - dryrun.staged_bytes(model),
            "kinds": {k: v for k, v in model.items()
                      if k.endswith(".count")},
            "unsplit": rec["temp_unsplit_over_model"],
            "refused": rec.get("model_axis_refused")}
    del low
    t_ref0 = time.perf_counter() - t_all
    res0 = x_join("x0", procs, work, deadline)
    t_x0 = time.perf_counter() - t_all
    # (x1)'s ranks; (x0)'s one-process resume beside them
    procs = x_spawn("x1", X1_WORLD, work)
    deadline = time.monotonic() + X_TIMEOUT
    run = s2_run(cfg, "exact", "float32")
    back = checkpoint.step_dir(os.path.join(work, "x0_snapshots"), X0_BACK)
    zero = map_tensors(torch.zeros_like, to_dev(trainer.init_state(
        run, torch.Generator().manual_seed(0))))
    with x_driver(dev, None, run, zero, resume=back) as drv:
        restored = [t.to("cpu", copy=True) for t in x_tensors(drv.state)]
        _, h = drv.run(X0_STEPS - X0_BACK)
        one = {"from": drv.resumed_from,
               "losses": [r["metrics"]["loss"] for r in h],
               "final": [t.to("cpu", copy=True)
                         for t in x_tensors(drv.state)]}
    del zero
    torch.cuda.empty_cache()
    res1 = x_join("x1", procs, work, deadline)
    t_x1 = time.perf_counter() - t_all - t_x0

    def within_leaf(got, want, tol):
        """max |got - want| over tol x the leaf's largest |want|, leaf by
        leaf (the worst)."""
        return max(((a - b).abs().max() / (tol * b.abs().max())).item()
                   for a, b in zip(got, want, strict=True))

    # (x0) the head cases against one process, at (t0)'s bounds
    for name, (want_loss, want_grads) in ref_heads.items():
        got = [rr["heads"][name] for rr in res0]
        loss_err = max(abs(g["loss"] - want_loss) / abs(want_loss)
                       for g in got)
        share = within_leaf(got[0]["grads"], want_grads, T0_TOL)
        print(f"main (x0) reduced granite-8b d_model 512 f32, {name}, on "
              f"1x4: loss {got[0]['loss']:.7f} (one process "
              f"{want_loss:.7f}, max rel err over the ranks {loss_err:.2e}, "
              f"limit {T0_TOL}); {len(want_grads)} gradients, worst share "
              f"of {T0_TOL} x the leaf's largest entry {share:.3f}; rank "
              f"0's model-axis [messages, bytes] by kind "
              f"{json.dumps(got[0]['log'])}")
        require(loss_err <= T0_TOL and share <= 1.0,
                f"(x0) {name}: the split heads disagree with one process")
    cut = res0[0]["heads"][next(iter(cases))]["log"]
    require("model all-gather" in cut and "model reduce-scatter" in cut,
            f"(x0): no head pieces crossed the model group: {cut}")
    # (x0) the gossip trainer with 2 KV heads on 1 x 4, at (t1)'s bounds
    got = res0[0]["gossip"]
    loss_err = max(abs(a - b) / abs(b) for rr in res0
                   for a, b in zip(rr["gossip"]["losses"], ref_gossip[0]))
    within, err = x_within(got["params"], ref_gossip[1])
    launches = [rr["gossip"]["launches"].get("gossip_mix", 0) for rr in res0]
    print(f"main (x0) reduced granite-8b (2 KV heads) f32, adam, {TRAIN_N} "
          f"nodes, ring R={TRAIN_R}, gossip on 1x4: losses "
          f"{json.dumps(got['losses'])} (one process "
          f"{json.dumps(ref_gossip[0])}, max rel err {loss_err:.2e}, limit "
          f"1e-4); parameters within 1e-4: {within:.6f} (limit >= 0.999), "
          f"max_abs_err {err:.3e}; gossip_mix launches by rank {launches}")
    require(loss_err <= 1e-4 and within >= 0.999,
            "(x0) gossip: the split KV heads disagree with one process")
    require(all(n > 0 for n in launches),
            f"(x0) gossip: gossip_mix launches by rank {launches}")
    # (x0) the exact-mode driver, its snapshot and the resumes
    ex = [rr["exact"] for rr in res0]
    e0 = ex[0]
    other = [e["other"] for e in ex]
    o_err = max(abs(a - b) / abs(b) for o in other
                for a, b in zip(o["losses"], e0["losses"][X0_BACK:]))
    one_err = max(abs(a - b) / abs(b) for a, b in zip(
        one["losses"], e0["losses"][X0_BACK:]))
    one_bitwise = all(torch.equal(a, b) for a, b in zip(
        restored, e0["at_back"], strict=True))
    one_within = x_within(one["final"], e0["final"])
    print(f"main (x0) the exact mode (FSDP + ZeRO-1) with 2 KV heads on 2x2,"
          f" adam, {X0_STEPS} rounds of 8 x {X0_SEQ} tokens: losses "
          f"{json.dumps(e0['losses'])}; the snapshot after round {X0_BACK} "
          f"({e0['saves']} saves, {e0['failures']} failures, written in "
          f"{e0['write_s']:.2f} s) byte for byte the one-process save of "
          f"the gathered state: {e0['same_files']}; resumed on 2x2, round "
          f"{X0_STEPS} bit for bit by rank "
          f"{[e['resumed']['bitwise'] for e in ex]}; resumed on 1x4, the "
          f"restored state bit for bit by rank "
          f"{[o['restored_bitwise'] for o in other]} (restored in "
          f"{max(o['restore_s'] for o in other):.2f} s), round {X0_STEPS} "
          f"loss max rel err {o_err:.2e} (limit 1e-4), parameters and "
          f"moments within 1e-4 {min(o['within'][0] for o in other):.6f} "
          f"(limit >= 0.999); resumed on one process, restored bit for bit "
          f"{one_bitwise}, round {X0_STEPS} loss rel err {one_err:.2e}, "
          f"within 1e-4 {one_within[0]:.6f}")
    require(e0["saves"] == 1 and e0["failures"] == 0,
            f"(x0) exact: snapshots {e0['saves']}, failures "
            f"{e0['failures']}: {e0['error']}")
    require(e0["same_files"] is True, "(x0) exact: the split snapshot is "
            "not the one-process save of the gathered state")
    require(all(e["resumed"]["bitwise"] and e["resumed"]["from"] == back
                and e["resumed"]["losses"] == e0["losses"][X0_BACK:]
                for e in ex), "(x0) exact: the resume on 2x2 is not the "
                              "uninterrupted run's bits")
    require(all(o["restored_bitwise"] for o in other) and one_bitwise,
            "(x0) exact: a restore onto 1x4 or one process is not the "
            "snapshot's bits")
    require(o_err <= 1e-4 and one_err <= 1e-4
            and min(o["within"][0] for o in other) >= 0.999
            and one_within[0] >= 0.999,
            "(x0) exact: a resumed round disagrees beyond (t1)'s bounds")
    # (x1)
    first = [rr["rounds"][0]["loss"] for rr in res1]
    loss_err = max(abs(x - ref1) / abs(ref1) for x in first)
    per = lambda key: [[rd["stats"][key] for rd in rr["rounds"]]
                       for rr in res1]
    peaks = [rr["peak_bytes"] for rr in res1]
    peak_ratio = [plan["peak"] / p for p in peaks]
    secs = [[round(rd["s"], 3) for rd in rr["rounds"]] for rr in res1]
    print(f"main (x1) {X1_ARCH} published widths, {TRAIN_LAYERS} layers, "
          f"bf16 + f32 masters, adam, {TRAIN_N} nodes x 2 x {TRAIN_S} "
          f"tokens, ring R={TRAIN_R}, gossip on 1x{X1_WORLD} ({X1_WORLD} "
          f"ranks on the card): losses by rank 0 "
          f"{[round(rd['loss'], 5) for rd in res1[0]['rounds']]} (round 1 "
          f"on one process {ref1:.5f}, max rel err over the ranks "
          f"{loss_err:.2e}, limit {T2_LOSS_TOL}); s per round by rank "
          f"{secs}; bytes staged per round, model axis "
          f"{sorted(set(x for xs in per('model_staged_bytes') for x in xs))}"
          f" (planned {int(plan['model_bytes'])}), data axis "
          f"{sorted(set(x for xs in per('data_staged_bytes') for x in xs))}"
          f" (planned {int(plan['data_bytes'])}); messages per round, model "
          f"axis {sorted(set(x for xs in per('model_messages') for x in xs))}"
          f" (planned {plan['model_messages']}: {json.dumps(plan['kinds'])})"
          f", data axis "
          f"{sorted(set(x for xs in per('data_messages') for x in xs))} "
          f"(planned {plan['data_messages']}); bytes at rest by rank "
          f"{sorted(set(rr['at_rest'] for rr in res1))} (planned "
          f"{plan['at_rest']}); peak memory by rank GB "
          f"{[round(p / 1e9, 3) for p in peaks]}, plan over measured "
          f"{min(peak_ratio):.4f}-{max(peak_ratio):.4f}; launches by rank "
          f"{[rr['launches'].get('gossip_mix', 0) for rr in res1]} "
          f"gossip_mix; rank 0's model-axis [messages, bytes] by kind, "
          f"round 1 {json.dumps(res1[0]['rounds'][0]['log'])}")
    require(plan["refused"] is None and not plan["unsplit"],
            f"(x1): the plan kept the model axis unsplit: {plan['refused']}")
    require(all(math.isfinite(rd["loss"]) for rr in res1
                for rd in rr["rounds"]), "(x1): losses not finite")
    require(loss_err <= T2_LOSS_TOL,
            "(x1): round 1's loss disagrees with one process's")
    require(all(rr["at_rest"] == plan["at_rest"] for rr in res1),
            "(x1): bytes at rest differ from the plan's")
    require(all(abs(x - 1) <= P1_BOUND for x in peak_ratio),
            f"(x1): a rank's peak is not within {P1_BOUND} of the plan's")
    for key, want in (("model_messages", plan["model_messages"]),
                      ("model_staged_bytes", plan["model_bytes"]),
                      ("data_messages", plan["data_messages"]),
                      ("data_staged_bytes", plan["data_bytes"])):
        require(all(x == want for xs in per(key) for x in xs),
                f"(x1): {key} {per(key)} differ from the plan's {want}")
    require(all(rr["launches"].get("gossip_mix", 0) > 0 for rr in res1),
            "(x1): gossip_mix did not launch on every rank")
    print(f"main (x) seconds: (x0) {t_x0:.1f} (its references and (x1)'s "
          f"plan {t_ref0:.1f} while its ranks ran; rank 0 "
          f"{res0[0]['seconds']:.1f}), (x1) {t_x1:.1f} (rank 0 "
          f"{res1[0]['seconds']:.1f}), all {time.perf_counter() - t_all:.1f}"
          f" (target < 150)")
    shutil.rmtree(work, ignore_errors=True)
    return {"gossip_mix": {
        "x0": [rr["gossip"]["launches"].get("gossip_mix", 0) for rr in res0],
        "x1": [rr["launches"].get("gossip_mix", 0) for rr in res1]}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    import torch.nn.functional as F

    from repro_torch import convert, roofline
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import (SHAPES, AveragingConfig,
                                          GovernorConfig, RunConfig,
                                          ShapeConfig, StreamConfig)
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
    from repro_torch.launch import dryrun
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
    s2b_staged = s_launches.pop("s2b_staged")
    # (t): the model axis, rank processes sharing the card
    t_launches = model_axis_phases(dev)
    # (v): elastic membership on the sharded node axis, rank processes
    # sharing the card
    v_launches = elastic_shard_phases(dev)
    # (w): error feedback, the hierarchical mode, snapshots, resume and
    # publication on the sharded node axis, rank processes sharing the card
    w_launches = durable_shard_phases(dev)
    # (x): the dense archs on the production mesh's model axis (heads and
    # KV heads split inside a head) and durable model-axis runs, rank
    # processes sharing the card
    x_launches = model_axis_heads_phases(dev)
    # what phase (p) holds its plans against: peaks, card times
    p_measured = {}

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
        # (u2)'s wire: 2 nodes, where the ring's one shift is both +1 and
        # -1, its own row weighed 0.6, R = 2 (its own generator's draws)
        g2 = torch.Generator(device=dev).manual_seed(2)
        sched = mixing.schedule("ring", 2, U2_SELF_WEIGHT)
        for d in (33, 8192, 32773):
            x = torch.randn((2, d), generator=g2, device=dev).to(dtype)
            compare(f"gossip_mix {dn} n=2 d={d} ring self weight "
                    f"{U2_SELF_WEIGHT} R=2", ops.gossip_mix(x, sched, 2),
                    ref.gossip_mix_ref(x, sched, 2), dn)
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
    # the prefill's own peak for (p1), the phase's kept across the reset
    phase_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = registry.prefill(params, cfg, prompt, st.cache)
    st = engine.ServeState(cache, logits[:, -1:].argmax(-1), P1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated() / 2**30
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
    peak = max(phase_peak, torch.cuda.max_memory_allocated()) / 2**30
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
          f"ms); peak memory {peak:.2f} GiB (the prefill's own "
          f"{prefill_peak:.2f}); logits finite {finite}; repeat "
          f"equals generate {torch.equal(again, out)}; "
          f"launches={json.dumps(counts)}")
    p_measured["(g1)"] = {"peak_GiB": peak, "prefill_peak_GiB": prefill_peak,
                          "card_ms": dev_prefill}
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
        """Card ms of the steps of one train step on `state` (of any node
        count), each between two CUDA events, in the trainer's order: each
        node's forward + backward, its gradients into the [N, ...] tree,
        the pack, the mix, the consensus error, the optimizer update.
        Every result is dropped once timed (a second optimizer state would
        not fit)."""
        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = fn()
            end.record()
            torch.cuda.synchronize()
            return result, start.elapsed_time(end)

        params, ms = state.params, {}
        n_ = len(state.opt.step)
        grads = tree_map(torch.empty_like, params)
        ms["node_loss_grad"], ms["grad_copy"] = [], []
        for i in range(n_):
            (_, _, g), t = timed(lambda: trainer.loss_and_grad(
                run, tree_map(lambda p: p[i], params),
                {k: v[i] for k, v in batch.items()}))
            ms["node_loss_grad"].append(t)
            ms["grad_copy"].append(timed(lambda: [
                buf[i].copy_(gi) for buf, gi in
                zip(tree_leaves(grads), tree_leaves(g))])[1])
            del g
        # packed as the trainer packs
        pools = trainer.layer_pools(params, run.model)
        (bufs, spec), ms["pack"] = timed(lambda: averaging.pack(grads, pools))
        del grads
        mix = averaging.make_gossip_mix(run.averaging, n_, device=dev)
        outs, ms["mix"] = timed(lambda: tuple(mix(b) for b in bufs))
        del bufs
        ms["consensus_error"] = timed(lambda: averaging.
                                      packed_consensus_error(outs, spec,
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
    finals, h_rounds, h_peak, h_card = {}, {}, {}, {}
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
        h_card[label] = card_ms / TRAIN_K
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
        # the prefill's own peak, the phase's kept across the reset
        phase_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = registry.prefill(params, cfg_s, prompt, st.cache)
        st = engine.ServeState(cache, logits[:, -1:].argmax(-1), P)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_peak = torch.cuda.max_memory_allocated() / 2**30
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
        stats["peak_GiB"] = max(phase_peak,
                                torch.cuda.max_memory_allocated()) / 2**30
        stats["prefill_peak_GiB"] = prefill_peak
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
    p_measured["(m1)"] = stats
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
        "shared": time_ms(lambda: (F.silu(xt @ ffn["shared"]["w_gate"])
                                   * (xt @ ffn["shared"]["w_up"]))
                          @ ffn["shared"]["w_down"], reps=5),
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
    p_measured["(n1)"] = stats
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
        "ffn": time_ms(lambda: L.apply_ffn(blk_r["ffn"], h, cfg_g),
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

    # ------------- the last three families through the trainer (u0)-(u3)
    t_u = time.perf_counter()

    def u_sampler(cfg_, seq, frames):
        """sample_fn(rng, n): Markov tokens and labels of `seq` tokens and,
        with `frames`, standard-normal [n, frames, frontend_embed_dim] f32
        frames (the reference's `synth_batch`), all from `rng`."""
        data = MarkovTokenStream(cfg_.vocab_size, seed=0)

        def sample(rng, n):
            out = draw_tokens(data, rng, n, seq)
            if frames:
                out["frames"] = rng.standard_normal(
                    (n, frames, cfg_.frontend_embed_dim)).astype(np.float32)
            return out

        return sample

    def n_buffers(params):
        """The packed gradient buffers of a step: one per dtype."""
        return len({p.dtype for p in tree_leaves(params)})

    def held_mix(label, wire, run, state, batch):
        """One round's gradients of `state` (node i on batch row i), packed
        as the trainer packs them and mixed by the routed kernel; each
        buffer held against the kernel's plain version on the card (column
        chunks of whole tiles, into one output) at the kernel checks'
        bound, and the two consensus errors within U_CERR_RTOL of each
        other (the consensus error reads the deviations from the node
        mean, which a wrong weight moves where the max-scaled bound may
        not). Returns the kernel's launches."""
        params, n_ = state.params, len(state.opt.step)
        grads = tree_map(torch.empty_like, params)
        for i in range(n_):
            _, _, g = trainer.loss_and_grad(
                run, tree_map(lambda p: p[i], params),
                {k: v[i] for k, v in batch.items()})
            for buf, gi in zip(tree_leaves(grads), tree_leaves(g)):
                buf[i].copy_(gi)
            del g
        pools = trainer.layer_pools(params, run.model)
        bufs, spec = averaging.pack(grads, pools)
        del grads
        avg = run.averaging
        sched = mixing.schedule(avg.topology, n_, avg.self_weight)
        if wire == "int8":
            name, tol = "gossip_mix_quant", QUANT_TOL
            plain = lambda part: ref.gossip_mix_quant_ref(
                part, sched, avg.rounds, "int8", block_d=avg.quant_block_d)
        else:
            # in f32, rounded once to the buffer's dtype, as the kernel
            # rounds (the int8 chain above rounds so too)
            name, tol = "gossip_mix", TOL
            plain = lambda part: ref.gossip_mix_ref(
                part.float(), sched, avg.rounds).to(part.dtype)
        mix = averaging.make_gossip_mix(avg, n_, device=dev)
        ops.reset_launches()
        outs = tuple(mix(b) for b in bufs)
        torch.cuda.synchronize()
        launched = ops.launches[name]
        plains = []
        for b, out in zip(bufs, outs):
            want = torch.empty_like(b)
            for c in range(0, b.shape[1], U_MIX_CHUNK):
                want[:, c:c + U_MIX_CHUNK] = plain(
                    b[:, c:c + U_MIX_CHUNK].contiguous())
            dt = str(b.dtype).split(".")[-1]
            compare(f"{name} {label} {wire} wire, round 1's packed {dt} "
                    f"gradients [{n_}, {b.shape[1]}] ring self weight "
                    f"{avg.self_weight or 'default'} R={avg.rounds}", out,
                    want, dt, tol, chunk=U_MIX_CHUNK)
            plains.append(want)
        del bufs
        ce_k, ce_p = (float(averaging.packed_consensus_error(o, spec, pools))
                      for o in (outs, tuple(plains)))
        rel = abs(ce_k - ce_p) / ce_p
        print(f"check {name} {label} {wire} wire: consensus_err of the "
              f"mixed buffers {ce_k:.6e}, of the plain version's "
              f"{ce_p:.6e}, rel err {rel:.2e} limit {U_CERR_RTOL} "
              f"{'ok' if rel <= U_CERR_RTOL else 'FAIL'}")
        require(rel <= U_CERR_RTOL,
                f"{label} {wire}: consensus errors of the kernel's and the "
                f"plain mix disagree")
        return launched

    def held_loss(run, state, batch):
        """The mean over nodes of each node's loss on one held batch."""
        with torch.no_grad():
            return sum(float(registry.loss_fn(
                tree_map(lambda p: p[i], state.params), run.model, batch,
                remat=False)[0]) for i in range(len(state.opt.step))) / len(
                    state.opt.step)

    # (u0) each family reduced, in f32, 3 rounds of the exact and the gossip
    # mode from the same state and draws on the card and on the CPU
    for arch, (layers, seq, frames) in U0_CASES.items():
        cfg_u = reduced(get_config(arch), layers=layers)
        sample = u_sampler(cfg_u, seq, frames)
        rng = np.random.default_rng(0)
        draws = [sample(rng, 8) for _ in range(H0_ROUNDS)]
        for mode in ("exact", "gossip"):
            run = RunConfig(model=cfg_u, shape=SHAPES["train_4k"],
                            averaging=AveragingConfig(mode, TRAIN_R, "ring"),
                            optimizer="adam", learning_rate=H0_LR,
                            param_dtype="float32")
            base = trainer.init_state(run, torch.Generator().manual_seed(0))
            batches = draws
            if mode == "gossip":
                base = trainer.replicate_for_nodes(base, TRAIN_N)
                batches = [trainer.make_node_batch(b, TRAIN_N)
                           for b in draws]
            mix_launches = (H0_ROUNDS * n_buffers(base.params)
                            * (mode == "gossip"))
            runs = {}
            for side, d_ in (("card", dev), ("cpu", cpu)):
                st = on_device(base, d_)
                bs = [{k: torch.from_numpy(v).to(d_) for k, v in b.items()}
                      for b in batches]
                step = trainer.build_train_step(run, None, n_nodes=TRAIN_N,
                                                device=d_)
                ops.reset_launches()
                losses, cerrs = [], []
                for b in bs:
                    st, m = step(st, b)
                    losses.append(float(m["loss"]))
                    cerrs.append(float(m["consensus_err"]))
                counts = (take_counts(
                    f"(u0) {arch} {mode}", [], {
                        "gossip_mix": mix_launches, "gossip_mix_quant": 0,
                        "flash_attention": 0, "krasulina_xi": 0,
                        "krasulina_xi_gossip": 0})
                          if side == "card" else None)
                runs[side] = (losses, cerrs, st, counts)
            (lc, cc, sc, counts), (lp, cp, sp, _) = runs["card"], runs["cpu"]
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
            cerr_err = max(abs(a - b) / abs(b) if b else abs(a)
                           for a, b in zip(cc, cp))
            diffs = [(a.cpu() - b).abs().ravel() for a, b in zip(
                tree_leaves(sc.params), tree_leaves(sp.params))]
            d = torch.cat(diffs)
            within = float((d <= 1e-4).float().mean())
            # each leaf apart: a leaf of a few hundred entries (an SSD's
            # A_log, an RG-LRU's lam) is under the 0.1% the pooled share
            # lets through
            leaf_within = min(float((x <= 1e-4).float().mean())
                              for x in diffs)
            print(f"main (u0) {arch} reduced f32 ({layers} layers, S={seq}"
                  f"{f', {frames} frames' if frames else ''}) {mode} mode "
                  f"N={TRAIN_N} ring R={TRAIN_R} adam, card vs CPU over "
                  f"{H0_ROUNDS} rounds: losses {json.dumps(lc)} (CPU "
                  f"{json.dumps(lp)}, max rel err {loss_err:.2e}, limit "
                  f"1e-4); consensus_err {json.dumps(cc)} (CPU "
                  f"{json.dumps(cp)}, max rel err {cerr_err:.2e}, limit "
                  f"1e-4); parameters within 1e-4: {within:.6f}, in the "
                  f"worst leaf {leaf_within:.6f} (limit >= 0.999 each), "
                  f"max_abs_err {float(d.max()):.3e} "
                  f"(limit {3 * H0_LR * H0_ROUNDS:.1e}, 3 lr per round); "
                  f"launches={json.dumps(counts)}")
            require(loss_err <= 1e-4, f"(u0) {arch} {mode}: losses disagree")
            require(within >= 0.999 and leaf_within >= 0.999
                    and float(d.max()) <= 3 * H0_LR * H0_ROUNDS,
                    f"(u0) {arch} {mode}: parameters disagree")
            require((min(cc) > 0) == (mode == "gossip"),
                    f"(u0) {arch} {mode}: consensus_err {cc}")
            require(cerr_err <= 1e-4,
                    f"(u0) {arch} {mode}: consensus errors disagree")
            del base, runs, sc, sp, st, diffs

    # (u1)-(u3) each family at its published widths: bf16 with f32 masters,
    # Adam, 2 x 512 tokens a node a round, K = 2, 4 supersteps
    # through the StreamingDriver. Each round is planned first
    # (`launch/dryrun.py`, a meta trace on the host; phase (p1) prints the
    # plans beside the peaks measured here), and (u2) drops its f32 masters
    # where the plan passes U_MASTERS_GB.
    one = dryrun.parse_mesh("1x1")
    u_plans = {}
    for label, arch, layers, n_u, u_wires, self_w, lr_u in U_RUNS:
        cfg_u = get_config(arch)
        if layers:
            cfg_u = dataclasses.replace(cfg_u, num_layers=layers)
        b_u = 2 * n_u  # the round's samples, 2 a node
        shape_u = ShapeConfig(label, TRAIN_S, b_u, "train")
        plan_kw = dict(averaging="gossip", rounds=TRAIN_R, cfg=cfg_u,
                       shape=shape_u, n_nodes=n_u)
        plan_u = dryrun.plan(arch, "train_4k", one, master_weights=True,
                             **plan_kw)
        masters = plan_u["memory"]["peak_gib"] * 2**30 / 1e9 <= U_MASTERS_GB
        planned_gb = plan_u["memory"]["peak_gib"] * 2**30 / 1e9
        if not masters:
            plan_u = dryrun.plan(arch, "train_4k", one, master_weights=False,
                                 **plan_kw)
        u_plans[label] = plan_u
        print(f"main {label} {arch} plan with f32 masters: peak "
              f"{planned_gb:.3f} GB (limit {U_MASTERS_GB} GB): masters "
              f"{'kept' if masters else 'dropped'}")
        sample = u_sampler(cfg_u, TRAIN_S,
                           TRAIN_S if cfg_u.is_encdec else 0)
        tokens_u = b_u * TRAIN_S
        for wire in u_wires:
            quant = quant_tile if wire == "int8" else {}
            run = RunConfig(model=cfg_u, shape=SHAPES["train_4k"],
                            averaging=AveragingConfig(
                                "gossip", TRAIN_R, "ring",
                                self_weight=self_w, **quant),
                            optimizer="adam", learning_rate=lr_u,
                            param_dtype="bfloat16", master_weights=masters)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tstate = trainer.replicate_for_nodes(trainer.init_state(
                run, torch.Generator(device=dev).manual_seed(0)), n_u)
            torch.cuda.synchronize()
            n_node = sum(t[0].numel() for t in tree_leaves(tstate.params))
            bufs_u = n_buffers(tstate.params)
            state_gb = torch.cuda.memory_allocated() / 1e9
            init_peak = torch.cuda.max_memory_allocated() / 1e9
            print(f"main {label} {arch} full width, {cfg_u.num_layers}"
                  f"{f' + {cfg_u.encoder_layers}' if cfg_u.is_encdec else ''}"
                  f" layers, {wire} wire: {n_node} parameters per node, "
                  f"{n_u} nodes, bf16 with{'' if masters else 'out'} f32 "
                  f"masters, Adam at {lr_u:g}, ring R={TRAIN_R} self weight "
                  f"{self_w or 'default'}, {bufs_u} packed buffers, state "
                  f"drawn and "
                  f"replicated on the card in {time.perf_counter() - t0:.2f} "
                  f"s, {state_gb:.2f} GB (peak {init_peak:.2f})")
            # round 1's gradients through the kernel against its plain
            # version, and one held batch's loss before the rounds
            rng = np.random.default_rng(2)
            b0 = {k: torch.from_numpy(v).to(dev) for k, v in
                  trainer.make_node_batch(sample(rng, b_u), n_u).items()}
            mixes = held_mix(label, wire, run, tstate, b0)
            require(mixes == bufs_u, f"{label} {wire}: round 1's mix "
                    f"launched its kernel {mixes} times, not {bufs_u}")
            del b0
            held = {k: torch.from_numpy(v).to(dev) for k, v in
                    sample(np.random.default_rng(3), 2).items()}
            loss_before = held_loss(run, tstate, held)
            cmp_peak = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            with StreamingDriver(run, None, tstate, sample, batch=b_u,
                                 n_nodes=n_u, device=dev,
                                 engine=EngineConfig(superstep=TRAIN_K,
                                                     prefetch_depth=2,
                                                     replan_every=0)) as drv:
                tstate, history = drv.run(TRAIN_SUPERSTEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            kernel = "gossip_mix" if wire == "exact" else "gossip_mix_quant"
            other = {k: 0 for k in ops.launches}
            other[kernel] = TRAIN_K * TRAIN_SUPERSTEPS * bufs_u
            counts = take_counts(f"{label} {wire}", [kernel], other)
            peak = torch.cuda.max_memory_allocated() / 1e9
            loss_after = held_loss(run, tstate, held)
            losses = [rec["metrics"]["loss"] for rec in history]
            cerrs = [rec["metrics"]["consensus_err"] for rec in history]
            for rec in history:
                print(f"  superstep {rec['superstep']} round {rec['round']}: "
                      f"loss {rec['metrics']['loss']:.5f} consensus_err "
                      f"{rec['metrics']['consensus_err']:.4e} "
                      f"wall {rec['wall_s']:.4f} s")
            steady = history[1:]
            rounds_s = len(steady) * TRAIN_K / sum(r["wall_s"] for r in steady)
            rng = np.random.default_rng(1)
            t0 = time.perf_counter()
            draws = [sample(rng, b_u) for _ in range(TRAIN_K)]
            host_ms = (time.perf_counter() - t0) / TRAIN_K * 1e3
            sup = trainer.build_superstep(run, None, n_nodes=n_u, device=dev)
            staged = {k: torch.from_numpy(np.stack([
                trainer.make_node_batch(b, n_u)[k] for b in draws])).to(dev)
                for k in draws[0]}
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tstate, _ = sup(tstate, staged)
            end.record()
            torch.cuda.synchronize()
            card_ms = start.elapsed_time(end) / TRAIN_K
            phases = round_phases(run, tstate, {k: v[0] for k, v in
                                                staged.items()})
            phases["sum"] = sum(sum(v) if isinstance(v, list) else v
                                for v in phases.values())
            print(f"main {label} round phases on the card, ms: "
                  f"{json.dumps(phases)}")
            late_peak = torch.cuda.max_memory_allocated() / 1e9
            if wire == "exact":
                p_measured[label] = {"peak_GiB": peak * 1e9 / 2**30,
                                     "card_ms": card_ms}
            print(f"main {label} {arch} {wire} wire: {TRAIN_K * len(history)}"
                  f" rounds in {wall:.3f} s; loss at round "
                  f"{history[0]['round']} {losses[0]:.5f}, at round "
                  f"{history[-1]['round']} {losses[-1]:.5f}; held batch's "
                  f"loss {loss_before:.5f} -> {loss_after:.5f} (fall "
                  f"{loss_before - loss_after:.5f}, limit > {U_LOSS_MARGIN})"
                  f"; consensus_err "
                  f"last {cerrs[-1]:.3e}; steady {rounds_s:.4f} rounds/s, "
                  f"{rounds_s * tokens_u:.1f} tokens/s; host sampler "
                  f"{host_ms:.3f} ms per round; card {card_ms:.3f} ms per "
                  f"round (CUDA events, a staged superstep of {TRAIN_K}) = "
                  f"{card_ms * rounds_s / 1e3:.3f} of the steady round; peak "
                  f"memory {peak:.2f} GB (driver), {init_peak:.2f} (state "
                  f"draw), {cmp_peak:.2f} (round-1 mix check), "
                  f"{late_peak:.2f} (timing); state {state_gb:.2f} GB; card {smi}; "
                  f"launches={json.dumps(counts)}")
            require(all(math.isfinite(x) for x in losses + cerrs),
                    f"{label} {wire}: a loss or consensus error is not finite")
            require(losses[-1] < losses[0],
                    f"{label} {wire}: the loss did not fall")
            require(loss_before - loss_after > U_LOSS_MARGIN,
                    f"{label} {wire}: the held batch's loss fell by "
                    f"{loss_before - loss_after:.5f}, not more than "
                    f"{U_LOSS_MARGIN}")
            require(min(cerrs) > 0, f"{label} {wire}: consensus_err is 0")
            require(max(peak, init_peak, cmp_peak, late_peak) < 80,
                    f"{label} {wire}: peak memory above 80 GB")
            del tstate, drv, sup, staged, held
            torch.cuda.empty_cache()
    print(f"main (u) seconds: {time.perf_counter() - t_u:.1f}; card {smi}")

    # ------------------------------------- the planner against the card (p)
    # (p1) each plan on a 1 x 1 mesh (`launch/dryrun.py`: meta traces on the
    # host, no card work) beside the peak its phase measured: (h1)'s whole
    # phase, (u1)-(u3)'s driver runs on the gossip_mix wire, and the
    # serving phases' own prefill (their phase peak, which
    # adds decode steps and the CUDA-graph timing's pool, printed beside);
    # (p2) (s2b)'s planned node-axis wire on a 4 x 1 mesh beside the bytes
    # its ranks staged (`dist.stats`); (p3) the H100 roofline's step bound
    # and implied MFU for (h1)'s round and (g1)'s prefill beside their card
    # times. No kernel launches.
    ops.reset_launches()
    t_p = time.perf_counter()
    one = dryrun.parse_mesh("1x1")
    cfg_p = dataclasses.replace(get_config("granite-8b"),
                                num_layers=TRAIN_LAYERS)
    p_shapes = {"(h1)": ShapeConfig("(h1)", TRAIN_S, TRAIN_B, "train")}
    plans = {"(h1)": dryrun.plan(
        "granite-8b", "train_4k", one, averaging="gossip", rounds=TRAIN_R,
        cfg=cfg_p, shape=p_shapes["(h1)"], n_nodes=TRAIN_N,
        master_weights=True)}
    for label, (arch, b, p) in (("(g1)", ("granite-8b", B1, P1)),
                                ("(m1)", ("qwen2-moe-a2.7b", 4, 512)),
                                ("(n1)", ("recurrentgemma-9b", 2, 4096))):
        p_shapes[label] = ShapeConfig(label, p, b, "prefill")
        plans[label] = dryrun.plan(arch, "prefill_32k", one,
                                   shape=p_shapes[label])
    p_measured["(h1)"] = {"peak_GiB": h_peak["(h1)"] * 1e9 / 2**30,
                          "card_ms": h_card["(h1)"]}
    # (u1)-(u3)'s rounds, planned in phase (u), beside their drivers' peaks
    plans.update(u_plans)
    for label, rec in plans.items():
        m, mem = p_measured[label], rec["memory"]
        own = "prefill_peak_GiB" in m
        held = m["prefill_peak_GiB"] if own else m["peak_GiB"]
        ratio = mem["peak_gib"] / held
        print(f"main (p1) {label} plan on 1x1: peak {mem['peak_gib']:.3f} "
              f"GiB (arguments {mem['argument_gib']:.3f}, temporaries "
              f"{mem['temp_gib']:.3f}, outputs {mem['output_gib']:.3f}, in "
              f"place {mem['alias_gib']:.3f}); measured "
              f"{'the prefill' if own else 'the phase'} {held:.3f} GiB; "
              f"plan/measured {ratio:.4f} (bound 1 +- {P1_BOUND}); the "
              f"phase's peak {m['peak_GiB']:.3f} GiB "
              f"({mem['peak_gib'] / m['peak_GiB']:.4f}); "
              f"{rec['cost']['flops'] / 1e12:.3f} TFLOP counted; traced in "
              f"{rec['trace_s']} s")
        require(abs(ratio - 1) <= P1_BOUND,
                f"(p1) {label}: the plan's peak is {ratio:.4f} of the "
                f"measured")
    for mode in ("exact", "gossip"):
        rec = dryrun.plan("granite-8b", "train_4k", dryrun.parse_mesh("4x1"),
                          averaging=mode, rounds=TRAIN_R, cfg=cfg_p,
                          shape=ShapeConfig("(s2b)", TRAIN_S, 2 * 4, "train"),
                          master_weights=True)
        planned, got = rec["staged_bytes"], s2b_staged[mode]
        err = max(abs(planned / g - 1) for g in got)
        coll = {k: v for k, v in rec["collectives"].items()
                if k != "hbm_bytes_est"}
        print(f"main (p2) (s2b) {mode} wire on a 4x1 mesh: planned "
              f"{planned / 1e9:.4f} GB staged a round a rank "
              f"{json.dumps(coll)}; measured by rank "
              f"{[round(g / 1e9, 4) for g in got]} GB; max rel err "
              f"{err:.2e} (limit 1e-2)")
        require(err <= 1e-2, f"(p2) {mode}: the planned wire is off by "
                             f"{err:.2e}")
    for label in ("(h1)", "(g1)"):
        rf = roofline.analyze(plans[label], cfg=cfg_p if label == "(h1)"
                              else None, shape=p_shapes[label])
        card_ms = p_measured[label]["card_ms"]
        mfu = rf.model_flops / (card_ms * 1e-3 * roofline.PEAK_FLOPS)
        print(f"main (p3) {label} roofline ({roofline.CARD}; card {smi}): "
              f"compute {rf.compute_s * 1e3:.3f} ms, memory "
              f"{rf.memory_s * 1e3:.3f} ms, collective "
              f"{rf.collective_s * 1e3:.3f} ms; step bound "
              f"{rf.step_time_s * 1e3:.3f} ms ({rf.dominant}), implied MFU "
              f"{rf.mfu:.4f}; measured on the card {card_ms:.3f} ms, MFU "
              f"{mfu:.4f}, {card_ms * 1e-3 / rf.step_time_s:.3f}x the bound")
    take_counts("(p)", [], {k: 0 for k in ops.launches})
    require(not any(ops.flash_launches.values()), "(p): a kernel launched")
    print(f"main (p) seconds: {time.perf_counter() - t_p:.1f}")
    del plans

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
    # the ranks' launches of (t1)-(t2), (v1)-(v2), (w0)-(w2) and
    # (x0)-(x1), by phase and rank, under "t", "v", "w" and "x"
    for key, phases in (("t", t_launches), ("v", v_launches),
                        ("w", w_launches), ("x", x_launches)):
        for row in rows:
            by_phase = phases.get(row["name"])
            if by_phase is not None:
                row["launches"] += sum(sum(v) for v in by_phase.values())
                row.setdefault("launches_by_nodes", {})[key] = by_phase
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
    if sys.argv[1:2] == ["--t-rank"]:
        sys.exit(t_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--v-rank"]:
        sys.exit(v_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--w-rank"]:
        sys.exit(w_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--x-rank"]:
        sys.exit(x_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                        sys.argv[5], sys.argv[6]))
    sys.exit(main())
