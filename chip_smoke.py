#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, then builds the three Hopper
   kernels from `src/repro_torch/kernels/csrc/` with nvcc (parallel) and
   prints the build time.
2. Holds each kernel against its plain PyTorch version on the card over a
   sweep of shapes and dtypes, printing the max error and the tolerance.
3. Drives the port's main path at the paper's Fig. 8 size (d = 3072, N = 10
   nodes, B = 1000 samples per round, ring gossip R = 8), each run with the
   launch counts set to 0 just before it and read just after:
   the governed `StreamingDriver` (fused `krasulina_xi_gossip`),
   `run_dm_krasulina` (`krasulina_xi`) and `run_d_krasulina(fuse_xi=False)`
   (`krasulina_xi` then `gossip_mix`). Each must end finite with
   sin^2 < 0.05, and each must have launched its kernels.
4. Times every kernel at the main path's shapes and at N=16, Bn=4, d=32768,
   R=8 against its bound, its plain version and (gossip_mix) one dense
   matmul, and prints one `{"kernels": [...]}` JSON line.

The last line is `{"ok": true, "device": {...}}`. Any mismatch or fault
raises and exits non-zero; there is no CPU path and no fallback. Without a
CUDA card, or without the repository around it, it exits non-zero and
prints no result.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 1e-3)}  # (rtol, atol)
HIGHD_N, HIGHD_B, HIGHD_R, HIGHD_K = 10, 1000, 8, 8
REPLACES = {
    "krasulina_xi": "src/repro/kernels/krasulina_update.py:59",
    "krasulina_xi_gossip": "src/repro/kernels/krasulina_update.py:132",
    "gossip_mix": "src/repro/kernels/consensus.py:52",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu" for name in REPLACES}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def compare(name, got, want, dtype_name):
    """Max |kernel - plain|, held to rtol * max|plain| + atol."""
    rtol, atol = TOL[dtype_name]
    err = (got.float() - want.float()).abs().max().item()
    limit = rtol * want.float().abs().max().item() + atol
    ok = math.isfinite(err) and err <= limit
    print(f"check {name}: max_abs_err={err:.3e} limit={limit:.3e} "
          f"(rtol={rtol}, atol={atol} of max|plain|) {'ok' if ok else 'FAIL'}")
    require(ok, f"{name} disagrees with its plain version")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch.configs.base import AveragingConfig, StreamConfig
    from repro_torch.configs.paper_pca import HIGHD, PCARunConfig
    from repro_torch.core import krasulina, mixing, problems
    from repro_torch.data.synthetic import make_pca_host_sampler, make_pca_stream
    from repro_torch.kernels import _cuda, ops, ref
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
    t0 = time.perf_counter()
    per_lib = _cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + " ".join(f"{k}={v:.1f}s" for k, v in per_lib.items()))

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
            e = compare(f"krasulina_xi {dn} w{tuple(w.shape)} z{zshape}",
                        ops.krasulina_xi(w, z), ref.krasulina_xi_ref(w, z), dn)
            if dn == "float32" and wkind == "nodes" and zshape[1] == 100:
                errs["krasulina_xi"] = e
    for N in (10, 16):
        for bn in (4, 100):
            for d in (70, 3072, 32768):
                w, z = randn(N, d), randn(N, bn, d)
                for topo in ("ring", "circulant2"):
                    sched = mixing.schedule(topo, N)
                    for R in (0, 1, 8):
                        e = compare(
                            f"krasulina_xi_gossip float32 N={N} Bn={bn} d={d} "
                            f"{topo} R={R}",
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
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for n in (5, 10, 16):
            for d in (33, 3072, 32773):
                x = randn(n, d, dtype=dtype)
                for topo in ("ring", "circulant2"):
                    sched = mixing.schedule(topo, n)
                    for R in (1, 8):
                        e = compare(f"gossip_mix {dn} n={n} d={d} {topo} R={R}",
                                    ops.gossip_mix(x, sched, R),
                                    ref.gossip_mix_ref(x, sched, R), dn)
                        if (dn, n, d, topo, R) == ("float32", 10, 3072,
                                                   "ring", 8):
                            errs["gossip_mix"] = e
    # the whole superstep on the card agrees with the CPU's plain path on a
    # small input (exact, fused gossip, unfused gossip)
    for label, avg, fuse in (
            ("exact", AveragingConfig(mode="exact"), None),
            ("gossip fused", AveragingConfig(mode="gossip", rounds=3), True),
            ("gossip unfused", AveragingConfig(mode="gossip", rounds=3), False)):
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

    # -------------------------------------------------------------- main path
    stream = make_pca_stream(HIGHD, device=dev)
    sin2 = lambda w: problems.sin2_error(w, stream.top_eigvec)
    step5 = lambda t: 5.0 / t
    w0 = randn(HIGHD.dim)
    w0 /= w0.norm()
    gossip = AveragingConfig(mode="gossip", rounds=HIGHD_R, topology="ring")
    launches = {k: 0 for k in ops.launches}

    def spread_of(w_nodes):
        wbar = w_nodes.mean(0)
        return (torch.linalg.vector_norm(w_nodes - wbar, dim=1).max()
                / torch.linalg.vector_norm(wbar)).item()

    def finish(label, w, w_nodes, sin2_final, rounds, seconds, expect):
        counts = dict(ops.launches)
        for k, v in counts.items():
            launches[k] += v
        finite = bool(torch.isfinite(w_nodes).all())
        spread = spread_of(w_nodes)
        print(f"main {label}: sin2={sin2_final:.5f} consensus_err={spread:.3e} "
              f"rounds_per_s={rounds / seconds:.2f} "
              f"samples_per_s={rounds * HIGHD_B / seconds:.1f} "
              f"launches={json.dumps(counts)}")
        require(finite and tuple(w.shape) == (HIGHD.dim,),
                f"{label}: state not finite or of the wrong shape")
        require(sin2_final < 0.05, f"{label}: sin2={sin2_final} not < 0.05")
        for k in expect:
            require(counts[k] > 0, f"{label}: kernel {k} was never launched")

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
    # where the driver's time goes: host synthesis of one round's samples vs
    # one round of the superstep on the card (batch already staged)
    sample = make_pca_host_sampler(stream)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    host = [sample(rng, HIGHD_B)["z"] for _ in range(HIGHD_K)]
    host_ms = (time.perf_counter() - t0) / HIGHD_K * 1e3
    staged = {"z": torch.from_numpy(np.stack(host)).reshape(
        HIGHD_K, HIGHD_N, HIGHD_B // HIGHD_N, HIGHD.dim).to(dev)}
    probe = krasulina.init_krasulina_state(w0, gossip, HIGHD_N, device=dev)
    builder(HIGHD_B)(probe, staged)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        probe, _ = builder(HIGHD_B)(probe, staged)
    torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) / (3 * HIGHD_K) * 1e3
    print(f"driver time per round: host sampler {host_ms:.3f} ms "
          f"({HIGHD_B} samples, d={HIGHD.dim}), superstep on the card "
          f"{device_ms:.4f} ms (launches and host overhead included), "
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

    # ----------------------------------------------------------------- timing
    def time_ms(fn, reps=20, replays=5):
        """Device time of one call: `reps` calls captured in a CUDA graph,
        replayed `replays` times between two events (no host launch gaps)."""
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

    def bound(bytes_moved, flops):
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def measure(name, shape, kernel, plain, bytes_moved, flops, library=None):
        b_ms, b_by = bound(bytes_moved, flops)
        out = {"shape": shape, "ms": time_ms(kernel),
               "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": time_ms(library) if library else None}
        print(f"time {name} {shape}: " + json.dumps(out))
        return out

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
            elif name == "krasulina_xi_gossip":
                timed.append(measure(
                    name, shape,
                    lambda: ops.krasulina_xi_gossip(w, z, sched, HIGHD_R),
                    lambda: ref.krasulina_xi_gossip_ref(w, z, sched, HIGHD_R),
                    4 * (N * bn * d + 2 * N * d),
                    4 * N * bn * d + 2 * terms * HIGHD_R * N * d))
            else:
                fused = mixing.compose_schedule(sched, HIGHD_R, N)
                A = torch.as_tensor(mixing.schedule_matrix(fused, N),
                                    dtype=torch.float32, device=dev)
                timed.append(measure(
                    name, shape, lambda: ops.gossip_mix(x, sched, HIGHD_R),
                    lambda: ref.gossip_mix_ref(x, sched, HIGHD_R),
                    4 * 2 * N * d, 2 * terms * HIGHD_R * N * d,
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
    # the per-round metric: the excess risk reads the [d, d] covariance, the
    # alignment error two vectors
    wbar = state.w.mean(0)
    for label, fn in (("pca_excess_risk", lambda: problems.pca_excess_risk(
                          wbar, stream.cov, stream.lambda1)),
                      ("sin2_error", lambda: sin2(wbar))):
        print(f"time metric {label} d={HIGHD.dim}: {time_ms(fn):.5f} ms")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
