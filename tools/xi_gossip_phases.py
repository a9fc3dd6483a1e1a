#!/usr/bin/env python3
"""Where the one-read krasulina_xi_gossip kernel spends its time on one
NVIDIA card: builds a copy of `csrc/krasulina_xi_gossip.cu` with a clock64()
stamp after each step (w tile in, partial s written, grid barrier 1, the
reduction, grid barrier 2, final s read, xi formed, gossip written), runs
it at path (a)'s shape (N = 10, Bn = 100, d = 3072) and the wide one
(N = 16, Bn = 4, d = 32768), f32, ring R = 8, and prints, per shape, the
kernel's time from CUDA-graph replays and each step's SM cycles (median
over blocks, thread 0 of each block) with its share of the block's total.

    python3 tools/xi_gossip_phases.py

The copy is built into the git-ignored `src/repro_torch/kernels/build/`;
the library the port loads is not touched. Needs a CUDA card and nvcc;
exits non-zero without them.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ("w tile in", "partial s", "grid barrier 1", "reduction",
         "grid barrier 2", "final s read", "xi", "gossip and store")


def instrumented(src: str) -> str:
    """The one-read kernel of `src` with a stamp after each step, and a C
    entry point `phases_launch` that takes the stamp buffer."""
    def once(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the source: "
                               f"{old!r}")
        return text.replace(old, new)

    head = src[:re.search(r"^// -+ two-pass$", src, re.M).start()]
    head = once(head, "Taps taps, T* __restrict__ out) {",
                "Taps taps, T* __restrict__ out, long long* stamps) {\n"
                "  const long long t_start = clock64();\n"
                "#define STAMP(k) if (threadIdx.x == 0) "
                "stamps[blockIdx.x * 8 + k] = clock64() - t_start;")
    w_in = "  mbar_wait(&full[N], 0);  // the w tile is in\n"
    head = once(head, w_in, w_in + "  STAMP(0)\n")
    parts = head.split("  grid_sync(bar, tiles);\n")
    if len(parts) != 3:
        raise RuntimeError("expected two grid barriers in the source")
    head = (parts[0] + "  STAMP(1)\n  grid_sync(bar, tiles);\n  STAMP(2)\n"
            + parts[1] + "  STAMP(3)\n  grid_sync(bar, tiles);\n  STAMP(4)\n"
            + parts[2])
    head = once(head, "= __ldcg(fin + j);\n  }\n  __syncthreads();\n",
                "= __ldcg(fin + j);\n  }\n  __syncthreads();\n  STAMP(5)\n")
    head = once(head, "  __syncthreads();\n  // 4. the composed gossip",
                "  __syncthreads();\n  STAMP(6)\n  // 4. the composed gossip")
    end = ("from_f32<T>(acc[k]);\n  }\n}")
    head = once(head, end, "from_f32<T>(acc[k]);\n  }\n  __syncthreads();\n"
                "  STAMP(7)\n}")
    head = once(head, "const Taps& taps, void* out, cudaStream_t stream) {",
                "const Taps& taps, void* out, cudaStream_t stream, "
                "long long* stamps) {")
    head = once(head, "bar, taps, static_cast<T*>(out));",
                "bar, taps, static_cast<T*>(out), stamps);")
    return head + """}  // namespace repro

extern "C" int phases_launch(const float* w, const float* z, int N, int Bn,
                             long long d, int bd, float* scratch,
                             unsigned* bar, float* out, int n_taps,
                             const int* shifts, const float* weights,
                             void* stream, long long* stamps) {
  repro::Taps taps = {};
  for (int t = 0; t < n_taps; ++t) taps.weight[shifts[t]] += weights[t];
  cudaStream_t st = (cudaStream_t)stream;
  if (bd == 32)
    return repro::launch_one_read<float, 32>(w, z, N, Bn, d, scratch, bar,
                                             taps, out, st, stamps);
  if (bd == 256)
    return repro::launch_one_read<float, 256>(w, z, N, Bn, d, scratch, bar,
                                              taps, out, st, stamps);
  return (int)cudaErrorInvalidValue;
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("xi_gossip_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import mixing
    from repro_torch.kernels import _cuda, ref
    from repro_torch.kernels.consensus import gossip_taps
    from repro_torch.kernels.krasulina_update import one_read_tile_width

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from prefill_card_time import time_ms

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _cuda.BUILD_DIR / "xi_gossip_phases.cu"
    lib_path = _cuda.BUILD_DIR / "libxi_gossip_phases.so"
    cu.write_text(instrumented((_cuda.CSRC / "krasulina_xi_gossip.cu")
                               .read_text()))
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                    "-o", str(lib_path), str(cu)], check=True)
    fn = ctypes.CDLL(str(lib_path)).phases_launch
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, I, I, LL, I, P, P, P, I, ctypes.POINTER(I),
                   ctypes.POINTER(ctypes.c_float), P, P]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = []
    for N, Bn, d in ((10, 100, 3072), (16, 4, 32768)):
        w = torch.randn((N, d), generator=gen, device=dev)
        z = torch.randn((N, Bn, d), generator=gen, device=dev)
        sched = mixing.schedule("ring", N)
        shifts, weights = gossip_taps(sched, 8, N)
        taps = len(shifts)
        shifts = (ctypes.c_int * taps)(*shifts)
        weights = (ctypes.c_float * taps)(*weights)
        bd = one_read_tile_width(
            d, torch.cuda.get_device_properties(dev).multi_processor_count)
        tiles = -(-d // bd)
        scratch = torch.empty(((-(-tiles // 32) * 32 + 1) * (N * Bn + N),),
                              device=dev)
        out = torch.empty((N, d), device=dev)
        stamps = torch.zeros((tiles, 8), dtype=torch.int64, device=dev)

        def launch():
            err = fn(w.data_ptr(), z.data_ptr(), N, Bn, d, bd,
                     scratch.data_ptr(), bar.data_ptr(), out.data_ptr(), taps,
                     shifts, weights,
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
                     stamps.data_ptr())
            if err:
                raise RuntimeError(f"phases_launch failed: cudaError {err}")

        launch()
        torch.cuda.synchronize()
        err = (out - ref.krasulina_xi_gossip_ref(w, z, sched, 8)).abs().max()
        ms = time_ms(torch, launch, 20, 5)
        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        at = stamps[:, :len(STEPS)].double().median(0).values.tolist()
        steps = [b - a for a, b in zip([0.0] + at[:-1], at)]
        rows.append({"shape": f"N={N} Bn={Bn} d={d} R=8 f32", "ms": ms,
                     "max_abs_err": err.item(), "cycles": dict(zip(
                         STEPS, steps)),
                     "share": {k: v / at[-1] for k, v in zip(STEPS, steps)}})
        print(f"xi_gossip_phases {rows[-1]['shape']}: {ms * 1e3:.3f} us; "
              + ", ".join(f"{k} {v:.0f} cycles ({v / at[-1]:.1%})"
                          for k, v in zip(STEPS, steps)))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"xi_gossip_phases": rows, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
