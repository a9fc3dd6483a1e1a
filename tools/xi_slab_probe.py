#!/usr/bin/env python3
"""Where the cluster-slab krasulina_xi kernel spends its time on one NVIDIA
card. Builds copies of `csrc/krasulina_xi.cu` that stop after each step and
times each from CUDA-graph replays (20 launches a graph, 5 replays, the
fastest of two):

* "loads": the mbarriers set up, every TMA load issued and landed, the
  cluster barrier passed;
* "dots": also the partial dots of step 1;
* "exchange": also the push of the partials and the wait for the cluster's;
* "final s": also the sum of the C slots;
* "full": the kernel as the port launches it (also xi, step 5).

The difference between two rows is what a step adds on the card's
critical path. It does so at the main path's shape (G = 10, B = 100,
d = 3072), the wide one (G = 16, B = 4, d = 32768) and a tiny one (G = 1,
B = 4, d = 512, where the bytes are negligible), f32 and bf16. Then it times
the full kernel at B = 100, d = 3072 for G = 2 ... 16 with the cluster
size its launcher picks, which shows what an SM holding two blocks costs.

    python3 tools/xi_slab_probe.py

The copies are built into the git-ignored `src/repro_torch/kernels/build/`;
the library the port loads is not touched. Needs a CUDA card and nvcc;
exits non-zero without them.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADS_DONE = (
    "  if (A.C > 0) {\n"
    "    if (threadIdx.x == 0) {\n"
    "      for (int k = 0; k < nb; ++k) if (k / A.nbr < live)"
    " mbar_wait(&full[k], 0);\n"
    "      if (live > 0) mbar_wait(wfull, 0);\n"
    "    }\n"
    "    return;\n"
    "  }\n")
# (name, anchor in the source, code placed right after the anchor)
CUTS = (
    ("loads", "  cluster_wait();\n  // 1. partial dots", LOADS_DONE),
    ("dots", "    if (u < units && sub == 0) upart[j * E + b] = acc;\n  }\n"
     "  __syncthreads();\n", "  if (A.C > 0) return;\n"),
    ("exchange", "  // run, gets the same bits (no float atomics)\n"
     "  mbar_wait(xfull, 0);\n", "  if (A.C > 0) return;\n"),
    ("final s", "    fin[b] = acc;\n  }\n  __syncthreads();\n",
     "  if (A.C > 0) return;\n"),
)
ENTRY = """}  // namespace repro

extern "C" int probe_launch(const void* w, long long w_stride, const void* z,
                            int G, int B, long long d, void* out, int dtype,
                            int* cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_cluster_slab<float>(w, w_stride, z, G, B, d, out,
                                             cluster, st);
  return repro::launch_cluster_slab<__nv_bfloat16>(w, w_stride, z, G, B, d,
                                                   out, cluster, st);
}
"""


def variant(src: str, cut) -> str:
    """The cluster-slab half of `src`, stopped after step `cut` (None: the
    whole kernel), with a C entry point `probe_launch`."""
    if cut is not None:
        name, anchor, code = cut
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor not found once in the source")
        src = src.replace(anchor, anchor.replace(
            "  cluster_wait();\n", "  cluster_wait();\n" + code)
            if name == "loads" else anchor + code)
    head = src[:src.index("// -------------------------------------------"
                          "----------------------- two-pass")]
    return head + ENTRY


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("xi_slab_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _cuda

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from prefill_card_time import time_ms

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = (_cuda.CSRC / "krasulina_xi.cu").read_text()
    steps = [c[0] for c in CUTS] + ["full"]
    procs = {}
    for name, cut in zip(steps, list(CUTS) + [None]):
        tag = name.replace(" ", "_")
        cu = _cuda.BUILD_DIR / f"xi_slab_probe_{tag}.cu"
        lib = _cuda.BUILD_DIR / f"libxi_slab_probe_{tag}.so"
        cu.write_text(variant(src, cut))
        procs[name] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(out, file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(lib)).probe_launch
        fn.argtypes = [P, LL, P, I, I, LL, P, I, ctypes.POINTER(I), P]
        fns[name] = fn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def timer(fn, w, z, G, B, d, dtype):
        out = torch.empty((G, d), dtype=dtype, device=dev)
        cluster = ctypes.c_int(0)

        def launch():
            err = fn(w.data_ptr(), d, z.data_ptr(), G, B, d, out.data_ptr(),
                     _cuda.DTYPE_CODES[dtype], ctypes.byref(cluster),
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"probe_launch failed: cudaError {err}")

        ms = min(time_ms(torch, launch, 20, 5) for _ in range(2))
        return ms, cluster.value

    steps_rows = []
    for G, B, d in ((10, 100, 3072), (16, 4, 32768), (1, 4, 512)):
        for dtype in (torch.float32, torch.bfloat16):
            w = torch.randn((G, d), generator=gen, device=dev).to(dtype)
            z = torch.randn((G, B, d), generator=gen, device=dev).to(dtype)
            us, cluster = {}, 0
            for name in steps:
                ms, cluster = timer(fns[name], w, z, G, B, d, dtype)
                us[name] = ms * 1e3
            row = {"shape": f"G={G} B={B} d={d} {str(dtype)[6:]}",
                   "cluster": cluster, "us": us}
            steps_rows.append(row)
            print(f"xi_slab_probe {row['shape']} C={cluster}: "
                  + ", ".join(f"{k} {v:.2f} us" for k, v in us.items()))
    sweep = []
    for G in (2, 4, 6, 8, 10, 12, 16):
        w = torch.randn((G, 3072), generator=gen, device=dev)
        z = torch.randn((G, 100, 3072), generator=gen, device=dev)
        ms, cluster = timer(fns["full"], w, z, G, 100, 3072, torch.float32)
        sweep.append({"G": G, "blocks": G * cluster, "us": ms * 1e3})
        print(f"xi_slab_probe G={G} B=100 d=3072 f32: {G * cluster} blocks "
              f"of {cluster} to a cluster, {ms * 1e3:.2f} us")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"xi_slab_probe": {"steps": steps_rows, "g_sweep": sweep,
                                        "card": smi}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
