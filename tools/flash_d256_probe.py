#!/usr/bin/env python3
"""The register report of the flash kernels in `csrc/flash_attention.cu`
(the mma.sync kernel and the f32 kernel, one instance per head-dim bucket
up to D = 256): compiles the file with `-Xptxas -v` into a temporary
directory, with the port's own nvcc flags, and prints each kernel's
registers, spills and shared memory.

    python3 tools/flash_d256_probe.py

Needs nvcc (no card); exits non-zero if the compile fails. The kernels'
numbers against their plain versions, and their times, come from
`chip_smoke.py`.
"""
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _cuda  # noqa: E402


def main() -> int:
    t0 = time.time()
    src = os.path.join(ROOT, "src/repro_torch/kernels/csrc/flash_attention.cu")
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas",
                              "-v", "-o", os.path.join(tmp, "fa.so"), src],
                             capture_output=True, text=True)
    print("nvcc rc", out.returncode, f"{time.time() - t0:.1f}s")
    for line in (out.stdout + out.stderr).splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling",
                                   "error")):
            print(line)
    return 1 if out.returncode else 0


if __name__ == "__main__":
    sys.exit(main())
