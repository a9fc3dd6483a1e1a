#!/usr/bin/env python3
"""The register report of the flash kernels: compiles
`csrc/flash_attention.cu` (the mma.sync kernel and the f32 kernel, one
instance per head-dim bucket up to D = 256) and `csrc/flash_attention_sm90.cu`
(the wgmma kernel at D = 64, 128 and 256) with `-Xptxas -v` into a temporary
directory, with the port's own nvcc flags, and prints each kernel's
registers and spills, and the dynamic shared memory a wgmma CTA asks for.

    python3 tools/flash_d256_probe.py

Needs nvcc (no card). Exits non-zero if a compile fails or if the wgmma
kernel at D = 256 spills or asks for more shared memory than a block may
use. The kernels' numbers against their plain versions, and their times,
come from `chip_smoke.py`.
"""
import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _cuda  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '(\w+)'")
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")


def report(text):
    """{mangled kernel name: (registers, spill stores, spill loads)} from
    ptxas's `-v` output."""
    out, name, spills = {}, None, (0, 0)
    for line in text.splitlines():
        if m := ENTRY.search(line):
            name, spills = m.group(1), (0, 0)
        elif (m := SPILL.search(line)) and name:
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := REGS.search(line)) and name:
            out[name] = (int(m.group(1)), *spills)
    return out


def main() -> int:
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("flash_attention", "flash_attention_sm90"):
            t0 = time.time()
            lib = os.path.join(tmp, f"{src}.so")
            out = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas",
                                  "-v", "-o", lib, str(_cuda.CSRC / f"{src}.cu")],
                                 capture_output=True, text=True)
            print(f"{src}.cu: nvcc rc {out.returncode} "
                  f"{time.time() - t0:.1f}s")
            if out.returncode:
                print(out.stdout + out.stderr)
                ok = False
                continue
            for name, (regs, st, ld) in report(out.stdout + out.stderr).items():
                print(f"  {name}: {regs} registers, {st} bytes spill stores, "
                      f"{ld} bytes spill loads")
                if "flash_sm90_kernelILi256E" in name and (st or ld):
                    ok = False
            if src == "flash_attention_sm90":
                fn = ctypes.CDLL(lib).flash_attention_sm90_smem_bytes
                for D in (64, 128, 256):
                    smem = fn(D)
                    print(f"  wgmma D={D}: {smem} bytes of dynamic shared "
                          f"memory (a block may use {_cuda.SMEM_BYTES})")
                    ok &= 0 < smem <= _cuda.SMEM_BYTES
    print("flash_d256_probe", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
