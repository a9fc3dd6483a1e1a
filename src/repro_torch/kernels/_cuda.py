"""Build, bind and launch the Hopper kernels: each `csrc/<name>.cu` is
compiled by `nvcc` for `sm_90a` into its own shared library with a plain C
interface, loaded with `ctypes`.

The build happens at first use (or through `build_all()`), from the
package's sources alone, into `kernels/build/` (listed in `.gitignore`). A
library's file name carries a hash of its source, of every `csrc/` header
the source includes (directly or through another header), and of the flags,
so an edited source or header is rebuilt and a stale library is never
loaded. All missing
libraries are compiled in parallel, one `nvcc` per source.

The launch helpers below check what a kernel takes (device, dtype, rank,
contiguity) and raise on anything else; a C entry point returns the
`cudaGetLastError()` of its launches, and `call` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the C `dtype` argument
SMEM_BYTES = 232_448  # shared memory one block may use on Hopper (227 KB)
N_SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_TERMS = 32  # kMaxTerms in csrc/common.cuh

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
SOURCES = ("flash_attention", "flash_attention_sm90", "gossip_mix",
           "gossip_mix_quant", "krasulina_xi", "krasulina_xi_gossip")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IP, _FP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
# C entry point and argument types of each library
SIGNATURES = {
    "flash_attention": ("flash_attention_launch",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _I, _I, _P]),
    "flash_attention_sm90": ("flash_attention_sm90_launch",
                             [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              ctypes.c_float, _P]),
    "gossip_mix": ("gossip_mix_launch",
                   [_P, _P, _I, _LL, _I, _I, _I, _I, _I, _IP, _FP, _P]),
    "gossip_mix_quant": ("gossip_mix_quant_launch",
                         [_P, _P, _I, _LL, _I, _LL, _I, _I, _I, _I, _IP, _FP,
                          _I, _I, _P]),
    "krasulina_xi": ("krasulina_xi_launch",
                     [_P, _LL, _P, _I, _I, _LL, _P, _P, _P, _I, _I, _IP,
                      _P]),
    "krasulina_xi_gossip": ("krasulina_xi_gossip_launch",
                            [_P, _P, _I, _I, _LL, _I, _P, _P, _P, _I, _I, _I,
                             _I, _IP, _FP, _P]),
}

_lock = threading.Lock()
_entry: Dict[str, ctypes._CFuncPtr] = {}  # loaded once per process


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); the Hopper "
                           "kernels are built with nvcc on the machine with "
                           "the card")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_includes(path: Path) -> Tuple[Path, ...]:
    """`path` and every `csrc/` file it includes with `#include "..."`,
    directly or through another such file, in a fixed order."""
    seen, todo = [], [path]
    while todo:
        cur = todo.pop(0)
        if cur in seen:
            continue
        seen.append(cur)
        todo += [CSRC / inc for inc in _INCLUDE.findall(cur.read_text())]
    return tuple(seen)


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in local_includes(CSRC / f"{name}.cu"):
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every library that is not built yet, all `nvcc`s at once.
    Returns the wall seconds of the build by library (0.0 for a library that
    was already there). Raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    seconds = {name: 0.0 for name in SOURCES}
    failures = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def entry(name: str) -> ctypes._CFuncPtr:
    """The C launch function of kernel `name`, building the libraries on the
    first call."""
    fn = _entry.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _entry:
            build_all()
            for lib_name, (sym, argtypes) in SIGNATURES.items():
                lib = ctypes.CDLL(str(library_path(lib_name)))
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _entry[lib_name] = fn
    return _entry[name]


def call(name: str, *args) -> None:
    """Launch kernel `name` through its C entry point; raise on a refused or
    failed launch (a refused launch never runs, and a later synchronize
    would not report it)."""
    err = entry(name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def check(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    """Raise unless `t` is a contiguous f32/bf16 CUDA tensor of `shape`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def tile_width(n: int, d: int, fixed_bytes: int = 0) -> int:
    """Columns per block for kernels that keep two f32 [n, bd] tiles in
    shared memory (plus `fixed_bytes` more): enough tiles to cover the SMs,
    a multiple of 32 (one warp across a row), at most 512. Raises when n is
    too large for even a 32-column tile."""
    want = 32 * -(-max(1, -(-d // N_SMS)) // 32)
    cap = (SMEM_BYTES - fixed_bytes) // (8 * n) // 32 * 32
    if cap < 32:
        raise ValueError(f"{n} rows do not fit a 32-column tile in shared "
                         f"memory ({SMEM_BYTES} bytes, {fixed_bytes} fixed)")
    return min(want, 512, cap)


def schedule_args(sched: Sequence[Tuple[int, float]], n: int):
    """(n_terms, shifts, weights) C arguments of a one-round schedule, shifts
    normalised into [0, n)."""
    terms = [(int(s) % n, float(w)) for s, w in sched]
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"schedule has {len(terms)} terms; the kernels take "
                         f"1 to {MAX_TERMS}")
    shifts = (ctypes.c_int * len(terms))(*[s for s, _ in terms])
    weights = (ctypes.c_float * len(terms))(*[w for _, w in terms])
    return len(terms), shifts, weights


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on `t`'s device, as the C `stream` argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
