"""Launcher-level perf hygiene of the port: the process environment that the
launchers (`launch/train.py`, `launch/serve.py`) set BEFORE `import torch`,
and the directory the Hopper kernels are built into.

This module stays import-light: no torch, no module of the port that pulls
torch in. Everything is env-dict manipulation, so it is unit-testable
without touching the real process environment.

* tcmalloc: the host-side staging threads (the prefetch ring, the gossip
  halo staging through pinned buffers) allocate large host blocks. The
  large-allocation report threshold is raised, and a detected tcmalloc is
  exported in `LD_PRELOAD` for *child* processes (a process cannot preload
  into itself; the launcher under `torchrun` is such a child).
* `--compilation-cache-dir DIR` is the directory the port's nvcc libraries
  build into (`kernels/_cuda.build_dir`): they are the port's only compiled
  artefacts, so a restarted run that points at the same directory loads
  them and skips the build. Without the flag they build into
  `src/repro_torch/kernels/build/` (git-ignored).

The reference's XLA step marker, its TPU detection and TF_CPP_MIN_LOG_LEVEL
have no counterpart: they configure XLA and TensorFlow logging, which this
package does not load, and CUDA needs no step marker for its profiler.

Escape hatch: `--no-env-tuning` on a launcher's command line, peeked from
argv before argparse runs (the tuning must land before `import torch`).
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

# Well-known tcmalloc locations (Debian/Ubuntu package paths).
TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)

# Keep one-off large-allocation reports from spamming the log (the pinned
# staging buffers and the superstep batches trip the default 1 GiB
# threshold constantly).
TCMALLOC_REPORT_THRESHOLD = "60000000000"

# the environment variable `kernels/_cuda.build_dir` reads
KERNEL_BUILD_ENV = "REPRO_TORCH_KERNEL_BUILD_DIR"


def find_tcmalloc() -> Optional[str]:
    """First existing well-known tcmalloc shared object, or None."""
    for p in TCMALLOC_PATHS:
        if os.path.exists(p):
            return p
    return None


def tuned_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Return the perf-hygiene mutations as a dict (pure; does not apply).

    * TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD raised (if unset).
    * LD_PRELOAD set to a detected tcmalloc (if unset and one exists) so
      child processes get it; the current process is unaffected.
    """
    env = dict(os.environ if env is None else env)
    out: Dict[str, str] = {}
    if "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD" not in env:
        out["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = TCMALLOC_REPORT_THRESHOLD
    tc = find_tcmalloc()
    if tc is not None and not env.get("LD_PRELOAD"):
        out["LD_PRELOAD"] = tc
    return out


def wants_tuning(argv: Optional[List[str]] = None) -> bool:
    """The escape hatch, peeked from raw argv (pre-argparse)."""
    argv = sys.argv if argv is None else argv
    return "--no-env-tuning" not in argv


def compilation_cache_env(cache_dir: str) -> Dict[str, str]:
    """Env mutations that point the kernel build at `cache_dir` (pure)."""
    return {KERNEL_BUILD_ENV: cache_dir}


def compilation_cache_dir_from_argv(argv: Optional[List[str]] = None
                                    ) -> Optional[str]:
    """Peek `--compilation-cache-dir PATH` (or `=PATH`) from raw argv."""
    argv = sys.argv if argv is None else argv
    for i, a in enumerate(argv):
        if a == "--compilation-cache-dir" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--compilation-cache-dir="):
            return a.split("=", 1)[1]
    return None


def apply(env: Optional[Dict[str, str]] = None, *,
          echo: bool = False) -> Dict[str, str]:
    """Apply `tuned_env` to os.environ (or the given dict, for tests).
    Returns the mutations that were applied."""
    target = os.environ if env is None else env
    changes = tuned_env(dict(target))
    target.update(changes)
    if echo and changes:
        print("env tuning: " + " ".join(f"{k}={v}" for k, v in
                                        sorted(changes.items())),
              file=sys.stderr)
    return changes


def apply_from_argv(argv: Optional[List[str]] = None) -> Dict[str, str]:
    """What the launchers call at import time, before `import torch`: apply
    the tuning unless `--no-env-tuning` is on the command line, and point
    the kernel build at `--compilation-cache-dir` when it is given (its own
    flag, independent of the escape hatch)."""
    changes: Dict[str, str] = {}
    cache_dir = compilation_cache_dir_from_argv(argv)
    if cache_dir is not None:
        cc = compilation_cache_env(cache_dir)
        os.environ.update(cc)
        changes.update(cc)
    if wants_tuning(argv):
        changes.update(apply(echo=False))
    return changes
