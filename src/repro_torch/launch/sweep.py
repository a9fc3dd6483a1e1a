"""Dry-run sweep of the port: every (architecture x input shape) on the
reference's 16 x 16 mesh as H100s (the 40 baselines), the 2 x 16 x 16 pass,
the paper-technique averaging variants, and the one-card pass (every
baseline on a 1 x 1 mesh). Each combo runs `python -m
repro_torch.launch.dryrun` in a subprocess of its own and writes a JSON
record under artifacts/dryrun_torch/, which `repro_torch.roofline` reads.

Usage:  PYTHONPATH=src python -m repro_torch.launch.sweep
            [--only baselines|multipod|averaging|onecard|all] [--force]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import ARCH_IDS
from repro_torch.configs.base import SHAPES

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                   "dryrun_torch")

# encoder-only or inapplicable skips would be listed here; all ten archs
# take all four shapes (the full-attention archs' long_500k runs a window,
# recorded as window_override)
SKIPS: set = set()


def combos(kind: str):
    """The reference's (arch, shape, tag) combos, then the one-card pass
    (tag "onecard", mesh 1x1)."""
    pairs = [(a, s) for a in ARCH_IDS for s in SHAPES if (a, s) not in SKIPS]
    if kind in ("baselines", "all"):
        for arch, shape in pairs:
            yield {"arch": arch, "shape": shape, "multi_pod": False,
                   "averaging": "exact", "tag": "base"}
    if kind in ("multipod", "all"):
        for arch, shape in pairs:
            yield {"arch": arch, "shape": shape, "multi_pod": True,
                   "averaging": "exact", "tag": "multipod"}
    if kind in ("averaging", "all"):
        # the paper's technique variants on train_4k, one per family exemplar
        for arch in ("granite-8b", "qwen2-moe-a2.7b", "mamba2-2.7b"):
            yield {"arch": arch, "shape": "train_4k", "multi_pod": False,
                   "averaging": "gossip", "rounds": 4, "tag": "gossip_r4"}
        yield {"arch": "granite-8b", "shape": "train_4k", "multi_pod": True,
               "averaging": "hierarchical", "rounds": 4, "tag": "hier_r4"}
    if kind in ("onecard", "all"):
        for arch, shape in pairs:
            yield {"arch": arch, "shape": shape, "multi_pod": False,
                   "mesh": "1x1", "averaging": "exact", "tag": "onecard"}


def artifact_path(c) -> str:
    return os.path.join(ART, f"{c['arch']}__{c['shape']}__{c['tag']}.json")


def run_combo(c, timeout=1200, out=None) -> dict:
    """One combo in a subprocess; its record goes to `out` (default: its
    artifact path)."""
    out = out or artifact_path(c)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           c["arch"], "--shape", c["shape"], "--averaging",
           c.get("averaging", "exact"), "--rounds", str(c.get("rounds", 1)),
           "--out", out]
    if c["multi_pod"]:
        cmd.append("--multi-pod")
    if c.get("mesh"):
        cmd += ["--mesh", c["mesh"]]
    if c.get("reduced"):
        cmd.append("--reduced")
    t0 = time.time()
    env = dict(os.environ)
    env["PYTHONPATH"] = env.get("PYTHONPATH", "src")
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env)
        ok = p.returncode == 0 and os.path.exists(out)
        err = "" if ok else (p.stderr[-2000:] or p.stdout[-2000:])
    except subprocess.TimeoutExpired:
        ok, err = False, "timeout"
    return {"combo": c, "ok": ok, "wall_s": round(time.time() - t0, 1),
            "err": err}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="all",
                    choices=["baselines", "multipod", "averaging", "onecard",
                             "all"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    os.makedirs(ART, exist_ok=True)
    results = []
    for c in combos(args.only):
        if not args.force and os.path.exists(artifact_path(c)):
            print(f"skip (exists): {c['arch']} {c['shape']} {c['tag']}")
            continue
        r = run_combo(c)
        status = "OK " if r["ok"] else "FAIL"
        print(f"{status} {c['arch']:24s} {c['shape']:12s} {c['tag']:9s} "
              f"{r['wall_s']:7.1f}s {r['err'][:200]}", flush=True)
        results.append(r)
    with open(os.path.join(ART, "_sweep_log.json"), "a") as f:
        json.dump(results, f, indent=1)
    fails = [r for r in results if not r["ok"]]
    print(f"\n{len(results) - len(fails)} ok, {len(fails)} failed")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
