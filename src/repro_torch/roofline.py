"""Roofline over the port's dry-run records (`launch/dryrun.py`), recast for
the H100, from `repro.roofline`.

Three terms per (arch x shape x mesh), each per rank (a record's counts
are one rank's):

    compute term    = analytic hardware FLOPs / chips / peak FLOP/s
    memory term     = the trace's HBM estimate / HBM bandwidth
    collective term = wire bytes of the step's messages / link bandwidth

The step bound is the largest term (no overlap credited), and the implied
MFU is the model FLOPs (6 N D to train, 2 N D to prefill, 2 N a decoded
token) over that bound times the chips' peak. An all-reduce moves about
twice its payload on a ring (reduce-scatter, then all-gather).

Hardware model: NVIDIA H100 SXM5 80GB HBM3 at 700 W: 989.4 TFLOP/s dense
bf16, 3.35 TB/s HBM, NVLink 4 at 450 GB/s a direction for each card
between the cards of a node. A mesh of more than one node's cards also
crosses the network between nodes, which is slower; the collective term
does not model it, so it is a lower bound there.
"""
from __future__ import annotations

import glob
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

CARD = "NVIDIA H100 SXM5 80GB HBM3, 700 W"
PEAK_FLOPS = 989.4e12  # dense bf16 / card
HBM_BW = 3.35e12  # bytes/s / card
LINK_BW = 450e9  # bytes/s / card, one direction, NVLink 4 within a node

# wire-byte multiplier per collective kind (ring algorithms)
WIRE_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0, "collective-permute": 1.0}


def _chips(rec: dict) -> int:
    if "chips" in rec:
        return int(rec["chips"])
    return math.prod(int(s) for s in rec["mesh"].split("x"))


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    mode: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_total: float
    useful_ratio: float
    peak_gib: float
    collectives: Dict[str, float]
    microbatches: int = 1
    chips: int = 1

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The step's lower bound: the largest of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization implied by the roofline step time."""
        if self.step_time_s <= 0:
            return 0.0
        return self.model_flops / (self.step_time_s * self.chips * PEAK_FLOPS)


def collective_wire_bytes(coll: Dict[str, float]) -> float:
    return sum(coll.get(kind, 0) * mult for kind, mult in WIRE_MULT.items())


def _shape(rec: dict, shape: Optional[ShapeConfig]) -> ShapeConfig:
    return shape or SHAPES[rec["shape"]]


def model_flops_for(rec: dict, shape: Optional[ShapeConfig] = None) -> float:
    """6*N*D for training (N = active params), 2*N per decoded token, 2*N*D
    for prefill. `shape` stands in for a record whose shape is not one of
    `SHAPES`."""
    n_active = rec["active_params"]
    shape = _shape(rec, shape)
    tokens = shape.global_batch * shape.seq_len
    if rec["mode"] == "train":
        return 6.0 * n_active * tokens
    if rec["mode"] == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # one token per sequence


def analytic_hw_flops(rec: dict, cfg: Optional[ModelConfig] = None,
                      shape: Optional[ShapeConfig] = None) -> float:
    """Hardware FLOPs executed: matmul FLOPs (k * N_active * tokens, k = 8
    for remat training = forward 2 + recompute 2 + backward 4; 2 for
    inference) plus attention score and value FLOPs at each layer's
    effective context. `cfg` and `shape` stand in for a record of a config
    or shape the registry does not hold."""
    from repro_torch.models.transformer import build_plan
    cfg = cfg or get_config(rec["arch"])
    shape = _shape(rec, shape)
    tokens = shape.global_batch * shape.seq_len
    k = 8.0 if rec["mode"] == "train" else 2.0
    total = k * rec["active_params"] * (
        tokens if rec["mode"] != "decode" else shape.global_batch)
    if cfg.num_heads:
        H, hd = cfg.num_heads, cfg.resolved_head_dim
        try:
            period, n_rep, tail = build_plan(cfg, rec.get("window_override", 0))
            specs = list(period) * n_rep + list(tail)
        except Exception:
            specs = []
        S = shape.seq_len
        attn = 0.0
        for sp in specs:
            if sp.kind not in ("attn", "mla"):
                continue
            if rec["mode"] == "decode":
                ctx = min(S, sp.window) if sp.window else S
                n_tok, mult = shape.global_batch, 1.0
            else:
                ctx = min(S, sp.window) if sp.window else S / 2.0
                n_tok = tokens
                mult = 3.0 if rec["mode"] == "train" else 1.0
            attn += 4.0 * n_tok * ctx * H * hd * mult
        total += attn
    return total


def _model_extent(rec: dict) -> int:
    """The model axis's extent: the last of the mesh's dims."""
    return int(rec["mesh"].split("x")[-1])


def analyze(rec: dict, cfg: Optional[ModelConfig] = None,
            shape: Optional[ShapeConfig] = None) -> Roofline:
    """The three terms of a record, per rank: the trace's counts need no
    trip scaling (it runs every layer); they are one rank's, except where
    the model axis is only planned (`temp_unsplit_over_model`): there they
    are one data rank's share, unsplit over the model axis, so the memory
    term takes the HBM estimate split evenly over that axis and the
    trace's total FLOPs are its count times the data extent. The compute term takes the analytic
    hardware FLOPs (the trace's own total is `useful_ratio`'s
    denominator), and the collective term the node-axis messages and the
    planned model-axis ones."""
    chips = _chips(rec)
    # a trace of one rank's blocks where the model axis executes
    model = (_model_extent(rec) if rec.get("temp_unsplit_over_model", True)
             else 1)
    scale = rec.get("trips", {}).get("scale", 1)
    hbm = rec.get("collectives", {}).get("hbm_bytes_est", 0.0)
    bytes_dev = (hbm if hbm else rec["cost"]["bytes"] * scale) / model
    coll = dict(rec.get("collectives", {}))
    for kind, v in rec.get("collectives_planned", {}).items():
        coll[kind] = coll.get(kind, 0) + v
    mf = model_flops_for(rec, shape)
    hw_dev = analytic_hw_flops(rec, cfg, shape) / chips
    hlo_total = rec["cost"]["flops"] * scale * (chips // model)
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        mode=rec["mode"], compute_s=hw_dev / PEAK_FLOPS,
        memory_s=bytes_dev / HBM_BW,
        collective_s=collective_wire_bytes(coll) / LINK_BW,
        model_flops=mf, hlo_flops_total=hlo_total,
        useful_ratio=mf / hlo_total if hlo_total else 0.0,
        peak_gib=rec["memory"]["peak_gib"], collectives=coll,
        microbatches=rec.get("microbatches", 1), chips=chips)


def load_artifacts(pattern: str = "artifacts/dryrun_torch/*.json"
                   ) -> List[dict]:
    out = []
    for path in sorted(glob.glob(pattern)):
        if os.path.basename(path).startswith("_"):
            continue
        with open(path) as f:
            out.append(json.load(f))
    return out


def table(rows: List[Roofline]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':8s} {'compute_s':>10s} "
           f"{'memory_s':>10s} {'collect_s':>10s} {'dominant':>10s} "
           f"{'useful':>7s} {'MFU':>6s} {'peak_GiB':>9s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:24s} {r.shape:12s} {r.mesh:8s} {r.compute_s:10.4f} "
            f"{r.memory_s:10.4f} {r.collective_s:10.4f} {r.dominant:>10s} "
            f"{r.useful_ratio:7.2f} {r.mfu:6.2f} {r.peak_gib:9.2f}")
    return "\n".join(lines)


def main():
    recs = load_artifacts()
    rows = [analyze(r) for r in recs]
    rows.sort(key=lambda r: (r.mesh, r.arch, r.shape))
    print(f"planned roofline: {CARD}: {PEAK_FLOPS / 1e12:.1f} TFLOP/s bf16, "
          f"{HBM_BW / 1e12:.2f} TB/s HBM, {LINK_BW / 1e9:.0f} GB/s NVLink")
    print(table(rows))


if __name__ == "__main__":
    main()
