"""Parameter initializers of the port's models, drawing from an explicit
`torch.Generator` on the device where the parameters live, or from
`MetaGenerator` for a shape-only init on the meta device (the planner's,
`launch/dryrun.py`).

The reference's mesh-aware sharding constraints (`pshard`, `set_mesh_rules`,
`mesh_rules`, `current_mesh`) are not ported: every tensor here lives whole
on one device. A sharded node axis needs none of them (each rank holds its
nodes' parameters whole, `repro_torch/dist.py`); they shard a model axis,
which `launch/sharding.py` and `launch/dryrun.py` plan but nothing executes
yet (ROADMAP.md queue 1). `stack_init` is not ported either: the port keeps
one parameter dict per layer instead of stacked super-blocks
(`models/transformer.py`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


class MetaGenerator:
    """Stands for a `torch.Generator` in a shape-only init: every draw is an
    empty tensor on the meta device, which has no generator. The CPU and
    card draws do not change."""

    device = torch.device("meta")


def _draw(gen, shape) -> torch.Tensor:
    """N(0, 1) in f32 of `shape` from `gen`, on its device."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, shape, dtype, scale: float = 1.0,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, (scale / sqrt(fan_in))^2) drawn in f32, then cast; fan_in
    defaults to shape[-2] (the `in` axis of an [in, out] weight)."""
    fi = fan_in if fan_in is not None else (
        shape[-2] if len(shape) >= 2 else shape[-1])
    std = scale / math.sqrt(fi)
    return _draw(gen, shape).mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return _draw(gen, shape).mul_(0.02).to(dtype)


def ones_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)
