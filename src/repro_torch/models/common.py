"""Parameter initializers of the port's models, drawing from an explicit
`torch.Generator` on the device where the parameters live.

The reference's mesh-aware sharding constraints (`pshard`, `set_mesh_rules`,
`mesh_rules`, `current_mesh`) do not apply on one card and are not ported:
every tensor here lives whole on one device. `stack_init` is not ported
either: the port keeps one parameter dict per layer instead of stacked
super-blocks (`models/transformer.py`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(gen: torch.Generator, shape, dtype, scale: float = 1.0,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, (scale / sqrt(fan_in))^2) drawn in f32, then cast; fan_in
    defaults to shape[-2] (the `in` axis of an [in, out] weight)."""
    fi = fan_in if fan_in is not None else (
        shape[-2] if len(shape) >= 2 else shape[-1])
    std = scale / math.sqrt(fi)
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


def ones_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)
