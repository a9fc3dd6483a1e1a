"""Unified model API of the port (the decoder-only assembly of the
attention-based families, its training loss included), plus `synth_batch`.
Encoder-decoder families are not ported yet and raise; the reference's
`input_specs` (abstract shapes for its multi-pod dry-run) has no
counterpart on one card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike
from repro_torch.models import transformer

# Early-fusion image prefix length for VLM/early-fusion train batches.
IMG_PREFIX = 256


def _mod(cfg: ModelConfig):
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder families are not ported yet")
    return transformer


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                window_override: int = 0):
    return _mod(cfg).init_params(gen, cfg, dtype,
                                 window_override=window_override)


def loss_fn(params, cfg: ModelConfig, batch, *, remat: bool = True,
            window_override: int = 0):
    """(loss, {"ce", "aux"}) of a batch {"tokens", "labels"} [B, S] (and
    "patches" [B, n, frontend_embed_dim] for early fusion)."""
    return _mod(cfg).loss_fn(params, cfg, batch, remat=remat,
                             window_override=window_override)


def forward(params, cfg: ModelConfig, batch, **kw):
    return _mod(cfg).forward(params, cfg, batch, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, window_override: int = 0, *,
               device: DeviceLike = None):
    return _mod(cfg).init_cache(cfg, batch, max_len, dtype,
                                window_override=window_override, device=device)


def prefill(params, cfg: ModelConfig, batch, cache, *,
            window_override: int = 0):
    return _mod(cfg).prefill(params, cfg, batch, cache,
                             window_override=window_override)


def decode_step(params, cfg: ModelConfig, tokens, cache, index, *,
                window_override: int = 0):
    return _mod(cfg).decode_step(params, cfg, tokens, cache, index,
                                 window_override=window_override)


def synth_batch(gen: torch.Generator, cfg: ModelConfig, shape_or_batch,
                seq_len: Optional[int] = None,
                mode: str = "train") -> Dict[str, torch.Tensor]:
    """Random tokens (and labels for "train") drawn from `gen`, on its
    device; an early-fusion arch's "train" batch also gets standard-normal
    "patches" [B, min(IMG_PREFIX, S), frontend_embed_dim] in f32."""
    _mod(cfg)  # refuses encoder-decoder configs
    if isinstance(shape_or_batch, ShapeConfig):
        B, S, mode = (shape_or_batch.global_batch, shape_or_batch.seq_len,
                      shape_or_batch.mode)
    else:
        B, S = shape_or_batch, seq_len
    draw = lambda: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                 device=gen.device)
    batch = {"tokens": draw()}
    if mode == "train":
        batch["labels"] = draw()
    if cfg.frontend_embed_dim and mode == "train":
        batch["patches"] = torch.randn(
            (B, min(IMG_PREFIX, S), cfg.frontend_embed_dim), generator=gen,
            device=gen.device)
    return batch
