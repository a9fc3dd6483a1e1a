"""Unified model API of the port over the decoder-only assembly
(`models/transformer.py`) and the encoder-decoder one (`models/encdec.py`),
their training losses included, plus `input_specs` (meta tensors standing
for a shape's inputs, the planner's, `launch/dryrun.py`) and
`synth_batch`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike
from repro_torch.models import encdec, transformer

# Encoder memory length of an encoder-decoder's cache (the stubbed
# frontend's frames), as in the reference.
ENC_LEN = 4096
# Early-fusion image prefix length for VLM/early-fusion train batches.
IMG_PREFIX = 256


def _mod(cfg: ModelConfig):
    return encdec if cfg.is_encdec else transformer


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                window_override: int = 0):
    return _mod(cfg).init_params(gen, cfg, dtype,
                                 window_override=window_override)


def loss_fn(params, cfg: ModelConfig, batch, *, remat: bool = True,
            window_override: int = 0):
    """(loss, {"ce", "aux"}) of a batch {"tokens", "labels"} [B, S] (and
    "patches" [B, n, frontend_embed_dim] for early fusion, "frames" [B, Se,
    frontend_embed_dim] for an encoder-decoder)."""
    return _mod(cfg).loss_fn(params, cfg, batch, remat=remat,
                             window_override=window_override)


def forward(params, cfg: ModelConfig, batch, **kw):
    return _mod(cfg).forward(params, cfg, batch, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, window_override: int = 0, *,
               device: DeviceLike = None):
    if cfg.is_encdec:
        return encdec.init_cache(cfg, batch, max_len, dtype, enc_len=ENC_LEN,
                                 window_override=window_override,
                                 device=device)
    return transformer.init_cache(cfg, batch, max_len, dtype,
                                  window_override=window_override,
                                  device=device)


def prefill(params, cfg: ModelConfig, batch, cache, *,
            window_override: int = 0):
    return _mod(cfg).prefill(params, cfg, batch, cache,
                             window_override=window_override)


def decode_step(params, cfg: ModelConfig, tokens, cache, index, *,
                window_override: int = 0):
    return _mod(cfg).decode_step(params, cfg, tokens, cache, index,
                                 window_override=window_override)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta tensors of a shape's model inputs, the reference's shapes and
    dtypes: train and prefill take the whole sequence's tokens (and labels
    to train), an encoder-decoder bf16 "frames" [B, min(ENC_LEN, S),
    frontend_embed_dim], an early-fusion arch's train batch bf16 "patches"
    [B, IMG_PREFIX, frontend_embed_dim]; decode takes ONE new token (its
    seq_len cache is built apart). Tokens are int32, as the reference's
    (the port's own batches carry int64 ids)."""
    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    if shape.mode == "decode":
        return {"tokens": meta((B, 1), torch.int32)}
    specs = {"tokens": meta((B, S), torch.int32)}
    if shape.mode == "train":
        specs["labels"] = meta((B, S), torch.int32)
    if cfg.is_encdec:
        specs["frames"] = meta((B, min(ENC_LEN, S), cfg.frontend_embed_dim),
                               torch.bfloat16)
    elif cfg.frontend_embed_dim and shape.mode == "train":
        specs["patches"] = meta((B, IMG_PREFIX, cfg.frontend_embed_dim),
                                torch.bfloat16)
    return specs


def synth_batch(gen: torch.Generator, cfg: ModelConfig, shape_or_batch,
                seq_len: Optional[int] = None,
                mode: str = "train") -> Dict[str, torch.Tensor]:
    """Random tokens (and labels for "train") drawn from `gen`, on its
    device; an encoder-decoder's batch also gets standard-normal "frames"
    [B, min(ENC_LEN, S), frontend_embed_dim] in f32, an early-fusion arch's
    "train" batch standard-normal "patches" [B, min(IMG_PREFIX, S),
    frontend_embed_dim] in f32."""
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
    if cfg.is_encdec:
        batch["frames"] = torch.randn(
            (B, min(ENC_LEN, S), cfg.frontend_embed_dim), generator=gen,
            device=gen.device)
    elif cfg.frontend_embed_dim and mode == "train":
        batch["patches"] = torch.randn(
            (B, min(IMG_PREFIX, S), cfg.frontend_embed_dim), generator=gen,
            device=gen.device)
    return batch
