"""Encoder-decoder backbone of the port (SeamlessM4T-medium). The speech
frontend is stubbed, as in the reference: the encoder consumes precomputed
frame embeddings ("frames") projected to d_model. The decoder is causal
self-attention, cross-attention into the encoder memory, and an FFN.

The reference scans over stacked layer parameters; the port keeps one dict
per layer ({"encoder": [...], "decoder": [...]}, `convert.lm_params`
unstacks the reference's tree) and loops over them. Every attention call
routes as `layers.apply_attention` says: on the card the encoder's full
attention and the cross-attention of a prefill take the flash kernel
unmasked, the decoder's causal prefill takes it causal, and a decode step's
S = 1 calls take `blockwise_attention`. A decode step recomputes each
layer's cross k/v from the memory, as the reference does.

The cache is {"decoder": [{"k", "v"} per layer], "memory": [B, Se, d]},
updated in place: a prefill writes each layer's self k/v and replaces
"memory" with the encoder's output.

Frames are cast to the parameters' dtype before the projection (the
reference's input specs declare them in the model's bf16; given f32 frames
and bf16 weights, the reference would promote its whole encoder-decoder to
f32, which the port does not).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import dense_init, embed_init

Params = Dict[str, Any]


def _init_enc_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    return {
        "norm1": L.init_norm(gen, cfg.d_model, cfg.norm, dtype),
        "attn": L.init_attention(gen, cfg, dtype),
        "norm2": L.init_norm(gen, cfg.d_model, cfg.norm, dtype),
        "ffn": L.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn, dtype),
    }


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    return {
        "norm1": L.init_norm(gen, cfg.d_model, cfg.norm, dtype),
        "self_attn": L.init_attention(gen, cfg, dtype),
        "norm_x": L.init_norm(gen, cfg.d_model, cfg.norm, dtype),
        "cross_attn": L.init_attention(gen, cfg, dtype),
        "norm2": L.init_norm(gen, cfg.d_model, cfg.norm, dtype),
        "ffn": L.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn, dtype),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                window_override: int = 0) -> Params:
    """{"embed", "frontend_proj", "encoder": [dicts], "decoder": [dicts],
    "final_norm"}, drawn from `gen` on its device."""
    return {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "frontend_proj": dense_init(gen, (cfg.frontend_embed_dim,
                                          cfg.d_model), dtype),
        "encoder": [_init_enc_block(gen, cfg, dtype)
                    for _ in range(cfg.encoder_layers)],
        "decoder": [_init_dec_block(gen, cfg, dtype)
                    for _ in range(cfg.num_layers)],
        "final_norm": L.init_norm(gen, cfg.d_model, cfg.norm, dtype),
    }


def _enc_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
               positions: torch.Tensor, train: bool) -> torch.Tensor:
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    out, _ = L.apply_attention(p["attn"], cfg, h, positions, attn_mode="full",
                               train=train)
    x = x + out
    h = L.apply_norm(p["norm2"], x, cfg.norm)
    return x + L.apply_ffn(p["ffn"], h, cfg)


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor, *,
           remat: bool = False, train: bool = False) -> torch.Tensor:
    """frames [B, Se, frontend_embed_dim] -> memory [B, Se, d_model]. With
    `remat` (the training loss) each layer is checkpointed."""
    proj = params["frontend_proj"]
    x = frames.to(proj.dtype) @ proj
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for p in params["encoder"]:
        if remat:
            x = checkpoint(partial(_enc_block, cfg, train=train), p, x,
                           positions, use_reentrant=False)
        else:
            x = _enc_block(cfg, p, x, positions, train)
    return x


def _cross_kv(cfg: ModelConfig, p: Params, memory: torch.Tensor):
    B, S, _ = memory.shape
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = (memory @ p["wk"]).reshape(B, S, kh, hd)
    v = (memory @ p["wv"]).reshape(B, S, kh, hd)
    return k, v


def _dec_block(cfg: ModelConfig, p: Params, x, positions, memory, cache,
               cache_index, window_override: int, train: bool = False):
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    mode = "window" if window_override else "causal"
    out, _ = L.apply_attention(p["self_attn"], cfg, h, positions,
                               attn_mode=mode, window=window_override,
                               cache=cache, cache_index=cache_index,
                               train=train)
    x = x + out
    h = L.apply_norm(p["norm_x"], x, cfg.norm)
    ck, cv = _cross_kv(cfg, p["cross_attn"], memory)
    out, _ = L.apply_attention(p["cross_attn"], cfg, h, positions,
                               attn_mode="full", cross_kv=(ck, cv),
                               train=train)
    x = x + out
    h = L.apply_norm(p["norm2"], x, cfg.norm)
    return x + L.apply_ffn(p["ffn"], h, cfg)


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, remat: bool = False, train: bool = False,
            window_override: int = 0, cache: Optional[Params] = None,
            cache_index=None, memory: Optional[torch.Tensor] = None):
    """batch: {"frames": [B, Se, F] (unless `memory` is given), "tokens":
    [B, Sd]}. Returns (logits, aux = 0, cache); the cache, if given, is
    updated in place. `train` and `remat` as in `transformer.forward`."""
    if memory is None:
        memory = encode(params, cfg, batch["frames"], remat=remat,
                        train=train)
    # the reference scales in f32 (jnp.sqrt of an int32), then casts
    x = L.embed_lookup(params["embed"], batch["tokens"])
    x = (x.float() * math.sqrt(cfg.d_model)).to(memory.dtype)
    B, Sd = batch["tokens"].shape
    base = 0 if cache_index is None else cache_index
    pos = torch.arange(Sd, device=x.device)
    if torch.is_tensor(base) and base.dim() == 1:
        positions = pos[None] + base[:, None]
    else:
        positions = (pos + base)[None].expand(B, Sd)
    for i, p in enumerate(params["decoder"]):
        c = None if cache is None else cache["decoder"][i]
        if remat and cache is None:
            blk = partial(_dec_block, cfg, cache=None, cache_index=None,
                          window_override=window_override, train=train)
            x = checkpoint(blk, p, x, positions, memory, use_reentrant=False)
        else:
            x = _dec_block(cfg, p, x, positions, memory, c, cache_index,
                           window_override, train)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = L.unembed_logits(params["embed"], x)
    if cache is not None:
        cache["memory"] = memory
    return logits, torch.zeros((), dtype=torch.float32, device=x.device), cache


def loss_fn(params: Params, cfg: ModelConfig, batch, *, remat: bool = True,
            window_override: int = 0):
    """(ce, {"ce", "aux": 0}) of a batch {"frames", "tokens", "labels"},
    with attention on its differentiable route."""
    logits, _, _ = forward(params, cfg, batch, remat=remat, train=True,
                           window_override=window_override)
    ce = L.cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, enc_len: int = 4096,
               window_override: int = 0, *,
               device: DeviceLike = None) -> Params:
    """{"decoder": [{"k", "v"} [batch, max_len, KH, hd] per layer], "memory":
    [batch, enc_len, d_model]}, zeroed."""
    dev = resolve_device(device)
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    layers: List[Params] = [{"k": zeros(batch, max_len, kh, hd),
                             "v": zeros(batch, max_len, kh, hd)}
                            for _ in range(cfg.num_layers)]
    return {"decoder": layers, "memory": zeros(batch, enc_len, cfg.d_model)}


def prefill(params: Params, cfg: ModelConfig, batch, cache, *,
            window_override: int = 0):
    logits, _, cache = forward(params, cfg, batch, cache=cache, cache_index=0,
                               window_override=window_override)
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, tokens, cache, index, *,
                window_override: int = 0):
    logits, _, cache = forward(params, cfg, {"tokens": tokens}, cache=cache,
                               cache_index=index, memory=cache["memory"],
                               window_override=window_override)
    return logits, cache
