"""Decoder-only transformer assembly of the port: the dense GQA, MLA, MoE,
early-fusion, SSD (ssm) and RG-LRU hybrid families.

The reference groups layers into super-blocks and scans over stacked
super-block parameters (`lax.scan`) to keep compile time O(period). The port
runs eagerly, so it keeps one parameter dict per layer and one KV-cache dict
per layer, in the order `layer_specs` gives, and loops over them in Python;
`convert.lm_params` interleaves the reference's stacked tree into that
order. `build_plan` keeps the reference's (period, n_repeats, tail) form:
(ssd,) x 64 for the ssm family, and for the hybrid family its period
(rglru, rglru, local attention) repeated, plus a tail of the period's
first layers.

Blocks: GQA attention (causal, sliding-window with a full or a
ring-buffer cache, chunked-local, iRoPE NoPE layers) and MLA, with dense
or MoE FFNs (the layers' aux losses summed); the Mamba-2 SSD block
(`models/ssm.py`, no FFN) and the RG-LRU block (`models/rglru.py`), whose
caches are per-layer recurrent states; the early-fusion frontend
projection of precomputed patch embeddings; and the training loss
(`loss_fn`) with activation checkpointing per layer.

Under an installed model axis (`models/common.py` `mesh_rules`) the
forward and the loss run on the rank's blocks through the layers'
tensor-parallel forms (`models/layers.py`, `models/moe.py`,
`models/ssm.py`, `models/rglru.py`): GQA and MLA heads, dense and MoE
FFNs (experts split on E, or on F where the extent does not divide E),
the SSD's heads, the RG-LRU's channels, the vocab, and early fusion's
frontend_proj, whose d_model columns a rank projects and all-gathers. A
checkpointed layer recomputes its forward, its model-group messages
included, in the backward.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as SSM
from repro_torch.models.common import (current_mesh, dense_init,
                                       embed_init, gather_columns)

Params = Dict[str, Any]


class LayerSpec(NamedTuple):
    kind: str  # attn | mla | rglru | ssd
    attn_mode: str = "causal"  # causal | window | chunk
    window: int = 0
    use_rope: bool = True
    has_moe: bool = False


def build_plan(cfg: ModelConfig, window_override: int = 0
               ) -> Tuple[Tuple[LayerSpec, ...], int, Tuple[LayerSpec, ...]]:
    """Returns (period_specs, n_repeats, tail_specs), as the reference."""

    def attn_spec(i: int) -> LayerSpec:
        kind = "mla" if cfg.mla is not None else "attn"
        mode, win, rope = "causal", 0, True
        if cfg.sliding_window:
            mode, win = "window", cfg.sliding_window
        if cfg.chunk_attn_window:
            if (i % cfg.global_attn_every) == cfg.global_attn_every - 1:
                mode, win, rope = "causal", 0, False  # iRoPE global layer: NoPE
            else:
                mode, win = "chunk", cfg.chunk_attn_window
        if window_override and mode == "causal":
            mode, win = "window", window_override
        has_moe = cfg.moe is not None and (i % cfg.moe.every == 0)
        return LayerSpec(kind, mode, win, rope, has_moe)

    if cfg.family == "ssm":
        return (LayerSpec("ssd"),), cfg.num_layers, ()
    if cfg.rglru is not None:
        r = cfg.rglru
        period = tuple(
            LayerSpec("attn", "window", r.local_window, True,
                      cfg.moe is not None)
            if i in r.attn_positions else LayerSpec("rglru")
            for i in range(r.pattern_period))
        return (period, cfg.num_layers // r.pattern_period,
                period[: cfg.num_layers % r.pattern_period])
    if cfg.chunk_attn_window:
        period = tuple(attn_spec(i) for i in range(cfg.global_attn_every))
        n = cfg.num_layers // cfg.global_attn_every
        tail = period[: cfg.num_layers % cfg.global_attn_every]
        return period, n, tail
    return (attn_spec(0),), cfg.num_layers, ()


def layer_specs(cfg: ModelConfig, window_override: int = 0) -> List[LayerSpec]:
    """Every layer's spec in the order the forward pass runs them: the
    period repeated n times, then the tail."""
    period, n, tail = build_plan(cfg, window_override)
    return list(period) * n + list(tail)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


_INIT_MIXER = {"attn": L.init_attention, "mla": L.init_mla,
               "rglru": R.init_rglru, "ssd": SSM.init_ssd}


def _init_block(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                dtype) -> Params:
    """{"norm1", "attn" (the mixer: attention, MLA, RG-LRU or SSD), "norm2",
    "ffn"}; an SSD block is the whole layer (no norm2, no FFN)."""
    p: Params = {"norm1": L.init_norm(gen, cfg.d_model, cfg.norm, dtype),
                 "attn": _INIT_MIXER[spec.kind](gen, cfg, dtype)}
    if spec.kind == "ssd":
        return p
    p["norm2"] = L.init_norm(gen, cfg.d_model, cfg.norm, dtype)
    if spec.has_moe:
        p["ffn"] = M.init_moe(gen, cfg, dtype)
    elif cfg.d_ff:
        p["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn, dtype)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                window_override: int = 0) -> Params:
    """Random parameters drawn from `gen`, on the generator's device:
    {"embed", "final_norm", "blocks": [one dict per layer], "frontend_proj"
    [frontend_embed_dim, d_model] for early fusion, "unembed" when the
    embeddings are not tied}."""
    specs = layer_specs(cfg, window_override)
    p: Params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "final_norm": L.init_norm(gen, cfg.d_model, cfg.norm, dtype),
        "blocks": [_init_block(gen, cfg, spec, dtype) for spec in specs],
    }
    if cfg.frontend_embed_dim:
        p["frontend_proj"] = dense_init(gen, (cfg.frontend_embed_dim,
                                              cfg.d_model), dtype)
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype)
    return p


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _apply_block(cfg: ModelConfig, spec: LayerSpec, p: Params, x, positions,
                 cache=None, cache_index=None, train: bool = False):
    """Returns (x, cache, aux): the layer's MoE aux loss, else None."""
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    if spec.kind == "mla":
        out, new_cache = L.apply_mla(
            p["attn"], cfg, h, positions, attn_mode=spec.attn_mode,
            window=spec.window, cache=cache, cache_index=cache_index)
    elif spec.kind == "rglru":
        out, new_cache = R.apply_rglru(p["attn"], cfg, h, state=cache)
    elif spec.kind == "ssd":
        out, new_cache = SSM.apply_ssd(p["attn"], cfg, h, state=cache)
    else:
        out, new_cache = L.apply_attention(
            p["attn"], cfg, h, positions, attn_mode=spec.attn_mode,
            window=spec.window, use_rope=spec.use_rope, cache=cache,
            cache_index=cache_index, train=train)
    x = x + out
    aux = None
    if "ffn" in p:
        h2 = L.apply_norm(p["norm2"], x, cfg.norm)
        if spec.has_moe:
            out2, aux = M.apply_moe(p["ffn"], cfg, h2)
        else:
            out2 = L.apply_ffn(p["ffn"], h2, cfg)
        x = x + out2
    return x, new_cache, aux


def _embed(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]):
    x = L.embed_lookup(params["embed"], batch["tokens"],
                       L.vocab_split(params["embed"], cfg))
    x = x * torch.tensor(float(cfg.d_model), dtype=x.dtype).sqrt()
    if cfg.frontend_embed_dim and "patches" in batch:
        # early fusion: precomputed modality embeddings [B, n, F] take the
        # place of the first n positions (the frontend itself is stubbed)
        w = params["frontend_proj"]
        pe = batch["patches"].to(x.dtype) @ w
        if current_mesh() is not None and L._is_block(w, 1, cfg.d_model):
            pe = gather_columns(pe)  # the rank's d_model columns, joined
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def _unembed(cfg: ModelConfig, params: Params, x: torch.Tensor):
    emb = params.get("unembed", params["embed"])
    return L.unembed_logits(emb, x, L.vocab_split(emb, cfg))


# ---------------------------------------------------------------------------
# Forward / loss (train + prefill), decode
# ---------------------------------------------------------------------------


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, window_override: int = 0, cache: Optional[List[Params]] = None,
            cache_index=None, remat: bool = False, train: bool = False):
    """Returns (logits, aux_loss, cache): the aux loss is the sum of the MoE
    layers' (0 without MoE). `cache` (one dict per layer) is updated in
    place; `cache_index` is an int (or 0-dim) write offset or a [B] vector
    of per-row positions (S == 1).

    `train=True` routes attention through the differentiable
    `blockwise_attention` (`layers.apply_attention`); `remat=True` (no
    cache) checkpoints each layer, so the backward recomputes one layer's
    activations at a time, as the reference's `jax.checkpoint` per
    super-block of its scan does (granite's super-block is one layer)."""
    specs = layer_specs(cfg, window_override)
    x = _embed(cfg, params, batch)
    B, Sq = batch["tokens"].shape
    base = 0 if cache_index is None else cache_index
    pos = torch.arange(Sq, device=x.device)
    if torch.is_tensor(base) and base.dim() == 1:
        positions = pos[None] + base[:, None]  # per-slot decode
    else:
        positions = (pos + base)[None].expand(B, Sq)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(specs):
        if remat and cache is None:
            blk = partial(_apply_block, cfg, spec, train=train)
            x, _, a = checkpoint(blk, params["blocks"][i], x, positions,
                                 use_reentrant=False)
        else:
            x, _, a = _apply_block(cfg, spec, params["blocks"][i], x,
                                   positions,
                                   cache=None if cache is None else cache[i],
                                   cache_index=cache_index, train=train)
        if a is not None:
            aux = aux + a
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return _unembed(cfg, params, x), aux, cache


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, remat: bool = True, window_override: int = 0):
    """The training loss: (loss, {"ce", "aux"}), the mean cross-entropy over
    labels >= 0 plus the routers' auxiliary loss weighted by
    `router_aux_loss_weight` over the layer count (0 without MoE), with
    attention on its differentiable route."""
    logits, aux, _ = forward(params, cfg, batch, remat=remat, train=True,
                             window_override=window_override)
    ce = L.cross_entropy(logits, batch["labels"], L.vocab_split(
        params.get("unembed", params["embed"]), cfg))
    aux_w = cfg.moe.router_aux_loss_weight if cfg.moe is not None else 0.0
    n_layers = max(cfg.num_layers, 1)
    loss = ce + aux_w * aux / n_layers
    return loss, {"ce": ce, "aux": aux / n_layers}


# ---------------------------------------------------------------------------
# KV caches and recurrent states
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, window_override: int = 0, *,
               device: DeviceLike = None) -> List[Params]:
    """One zeroed cache per layer: {"k", "v"} [batch, L, KH, hd] for GQA,
    L = max_len, or min(max_len, W) for a sliding-window layer with
    `cfg.ring_buffer_cache`; {"ckv" [batch, max_len, kv_lora_rank],
    "krope" [batch, max_len, 1, qk_rope_head_dim]} for MLA; the recurrent
    state {"h" (f32), "conv"} of an RG-LRU or SSD layer."""
    dev = resolve_device(device)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    cache = []
    for spec in layer_specs(cfg, window_override):
        if spec.kind == "rglru":
            cache.append(R.init_rglru_state(cfg, batch, dtype, device=dev))
            continue
        if spec.kind == "ssd":
            cache.append(SSM.init_ssd_state(cfg, batch, dtype, device=dev))
            continue
        if spec.kind == "mla":
            m = cfg.mla
            cache.append({"ckv": zeros(batch, max_len, m.kv_lora_rank),
                          "krope": zeros(batch, max_len, 1,
                                         m.qk_rope_head_dim)})
            continue
        eff = max_len
        if cfg.ring_buffer_cache and spec.attn_mode == "window" and spec.window:
            eff = min(max_len, spec.window)
        kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        cache.append({"k": zeros(batch, eff, kh, hd),
                      "v": zeros(batch, eff, kh, hd)})
    return cache


def prefill(params: Params, cfg: ModelConfig, batch, cache, *,
            window_override: int = 0):
    logits, _, cache = forward(params, cfg, batch, cache=cache, cache_index=0,
                               window_override=window_override)
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, tokens, cache, index, *,
                window_override: int = 0):
    """tokens: [B, 1]; index: int (current length) or [B] tensor (per-slot
    lengths, continuous batching). Returns (logits, cache)."""
    logits, _, cache = forward(params, cfg, {"tokens": tokens}, cache=cache,
                               cache_index=index,
                               window_override=window_override)
    return logits, cache
