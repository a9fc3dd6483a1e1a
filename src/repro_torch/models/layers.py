"""Core neural layers of the port's decoders: norms, RoPE, masked blockwise
attention (causal / sliding-window / chunked-local), the GQA attention block
with a KV cache (full, or a W-slot ring for sliding-window layers), the MLA
block with its latent cache, the vocab projection and the gated FFN.

Weights keep the reference's [in, out] layout (`x @ W`), so carrying them
across is a copy. GQA attention of more than 16 fresh query positions
(a causal prefill, an encoder's full attention, a decoder's
cross-attention into its encoder memory) goes through
`kernels.ops.attention` (the Hopper flash kernel on the card, which has no
backward); every other attention call, MLA's included, and every call of
the training loss (`train=True`), is the plain, differentiable
`blockwise_attention` below, where the reference runs jnp code too.

Under a model axis (`models/common.py` `mesh_rules`) each rank holds its
model index's blocks of the reference's placements (`launch/sharding.py`
`_NAME_SPECS`, sanitized as `_resolve` does): its columns of wq, wk, wv,
w_gate and w_up and its rows of wo and w_down, or the whole leaf where the
extent does not divide the dim. The column blocks need not hold whole
heads (granite-8b's 8 KV heads over 16 ranks give each half a head): a
rank runs every head that overlaps its rows of wo, and their KV heads,
whole, gathering the pieces it lacks from the ranks that share the head
(`_head_split`, `models.common.gather_from_model`) before the head's
qk-norm and RoPE, which need all of it; it keeps the output columns of its
wo rows, whose partial sums are added over the model group in f32 and
cast once (`_row_split`). A head two ranks use runs on both, and its
gradients are summed back to the ranks that own its columns. Where the
extent divides the heads and KV heads this is the Megatron split, with no
gather. An FFN whose width the extent does not divide runs whole on every
rank, without a message. The vocab-parallel embedding holds the rank's
vocab rows (`embed_lookup`, `unembed_logits`) and `cross_entropy` reduces
its log-sum-exp and gold logit over the group. Where the extent does not
divide the vocab, the embedding holds the rank's d_model columns (the
reference's `_ALT_SPECS` fallback): the lookup all-gathers the columns,
the unembedding sums the columns' partial logits over the group, and the
loss runs on whole logits (`vocab_split`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed import ReduceOp

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import all_reduce_, model_index
from repro_torch.kernels import ops
from repro_torch.models.common import (copy_to_model, current_mesh,
                                       dense_init, gather_columns,
                                       gather_from_model, ones_init,
                                       reduce_from_model)

Params = Dict[str, Any]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
FLASH_MIN_SEQ = 17  # prompts of 16 tokens or fewer take the masked dot


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(gen: torch.Generator, dim: int, kind: str,
              dtype=torch.float32) -> Params:
    p = {"scale": ones_init(gen, (dim,), dtype)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=gen.device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def rms_norm_headdim(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free QK-norm over the head dim (Chameleon / Llama-4 style)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # [..., S, d/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Masked blockwise attention
# ---------------------------------------------------------------------------


def _mask_block(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                window: int, chunk: int, kv_valid: Any) -> torch.Tensor:
    """Boolean [..., q, k] mask from absolute positions. q_pos: [..., q] (a
    leading batch axis stands in for the reference's vmap over rows);
    kv_valid: None, an int or a [...] tensor of valid key counts.
    window/chunk of 0 disable."""
    qp = q_pos[..., :, None]
    kp = k_pos
    m = torch.ones(q_pos.shape + k_pos.shape, dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    if chunk > 0:
        m = m & ((kp // chunk) == (qp // chunk))
    if torch.is_tensor(kv_valid):  # [1, q, k] and [B] broadcast to [B, q, k]
        kv_valid = kv_valid[..., None, None]
    if kv_valid is not None:
        m = m & (kp < kv_valid)
    return m


def blockwise_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KH, D]
    v: torch.Tensor,  # [B, Sk, KH, Dv]
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 0,
    q_offset: Any = 0,  # int, 0-dim or [B]: absolute position of q[:, 0]
    kv_valid: Any = None,  # None, int, 0-dim or [B]: #valid cache slots
    kv_block: int = 512,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention; never materializes [Sq, Sk] for Sk > kv_block.

    The plain PyTorch form of the reference's `blockwise_attention`: q is
    rounded to k's dtype and p to v's dtype before their products, which
    accumulate in f32. GQA: head h reads kv head h // G (the reference's
    `jnp.repeat(axis=2)`), computed on a [B, KH, G, ...] view of q instead of
    a repeated copy of k and v. Sq <= 16 is one masked dot over all of k;
    longer queries scan kv blocks of `kv_block`."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KH
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qg = q.to(k.dtype).float().reshape(B, Sq, KH, G, D).permute(0, 2, 3, 1, 4)
    # positions stay Python ints where they are: no host-to-device copies
    q_pos = torch.arange(Sq, device=dev)
    if torch.is_tensor(q_offset):
        qp = q_pos[None] + q_offset.reshape(-1, 1)  # [1 or B, Sq]
    else:
        qp = (q_pos + q_offset)[None]
    kvv = Sk if kv_valid is None else kv_valid

    def scores(kblk: torch.Tensor, k0: int) -> torch.Tensor:
        """Masked f32 scores [B, KH, G, Sq, nk] of keys k0 .. k0 + nk - 1."""
        kt = kblk.float().permute(0, 2, 3, 1)[:, :, None]  # [B, KH, 1, D, nk]
        s = (qg @ kt) * scale
        k_pos = k0 + torch.arange(kblk.shape[1], device=dev)
        mask = _mask_block(qp, k_pos, causal=causal, window=window,
                           chunk=chunk, kv_valid=kvv)  # [1 or B, Sq, nk]
        return s.masked_fill(~mask[:, None, None], NEG_INF)

    def pv(p: torch.Tensor, vblk: torch.Tensor) -> torch.Tensor:
        vf = vblk.float().permute(0, 2, 1, 3)[:, :, None]  # [B, KH, 1, nk, Dv]
        return p.to(vblk.dtype).float() @ vf

    def heads(o: torch.Tensor) -> torch.Tensor:  # [B, KH, G, Sq, Dv] ->
        return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(v.dtype)

    if Sq <= 16:
        # decode fast path: one masked dot over the whole cache
        p = torch.softmax(scores(k, 0), dim=-1)
        return heads(pv(p, v))

    nblocks = max(1, (Sk + kv_block - 1) // kv_block)
    pad = nblocks * kv_block - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    m = torch.full((B, KH, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KH, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KH, G, Sq, Dv), dtype=torch.float32, device=dev)
    for i in range(nblocks):
        blk = slice(i * kv_block, (i + 1) * kv_block)
        s = scores(k[:, blk], i * kv_block)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)  # zero out fully-masked rows later via l
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + pv(p, v[:, blk])
        m = m_new
    return heads(acc / l[..., None].clamp_min(1e-30))


# ---------------------------------------------------------------------------
# GQA attention block (with optional KV cache)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KH = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init(gen, (d, H * hd), dtype),
        "wk": dense_init(gen, (d, KH * hd), dtype),
        "wv": dense_init(gen, (d, KH * hd), dtype),
        "wo": dense_init(gen, (H * hd, d), dtype, fan_in=H * hd),
    }


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0,
           chunk: int = 0) -> torch.Tensor:
    """Attention of fresh k/v through `ops.attention`, positions of q and k
    both counted from 0: q [B, Sq, H, D], k/v [B, Sk, KH, D] -> [B, Sq, H,
    D] in k's dtype."""
    G = q.shape[2] // k.shape[2]
    qh = q.to(k.dtype).permute(0, 2, 1, 3).contiguous()
    kh = k.repeat_interleave(G, dim=2).permute(0, 2, 1, 3).contiguous()
    vh = v.repeat_interleave(G, dim=2).permute(0, 2, 1, 3).contiguous()
    out = ops.attention(qh, kh, vh, causal=causal, window=window, chunk=chunk)
    return out.permute(0, 2, 1, 3)


class _Heads(NamedTuple):
    """One rank's share of a GQA layer whose wq columns (and wo rows) the
    model axis splits (`_head_split`)."""

    rows: Tuple[int, int]  # its rows of wo: the output columns it keeps
    q: Tuple[int, int]  # [h0, h1): the heads that overlap them
    kv: Tuple[int, int]  # [k0, k1): their KV heads
    g_q: int  # the ranks of the block whose wq columns hold its heads
    g_kv: int  # the same for wk and wv; 0 where they are kept whole


def _is_block(leaf: torch.Tensor, dim: int, whole: int) -> bool:
    """Whether the rank holds a model-axis block of `leaf` along `dim`
    (`whole` wide unsplit) and not all of it: `launch/sharding.py` splits
    the dim where the extent divides it and `_sanitize` keeps the whole
    leaf where it does not (every leaf is whole without a model axis)."""
    return leaf.shape[dim] != whole


def _head_split(cfg: ModelConfig, mesh, p: Params) -> Optional[_Heads]:
    """This rank's `_Heads` over `mesh`'s model axis from the blocks of
    `p` it holds, or None where wq is whole (no model axis, or one whose
    extent does not divide its H * hd columns: wk, wv and wo are whole
    too), so every rank runs every head. A split of C columns gives each
    rank C / m of them; the ranks whose columns share a head form blocks
    of g = hd / gcd(hd, C / m) consecutive model indices (g divides m),
    each holding whole heads."""
    hd, H, KH = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    if not _is_block(p["wq"], -1, H * hd):
        return None
    i, width = model_index(mesh), p["wq"].shape[-1]
    rows = (i * width, (i + 1) * width)
    h0, h1 = rows[0] // hd, -(-rows[1] // hd)
    G = H // KH
    block = lambda w: hd // math.gcd(hd, w)
    return _Heads(rows, (h0, h1), (h0 // G, (h1 - 1) // G + 1), block(width),
                  block(p["wk"].shape[-1])
                  if _is_block(p["wk"], -1, KH * hd) else 0)


def _take_heads(cols: torch.Tensor, g: int, lo: int, hi: int,
                hd: int) -> torch.Tensor:
    """Heads [lo, hi) [B, S, hi - lo, hd] of the projection whose [B, S, c]
    columns the rank holds, its block of g model indices holding them
    whole (`gather_from_model`)."""
    start = model_index(current_mesh()) // g * g * cols.shape[-1]
    full = gather_from_model(cols, g)
    return full[..., lo * hd - start:hi * hd - start].reshape(
        *cols.shape[:2], -1, hd)


def _split_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
               heads: _Heads,
               memory: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, ...]:
    """q [B, S, h1 - h0, hd] of the rank's heads and k, v [B, Sk, ., hd] of
    their KV heads, whole: each projected from the columns the rank holds,
    the pieces it lacks gathered from its block (`gather_from_model`); k
    and v from x, or from the encoder's `memory` (cross-attention, Sk its
    length). k and v kept whole are computed whole, each rank's gradient
    of them summed over the model group (`copy_to_model` on the product).
    Where the rank's heads do not read their KV heads as
    `blockwise_attention`'s h // G' does (G' = its heads over its KV
    heads), k and v come back one per head."""
    kv_in = x if memory is None else memory
    B, Sk, _ = kv_in.shape
    hd = cfg.resolved_head_dim
    xs = copy_to_model(x)
    kvs = xs if memory is None else copy_to_model(memory)
    (h0, h1), (k0, k1) = heads.q, heads.kv
    q = _take_heads(xs @ p["wq"], heads.g_q, h0, h1, hd)
    if heads.g_kv:
        k = _take_heads(kvs @ p["wk"], heads.g_kv, k0, k1, hd)
        v = _take_heads(kvs @ p["wv"], heads.g_kv, k0, k1, hd)
    else:
        whole = lambda w: copy_to_model(kv_in @ w)[
            ..., k0 * hd:k1 * hd].reshape(B, Sk, -1, hd)
        k, v = whole(p["wk"]), whole(p["wv"])
    G = cfg.num_heads // cfg.num_kv_heads
    reads = [h // G - k0 for h in range(h0, h1)]
    Gn, rest = divmod(h1 - h0, k1 - k0)
    if rest or reads != [j // Gn for j in range(h1 - h0)]:
        idx = torch.tensor(reads, device=x.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return q, k, v


def _out_proj(h: torch.Tensor, wo: torch.Tensor,
              heads: Optional[_Heads], hd: int) -> torch.Tensor:
    """The attention output [B, S, H' * hd] of the rank's heads through
    its rows of wo (`_row_split`), or h @ wo where it runs every head."""
    if heads is None:
        return h @ wo
    lo = heads.rows[0] - heads.q[0] * hd
    return _row_split(h[..., lo:lo + heads.rows[1] - heads.rows[0]], wo)


def apply_attention(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S] absolute positions
    *,
    attn_mode: str = "causal",  # causal | window | chunk | full (encoder)
    window: int = 0,
    use_rope: bool = True,
    cache: Optional[Params] = None,  # {"k","v"} [B, S_max or W, KH, hd]
    cache_index: Any = None,  # int or 0-dim (write offset of the batch), or
    # a [B] vector (per-slot decode, continuous batching; requires S == 1)
    memory: Optional[torch.Tensor] = None,  # cross-attention's [B, Sk, D]
    train: bool = False,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (out [B, S, D], cache). The cache is updated IN PLACE (the
    reference returns a new one) and returned for the caller's convenience.

    Routing, fixed by shape and by `train`: a call of S > 16 positions with
    no cache, or with the Python integer cache_index 0 (prefill), runs
    `ops.attention` on the fresh k/v (the flash kernel on the card, or
    raise), masked or not, at any key count; every other call (decode
    against the cache, prompts of 16 tokens or fewer, a multi-token call at
    a non-zero index) runs `blockwise_attention`. `train=True` (the training loss)
    always runs `blockwise_attention`, which autograd differentiates: the
    flash kernel has no backward, in the reference as here, and the
    reference trains through its jnp `blockwise_attention` too. A
    sliding-window layer whose cache is a ring of W <= window slots
    (`cfg.ring_buffer_cache`) takes `_ring_attention`.

    Cross-attention (the encoder's `memory` [B, Sk, D], whose k and v the
    layer projects) attends without a mask, RoPE, a qk-norm on k or a
    cache write; it is fresh whatever the cache, so it routes as a prefill
    does. Over a model axis its q heads come from x and their k and v from
    the memory, which is replicated (`_split_qkv`)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    heads = _head_split(cfg, current_mesh(), p)
    cross = memory is not None
    if heads is None:  # every head on this rank
        H, KH = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
        q = (x @ p["wq"]).reshape(B, S, H, hd)
        kv_in = memory if cross else x
        k = (kv_in @ p["wk"]).reshape(B, kv_in.shape[1], KH, hd)
        v = (kv_in @ p["wv"]).reshape(B, kv_in.shape[1], KH, hd)
    else:  # the rank's heads over a model axis
        q, k, v = _split_qkv(p, cfg, x, heads, memory)
        H = q.shape[2]
    if cfg.use_qk_norm:
        q = rms_norm_headdim(q)
        if not cross:
            k = rms_norm_headdim(k)
    if use_rope and not cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    causal = attn_mode in ("causal", "window", "chunk") and not cross
    eff_window = window if attn_mode == "window" else 0
    eff_chunk = window if attn_mode == "chunk" else 0
    if cross:
        cache = None

    if (cache is not None and cfg.ring_buffer_cache and attn_mode == "window"
            and window and cache["k"].shape[1] <= window):
        out = _ring_attention(q, k, v, cache, cache_index, window=window)
        return _out_proj(out.reshape(B, S, H * hd).to(p["wo"].dtype),
                         p["wo"], heads, hd), cache
    prefill = cache is None or (isinstance(cache_index, int)
                                and cache_index == 0)
    if cache is not None:
        k = k.to(cache["k"].dtype)
        v = v.to(cache["v"].dtype)
        if torch.is_tensor(cache_index) and cache_index.dim() == 1:
            # per-slot decode: row b writes its own position cache_index[b]
            rows = torch.arange(B, device=x.device)
            cache["k"][rows, cache_index] = k[:, 0]
            cache["v"][rows, cache_index] = v[:, 0]
        else:
            cache["k"][:, cache_index:cache_index + S] = k
            cache["v"][:, cache_index:cache_index + S] = v

    if S >= FLASH_MIN_SEQ and prefill and not train:
        # The reference's prefill attends over the whole max_len cache with
        # kv_valid = S; the causal mask already excludes every slot at or past
        # S, so attending over the S fresh (cache-dtype) k/v is the same sum.
        out = _flash(q, k, v, causal=causal, window=eff_window,
                     chunk=eff_chunk)
    elif cache is not None:
        out = blockwise_attention(q, cache["k"], cache["v"], causal=causal,
                                  window=eff_window, chunk=eff_chunk,
                                  q_offset=cache_index,
                                  kv_valid=cache_index + S)
    else:
        out = blockwise_attention(q, k, v, causal=causal, window=eff_window,
                                  chunk=eff_chunk)
    out = _out_proj(out.reshape(B, S, H * hd).to(p["wo"].dtype), p["wo"],
                    heads, hd)
    return out, cache


def _row_split(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w, w row-split over an installed model axis: each rank's f32
    partial product, summed over the model group and cast once (a bf16
    partial per rank would round twice)."""
    if current_mesh() is None:
        return h @ w
    out = reduce_from_model(h.float() @ w.float())
    return out.to(torch.promote_types(h.dtype, w.dtype))


def _ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cache: Params, cache_index: Any, *,
                    window: int) -> torch.Tensor:
    """Attention of a sliding-window layer through its W-slot ring cache
    (W = min(max_len, window)): position p lives in slot p % W. RoPE is
    applied before the write, so a slot needs no position and validity is a
    count. One token (decode, a scalar or a per-slot [B] index) is written
    to its slot and attends to the min(index + 1, W) valid slots, unmasked.
    More tokens are a prefill from position 0, as in the reference (which
    assumes it): causal windowed attention over the fresh k/v, the flash
    kernel's route for S > 16, then the last W positions stored, rolled by
    (S - W) % W so that each sits in its slot. Returns [B, S, H, hd]."""
    B, S = q.shape[:2]
    W = cache["k"].shape[1]
    if S == 1:
        slot = cache_index % W
        if torch.is_tensor(cache_index) and cache_index.dim() == 1:
            rows = torch.arange(B, device=q.device)
            cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        else:
            cache["k"][:, slot:slot + 1] = k.to(cache["k"].dtype)
            cache["v"][:, slot:slot + 1] = v.to(cache["v"].dtype)
        kvv = (torch.clamp(cache_index + 1, max=W)
               if torch.is_tensor(cache_index) else min(cache_index + 1, W))
        return blockwise_attention(q, cache["k"], cache["v"], causal=False,
                                   kv_valid=kvv)
    if S >= FLASH_MIN_SEQ:
        out = _flash(q, k, v, window=window)
    else:
        out = blockwise_attention(q, k, v, causal=True, window=window)
    if S >= W:
        shift = (S - W) % W
        cache["k"].copy_(torch.roll(k[:, -W:], shift, dims=1))
        cache["v"].copy_(torch.roll(v[:, -W:], shift, dims=1))
    else:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    return out


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention) block
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(gen, (d, m.q_lora_rank), dtype),
        "wq_b": dense_init(gen, (m.q_lora_rank, H * qk), dtype),
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            dtype),
        "wkv_b": dense_init(gen, (m.kv_lora_rank,
                                  H * (m.qk_nope_head_dim + m.v_head_dim)),
                            dtype),
        "wo": dense_init(gen, (H * m.v_head_dim, d), dtype,
                         fan_in=H * m.v_head_dim),
        "norm_kv": ones_init(gen, (m.kv_lora_rank,), dtype),
    }


def apply_mla(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    *,
    attn_mode: str = "causal",
    window: int = 0,
    cache: Optional[Params] = None,  # {"ckv": [B,S,rank], "krope": [B,S,1,rope]}
    cache_index: Any = None,  # as apply_attention's
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (out [B, S, D], cache), the cache updated in place.

    The latent ckv is rms-normed in f32, cast back and scaled by `norm_kv`;
    the cache holds it and the roped shared key, and every call re-expands
    the whole cache through `wkv_b` (as the reference does) and attends
    through `blockwise_attention` with scale 1/sqrt(qk_nope + qk_rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    qk_n, qk_r, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    split = current_mesh() is not None and any(
        _is_block(p[k], dim, H * w) for k, dim, w in (
            ("wq_b", -1, qk_n + qk_r), ("wkv_b", -1, qk_n + dv),
            ("wo", 0, dv)))
    if split and cache is not None:
        raise NotImplementedError(
            "MLA with a cache over a model axis that splits its heads: "
            "serving on a model axis (ROADMAP.md queue 1 item 7)")
    rows = (0, H * dv)
    if split and _is_block(p["wo"], 0, H * dv):
        width = p["wo"].shape[0]
        rows = (model_index(current_mesh()) * width,
                (model_index(current_mesh()) + 1) * width)
    h0, h1 = rows[0] // dv, -(-rows[1] // dv)  # the heads the rank runs
    proj = (lambda inp, w, hd: _mla_heads(inp, w, hd, H, h0, h1)) \
        if split else (lambda inp, w, hd: (inp @ w).reshape(
            *inp.shape[:2], H, hd))

    q = proj(x @ p["wq_a"], p["wq_b"], qk_n + qk_r)
    q_nope, q_rope = q[..., :qk_n], q[..., qk_n:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = x @ p["wkv_a"]
    ckv, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    ckvf = ckv.float()
    ckv = (ckvf * torch.rsqrt(ckvf.square().mean(-1, keepdim=True) + 1e-6)
           ).to(x.dtype) * p["norm_kv"]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)

    kv_valid, q_offset = None, 0
    if cache is not None:
        ckv = ckv.to(cache["ckv"].dtype)
        k_rope = k_rope.to(cache["krope"].dtype)
        if torch.is_tensor(cache_index) and cache_index.dim() == 1:
            # per-slot decode (S == 1): row b writes its own position
            rows = torch.arange(B, device=x.device)
            cache["ckv"][rows, cache_index] = ckv[:, 0]
            cache["krope"][rows, cache_index] = k_rope[:, 0]
        else:
            cache["ckv"][:, cache_index:cache_index + S] = ckv
            cache["krope"][:, cache_index:cache_index + S] = k_rope
        ckv, k_rope = cache["ckv"], cache["krope"]
        kv_valid, q_offset = cache_index + S, cache_index

    dt = torch.promote_types(ckv.dtype, p["wkv_b"].dtype)  # jnp's promotion
    kv_up = proj(ckv.to(dt), p["wkv_b"].to(dt), qk_n + dv)
    Sk, Hr = kv_up.shape[1], kv_up.shape[2]
    k_nope, v = kv_up[..., :qk_n], kv_up[..., qk_n:]
    if (h0, h1) != (0, H):
        k_rope = copy_to_model(k_rope)  # read by the rank's heads only
    k = torch.cat([k_nope, k_rope.expand(B, Sk, Hr, qk_r).to(k_nope.dtype)],
                  dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    out = blockwise_attention(qfull, k, v, causal=True,
                              window=window if attn_mode == "window" else 0,
                              q_offset=q_offset, kv_valid=kv_valid,
                              softmax_scale=1.0 / math.sqrt(qk_n + qk_r))
    out = out.reshape(B, S, Hr * dv).to(p["wo"].dtype)
    if (h0, h1) == (0, H):
        return out @ p["wo"], cache
    lo = rows[0] - h0 * dv
    return _row_split(out[..., lo:lo + rows[1] - rows[0]], p["wo"]), cache


def _mla_heads(inp: torch.Tensor, w: torch.Tensor, hd: int, H: int,
               h0: int, h1: int) -> torch.Tensor:
    """Heads [h0, h1) [B, S, h1 - h0, hd] of inp @ w (a projection of H
    heads of hd columns) over an installed model axis, from the block of w
    the rank holds. The rank runs the heads that overlap its rows of wo
    (all H where wo is whole). A split w joins the pieces of those heads
    from its block of g = hd / gcd(hd, columns a rank holds) model indices
    (`_take_heads`), or, where the rank runs every head, every rank's
    columns (`gather_columns`); a whole w is projected whole. inp enters a
    split w, and a whole w's product a split of the heads, through
    `copy_to_model`: each rank's gradient covers its share."""
    B, S = inp.shape[:2]
    every = (h0, h1) == (0, H)
    if not _is_block(w, -1, H * hd):
        out = inp @ w
        out = out if every else copy_to_model(out)
        return out[..., h0 * hd:h1 * hd].reshape(B, S, -1, hd)
    cols = copy_to_model(inp) @ w
    if every:
        return gather_columns(cols).reshape(B, S, H, hd)
    return _take_heads(cols, hd // math.gcd(hd, w.shape[-1]), h0, h1, hd)


# ---------------------------------------------------------------------------
# Vocab projection
# ---------------------------------------------------------------------------


def vocab_split(emb: torch.Tensor, cfg: ModelConfig) -> Optional[int]:
    """The dim of a [vocab, d_model] table (embed, unembed) that the
    installed model axis splits on this rank: 0, its vocab rows (the
    reference's placement); 1, its d_model columns (`_ALT_SPECS`, where
    the extent does not divide the vocab); None, the whole table (no
    model axis, or one whose extent divides neither dim)."""
    if current_mesh() is None:
        return None
    if _is_block(emb, 0, cfg.vocab_size):
        return 0
    return 1 if _is_block(emb, 1, cfg.d_model) else None


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor,
                 split: Optional[int] = None) -> torch.Tensor:
    """The embeddings of `tokens`, emb split as `split` says
    (`vocab_split`). Over its vocab rows the tokens outside them take
    zeros, and the rows sum over the model group (one rank holds each
    token's row). Over its d_model columns the rank looks up its columns
    of every token, and one all-gather over the model group joins them
    (`gather_columns`: the backward keeps the rank's columns)."""
    if split is None:
        return emb[tokens]
    if split == 1:
        return gather_columns(emb[tokens])
    mesh = current_mesh()
    V = emb.shape[0]
    local = tokens - model_index(mesh) * V
    inside = (local >= 0) & (local < V)
    rows = torch.where(inside[..., None], emb[local.clamp(0, V - 1)],
                       torch.zeros((), dtype=emb.dtype, device=emb.device))
    return reduce_from_model(rows).to(emb.dtype)


def unembed_logits(emb: torch.Tensor, x: torch.Tensor,
                   split: Optional[int] = None) -> torch.Tensor:
    """logits = x @ emb^T with the vocab dim padded to a multiple of 16, as in
    the reference (which pads so the vocab shards evenly); padded entries
    are NEG_INF so a softmax over them is exact. emb is split as `split`
    says (`vocab_split`). Over its vocab rows, the rank's vocab columns
    (the split divides the vocab: no padding). Over its d_model columns,
    the partial logits of the rank's columns of x, summed over the model
    group in f32 and cast once (`_row_split`), then padded: whole logits
    on every rank, x's gradient summed back over the group
    (`copy_to_model`)."""
    if split == 0:
        return copy_to_model(x) @ emb.t()
    V = emb.shape[0]
    Vp = ((V + 15) // 16) * 16
    if Vp != V:
        emb = F.pad(emb, (0, 0, 0, Vp - V))
    if split == 1:
        w = emb.shape[1]
        c0 = model_index(current_mesh()) * w
        logits = _row_split(copy_to_model(x)[..., c0:c0 + w], emb.t())
    else:
        logits = x @ emb.t()
    if Vp != V:
        logits[..., V:] = NEG_INF
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  split: Optional[int] = None) -> torch.Tensor:
    """Mean CE over positions with label >= 0, in f32 with the
    log-sum-exp. The gold score is a gather, where the reference contracts a
    one-hot to keep its vocab axis sharded: the same number. With the
    unembedding split over its vocab rows (`split` 0, `vocab_split`) the
    logits are the rank's vocab columns (`_VocabParallelCE`); otherwise
    they are whole on every rank."""
    mesh = current_mesh()
    if split == 0:
        return _VocabParallelCE.apply(logits, labels, mesh)
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)


class _VocabParallelCE(torch.autograd.Function):
    """`cross_entropy` over vocab-split logits [..., V / m]: the max, then
    the sum of exponentials and the gold logit (each rank's share: zero
    where the label is not among its columns), all-reduced over the model
    group in f32; the gradient is (softmax - one-hot) on the rank's
    columns."""

    @staticmethod
    def forward(ctx, logits, labels, mesh):
        lf = logits.float()
        V = lf.shape[-1]
        m = all_reduce_(lf.amax(-1).contiguous(), mesh, ReduceOp.MAX,
                        axis="model")
        e = torch.exp(lf - m[..., None])
        local = labels.long() - model_index(mesh) * V
        inside = (local >= 0) & (local < V) & (labels >= 0)
        local = local.clamp(0, V - 1)
        gold = torch.where(inside, lf.gather(-1, local[..., None])[..., 0],
                           torch.zeros((), device=lf.device))
        sums = all_reduce_(torch.stack([e.sum(-1), gold]), mesh,
                           axis="model")
        mask = (labels >= 0).float()
        weight = mask / mask.sum().clamp_min(1.0)
        ctx.save_for_backward(e, sums[0], local, inside, weight)
        ctx.dtype = logits.dtype
        return ((m + torch.log(sums[0]) - sums[1]) * weight).sum()

    @staticmethod
    def backward(ctx, g):
        e, sumexp, local, inside, weight = ctx.saved_tensors
        p = e / sumexp[..., None]
        p.scatter_add_(-1, local[..., None], -inside.float()[..., None])
        return (p * (weight * g)[..., None]).to(ctx.dtype), None, None


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype) -> Params:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype),
            "w_up": dense_init(gen, (d_model, d_ff), dtype),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff),
        }
    return {
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def apply_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The `cfg.ffn` FFN. Under a model axis: the rank's FFN columns, then
    `_row_split`; where the leaves are whole (the extent does not divide
    `cfg.d_ff`), the whole FFN on every rank, with no message."""
    split = _is_block(p["w_down"], 0, cfg.d_ff)
    if split:
        x = copy_to_model(x)
    if cfg.ffn in ("swiglu", "geglu"):
        act = F.silu if cfg.ffn == "swiglu" else _gelu
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = _gelu(x @ p["w_up"])
    return _row_split(h, p["w_down"]) if split else h @ p["w_down"]
