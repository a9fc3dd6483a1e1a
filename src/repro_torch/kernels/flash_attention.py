"""CUDA kernels for blockwise (flash) attention with causal, sliding-window and
chunked-local masks: `flash_attention_cuda` replaces the Pallas
`flash_attention` of the JAX package. It picks one of three kernels by shape
(`flash_variant`), never because another failed:

* "wgmma" (`csrc/flash_attention_sm90.cu`): bf16 with D in {64, 128, 256}
  and 16-byte aligned tensors: every prefill of granite-8b, of the attention
  families and of seamless-m4t-medium, and recurrentgemma-9b's local
  attention (D = 256). Warp-specialised for Hopper: one thread of a producer
  warpgroup streams K and V tiles by TMA into a two-stage ring (128 keys a
  tile, 64 at D = 256); two consumer warpgroups run both products with
  `wgmma` (P from registers).
* "mma_sync" (`csrc/flash_attention.cu`): bf16 at other head dims up to 256,
  and bf16 tensors that are not 16-byte aligned, with Ampere's `mma.sync`
  and plain loads.
* "f32" (`csrc/flash_attention.cu`): f32, plain FMAs, D up to 256.

Each block owns a query tile and loops over the key tiles that hold a live
(query, key) pair, carrying the online-softmax statistics in registers. The
TPU kernel's lane-replicated statistics and sequential kv grid axis are not
carried over.

Keys at or past Sk are masked and a fully masked row is 0, as in
`ref.attention_ref`, so any Sk is taken with any mask; the Pallas kernel
instead pads Sk with zero keys that a causal call with Sq > Sk can attend
to (and so refuses unmasked attention unless Sk is a multiple of its key
block), and gives a fully masked row the mean of the values it visited.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _cuda

MAX_HEAD_DIM = 256
VARIANTS = ("wgmma", "mma_sync", "f32")
SM90_HEAD_DIMS = (64, 128, 256)  # the head dims of the wgmma kernel


def flash_variant(dtype: torch.dtype, D: int, aligned: bool) -> str:
    """The kernel that attention of this dtype, head dim and alignment (every
    pointer 16-byte aligned) launches: "wgmma", "mma_sync" or "f32"."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    return "wgmma" if D in SM90_HEAD_DIMS and aligned else "mma_sync"


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel `flash_attention_cuda` launches for these inputs (its
    output, newly allocated, is always 16-byte aligned)."""
    return flash_variant(q.dtype, q.shape[-1], _aligned(q, k, v))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         chunk: int = 0) -> torch.Tensor:
    """Masked attention on the card. q: [B, H, Sq, D]; k, v: [B, H, Sk, D]
    (GQA heads repeated by the caller); contiguous CUDA tensors of one dtype,
    f32 or bf16, D <= 256. Scale 1/sqrt(D); query and key positions both
    count from 0. Returns [B, H, Sq, D] in q's dtype."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B, H, Sq, D], got "
                         f"{tuple(q.shape)}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2] if k.dim() == 4 else -1
    _cuda.check("flash_attention q", q, (B, H, Sq, D))
    _cuda.check("flash_attention k", k, (B, H, Sk, D))
    _cuda.check("flash_attention v", v, (B, H, Sk, D))
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if window < 0 or chunk < 0:
        raise ValueError(f"window={window} and chunk={chunk} must be >= 0")
    out = torch.empty_like(q)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H,
            Sq, Sk, D, int(bool(causal)), int(window), int(chunk),
            1.0 / math.sqrt(D))
    with torch.cuda.device(q.device):
        if route(q, k, v) == "wgmma":
            _cuda.call("flash_attention_sm90", *args, _cuda.stream_of(q))
        else:
            vec = D % 8 == 0 and _aligned(q, k, v)
            _cuda.call("flash_attention", *args, _cuda.DTYPE_CODES[q.dtype],
                       int(vec), _cuda.stream_of(q))
    return out
