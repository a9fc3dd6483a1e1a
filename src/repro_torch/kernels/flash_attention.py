"""CUDA kernel for blockwise (flash) attention with causal, sliding-window and
chunked-local masks: `flash_attention_cuda` (`csrc/flash_attention.cu`)
replaces the Pallas `flash_attention` of the JAX package.

One block per (batch*head, 64-row query tile) loops over the key tiles that
hold a live (query, key) pair, carrying the online-softmax statistics in
registers; bf16 runs both products on the tensor cores (`mma.sync`, f32
accumulation), f32 runs plain f32 FMAs. The TPU kernel's lane-replicated
statistics and sequential kv grid axis are not carried over.

Keys at or past Sk are masked and a fully masked row is 0, as in
`ref.attention_ref`; the Pallas kernel instead pads Sk with zero keys that a
causal call with Sq > Sk can attend to, and gives a fully masked row the
mean of the values it visited.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _cuda

MAX_HEAD_DIM = 128
REF_BLOCK_K = 128  # the Pallas kernel's default block_k


def check_masking(sk: int, causal: bool, window: int, chunk: int) -> None:
    """The reference's rule: unmasked attention needs Sk divisible by its key
    block, min(128, Sk). Kept so that both packages take the same inputs."""
    bk = min(REF_BLOCK_K, sk)
    if sk % bk and not (causal or window or chunk):
        raise ValueError("unmasked attention requires Sk divisible by block_k")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         chunk: int = 0) -> torch.Tensor:
    """Masked attention on the card. q: [B, H, Sq, D]; k, v: [B, H, Sk, D]
    (GQA heads repeated by the caller); contiguous CUDA tensors of one dtype,
    f32 or bf16, D <= 128. Scale 1/sqrt(D); query and key positions both
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
    check_masking(Sk, causal, window, chunk)
    out = torch.empty_like(q)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    vec = D % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    with torch.cuda.device(q.device):
        _cuda.call("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), B * H, Sq, Sk, D, int(bool(causal)),
                   int(window), int(chunk), 1.0 / math.sqrt(D),
                   _cuda.DTYPE_CODES[q.dtype], int(vec), _cuda.stream_of(q))
    return out
