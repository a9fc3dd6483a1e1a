"""CUDA kernel for R rounds of circulant gossip consensus (paper eq. 17),
unquantized: `csrc/gossip_mix.cu`, which replaces the Pallas
`gossip_mix_pallas` of the JAX package. Each block keeps one [n, bd] column
tile in shared memory for all R rounds, so the buffer is read once and
written once whatever R is.

The quantized kernel (`gossip_mix_quant_pallas`) and the sharded-node-axis
rules come with later slices of the port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda


def gossip_mix_cuda(x: torch.Tensor, sched, rounds: int) -> torch.Tensor:
    """R rounds of `sum_s w_s * roll(x, s, axis=0)` on the card. x: [n, ...]
    contiguous f32/bf16 CUDA tensor (trailing dims are flattened); `sched`:
    the one-round ((shift, weight), ...) schedule. Output has x's dtype."""
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    n = x.shape[0]
    _cuda.check("gossip_mix", x, tuple(x.shape))
    flat = x.reshape(n, -1)
    d = flat.shape[1]
    out = torch.empty_like(flat)
    if d == 0:
        return out.reshape(x.shape)
    n_terms, shifts, weights = _cuda.schedule_args(sched, n)
    bd = _cuda.tile_width(n, d)
    with torch.cuda.device(x.device):
        _cuda.call("gossip_mix", flat.data_ptr(), out.data_ptr(), n, d, bd,
                   _cuda.DTYPE_CODES[x.dtype], rounds, n_terms, shifts,
                   weights, _cuda.stream_of(x))
    return out.reshape(x.shape)
