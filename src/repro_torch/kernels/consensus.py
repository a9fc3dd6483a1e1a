"""CUDA kernels for R rounds of circulant gossip consensus (paper eq. 17),
unquantized and quantized.

* `gossip_mix_cuda` (`csrc/gossip_mix.cu`) replaces the Pallas
  `gossip_mix_pallas` of the JAX package. The rounds are linear, so the
  wrapper composes the R-round schedule into one circulant of at most n taps
  (`gossip_taps`, cached); each block stages one [n, bd] column tile in
  shared memory and writes every element once as its tap sum, so the buffer
  is read once and written once whatever R is.
* `gossip_mix_quant_cuda` (`csrc/gossip_mix_quant.cu`) replaces
  `gossip_mix_quant_pallas`: the Section VI wire with one sign or int8
  scale per [n, block_d] column tile. A thread-block cluster of
  `quant_cluster_size(block_d)` blocks holds each tile, every block its own
  columns for all R rounds, and the blocks agree on the tile's scale each
  round through distributed shared memory. The stochastic int8 compressor
  and sender-local (`per_node`) statistics have no kernel, in the reference
  as here.

The sharded-node-axis rules come with a later slice of the port.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cuda

QUANT_CODES = {"sign": 0, "int8": 1}  # the C `quant` argument
# the C `design` argument: a cluster of blocks per statistic tile, or the
# earlier kernel of one block per tile (timed beside it, never on a path)
QUANT_DESIGNS = {"cluster-tile": 0, "resident-tile": 1}
QUANT_CLUSTERS = (16, 8, 4, 2, 1)  # blocks per statistic tile, largest first
_QUANT_MAX_THREADS, _QUANT_MAX_VALUES = 1024, 16  # csrc/gossip_mix_quant.cu
_SCRATCH_BYTES = 8 * 33  # the resident-tile kernel's reduction scratch
# kMaxNodes in csrc/gossip_mix.cu: the largest node count that the repository's
# configs, tests and benchmarks mix over (a composed schedule has <= n taps)
MAX_GOSSIP_NODES = 64
_THREADS = 256  # kThreads in csrc/common.cuh
_ROWS = 4  # kRows in csrc/gossip_mix.cu: output rows per thread


@functools.lru_cache(maxsize=256)
def _compose(sched: Tuple[Tuple[int, float], ...], rounds: int,
             n: int) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    from repro_torch.core.mixing import compose_schedule

    fused = compose_schedule(sched, rounds, n)
    return (tuple(s % n for s, _ in fused), tuple(w for _, w in fused))


def gossip_taps(sched, rounds: int,
                n: int) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    """The taps of R rounds of the one-round schedule `sched` over n nodes:
    (shifts in [0, n), weights), at most n of them, composed in f64 once per
    (schedule, R, n) and cached (the callers pass the same schedule every
    round). Raises beyond the kernel's MAX_GOSSIP_NODES."""
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if not 1 <= n <= MAX_GOSSIP_NODES:
        raise ValueError(f"gossip_mix: {n} nodes; the kernel takes 1 to "
                         f"{MAX_GOSSIP_NODES} (one tap per node of the "
                         f"composed schedule)")
    key = tuple((int(s), float(w)) for s, w in sched)
    return _compose(key, int(rounds), int(n))


def gossip_tile_width(n: int, d: int) -> int:
    """Columns per block of the gossip_mix kernel: the widest power of two
    from 8 to 512 that still gives at least as many column tiles as SMs and
    fits the block's threads (one per column and group of _ROWS rows) in
    256. The [n, bd] f32 tile then fits shared memory for every n the kernel
    takes."""
    groups = -(-n // _ROWS)
    bd = 512
    while bd > 8 and (-(-d // bd) < _cuda.N_SMS or bd * groups > _THREADS):
        bd //= 2
    return bd


def gossip_mix_cuda(x: torch.Tensor, sched, rounds: int) -> torch.Tensor:
    """R rounds of `sum_s w_s * roll(x, s, axis=0)` on the card, as one pass
    of the composed schedule. x: [n, ...] contiguous f32/bf16 CUDA tensor
    (trailing dims are flattened); `sched`: the one-round ((shift, weight),
    ...) schedule. Output has x's dtype; it differs from the round-by-round
    plain version by f32 reassociation only."""
    n = x.shape[0]
    shifts, weights = gossip_taps(sched, rounds, n)
    _cuda.check("gossip_mix", x, tuple(x.shape))
    flat = x.reshape(n, -1)
    d = flat.shape[1]
    out = torch.empty_like(flat)
    if d == 0:
        return out.reshape(x.shape)
    with torch.cuda.device(x.device):
        _cuda.call("gossip_mix", flat.data_ptr(), out.data_ptr(), n, d,
                   gossip_tile_width(n, d), _cuda.DTYPE_CODES[x.dtype],
                   len(shifts), (ctypes.c_int * len(shifts))(*shifts),
                   (ctypes.c_float * len(weights))(*weights),
                   _cuda.stream_of(x))
    return out.reshape(x.shape)


def quant_cluster_size(bd: int) -> int:
    """Blocks per [n, bd] statistic tile of the quantized gossip kernel: the
    largest of 16, 8, 4, 2, 1 that leaves each block at least 32 of the
    tile's columns (a warp across a row)."""
    return next(c for c in QUANT_CLUSTERS if bd >= 32 * c or c == 1)


def quant_slice_columns(bd: int, cluster: int) -> Tuple[int, int]:
    """(cw, padded): the columns of a tile that one block of the cluster
    holds, ceil(bd / cluster), and that width padded to the power of two
    from 8 up that the kernel lays a row out in (2^cw_log in the source)."""
    cw = -(-bd // cluster)
    return cw, max(8, 1 << (cw - 1).bit_length())


def quant_tile_of(x: torch.Tensor, block_d: int) -> int:
    """The statistic tile width bd = min(block_d, d) of x [n, ...]."""
    return min(block_d, x[0].numel())


def gossip_mix_quant_cuda(x: torch.Tensor, sched, rounds: int, quant: str, *,
                          block_d: int = 512, valid_d: Optional[int] = None,
                          _design: str = "cluster-tile") -> torch.Tensor:
    """R rounds of quantized gossip with one compressor scale per
    [n, min(block_d, d)] column tile, on the card. x: [n, ...] contiguous
    f32/bf16 CUDA tensor (trailing dims are flattened); quant: "sign" |
    "int8"; flattened columns >= `valid_d` are pad (must be zero) and are
    left out of the statistics (None: every column is valid). The rounds run
    in f32 and the output, of x's dtype, is rounded once. `_design` is for
    timing the earlier kernel ("resident-tile") beside the cluster kernel;
    the port's paths never pass it."""
    if quant not in QUANT_CODES:
        raise ValueError(f"the quantized gossip kernel takes sign or int8, "
                         f"got {quant!r}")
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    n = x.shape[0]
    _cuda.check("gossip_mix_quant", x, tuple(x.shape))
    flat = x.reshape(n, -1)
    d = flat.shape[1]
    out = torch.empty_like(flat)
    if d == 0:
        return out.reshape(x.shape)
    dv = d if valid_d is None else int(valid_d)
    if not 0 <= dv <= d:
        raise ValueError(f"valid_d={valid_d} outside [0, {d}]")
    if any(s != 0 and s % n == 0 for s, _ in sched):
        raise ValueError(f"schedule {sched} has a non-self term that rolls "
                         f"by a multiple of n={n}")
    bd = min(block_d, d)
    if _design not in QUANT_DESIGNS:
        raise ValueError(f"unknown gossip_mix_quant design {_design!r}")
    if _design == "cluster-tile":
        cluster = quant_cluster_size(bd)
        cw, padded = quant_slice_columns(bd, cluster)
        # a thread holds one column and up to 16 rows; the compressed values
        # (4 n padded bytes, at most 64 KB) always fit shared memory
        if padded * -(-n // _QUANT_MAX_VALUES) > _QUANT_MAX_THREADS:
            raise ValueError(
                f"gossip_mix_quant: a [{n}, {cw}] slice of a [{n}, {bd}] tile "
                f"is more than a block holds ({_QUANT_MAX_THREADS} threads of "
                f"{_QUANT_MAX_VALUES} values); use a smaller quant_block_d")
    else:
        cluster = 1
        if 8 * n * bd > _cuda.SMEM_BYTES - _SCRATCH_BYTES:
            raise ValueError(
                f"gossip_mix_quant: two f32 [{n}, {bd}] tiles need "
                f"{8 * n * bd} bytes of shared memory, more than the "
                f"{_cuda.SMEM_BYTES - _SCRATCH_BYTES} a block can have")
    n_terms, shifts, weights = _cuda.schedule_args(sched, n)
    with torch.cuda.device(x.device):
        _cuda.call("gossip_mix_quant", flat.data_ptr(), out.data_ptr(), n, d,
                   bd, dv, QUANT_CODES[quant], _cuda.DTYPE_CODES[x.dtype],
                   rounds, n_terms, shifts, weights, cluster,
                   QUANT_DESIGNS[_design], _cuda.stream_of(x))
    return out.reshape(x.shape)
