"""CUDA kernels for R rounds of circulant gossip consensus (paper eq. 17),
unquantized and quantized.

* `gossip_mix_cuda` (`csrc/gossip_mix.cu`) replaces the Pallas
  `gossip_mix_pallas` of the JAX package. Its design follows the node count
  (`gossip_design`): "composed" up to MAX_GOSSIP_NODES, where the rounds,
  being linear, compose into one circulant of at most n taps (`gossip_taps`,
  cached) and each block writes every element of its [n, bd] column tile
  once as its tap sum; "rounds" beyond, where each block keeps its tile in
  shared memory for all R rounds of the one-round schedule. Either way the
  buffer is read once and written once whatever R is.
* `gossip_mix_quant_cuda` (`csrc/gossip_mix_quant.cu`) replaces
  `gossip_mix_quant_pallas`: the Section VI wire with one sign or int8
  scale per [n, block_d] column tile. Its design follows the tile
  (`quant_design`): "cluster-tile", a thread-block cluster of
  `quant_cluster_size(block_d)` blocks per tile, every block its own columns
  for all R rounds, the blocks agreeing on the tile's scale each round
  through distributed shared memory; or "resident-tile", one block per tile
  holding two f32 copies of it, where a cluster block cannot hold its slice.
  The stochastic int8 compressor and sender-local (`per_node`) statistics
  have no kernel, in the reference as here.

The sharded-node-axis rules come with a later slice of the port.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cuda

QUANT_CODES = {"sign": 0, "int8": 1}  # the C `quant` argument
# the C `design` argument of gossip_mix: one pass of the composed taps, or
# the one-round schedule R times on a resident tile
GOSSIP_DESIGNS = {"composed": 0, "rounds": 1}
# the C `design` argument of gossip_mix_quant: a cluster of blocks per
# statistic tile, or one block per tile (the earlier kernel)
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


def gossip_design(n: int) -> str:
    """The gossip_mix kernel that n nodes launch: "composed" (one pass of at
    most n taps) up to MAX_GOSSIP_NODES, else "rounds" (the one-round
    schedule R times on a tile resident in shared memory)."""
    return "composed" if n <= MAX_GOSSIP_NODES else "rounds"


def gossip_mix_cuda(x: torch.Tensor, sched, rounds: int) -> torch.Tensor:
    """R rounds of `sum_s w_s * roll(x, s, axis=0)` on the card, by the
    design `gossip_design` names. x: [n, ...] contiguous f32/bf16 CUDA tensor
    (trailing dims are flattened); `sched`: the one-round ((shift, weight),
    ...) schedule. Output has x's dtype; it differs from the round-by-round
    plain version by f32 reassociation only (not at all in "rounds"). Raises
    where two f32 [n, 32] tiles do not fit shared memory (`_cuda.tile_width`,
    about 900 nodes)."""
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    n = x.shape[0]
    design = gossip_design(n)
    if design == "composed":
        shifts, weights = gossip_taps(sched, rounds, n)
        n_terms = len(shifts)
        shifts = (ctypes.c_int * n_terms)(*shifts)
        weights = (ctypes.c_float * n_terms)(*weights)
    else:
        n_terms, shifts, weights = _cuda.schedule_args(sched, n)
    _cuda.check("gossip_mix", x, tuple(x.shape))
    flat = x.reshape(n, -1)
    d = flat.shape[1]
    out = torch.empty_like(flat)
    if d == 0:
        return out.reshape(x.shape)
    bd = gossip_tile_width(n, d) if design == "composed" \
        else _cuda.tile_width(n, d)
    with torch.cuda.device(x.device):
        _cuda.call("gossip_mix", flat.data_ptr(), out.data_ptr(), n, d, bd,
                   _cuda.DTYPE_CODES[x.dtype], GOSSIP_DESIGNS[design], rounds,
                   n_terms, shifts, weights, _cuda.stream_of(x))
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


def quant_cluster_fits(n: int, bd: int) -> bool:
    """Whether a cluster-tile block holds its [n, cw] slice of an [n, bd]
    tile: one thread per padded column and group of up to 16 rows, at most
    1,024 threads (the compressed values, 4 n padded bytes, at most 64 KB,
    always fit shared memory)."""
    _, padded = quant_slice_columns(bd, quant_cluster_size(bd))
    return padded * -(-n // _QUANT_MAX_VALUES) <= _QUANT_MAX_THREADS


def quant_resident_fits(n: int, bd: int) -> bool:
    """Whether a resident-tile block holds two f32 [n, bd] tiles and its
    reduction scratch in shared memory."""
    return 8 * n * bd <= _cuda.SMEM_BYTES - _SCRATCH_BYTES


def quant_design(n: int, d: int, block_d: int) -> str:
    """The gossip_mix_quant kernel that an [n, d] buffer with statistic
    tiles of min(block_d, d) columns launches: "cluster-tile" where a block
    of the cluster holds its slice of a tile, else "resident-tile" where one
    block holds the whole tile twice in f32. Raises, naming both limits,
    where neither does."""
    bd = min(block_d, d)
    if quant_cluster_fits(n, bd):
        return "cluster-tile"
    if quant_resident_fits(n, bd):
        return "resident-tile"
    cluster = quant_cluster_size(bd)
    cw, _ = quant_slice_columns(bd, cluster)
    raise ValueError(
        f"gossip_mix_quant: an [{n}, {bd}] tile fits neither kernel: its "
        f"[{n}, {cw}] slice (of {cluster} per tile) is more than a "
        f"cluster-tile block holds ({_QUANT_MAX_THREADS} threads of "
        f"{_QUANT_MAX_VALUES} values), and two f32 copies of the tile need "
        f"{8 * n * bd} bytes of shared memory, more than the "
        f"{_cuda.SMEM_BYTES - _SCRATCH_BYTES} a resident-tile block can "
        f"have; use a smaller quant_block_d")


def quant_route(x: torch.Tensor, block_d: int) -> str:
    """The design that gossip_mix_quant_cuda(x, ..., block_d=block_d)
    launches."""
    return quant_design(x.shape[0], x[0].numel(), block_d)


def gossip_mix_quant_cuda(x: torch.Tensor, sched, rounds: int, quant: str, *,
                          block_d: int = 512, valid_d: Optional[int] = None,
                          _design: Optional[str] = None) -> torch.Tensor:
    """R rounds of quantized gossip with one compressor scale per
    [n, min(block_d, d)] column tile, on the card. x: [n, ...] contiguous
    f32/bf16 CUDA tensor (trailing dims are flattened); quant: "sign" |
    "int8"; flattened columns >= `valid_d` are pad (must be zero) and are
    left out of the statistics (None: every column is valid). The rounds run
    in f32 and the output, of x's dtype, is rounded once. The design follows
    `quant_route`; `_design` forces one, for timing the two beside each other
    (the port's paths never pass it), and raises where it cannot run."""
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
    if _design is None:
        design = quant_design(n, d, block_d)
    elif _design not in QUANT_DESIGNS:
        raise ValueError(f"unknown gossip_mix_quant design {_design!r}")
    elif _design == "cluster-tile" and not quant_cluster_fits(n, bd):
        cw, _ = quant_slice_columns(bd, quant_cluster_size(bd))
        raise ValueError(
            f"gossip_mix_quant: a [{n}, {cw}] slice of a [{n}, {bd}] tile "
            f"is more than a block holds ({_QUANT_MAX_THREADS} threads of "
            f"{_QUANT_MAX_VALUES} values)")
    elif _design == "resident-tile" and not quant_resident_fits(n, bd):
        raise ValueError(
            f"gossip_mix_quant: two f32 [{n}, {bd}] tiles need "
            f"{8 * n * bd} bytes of shared memory, more than the "
            f"{_cuda.SMEM_BYTES - _SCRATCH_BYTES} a block can have")
    else:
        design = _design
    cluster = quant_cluster_size(bd) if design == "cluster-tile" else 1
    n_terms, shifts, weights = _cuda.schedule_args(sched, n)
    with torch.cuda.device(x.device):
        _cuda.call("gossip_mix_quant", flat.data_ptr(), out.data_ptr(), n, d,
                   bd, dv, QUANT_CODES[quant], _cuda.DTYPE_CODES[x.dtype],
                   rounds, n_terms, shifts, weights, cluster,
                   QUANT_DESIGNS[design], _cuda.stream_of(x))
    return out.reshape(x.shape)
