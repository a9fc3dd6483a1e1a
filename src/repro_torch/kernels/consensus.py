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
  holding two f32 copies of it, where a cluster block cannot hold its slice
  or where there are enough tiles to fill the card with one block each (at
  up to 16 nodes its blocks are wide enough to beat clusters of one-warp
  blocks there: `PERF.md` §6 row 2).
  The stochastic int8 compressor and sender-local (`per_node`) statistics
  have no kernel, in the reference as here.

The sharded-node-axis rules (`gossip_mix_shard`, `gossip_mix_quant_shard`)
replace both kernels where the node axis is split over the ranks of a mesh
(`repro_torch/dist.py`, which also carries the messages). They have no Pallas
body in the reference either (its shard_map rules are plain `jnp`), so the
per-round slice sum is plain PyTorch on the card; only the halo rows cross
between ranks.
"""
from __future__ import annotations

import math
import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch import dist as rdist
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
# up to this many nodes, a buffer of at least N_SMS tiles takes the
# resident-tile kernel (`quant_design`); the node counts measured
QUANT_RESIDENT_MAX_NODES = 16
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
    tiles of min(block_d, d) columns launches. "resident-tile" (one block
    holds the whole tile twice in f32) at up to QUANT_RESIDENT_MAX_NODES
    nodes once the tiles are at least as many as the card's SMs: one block
    per tile then fills the card, and the cluster-tile design's blocks, of
    one warp each at such n, cost 2-8x more (measured at n = 3 to 16, from
    512 tiles up, by tools/quant_route_probe.py). Otherwise "cluster-tile"
    where a block of the cluster holds its slice of a tile (few tiles: the
    cluster spreads each over up to 16 SMs), else "resident-tile". Raises,
    naming both limits, where neither kernel holds the tile."""
    bd = min(block_d, d)
    if (n <= QUANT_RESIDENT_MAX_NODES and -(-d // bd) >= _cuda.N_SMS
            and quant_resident_fits(n, bd)):
        return "resident-tile"
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


def _slot_args(h: torch.Tensor, bm, bd: int):
    if h.device.type != "cuda" or h.dtype != torch.float32 or h.dim() != 2:
        raise ValueError(f"the slot kernels take an f32 [n, entries] CUDA "
                         f"tensor, got {h.dtype} {tuple(h.shape)} on "
                         f"{h.device}")
    if h.stride(1) != 1:
        raise ValueError("the slot kernels take rows of contiguous entries")
    return (h.shape[0], h.shape[1], bm.offset, bm.w, bm.L, bm.m)


def quant_slot_stats_cuda(h: torch.Tensor, bm, bd: int, lo: int, hi: int,
                          partial: torch.Tensor, quant: str) -> torch.Tensor:
    """The rank's statistics of slots [lo, hi) of one leaf's block h
    ([n, entries] f32 on the card, rows of contiguous entries) combined
    into `partial` ([1, slots] f64, contiguous, on h's card) in place: the
    sum of |h| over every row for sign, the max for int8, per slot of bd
    reference positions, the block placed by `bm` (`core.quantize.BlockMap`)."""
    if quant not in QUANT_CODES:
        raise ValueError(f"the slot kernels take sign or int8, got {quant!r}")
    n, size, offset, w, L, m = _slot_args(h, bm, bd)
    if (partial.dtype != torch.float64 or not partial.is_contiguous()
            or partial.device != h.device or partial.shape[-1] < hi):
        raise ValueError("partial must be a contiguous f64 [1, slots] "
                         "tensor on h's card, slots >= hi")
    with torch.cuda.device(h.device):
        _cuda.call("quant_slot_stats", h.data_ptr(), h.stride(0), n, size,
                   offset, w, L, m, bm.span, bd, lo, hi,
                   partial.data_ptr(), QUANT_CODES[quant],
                   _cuda.stream_of(h))
    return partial


def quant_slot_round_cuda(h: torch.Tensor, bm, bd: int, scale: torch.Tensor,
                          sched, quant: str) -> torch.Tensor:
    """One round of quantized gossip on one leaf's block h ([n, entries]
    f32 on the card, contiguous): h' = sum_k w_k roll(C(h), s_k), the self
    term uncompressed, each value compressed with the f32 scale of its
    slot (`scale` [1, slots], contiguous), the block placed by `bm`."""
    if quant not in QUANT_CODES:
        raise ValueError(f"the slot kernels take sign or int8, got {quant!r}")
    n, size, offset, w, L, m = _slot_args(h, bm, bd)
    if not h.is_contiguous():
        raise ValueError("quant_slot_round takes a contiguous block")
    if (scale.dtype != torch.float32 or not scale.is_contiguous()
            or scale.device != h.device):
        raise ValueError("scale must be a contiguous f32 tensor on h's card")
    if any(s != 0 and s % n == 0 for s, _ in sched):
        raise ValueError(f"schedule {sched} has a non-self term that rolls "
                         f"by a multiple of n={n}")
    out = torch.empty_like(h)
    n_terms, shifts, weights = _cuda.schedule_args(sched, n)
    with torch.cuda.device(h.device):
        _cuda.call("quant_slot_round", h.data_ptr(), out.data_ptr(), n, size,
                   offset, w, L, m, bd, scale.data_ptr(), QUANT_CODES[quant],
                   n_terms, shifts, weights, _cuda.stream_of(h))
    return out


# ---------------------------------------------------------------------------
# Partitioning rules for a sharded node axis
#
# A roll over a node axis split across ranks would move every row. These
# rules exchange only the halo rows the schedule reaches, per round, as
# point-to-point messages between the shards that hold them (as the
# reference's `_gather_halo` ppermutes), build the halo-extended local
# tile, and apply the round as a weighted sum of contiguous row slices: no
# wraparound. Per-round semantics are kept, term for term in the
# schedule's order, so the exact rule equals the plain per-round path
# (`ref.gossip_mix_ref`) bit for bit. The columns are independent, so all R
# rounds run on one column chunk (`rdist.column_chunks`, one width on every
# rank) at a time: the halo messages and the temporaries stay within
# `rdist.STAGE_BYTES` per row block at any width.
#
# The rows a shard holds come from a row table (`rdist.RowTable`): the even
# split of the node axis (`rdist.row_table`), an uneven one, or an elastic
# run's cohort (`rdist.cohort_rows`), where a shard may hold no row. A hop
# may then cross shards of different lengths, or shards with no rows; a
# shard with no row sends and receives nothing.
# ---------------------------------------------------------------------------

_TAG = 1 << 10  # + the piece's index in its receiver's tile: one tag each


def centered_shift(s: int, n: int) -> int:
    """Canonical shift representative in (-n/2, n/2]."""
    s = s % n
    return s if s <= n // 2 else s - n


def halo_reach(sched, n: int) -> Tuple[int, int]:
    """(rows needed from preceding shards, rows from following shards) for
    one round of `sched` on an [n, ...] buffer: roll by +s pulls rows from s
    above."""
    up = max((centered_shift(s, n) for s, _ in sched
              if centered_shift(s, n) > 0), default=0)
    down = max((-centered_shift(s, n) for s, _ in sched
                if centered_shift(s, n) < 0), default=0)
    return up, down


def shard_compatible(sched, rows: rdist.RowTable) -> bool:
    """True when the halo rules cover this (schedule, row table): more than
    one shard, and every shard that holds rows takes its one-round reach
    from the other shards' rows without wrapping onto its own."""
    if len(rows) <= 1:
        return False
    n = rows[-1][1]
    ru, rd = halo_reach(sched, n)
    return all(ru + rd + b - a <= n for a, b in rows if b > a)


def halo_pieces(rows: rdist.RowTable, ru: int, rd: int
                ) -> List[List[Tuple[int, int, int]]]:
    """Per shard, the pieces of its halo-extended tile that other shards
    hold, in tile order: (source shard, the first of its rows, rows). A
    shard's tile is the `ru` rows before its first row, its own rows and
    the `rd` rows after its last, cyclic over the n = rows[-1][1] rows; a
    shard with no row has no tile."""
    n = rows[-1][1]

    def pieces(start: int, count: int):
        out, p = [], 0
        while p < count:
            pos = (start + p) % n
            j = next(j for j, (a, b) in enumerate(rows) if a <= pos < b)
            take = min(count - p, rows[j][1] - pos)
            out.append((j, pos - rows[j][0], take))
            p += take
        return out

    return [pieces(a - ru, ru) + pieces(b, rd) if b > a else []
            for a, b in rows]


def halo_wire(rows: rdist.RowTable, ru: int, rd: int,
              index: int) -> Tuple[int, int, int]:
    """(messages sent, rows sent, rows received) of shard `index` in one
    halo exchange (`halo_pieces`): what the planner counts per round and
    column chunk."""
    plan = halo_pieces(rows, ru, rd)
    sent = [k for dst in plan for j, _, k in dst if j == index]
    return len(sent), sum(sent), sum(k for _, _, k in plan[index])


def _ext_tile(h: torch.Tensor, plan, ru: int, mesh) -> torch.Tensor:
    """This shard's halo-extended tile [ru + rows + rd, c] of its rows h:
    every piece another shard needs from h posted, every piece of its own
    tile received, in one exchange. The peers are the node shards' ranks
    at this rank's model index (`dist.exchange`), so over a model axis each
    model index mixes its own columns inside its data group."""
    i = rdist.node_index(mesh)
    sends = [(dst, h[s0:s0 + k], _TAG + t)
             for dst, tile in enumerate(plan)
             for t, (j, s0, k) in enumerate(tile) if j == i]
    bufs = [h.new_empty((k, h.shape[1])) for _, _, k in plan[i]]
    recvs = [(j, buf, _TAG + t)
             for t, ((j, _, _), buf) in enumerate(zip(plan[i], bufs))]
    rdist.exchange(sends, recvs, mesh)
    if not bufs:
        return h
    up, got = [], 0
    while got < ru:  # the pieces before the shard's rows come first
        got += bufs[len(up)].shape[0]
        up.append(bufs[len(up)])
    return torch.cat(up + [h] + bufs[len(up):], dim=0)


def _slice_round(ext: torch.Tensor, sched, n: int, ru: int, n_local: int,
                 self_term: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One gossip round as a weighted sum of contiguous row slices of the
    halo-extended tile, in the schedule's order. `self_term` (optional)
    takes the place of the s == 0 source: the quantized wire keeps the
    resident rows uncompressed for themselves."""
    acc = None
    for s, w in sched:
        sc = centered_shift(s, n)
        if sc == 0 and self_term is not None:
            t = w * self_term
        else:
            t = w * ext[ru - sc:ru - sc + n_local]
        acc = t if acc is None else acc + t
    return acc


def _table(x: torch.Tensor, mesh, rows) -> rdist.RowTable:
    """The row table of a rule's call: `rows`, or the even split of
    x.shape[0] * E rows."""
    return rows or rdist.row_table(mesh, x.shape[0] * rdist.n_data_nodes(mesh))


def gossip_mix_shard(x: torch.Tensor, sched, rounds: int, mesh,
                     rows: Optional[rdist.RowTable] = None) -> torch.Tensor:
    """R rounds of circulant gossip over an n-node axis split over the node
    axes of `mesh` as `rows` says (default: evenly, n = x.shape[0] * E with
    E = `n_data_nodes(mesh)`). x: this rank's rows; returns its rows after
    the R rounds, bit for bit the rows of the plain per-round path over the
    whole axis."""
    rows = _table(x, mesh, rows)
    n = rows[-1][1]
    n_local = x.shape[0]
    sched = tuple(sched)
    ru, rd = halo_reach(sched, n)
    plan = halo_pieces(rows, ru, rd)
    h = x.reshape(n_local, math.prod(x.shape[1:]))
    out = torch.empty_like(h)
    top = max(b - a for a, b in rows)
    for c0, c1 in rdist.column_chunks(h.shape[1], top, h.element_size()):
        hc = h[:, c0:c1]
        for _ in range(rounds):
            ext = _ext_tile(hc, plan, ru, mesh)
            hc = _slice_round(ext, sched, n, ru, n_local)
            del ext
        out[:, c0:c1] = hc
    return out.reshape(x.shape)


def gossip_mix_quant_shard(x: torch.Tensor, sched, rounds: int, quant: str,
                           mesh, *, block_d: int = 512,
                           valid_d: Optional[int] = None,
                           key: Optional[int] = None,
                           rows: Optional[rdist.RowTable] = None
                           ) -> torch.Tensor:
    """Quantized per-round gossip on a sharded node axis (split as `rows`
    says, default evenly) with per-node tile statistics
    (`quantize.tile_compress(per_node=True)`): each node scales its
    outgoing message from its own rows, the statistic a real sender
    computes locally, so the wire values do not depend on the split and the
    rows equal those of the plain per-node path
    (`ref.gossip_mix_quant_ref(per_node=True)`). The rounds run in f32 and
    the result is cast to x's dtype once. A stochastic compressor folds
    this rank's node shard into `key` (as the reference folds its
    `axis_index`), then the round, then the column chunk: deterministic,
    but layout-dependent noise; sign and int8 do not depend on the
    layout."""
    from repro_torch.core.quantize import STOCHASTIC, fold_in, tile_compress

    rows = _table(x, mesh, rows)
    n = rows[-1][1]
    n_local = x.shape[0]
    sched = tuple(sched)
    ru, rd = halo_reach(sched, n)
    plan = halo_pieces(rows, ru, rd)
    h = x.reshape(n_local, math.prod(x.shape[1:]))
    d = h.shape[1]
    k0 = key
    if quant in STOCHASTIC and k0 is not None:
        k0 = fold_in(k0, rdist.node_index(mesh))
    out = torch.empty_like(h)
    # chunks on statistic-tile boundaries, so each tile lies in one chunk
    top = max(b - a for a, b in rows)
    chunks = rdist.column_chunks(d, top, 4, multiple=min(block_d, d))
    for j, (c0, c1) in enumerate(chunks):
        hc = h[:, c0:c1].float()
        dv = None if valid_d is None else min(max(valid_d - c0, 0), c1 - c0)
        for r in range(rounds):
            k = None
            if k0 is not None:
                k = fold_in(k0, r)
                if len(chunks) > 1:
                    k = fold_in(k, j)
            q = (tile_compress(hc, quant, block_d, valid_d=dv, key=k,
                               per_node=True) if n_local else hc)
            ext = _ext_tile(q, plan, ru, mesh)
            hc = _slice_round(ext, sched, n, ru, n_local, self_term=hc)
            del ext, q
        out[:, c0:c1] = hc.to(x.dtype)
    return out.reshape(x.shape)
