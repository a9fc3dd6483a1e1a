"""CUDA kernels for the mini-batch Krasulina pseudo-gradient, per node and —
for the decentralized D-Krasulina track — fused with the R-round gossip
consensus that follows it.

* `krasulina_xi_cuda` (`csrc/krasulina_xi.cu`) replaces the Pallas
  `krasulina_xi_pallas`: s = Z w, then xi = Z^T s / B - (mean(s^2) /
  ||w||^2) w, for G groups at once (the port's stand-in for `jax.vmap`).
  Its design is picked by shape (`xi_design`): "cluster-slab", one launch in
  which a thread-block cluster per group holds Z_g in shared memory, one
  column slice per block, and the blocks exchange their partial s and
  ||w||^2 through distributed shared memory, so Z, w and xi each cross HBM
  once; or "two-pass", where the slab does not fit or the TMA cannot take
  the rows, the row dots then column tiles, reading Z twice.
* `krasulina_xi_gossip_cuda` (`csrc/krasulina_xi_gossip.cu`) replaces
  `krasulina_xi_gossip_pallas`: per-node xi, then the R gossip rounds. Its
  design is picked by shape (`xi_gossip_design`): "one-read", one launch
  that reads Z once into shared memory, reduces s and ||w||^2 across the
  grid behind a grid barrier and applies the R rounds as one pass of the
  composed circulant (`consensus.gossip_taps`); or "two-pass", where the
  slab does not fit, the row dots then column tiles with every round on
  the resident tile.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import dist as rdist
from repro_torch.kernels import _cuda
from repro_torch.kernels.consensus import MAX_GOSSIP_NODES, gossip_taps

# the C `design` argument of krasulina_xi and of krasulina_xi_gossip
XI_DESIGNS = {"cluster-slab": 0, "two-pass": 1}
XI_GOSSIP_DESIGNS = {"one-read": 0, "two-pass": 1}
_BOX_MAX = 256  # the most elements along one dimension of a TMA box
_SLAB_THREADS = 256  # kSlabThreads in csrc/krasulina_xi.cu
_SLAB_CLUSTER = 16  # the largest cluster the cluster-slab launcher picks
# the blocks per cluster of the last cluster-slab launch of each
# (G, B, d, dtype), as its launcher picked them
xi_clusters: Dict[Tuple[int, int, int, torch.dtype], int] = {}
# the one-read kernel's grid-barrier words: one per (device, stream), zeroed
# when made and never reset; and zeroed words not yet given to a stream, one
# set per device, made at its first launch
_grid_barriers: Dict[Tuple[int, int], torch.Tensor] = {}
_spare_barriers: Dict[int, List[torch.Tensor]] = {}
_SPARE_BARRIERS = 8


def xi_slab_shape(B: int, d: int, C: int,
                  elem: int) -> Tuple[int, int, int, int, int]:
    """(cw, bc, nbc, br, nbr): how a cluster-slab block's slice of a group
    is cut into TMA boxes, as `slab_args` in csrc/krasulina_xi.cu does it:
    cw = nbc bc columns (ceil(d / C) rounded up to a multiple of 8, in nbc
    boxes of bc <= 256 columns), B rows in nbr boxes of br <= 256 rows (at
    least 4 boxes in all where B allows), br a multiple of the rows that
    fill whole 128-byte lines."""
    up = lambda v, a: -(-v // a) * a
    per = -(-d // C)
    nbc = -(-per // _BOX_MAX)
    bc = up(-(-per // nbc), 8)
    step = 1
    while step * bc * elem % 128:
        step *= 2
    want = -(-4 // nbc)
    nbr = -(-B // _BOX_MAX)
    if want > nbr:
        nbr = min(want, B)
    br = min(up(-(-B // nbr), step), _BOX_MAX)
    return nbc * bc, bc, nbc, br, -(-B // br)


def xi_slab_smem(B: int, d: int, C: int, elem: int) -> int:
    """Dynamic shared memory of one cluster-slab block, in bytes, as
    `slab_args` in csrc/krasulina_xi.cu lays it out: nb + 2 mbarriers; the
    nbc boxes of w, each 128-byte aligned; the slab, nbr br rows of each
    column box; f32 partials by column box, the block's own, C receive
    slots, the final values, and the row groups' column sums where a
    column's rows are split; plus 128 bytes to align its base."""
    up = lambda v, a: -(-v // a) * a
    cw, bc, nbc, br, nbr = xi_slab_shape(B, d, C, elem)
    e4, quads = up(B + 1, 4), cw // 4
    nrg = 1 if quads >= _SLAB_THREADS else min(_SLAB_THREADS // quads, 8)
    loads = up(8 * (nbr * nbc + 2), 128) + nbc * up(bc * elem, 128) \
        + nbc * nbr * br * bc * elem
    f32 = up(4 * nbc * (B + 1), 16) + 4 * e4 * (C + 1) + 4 * (e4 + 4) \
        + (4 * nrg * cw if nrg > 1 else 0)
    return loads + f32 + 128


def xi_design(G: int, B: int, d: int, dtype: torch.dtype,
              aligned: bool = True) -> str:
    """The krasulina_xi kernel that w [G, d] (or [d]), z [G, B, d] of `dtype`
    launch: "cluster-slab" where a block's slice of Z at the largest
    cluster (16 blocks) fits its shared memory and the TMA can take the rows
    (a 16-byte multiple of a row stride, w and z 16-byte aligned); else
    "two-pass". Which cluster size runs is the launcher's pick, from the
    card's occupancy (`xi_clusters`)."""
    elem = dtype.itemsize
    fits = (aligned and (d * elem) % 16 == 0
            and xi_slab_smem(B, d, _SLAB_CLUSTER, elem) <= _cuda.SMEM_BYTES)
    return "cluster-slab" if fits else "two-pass"


def xi_route(w: torch.Tensor, z: torch.Tensor) -> str:
    """The design that krasulina_xi_cuda(w, z) launches."""
    G, B, d = (1, *z.shape) if z.dim() == 2 else z.shape
    return xi_design(G, B, d, z.dtype,
                     aligned=(z.data_ptr() | w.data_ptr()) % 16 == 0)


def krasulina_xi_cuda(w: torch.Tensor, z: torch.Tensor, *,
                      _design: str = None) -> torch.Tensor:
    """w: [d]; z: [B, d] -> xi [d]. Batched: w [G, d] (or a shared [d]) and
    z [G, B, d] -> xi [G, d]. f32 or bf16, w and z of one dtype; the
    output has w's dtype, the arithmetic is f32 and the mean uses the true
    B. The design follows `xi_route`; `_design` forces one, for timing the
    two beside each other (the port's paths never pass it), and raises where
    "cluster-slab" cannot run."""
    if z.dim() not in (2, 3):
        raise ValueError(f"krasulina_xi: z must be [B, d] or [G, B, d], got "
                         f"{tuple(z.shape)}")
    single = z.dim() == 2
    G, B, d = (1, *z.shape) if single else z.shape
    _cuda.check("krasulina_xi z", z, tuple(z.shape))
    shared_w = w.dim() == 1
    _cuda.check("krasulina_xi w", w, (d,) if shared_w else (G, d))
    if w.dtype != z.dtype:
        raise TypeError(f"krasulina_xi: w is {w.dtype} but z is {z.dtype}")
    design = xi_route(w, z)
    if _design is not None:
        if _design not in XI_DESIGNS:
            raise ValueError(f"unknown krasulina_xi design {_design!r}")
        if _design == "cluster-slab" and design != "cluster-slab":
            raise ValueError(f"krasulina_xi: the cluster-slab kernel cannot "
                             f"take G={G} B={B} d={d} {z.dtype}")
        design = _design
    out = torch.empty((G, d), dtype=w.dtype, device=z.device)
    s = nrm2 = None
    if design == "two-pass":
        s = torch.empty((G, B), dtype=torch.float32, device=z.device)
        nrm2 = torch.empty((G,), dtype=torch.float32, device=z.device)
    cluster = ctypes.c_int(0)
    with torch.cuda.device(z.device):
        _cuda.call("krasulina_xi", w.data_ptr(), 0 if shared_w else d,
                   z.data_ptr(), G, B, d,
                   None if s is None else s.data_ptr(),
                   None if nrm2 is None else nrm2.data_ptr(), out.data_ptr(),
                   _cuda.DTYPE_CODES[z.dtype], XI_DESIGNS[design],
                   ctypes.byref(cluster), _cuda.stream_of(z))
    if design == "cluster-slab":
        xi_clusters[(G, B, d, z.dtype)] = cluster.value
    return out[0] if single else out


def one_read_tile_width(d: int, n_sms: int = _cuda.N_SMS) -> int:
    """Columns per block of the one-read kernel: the narrowest power of two
    from 32 up that needs no more column tiles than SMs (one block per SM,
    all resident at once)."""
    bd = 32
    while bd * n_sms < d:
        bd *= 2
    return bd


def one_read_smem(N: int, Bn: int, bd: int, elem: int) -> int:
    """Dynamic shared memory of one one-read block, in bytes: the layout of
    `OneReadLayout` in csrc/krasulina_xi_gossip.cu (N + 1 mbarriers; the w
    tile and a [Bn, bd] box of Z per node, each 128-byte aligned; f32 xi,
    the final s padded to 4 per node with ||w||^2, the gossip's weight
    table) plus 128 bytes to align its base."""
    up = lambda v, a: -(-v // a) * a
    loads = up(8 * (N + 1), 128) + up(N * bd * elem, 128) \
        + N * up(Bn * bd * elem, 128)
    return loads + 4 * (N * bd + N * up(Bn, 4) + N + 2 * N + 4) + 128


def xi_gossip_design(N: int, Bn: int, d: int, dtype: torch.dtype,
                     n_sms: int = _cuda.N_SMS, aligned: bool = True) -> str:
    """The krasulina_xi_gossip kernel that w [N, d], z [N, Bn, d] of `dtype`
    launch on a card of `n_sms` SMs: "one-read" where a block's [N, Bn, bd]
    slab of Z fits its shared memory with one block per SM, the TMA can
    take the rows (a 16-byte multiple of a row stride, w and z 16-byte
    aligned, at most 256 rows and columns to a box) and the composed
    schedule fits the kernel's taps (N <= MAX_GOSSIP_NODES); else
    "two-pass"."""
    elem = dtype.itemsize
    bd = one_read_tile_width(d, n_sms)
    fits = (aligned and N <= MAX_GOSSIP_NODES and Bn <= _BOX_MAX
            and bd <= _BOX_MAX and (d * elem) % 16 == 0
            and one_read_smem(N, Bn, bd, elem) <= _cuda.SMEM_BYTES)
    return "one-read" if fits else "two-pass"


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def xi_gossip_route(w: torch.Tensor, z: torch.Tensor) -> str:
    """The design that krasulina_xi_gossip_cuda(w, z, ...) launches."""
    N, Bn, d = z.shape
    return xi_gossip_design(N, Bn, d, z.dtype, _sm_count(z.device.index),
                            aligned=(z.data_ptr() | w.data_ptr()) % 16 == 0)


def _grid_barrier(device: torch.device, stream: int) -> torch.Tensor:
    """The one-read kernel's grid-barrier word for launches on `stream` (a
    CUDA stream handle) of `device`. Launches on one stream run one after
    another, so they may share a word; launches on two streams may overlap,
    so each stream has its own. A word is zeroed when made and never reset
    (each barrier adds 2^31 to it), so a CUDA graph's replay needs no
    memset. Under graph capture a new stream takes one of the device's
    spare words, zeroed at its first launch: a device must see one launch
    before a capture. A graph keeps the word of the stream it was captured
    on: replay it on one stream at a time."""
    key = (device.index, stream)
    bar = _grid_barriers.get(key)
    if bar is not None:
        return bar
    spares = _spare_barriers.get(device.index)
    if torch.cuda.is_current_stream_capturing():
        if not spares:
            raise RuntimeError("krasulina_xi_gossip: launch the one-read "
                               "kernel once on this device before capturing "
                               "it in a CUDA graph (its barrier words are "
                               "made then)")
        bar = spares.pop()
    else:
        if spares is None:
            _spare_barriers[device.index] = list(torch.zeros(
                (_SPARE_BARRIERS, 1), dtype=torch.int32, device=device))
        bar = torch.zeros(1, dtype=torch.int32, device=device)
    _grid_barriers[key] = bar
    return bar


def krasulina_xi_gossip_cuda(w: torch.Tensor, z: torch.Tensor, sched,
                             rounds: int, *,
                             _design: str = None) -> torch.Tensor:
    """w: [N, d] per-node iterates; z: [N, Bn, d] per-node mini-batches ->
    [N, d] gossip-mixed pseudo-gradients: R rounds of
    `sum_s w_s * roll(xi, s, axis=0)` applied to xi_n = krasulina_xi(w_n,
    z_n). R = 0 is the plain xi. The design follows `xi_gossip_route`;
    `_design` forces one, for timing the two beside each other (the port's
    paths never pass it), and raises where "one-read" cannot run."""
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if z.dim() != 3:
        raise ValueError(f"krasulina_xi_gossip: z must be [N, Bn, d], got "
                         f"{tuple(z.shape)}")
    n, bn, d = z.shape
    _cuda.check("krasulina_xi_gossip z", z, (n, bn, d))
    _cuda.check("krasulina_xi_gossip w", w, (n, d))
    if w.dtype != z.dtype:
        raise TypeError(f"krasulina_xi_gossip: w is {w.dtype} but z is "
                        f"{z.dtype}")
    design = xi_gossip_route(w, z)
    if _design is not None:
        if _design not in XI_GOSSIP_DESIGNS:
            raise ValueError(f"unknown krasulina_xi_gossip design "
                             f"{_design!r}")
        if _design == "one-read" and design != "one-read":
            raise ValueError(f"krasulina_xi_gossip: the one-read kernel "
                             f"cannot take N={n} Bn={bn} d={d} {z.dtype}")
        design = _design
    out = torch.empty((n, d), dtype=w.dtype, device=z.device)
    if design == "one-read":
        shifts, weights = gossip_taps(sched, rounds, n)
        n_terms = len(shifts)
        shifts = (ctypes.c_int * n_terms)(*shifts)
        weights = (ctypes.c_float * n_terms)(*weights)
        bd = one_read_tile_width(d, _sm_count(z.device.index))
        # the partials of 32 tiles side by side for each entry, then the
        # final values
        tiles = -(-d // bd)
        scratch = torch.empty(((-(-tiles // 32) * 32 + 1) * (n * bn + n),),
                              dtype=torch.float32, device=z.device)
        stream = _cuda.stream_of(z)
        bar = _grid_barrier(z.device, stream.value).data_ptr()
    else:
        n_terms, shifts, weights = _cuda.schedule_args(sched, n)
        # s [N, Bn] and the per-node coefficients share the block's shared
        # memory
        bd = _cuda.tile_width(n, d, fixed_bytes=4 * (n * bn + n))
        scratch = torch.empty((n * bn + n,), dtype=torch.float32,
                              device=z.device)
        bar = None
    with torch.cuda.device(z.device):
        _cuda.call("krasulina_xi_gossip", w.data_ptr(), z.data_ptr(), n, bn,
                   d, bd, scratch.data_ptr(), bar, out.data_ptr(),
                   _cuda.DTYPE_CODES[z.dtype], XI_GOSSIP_DESIGNS[design],
                   rounds, n_terms, shifts, weights, _cuda.stream_of(z))
    return out


# ---------------------------------------------------------------------------
# Partitioning rule for a sharded node axis
# ---------------------------------------------------------------------------


def krasulina_xi_gossip_shard(w: torch.Tensor, z: torch.Tensor, sched,
                              rounds: int, mesh,
                              rows: Optional[rdist.RowTable] = None
                              ) -> torch.Tensor:
    """Fused xi + R-round gossip over a node axis split over the node axes
    of `mesh` as `rows` says (`consensus.gossip_mix_shard`; default
    evenly). w: this rank's rows [n_local, d]; z: its samples
    [n_local, B, d]. The xi pass (Alg. 2 step 4) is node-local, so each
    rank computes its own rows' pseudo-gradients without any exchange
    (through `kernels.ops.krasulina_xi`: the `krasulina_xi` kernel on the
    card); only the consensus rounds communicate, as the halo rounds of
    `consensus.gossip_mix_shard`. Equals the strict per-round form
    `gossip_mix_ref(krasulina_xi_ref(w, z), sched, rounds)` on the rank's
    rows to f32 round-off (bit for bit on the CPU)."""
    from repro_torch.kernels.consensus import gossip_mix_shard
    from repro_torch.kernels.ops import krasulina_xi

    return gossip_mix_shard(krasulina_xi(w, z), sched, rounds, mesh, rows)
