"""Message compressors for consensus rounds (paper Section VI, "Message
quantization" — signSGD [125] and int8 rounding, deterministic and
stochastic). Applied to gossip messages in `core.averaging` /
`core.mixing`.

Three statistics granularities, selected by `core.mixing.CirculantMixOp.stats`:

* **global**  — one scale per message array (`sign_compress` /
  `int8_compress`): the oracle.
* **segment** — one scale per leaf segment of a packed flat buffer
  (`core.packing`): the per-leaf path's statistics on the single packed
  buffer.
* **tile**    — one scale per `[n, block_d]` column tile (`tile_compress`):
  the statistics the CUDA kernel computes in shared memory
  (`kernels.consensus.gossip_mix_quant_cuda`); this form is its plain
  version and the CPU path.

All stat reductions accept an optional validity `mask` so zero-padded columns
(hierarchical reduce-scatter padding, tile padding) never perturb the scales.

Stochastic rounding (`int8_stoch`) draws its uniforms from a
`torch.Generator`, where the reference uses threefry keys: the two agree in
distribution only (`docs/DESIGN.md` §Deviations item 4). A `key` here is an
integer seed; `fold_in` derives per-step and per-round keys from it, as
`jax.random.fold_in` does in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-12
_DEFAULT_SEED = 0x5EED
_MASK64 = (1 << 64) - 1

Key = Optional[int]


def fold_in(key: int, data: int) -> int:
    """A new integer key from (key, data): the splitmix64 finaliser of the
    pair, cut to 63 bits so it is a valid `torch.Generator` seed. The port's
    stand-in for `jax.random.fold_in`."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _uniform(key: Key, shape, device: torch.device) -> torch.Tensor:
    """f32 U[0, 1) of `shape` on `device`, from a `torch.Generator` seeded
    with `key` (None: the module's fixed seed, as the reference's
    `key=None`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_DEFAULT_SEED if key is None else int(key))
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


def _abs_mean(x: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return x.abs().mean()
    m = torch.broadcast_to(mask, x.shape)
    cnt = m.to(x.dtype).sum().clamp_min(1)
    return torch.where(m, x.abs(), 0).sum() / cnt


def _abs_max(x: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return x.abs().amax()
    return torch.where(mask, x.abs(), 0).amax()


def sign_compress(x: torch.Tensor, *, mask=None) -> torch.Tensor:
    """1-bit signSGD compressor with the scale-preserving mean-|x| factor."""
    return torch.sign(x) * _abs_mean(x, mask)


def int8_compress(x: torch.Tensor, *, mask=None) -> torch.Tensor:
    """Deterministic symmetric int8 quantization (dequantized back to float —
    models the wire format's precision loss)."""
    scale = _abs_max(x, mask).clamp_min(_EPS) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def int8_stoch_compress(x: torch.Tensor, *, key: Key = None,
                        mask=None) -> torch.Tensor:
    """Unbiased symmetric int8: floor(v + u), u ~ U[0, 1) rounds v up with
    probability frac(v), so E[dequant] = x (up to the clip). `key=None` uses
    a fixed seed — the same noise at every call; the mixing loop folds the
    round index in."""
    scale = _abs_max(x, mask).clamp_min(_EPS) / 127.0
    v = x.float() / scale.float()
    u = _uniform(key, x.shape, x.device)
    q = torch.clamp(torch.floor(v + u), -127, 127)
    return (q * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# Segment statistics (packed flat buffers, `core.packing`)
# ---------------------------------------------------------------------------


def segment_scales(x: torch.Tensor, seg_widths, kind: str) -> torch.Tensor:
    """Per-column scale vector [D] for a packed buffer x: [..., D] whose
    trailing axis is the concatenation of contiguous leaf segments of widths
    `seg_widths`: each segment gets the statistic (`kind`: "mean_abs" |
    "max_abs") it would get on the per-leaf path. Per-segment reductions are
    static contiguous slices (exact, unlike differences of a running sum)."""
    from repro_torch.core.packing import segment_sums

    widths = np.asarray(seg_widths, np.int64)
    d = int(widths.sum())
    if x.shape[-1] != d:
        raise ValueError(f"buffer width {x.shape[-1]} != sum(seg_widths)={d}")
    a = x.abs().reshape(-1, d)
    rows = a.shape[0]
    if kind == "mean_abs":
        col = a.sum(0)  # [D]
        cnt = torch.as_tensor(np.maximum(widths * rows, 1), dtype=col.dtype,
                              device=col.device)
        per_seg = segment_sums(col, widths) / cnt
    elif kind == "max_abs":
        col = _row_max(a)  # [D]
        per_seg = torch.stack([p.amax() if p.numel() else col.new_zeros(())
                               for p in torch.split(col, widths.tolist())])
    else:
        raise ValueError(f"unknown statistic {kind!r}")
    return torch.repeat_interleave(
        per_seg, torch.as_tensor(widths, device=per_seg.device), output_size=d)


def _row_max(a: torch.Tensor) -> torch.Tensor:
    """max over the (small) leading axis. The reference unrolls it into an
    elementwise chain for XLA's CPU backend; one `amax` gives the same
    values here (a max is exact in any order)."""
    return a.amax(0)


def _segment_compress(x, name, seg_widths, *, key: Key = None):
    if name == "sign":
        return torch.sign(x) * segment_scales(x, seg_widths, "mean_abs")
    s = segment_scales(x, seg_widths, "max_abs").clamp_min(_EPS) / 127.0
    if name == "int8":
        return torch.clamp(torch.round(x / s), -127, 127) * s
    if name == "int8_stoch":
        v = x.float() / s.float()
        u = _uniform(key, x.shape, x.device)
        return (torch.clamp(torch.floor(v + u), -127, 127) * s).to(x.dtype)
    raise ValueError(f"unknown compressor {name!r}")


# ---------------------------------------------------------------------------
# Tile statistics (the CUDA kernel's form; its plain version / CPU path)
# ---------------------------------------------------------------------------


def tile_valid_counts(d: int, block_d: int, valid_d: Optional[int] = None
                      ) -> np.ndarray:
    """Static per-tile count of valid columns for a [*, d] buffer tiled at
    `block_d` with columns >= `valid_d` being pad."""
    bd = min(block_d, d)
    tiles = -(-d // bd)
    dv = d if valid_d is None else valid_d
    lo = np.arange(tiles) * bd
    return np.clip(np.minimum(lo + bd, dv) - lo, 0, bd)


def tile_compress(x: torch.Tensor, name: str, block_d: int, *,
                  valid_d: Optional[int] = None, key: Key = None,
                  per_node: bool = False,
                  rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Quantize x: [n, D] with one scale per [n, block_d] column tile.

    Matches the statistics of `kernels.consensus.gossip_mix_quant_cuda`: f32
    computation, and the ragged tail / columns >= `valid_d` excluded from
    every statistic. Pad columns are REQUIRED to be zero (both pad sources —
    kernel tiling and the hierarchical reduce-scatter — zero-fill), so the
    statistics are plain reductions with static counts. Output dtype
    follows x.

    `per_node=True` keeps the node axis out of the statistic: one scale per
    [1, block_d] row tile — the statistic a real sender computes from its
    own message alone.

    `rows=(start, n_total)` says that x holds rows [start, start + n) of an
    n_total-row node axis (a rank's rows of a split axis, `per_node=True`):
    the stochastic compressor then draws the whole axis's uniforms and keeps
    these rows', so a rank's rows get the numbers that one process draws
    for them."""
    n, d = x.shape
    bd = min(block_d, d)
    tiles = -(-d // bd)
    pad = tiles * bd - d
    xf = x.float()
    if pad:
        xf = F.pad(xf, (0, pad))
    xt = xf.reshape(n, tiles, bd)
    a = xt.abs()
    if name == "sign":
        # `tile_valid_counts` made on the device (no host copy, so the
        # chain can be captured in a CUDA graph)
        dv = d if valid_d is None else valid_d
        lo = torch.arange(tiles, device=x.device) * bd
        per_tile = 1 if per_node else n
        cnt = (torch.clamp(dv - lo, 0, bd) * per_tile).clamp_min(1).float()
        # the sum of |x| is taken in f64 and rounded to f32 once, so the
        # scale does not depend on the order of the sum: the CUDA kernel
        # sums in its own order and still gets the same f32 scale, and a
        # value near 0 cannot change sign between the two on an ulp
        s = a.sum(2, dtype=torch.float64)  # [n, tiles]
        total = s if per_node else s.sum(0, keepdim=True)
        scale = total.float() / cnt
        out = torch.sign(xt) * scale[:, :, None]
    else:
        amax = a.amax(2) if per_node else a.amax(2).amax(0, keepdim=True)
        # divided by a tensor, not a Python number: on a CUDA tensor PyTorch
        # turns division by a host scalar into a product with its
        # reciprocal, which is an ulp off the correctly rounded quotient
        # the reference and the CUDA kernel take
        scale = (amax.clamp_min(_EPS) / amax.new_full((), 127.0))[:, :, None]
        v = xt / scale
        if name == "int8":
            out = torch.clamp(torch.round(v), -127, 127) * scale
        elif name == "int8_stoch":
            if rows is None:
                u = _uniform(key, v.shape, x.device)
            else:
                start, total = rows
                u = _uniform(key, (total, tiles, bd), x.device)[start:start + n]
            out = torch.clamp(torch.floor(v + u), -127, 127) * scale
        else:
            raise ValueError(f"unknown compressor {name!r}")
    out = out.reshape(n, tiles * bd)
    if pad:
        out = out[:, :d]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Statistics at the reference's positions
#
# The reference mixes whole leaves: its stacked [N, n_rep, ...] leaves, or
# the packed [N, D] buffers of them. So a statistic slot of its wire (a
# [n, block_d] tile of "tile", a [1, block_d] tile of "node" and of error
# feedback, a leaf of "global", a leaf segment of "segment") spans entries
# that the port holds in other tensors: the layers of a stack are leaves of
# their own, and over a model axis a rank holds a block of each leaf. A
# `BlockMap` places the entries of one node row of such a tensor in the
# reference's row; `Slots` lays the slots over the maps of one reference
# leaf or buffer. A rank reduces its entries into the slots
# (`slot_partials`); a slot that holds entries of more than one rank of a
# model group (`Slots.straddling`) is then completed by one f32 all-reduce
# over the group (`complete_slots`). A slot inside one rank's block needs
# no message, and a leaf whose runs start and end on slot boundaries needs
# none at all. No per-entry table is built: a position is computed from a
# few integers where it is used.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockMap:
    """Where the entries of one node row of a tensor lie in the reference's
    row: local entry l sits at `offset + (l // w) * L + m * w + l % w`.
    A leaf split over a model axis of extent L // w on one dim holds runs
    of w entries (the dim's share times the entries under it) every L (the
    dim's whole extent times them), at its model index m; a leaf kept
    whole over it (or on one process) is one run, w = L = size, m = 0."""

    offset: int  # the reference position of the leaf's first entry
    size: int  # entries of one node row of the tensor
    w: int
    L: int
    m: int = 0
    whole: bool = True

    @property
    def extent(self) -> int:
        """The ranks that split the leaf (1: kept whole)."""
        return 1 if self.whole else self.L // self.w

    @property
    def span(self) -> int:
        """The reference entries of the whole leaf."""
        return self.size * self.extent

    def position(self, l):
        """The reference position of local entry l (an int or a tensor)."""
        return self.offset + (l // self.w) * self.L + self.m * self.w \
            + l % self.w

    def before(self, p: int) -> int:
        """How many local entries lie before reference position p."""
        q = p - self.offset
        if q <= 0:
            return 0
        if q >= self.span:
            return self.size
        r, c = divmod(q, self.L)
        return min(r * self.w + min(max(c - self.m * self.w, 0), self.w),
                   self.size)


def block_map(shape: Sequence[int], split: Optional[int], extent: int = 1,
              index: int = 0, offset: int = 0) -> BlockMap:
    """The map of a rank's block of a leaf of `shape` (node axis left out)
    that the model axis (of `extent`, this rank at `index`) splits on dim
    `split` (None: kept whole), the leaf starting at `offset`."""
    total = math.prod(shape)
    if split is None or extent == 1:
        return BlockMap(offset, total, max(total, 1), max(total, 1))
    inner = math.prod(shape[split + 1:])
    L = shape[split] * inner
    return BlockMap(offset, total // extent, L // extent, L, index, False)


def block_maps(layouts, extent: int = 1, index: int = 0,
               offset: int = 0) -> Tuple[BlockMap, ...]:
    """The maps of leaves laid end to end in the reference's row from
    `offset`: `layouts` gives each one's (shape, split dim or None)."""
    out = []
    for shape, split in layouts:
        bm = block_map(shape, split, extent, index, offset)
        out.append(bm)
        offset += bm.span
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Slots:
    """The statistic slots of a reference row of `width` entries (the first
    `valid` of them real, the rest pad), whose entries the tensors of
    `maps` hold: one slot per `bd` entries (a tile; `bd` is the reference's
    min(block_d, width)), or with `seg` one slot per group of leaves
    (`seg[i]`, map i's slot: "global" has one, "segment" one a leaf of the
    reference). `index` is this rank's model index; maps of split leaves
    carry their own."""

    maps: Tuple[BlockMap, ...]
    bd: int
    width: int
    valid: int
    seg: Optional[Tuple[int, ...]] = None
    index: int = 0

    @functools.cached_property
    def n_slots(self) -> int:
        if self.seg is not None:
            return max(self.seg, default=-1) + 1
        return -(-self.width // self.bd) if self.width else 0

    def slot_range(self, i: int) -> Tuple[int, int]:
        """[first, last + 1) of the slots leaf i's entries fall in."""
        if self.seg is not None:
            return self.seg[i], self.seg[i] + 1
        bm = self.maps[i]
        if bm.span == 0:
            return 0, 0
        return bm.offset // self.bd, (bm.offset + bm.span - 1) // self.bd + 1

    def _owners(self, i: int) -> np.ndarray:
        """Per slot of leaf i: -1 where every rank holds the leaf's entries
        in it (kept whole), k where rank k alone does, -2 where several."""
        lo, hi = self.slot_range(i)
        bm = self.maps[i]
        if bm.whole:
            return np.full(hi - lo, -1, np.int64)
        if self.seg is not None:
            return np.full(hi - lo, -2, np.int64)
        s = np.arange(lo, hi, dtype=np.int64)
        a = np.maximum(s * self.bd, bm.offset) - bm.offset
        b = np.minimum((s + 1) * self.bd, bm.offset + bm.span) - bm.offset
        same = a // bm.w == (b - 1) // bm.w
        return np.where(same, (a // bm.w) % bm.extent, -2)

    @functools.cached_property
    def straddling(self) -> np.ndarray:
        """The slots (ascending) that hold entries of more than one rank of
        a model group: the slots a rank completes with the group's
        partials. Empty on one process."""
        label = np.full(self.n_slots, -3, np.int64)  # -3: no entry yet
        for i in range(len(self.maps)):
            lo, hi = self.slot_range(i)
            own, cur = self._owners(i), label[lo:hi]
            label[lo:hi] = np.where((cur == -3) | (cur == own), own, -2)
        return np.flatnonzero(label == -2)

    def counted_range(self, i: int) -> Tuple[int, int]:
        """The slots leaf i adds its entries to: all of its slots, save,
        on a rank other than the first of its model group, the slots at
        either end of a leaf kept whole that straddle (every rank holds
        those entries; the first rank counts them in the group's sum)."""
        lo, hi = self.slot_range(i)
        if not self.maps[i].whole or self.index == 0 or hi <= lo:
            return lo, hi
        st = self.straddling
        inside = lambda s: bool(np.isin(s, st))
        if inside(lo):
            lo += 1
        if hi > lo and inside(hi - 1):
            hi -= 1
        return lo, hi

    def counts(self, rows: int) -> np.ndarray:
        """The valid entries of each slot over `rows` node rows, at least 1
        (`tile_valid_counts`'s rule; a segment's or the leaf's entries)."""
        if self.seg is not None:
            per = np.zeros(self.n_slots, np.int64)
            for s, bm in zip(self.seg, self.maps):
                per[s] += bm.span
        else:
            per = tile_valid_counts(self.width, self.bd, self.valid)
        return np.maximum(per * rows, 1)

    def slot_of(self, i: int, l: torch.Tensor) -> torch.Tensor:
        """The slot of leaf i's local entries l (an int64 tensor)."""
        if self.seg is not None:
            return torch.full_like(l, self.seg[i])
        return self.maps[i].position(l) // self.bd

    @functools.cached_property
    def aligned(self) -> Tuple[bool, ...]:
        """Per leaf: whether its local [n, bd] tiles are the reference's
        slots, entry for entry: every run starts on a slot boundary and
        fills whole slots (a leaf kept whole may end on the row's ragged
        last slot), and no pad lies in them. Such a leaf's statistics need
        no other tensor and no message."""
        if self.seg is not None:
            return tuple(False for _ in self.maps)
        out = []
        for bm in self.maps:
            run = bm.size if bm.whole else bm.w
            end = bm.offset + bm.span
            out.append(bm.size > 0 and bm.offset % self.bd == 0
                       and end <= self.valid
                       and (run % self.bd == 0
                            or (bm.whole and end == self.width)))
        return tuple(out)


def slot_partials(xs: Sequence[Optional[torch.Tensor]], slots: Slots,
                  stat: str, *, per_node: bool = False, starts=None,
                  window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """This rank's statistics of the slots of `window` (default: every
    slot), [rows or 1, window's slots]: the sum of |x| in f64
    (`stat="sum"`) or the max of |x| in f32 ("max") over the entries of
    xs[i] ([rows, cnt]: leaf i's local entries from starts[i], default 0;
    None: none of leaf i's) that fall in the slots of
    `slots.counted_range(i)`; over every row of xs, or each row apart with
    `per_node`. A slot without an entry of this rank holds 0, the identity
    of both. The plain version of `kernels.ops.quant_slot_stats`."""
    lo_w, hi_w = window or (0, slots.n_slots)
    live = [x for x in xs if x is not None]
    rows = live[0].shape[0] if live else 0
    dev = live[0].device if live else None
    f64 = stat == "sum"
    out = torch.zeros((rows if per_node else 1, hi_w - lo_w),
                      dtype=torch.float64 if f64 else torch.float32,
                      device=dev)
    for i, x in enumerate(xs):
        if x is None or x.shape[-1] == 0:
            continue
        lo, hi = slots.counted_range(i)
        lo, hi = max(lo, lo_w), min(hi, hi_w)
        if hi <= lo:
            continue
        a = x.abs().to(torch.float64 if f64 else torch.float32)
        if not per_node:
            a = a.sum(0, keepdim=True) if f64 else a.amax(0, keepdim=True)
        l0 = 0 if starts is None else starts[i]
        slot = slots.slot_of(i, torch.arange(l0, l0 + x.shape[-1],
                                             device=dev))
        keep = (slot >= lo) & (slot < hi)
        idx = torch.where(keep, slot - lo_w, 0).expand_as(a)
        a = torch.where(keep, a, 0)
        out.scatter_reduce_(1, idx, a, "sum" if f64 else "amax")
    return out


def complete_slots(partial: torch.Tensor, slots: Slots, stat: str,
                   mesh=None, window: Optional[Tuple[int, int]] = None
                   ) -> torch.Tensor:
    """`partial` (the slots of `window`) with its straddling slots summed
    (`stat="sum"`) or maxed over this rank's model group: one f32
    all-reduce of those columns, logged as "slot all-reduce"
    (`dist.log`), none where no slot straddles or the mesh has no model
    axis. Returns the slots' f32 statistics."""
    from repro_torch import dist as rdist

    lo, hi = window or (0, slots.n_slots)
    st = slots.straddling
    st = st[(st >= lo) & (st < hi)] - lo
    if mesh is None or rdist.model_extent(mesh) == 1 or len(st) == 0:
        return partial.float()
    idx = torch.as_tensor(st, device=partial.device)
    msg = partial.index_select(1, idx).float().contiguous()
    op = torch.distributed.ReduceOp.SUM if stat == "sum" else \
        torch.distributed.ReduceOp.MAX
    rdist.all_reduce_(msg, mesh, op, axis="model", kind="slot all-reduce")
    out = partial.float()
    out.index_copy_(1, idx, msg)
    return out


def slot_scales(stats: torch.Tensor, slots: Slots, name: str, rows: int,
                window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The f32 scale of each slot of `window` from its statistic: mean |x|
    over the slot's valid entries on `rows` rows (sign; `tile_compress`'s
    division), or max(max |x|, eps) / 127 (int8)."""
    if name == "sign":
        lo, hi = window or (0, slots.n_slots)
        cnt = torch.as_tensor(slots.counts(rows)[lo:hi], dtype=torch.float32,
                              device=stats.device)
        return stats / cnt
    return stats.clamp_min(_EPS) / stats.new_full((), 127.0)


def slot_compress(x: torch.Tensor, slots: Slots, i: int,
                  scale: torch.Tensor, name: str, *, key: Key = None,
                  start: int = 0, window_lo: int = 0) -> torch.Tensor:
    """Leaf i's local entries x [rows, cnt] (from `start`) compressed with
    the scales of their slots (`scale` [rows or 1, slots from
    `window_lo`]), in f32, as `tile_compress` compresses with its own."""
    l = torch.arange(start, start + x.shape[-1], device=x.device)
    s = scale.index_select(1, slots.slot_of(i, l) - window_lo)
    xf = x.float()
    if name == "sign":
        return torch.sign(xf) * s
    v = xf / s
    if name == "int8":
        return torch.clamp(torch.round(v), -127, 127) * s
    if name == "int8_stoch":
        u = _uniform(key, v.shape, x.device)
        return torch.clamp(torch.floor(v + u), -127, 127) * s
    raise ValueError(f"unknown compressor {name!r}")


# ---------------------------------------------------------------------------
# Registry / factory
# ---------------------------------------------------------------------------

STOCHASTIC = ("int8_stoch",)

COMPRESSORS = {
    "none": lambda x: x,
    "sign": sign_compress,
    "int8": int8_compress,
    "int8_stoch": int8_stoch_compress,
}


def make_compressor(name: str, *, key: Key = None, mask=None, seg_widths=None
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Unary message compressor with the requested statistics.

    With every keyword at its default this is exactly ``COMPRESSORS[name]``.
    `seg_widths` (per-segment widths of a packed buffer) switches to
    per-leaf-segment statistics; `mask` excludes padded columns from the
    global statistics; `key` feeds stochastic compressors (ignored by
    deterministic ones)."""
    if name == "none":
        return lambda x: x
    if name not in COMPRESSORS:
        raise ValueError(f"unknown compressor {name!r}")
    if seg_widths is not None:
        return lambda x: _segment_compress(x, name, seg_widths, key=key)
    if name == "sign":
        return lambda x: sign_compress(x, mask=mask)
    if name == "int8":
        return lambda x: int8_compress(x, mask=mask)
    return lambda x: int8_stoch_compress(x, key=key, mask=mask)
