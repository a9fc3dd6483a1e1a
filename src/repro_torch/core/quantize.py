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

from typing import Callable, Optional, Tuple

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
