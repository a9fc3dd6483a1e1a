"""The port's message compressors (`repro_torch.core.quantize`) against
`repro.core.quantize` on the same numpy inputs.

The statistics at the reference's positions (`Slots`): M blocks of each
leaf of a reference row (a stack of layers, or a packed buffer), cut in one
process as M ranks of a model axis hold them, reduced into the slots by
each "rank", the straddling slots completed across the ranks as the
model group's all-reduce completes them: every rank's compressed blocks
are the reference's `tile_compress` (or global compressor) of the whole
row, at the tolerances below.

Deterministic compressors: the int8 integer levels match exactly and the
dequantized values to rtol 1e-6 (the scales are the same f32 max and
division); sign values to rtol 1e-6 / atol 1e-7 (the mean's sum is taken in
another order). The stochastic int8 compressor draws from a
`torch.Generator`, which cannot give threefry's numbers: it is held to
unbiasedness and to "every value is an adjacent integer level", as
`tests/test_consensus_engine.py` holds the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro_torch.core import quantize as tq


def _pair(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("shape", [(8, 24), (5, 3, 7), (400,)])
@pytest.mark.parametrize("masked", [False, True])
def test_global_compressors_match_reference(shape, masked):
    jx, tx = _pair(shape, 0)
    jm = tm = None
    if masked:  # the last column is pad: zero, and masked out of the stats
        keep = np.arange(shape[-1]) < shape[-1] - 1
        jx, tx = jnp.where(keep, jx, 0), torch.where(torch.from_numpy(keep),
                                                     tx, 0)
        jm, tm = jnp.asarray(keep), torch.from_numpy(keep)
    np.testing.assert_allclose(_np(tq.sign_compress(tx, mask=tm)),
                               _np(jq.sign_compress(jx, mask=jm)),
                               rtol=1e-6, atol=1e-7)
    got, want = tq.int8_compress(tx, mask=tm), jq.int8_compress(jx, mask=jm)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)
    scale = float(np.abs(_np(tx)).max()) / 127.0
    np.testing.assert_array_equal(np.round(_np(got) / scale),
                                  np.round(_np(want) / scale))


@pytest.mark.parametrize("name", ["sign", "int8"])
@pytest.mark.parametrize("widths", [(3, 5, 8), (1, 40, 2, 0, 7), (16,)])
def test_segment_statistics_match_reference(name, widths):
    d = sum(widths)
    jx, tx = _pair((6, d), 1)
    for kind in ("mean_abs", "max_abs"):
        np.testing.assert_allclose(
            _np(tq.segment_scales(tx, widths, kind)),
            _np(jq.segment_scales(jx, widths, kind)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        _np(tq.make_compressor(name, seg_widths=widths)(tx)),
        _np(jq.make_compressor(name, seg_widths=widths)(jx)),
        rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="sum"):
        tq.segment_scales(tx, widths + (1,), "max_abs")


def test_row_max_is_the_leading_axis_max():
    jx, tx = _pair((5, 9), 2)
    np.testing.assert_array_equal(_np(tq._row_max(tx.abs())),
                                  _np(jq._row_max(jnp.abs(jx))))


@pytest.mark.parametrize("d,block_d,valid_d", [(64, 64, None), (130, 32, None),
                                               (33, 16, None), (49, 16, 40),
                                               (70, 512, 61), (10, 4, 0)])
def test_tile_valid_counts_match_reference(d, block_d, valid_d):
    np.testing.assert_array_equal(tq.tile_valid_counts(d, block_d, valid_d),
                                  jq.tile_valid_counts(d, block_d, valid_d))


@pytest.mark.parametrize("name", ["sign", "int8"])
@pytest.mark.parametrize("per_node", [False, True])
@pytest.mark.parametrize("n,d,block_d,valid_d", [(8, 64, 64, None),
                                                 (8, 130, 32, None),
                                                 (5, 33, 16, None),
                                                 (4, 49, 16, 40),
                                                 (3, 20, 512, None)])
def test_tile_compress_matches_reference(name, per_node, n, d, block_d,
                                         valid_d):
    jx, tx = _pair((n, d), 3)
    if valid_d is not None:  # pad columns are zero by contract
        jx, tx = jx.at[:, valid_d:].set(0), tx.clone()
        tx[:, valid_d:] = 0
    got = tq.tile_compress(tx, name, block_d, valid_d=valid_d,
                           per_node=per_node)
    want = jq.tile_compress(jx, name, block_d, valid_d=valid_d,
                            per_node=per_node)
    assert got.shape == (n, d) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-7)


def test_tile_compress_bf16_computes_in_f32():
    a = np.random.default_rng(4).standard_normal((6, 40)).astype(np.float32)
    got = tq.tile_compress(torch.from_numpy(a).bfloat16(), "int8", 16)
    want = jq.tile_compress(jnp.asarray(a, jnp.bfloat16), "int8", 16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("form", ["global", "segment", "tile"])
def test_int8_stoch_rounds_to_adjacent_levels(form):
    """Every dequantized value is an integer level next to x/scale; the
    same key gives the same draw, another key another."""
    _, x = _pair((1, 400), 22)
    scale = float(x.abs().max()) / 127.0
    run = {
        "global": lambda k: tq.int8_stoch_compress(x, key=k),
        "segment": lambda k: tq.make_compressor(
            "int8_stoch", key=k, seg_widths=(400,))(x),
        "tile": lambda k: tq.tile_compress(x, "int8_stoch", 512, key=k),
    }[form]
    out = run(3)
    q = out.numpy() / scale
    np.testing.assert_allclose(q, np.round(q), atol=1e-4)
    assert np.all(np.abs(q - x.numpy() / scale) <= 1.0 + 1e-4)
    np.testing.assert_array_equal(out.numpy(), run(3).numpy())
    assert not np.array_equal(out.numpy(), run(4).numpy())


def test_int8_stoch_is_unbiased():
    """E[dequant] = x: the mean over 200 keys lies within 0.25 of a
    quantization step of x everywhere (about 4 sigma of that mean)."""
    _, x = _pair((64,), 23)
    outs = torch.stack([tq.int8_stoch_compress(x, key=k) for k in range(200)])
    scale = float(x.abs().max()) / 127.0
    assert float((outs.mean(0) - x).abs().max()) < 0.25 * scale


def test_int8_stoch_keeps_dtype_and_default_key():
    """bf16 in, bf16 out; `key=None` is one fixed seed, the same at every
    call, as in the reference."""
    _, x = _pair((3, 8), 24)
    a = tq.int8_stoch_compress(x.bfloat16())
    assert a.dtype == torch.bfloat16
    b = tq.int8_stoch_compress(x.bfloat16())
    np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


def test_fold_in_is_deterministic_and_spreads():
    keys = {tq.fold_in(k, r) for k in range(20) for r in range(20)}
    assert len(keys) == 400
    assert tq.fold_in(7, 3) == tq.fold_in(7, 3)
    assert all(0 <= k < 2 ** 63 for k in keys)


def test_registry_and_factory():
    assert tq.STOCHASTIC == jq.STOCHASTIC
    assert set(tq.COMPRESSORS) == set(jq.COMPRESSORS)
    _, x = _pair((4, 6), 25)
    assert tq.make_compressor("none")(x) is x
    for name in ("sign", "int8"):
        np.testing.assert_array_equal(tq.make_compressor(name)(x).numpy(),
                                      tq.COMPRESSORS[name](x).numpy())
    with pytest.raises(ValueError, match="unknown"):
        tq.make_compressor("int4")
    with pytest.raises(ValueError, match="unknown"):
        tq.tile_compress(x, "int4", 4)


# (layouts of one reference row: (whole shape, split dim or None), model
# extent): column splits (wk-like runs), row splits, 3-dim leaves, and
# leaves kept whole beside them
SLOT_ROWS = [
    ([((8, 12), 1), ((10, 6), 0), ((7,), None), ((4, 6, 4), 2)], 2),
    ([((16, 8), 1), ((8, 12), 0), ((5, 3), None), ((4, 16), 1)], 4),
    ([((6, 32), 1), ((6, 32), 1)], 4),  # a stack of 2 layers, runs of 8
    ([((3, 5), None), ((12, 20), 0), ((2, 4, 6), 1)], 2),
]


def _cut(whole, shape, split, M, m):
    """Rank m's block of a whole [n, *shape] leaf split on `split`."""
    if split is None:
        return whole
    size = shape[split] // M
    return whole.narrow(1 + split, m * size, size)


def _rank_stats(leaves, layouts, M, slots_of, stat, per_node):
    """Each rank's blocks ([n, entries]) and its completed statistics: its
    partials, the straddling slots reduced over the M ranks."""
    from repro_torch.core import quantize as q

    blocks, parts, slots = [], [], []
    for m in range(M):
        maps = q.block_maps(layouts, M, m)
        sl = slots_of(maps, m)
        bl = [_cut(x, shape, split, M, m).reshape(x.shape[0], -1)
              for x, (shape, split) in zip(leaves, layouts)]
        blocks.append(bl)
        slots.append(sl)
        parts.append(q.slot_partials(bl, sl, stat, per_node=per_node))
    st = torch.as_tensor(slots[0].straddling, dtype=torch.long)
    stack = torch.stack([p.float() for p in parts])
    done = stack.sum(0) if stat == "sum" else stack.amax(0)
    out = []
    for p in parts:
        c = p.float()
        c[:, st] = done[:, st]
        out.append(c)
    return blocks, slots, out


@pytest.mark.parametrize("name", ["sign", "int8"])
@pytest.mark.parametrize("per_node", [False, True])
@pytest.mark.parametrize("block_d", [8, 12, 64])
@pytest.mark.parametrize("row", range(len(SLOT_ROWS)))
def test_blocks_take_the_whole_rows_tile_statistics(name, per_node, block_d,
                                                    row):
    """Every rank's blocks, compressed with the statistics of their tiles
    completed over the ranks, are the reference's `tile_compress` of the
    whole row; the straddling slots are those a second rank holds part of,
    and a layout whose runs fill whole tiles has none."""
    layouts, M = SLOT_ROWS[row]
    rng = np.random.default_rng(40 + row)
    n = 3
    leaves = [torch.from_numpy(rng.standard_normal(
        (n,) + shape).astype(np.float32)) for shape, _ in layouts]
    whole = torch.cat([x.reshape(n, -1) for x in leaves], 1)
    D = whole.shape[1]
    bd = min(block_d, D)
    stat = "sum" if name == "sign" else "max"
    blocks, slots, stats = _rank_stats(
        leaves, layouts, M, lambda maps, m: tq.Slots(maps, bd, D, D, index=m),
        stat, per_node)
    want = np.asarray(jq.tile_compress(jnp.asarray(whole.numpy()), name,
                                       block_d, per_node=per_node))
    for m in range(M):
        sl = slots[m]
        scale = tq.slot_scales(stats[m], sl, name, 1 if per_node else n)
        for i, (b, bm) in enumerate(zip(blocks[m], sl.maps)):
            got = tq.slot_compress(b, sl, i, scale, name)
            pos = bm.position(torch.arange(bm.size)).numpy()
            np.testing.assert_allclose(_np(got), want[:, pos], rtol=1e-6,
                                       atol=1e-7)
    # a slot straddles where its entries lie on more than one rank
    owner = np.full(D, -1)
    for m in range(M):
        for bm in slots[m].maps:
            if not bm.whole:
                owner[bm.position(np.arange(bm.size))] = m
    tiles = [set(owner[s * bd:(s + 1) * bd]) for s in range(-(-D // bd))]
    want_st = [s for s, t in enumerate(tiles)
               if len(t - {-1}) > 1 or (-1 in t and len(t) > 1)]
    np.testing.assert_array_equal(slots[0].straddling, want_st)


@pytest.mark.parametrize("name", ["sign", "int8"])
@pytest.mark.parametrize("row", range(len(SLOT_ROWS)))
def test_blocks_take_the_whole_rows_global_statistics(name, row):
    """One slot for the whole row ("global"): the compressed blocks are
    the reference's global compressor of the whole row."""
    layouts, M = SLOT_ROWS[row]
    rng = np.random.default_rng(60 + row)
    n = 4
    leaves = [torch.from_numpy(rng.standard_normal(
        (n,) + shape).astype(np.float32)) for shape, _ in layouts]
    whole = torch.cat([x.reshape(n, -1) for x in leaves], 1)
    D = whole.shape[1]
    stat = "sum" if name == "sign" else "max"
    blocks, slots, stats = _rank_stats(
        leaves, layouts, M,
        lambda maps, m: tq.Slots(maps, 0, D, D, seg=(0,) * len(maps),
                                 index=m), stat, False)
    want = np.asarray(jq.COMPRESSORS[name](jnp.asarray(whole.numpy())))
    for m in range(M):
        sl = slots[m]
        scale = tq.slot_scales(stats[m], sl, name, n)
        for i, (b, bm) in enumerate(zip(blocks[m], sl.maps)):
            got = tq.slot_compress(b, sl, i, scale, name)
            pos = bm.position(torch.arange(bm.size)).numpy()
            np.testing.assert_allclose(_np(got), want[:, pos], rtol=1e-6,
                                       atol=1e-7)


def test_aligned_blocks_need_no_message():
    """Runs that start and end on tile boundaries (w a multiple of bd)
    leave no slot straddling, and every leaf aligned; wk-like runs of
    half a tile straddle every tile."""
    maps = tq.block_maps([((4, 64), 1), ((32, 8), 0), ((16,), None)], 4, 1)
    sl = tq.Slots(maps, 16, sum(b.span for b in maps),
                  sum(b.span for b in maps), index=1)
    assert len(sl.straddling) == 0 and all(sl.aligned)
    maps = tq.block_maps([((4, 64), 1)], 4, 2)
    sl = tq.Slots(maps, 32, 256, 256, index=2)
    np.testing.assert_array_equal(sl.straddling, np.arange(8))
    assert sl.aligned == (False,)


def test_int8_stoch_blocks_are_deterministic_and_unbiased():
    """A rank's stochastic compression with the completed scales repeats
    under its key and is unbiased: the mean over 200 keys lies within 0.25
    of a step of every entry."""
    maps = tq.block_maps([((6, 16), 1)], 2, 1)
    sl = tq.Slots(maps, 8, 96, 96, index=1)
    x = torch.from_numpy(np.random.default_rng(70).standard_normal(
        (2, 48)).astype(np.float32))
    part = tq.slot_partials([x], sl, "max")
    scale = tq.slot_scales(part, sl, "int8_stoch", 2)
    run = lambda k: tq.slot_compress(x, sl, 0, scale, "int8_stoch", key=k)
    np.testing.assert_array_equal(run(5).numpy(), run(5).numpy())
    outs = torch.stack([run(k) for k in range(200)])
    step = scale.index_select(1, sl.slot_of(0, torch.arange(48)))
    assert bool(((outs.mean(0) - x).abs() < 0.25 * step).all())
