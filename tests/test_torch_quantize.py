"""The port's message compressors (`repro_torch.core.quantize`) against
`repro.core.quantize` on the same numpy inputs.

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
