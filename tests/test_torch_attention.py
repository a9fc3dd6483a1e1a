"""The port's attention against the JAX package, on identical numpy inputs:
`kernels.ref.attention_ref` and `kernels.ops.attention` (its CPU path) are
held against the JAX `attention_ref` and the Pallas `flash_attention` in
interpret mode on `tests/test_kernels.py`'s cases and at head dim 256, at
its tolerances (2e-5 f32, 3e-2 bf16), and the plain model path against the JAX
`blockwise_attention` at 2e-4 (`tests/test_kernels.py:90`).

The hand-written kernel itself is held against `attention_ref` on the card
by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention
from repro.models.layers import blockwise_attention as jblockwise
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_variant, route
from repro_torch.models.layers import blockwise_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# tests/test_kernels.py CASES: (B, H, Sq, Sk, D, causal, window, chunk)
CASES = [
    (1, 2, 128, 128, 64, True, 0, 0),
    (2, 2, 256, 256, 64, True, 0, 0),
    (1, 1, 256, 256, 128, True, 64, 0),   # sliding window
    (1, 2, 256, 256, 64, True, 0, 128),   # chunked-local (iRoPE)
    (1, 1, 200, 200, 64, True, 0, 0),     # non-divisible seq (padding path)
    (1, 1, 128, 384, 64, True, 0, 0),     # decode-ish: Sq < Sk
]


def _qkv(B, H, Sq, Sk, D, seed, dtype="float32"):
    """The same numbers as JAX and torch arrays (bf16 rounds identically from
    the same f32 values in both)."""
    rng = np.random.default_rng(seed)
    shapes = ((B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D))
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,window,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax_ref_and_pallas(B, H, Sq, Sk, D, causal, window,
                                              chunk, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, H, Sq, Sk, D, 2, dtype)
    masks = dict(causal=causal, window=window, chunk=chunk)
    want = jref.attention_ref(jq, jk, jv, **masks)
    pallas = flash_attention(jq, jk, jv, interpret=True, **masks)
    ops.reset_launches()
    got = ops.attention(tq, tk, tv, **masks)
    assert ops.launches["flash_attention"] == 0  # the CPU takes the plain path
    assert got.dtype == tq.dtype and got.shape == (B, H, Sq, D)
    plain = tref.attention_ref(tq, tk, tv, **masks)
    assert torch.equal(got, plain)
    tol = TOL[dtype]
    for other in (want, pallas):
        np.testing.assert_allclose(_f32(got), _f32(other), rtol=tol, atol=tol)


# head dim 256 (recurrentgemma-9b's local attention), each mask kind, Sq
# and Sk not multiples of 64, and Sq < Sk unmasked (a cross-attention)
D256_CASES = [
    (1, 2, 136, 136, 256, True, 0, 0),
    (1, 1, 200, 200, 256, True, 64, 0),   # sliding window that binds
    (1, 2, 150, 150, 256, True, 0, 64),   # chunked-local
    (1, 2, 128, 128, 256, False, 0, 0),   # unmasked (an encoder)
    (2, 1, 72, 256, 256, False, 0, 0),    # cross-attention: Sq < Sk
    (1, 1, 40, 104, 256, False, 0, 0),    # one ragged block of keys
]


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,window,chunk", D256_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_256_matches_jax_ref_and_pallas(B, H, Sq, Sk, D, causal,
                                                 window, chunk, dtype):
    """The plain path at D = 256 against the JAX `attention_ref` and the
    Pallas kernel (which takes any D) in interpret mode, at the tolerances
    above; the kernel's route at this head dim is wgmma (bf16, aligned) or
    the f32 kernel."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, H, Sq, Sk, D, 9, dtype)
    masks = dict(causal=causal, window=window, chunk=chunk)
    got = ops.attention(tq, tk, tv, **masks)
    assert got.shape == (B, H, Sq, D)
    tol = TOL[dtype]
    for other in (jref.attention_ref(jq, jk, jv, **masks),
                  flash_attention(jq, jk, jv, interpret=True, **masks)):
        np.testing.assert_allclose(_f32(got), _f32(other), rtol=tol, atol=tol)
    assert route(tq, tk, tv) == ("f32" if dtype == "float32" else "wgmma")


def test_plain_path_matches_model_blockwise():
    """The port's attention (plain path and its model-side
    `blockwise_attention`) against the JAX `blockwise_attention`, in its
    [B, S, H, D] layout, at the reference's 2e-4."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 4, 192, 192, 64, 3)
    want = jblockwise(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                      jv.transpose(0, 2, 1, 3), causal=True, kv_block=64)
    want = _f32(want.transpose(0, 2, 1, 3))
    np.testing.assert_allclose(_f32(ops.attention(tq, tk, tv, causal=True)),
                               want, rtol=2e-4, atol=2e-4)
    got = blockwise_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), causal=True, kv_block=64)
    np.testing.assert_allclose(_f32(got.transpose(1, 2)), want, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("seed", [1, 7, 23, 64])
def test_attention_rows_are_convex_combinations(seed):
    """Each output row is a convex combination of value rows, so it lies
    within [min v, max v] (the property of tests/test_kernels.py:107)."""
    _, (q, k, v) = _qkv(1, 1, 128, 128, 32, seed)
    out = ops.attention(q, k, v, causal=True)
    assert out.max().item() <= v.max().item() + 1e-4
    assert out.min().item() >= v.min().item() - 1e-4


@pytest.mark.parametrize("Sq,Sk,window", [(96, 40, 16), (384, 200, 0)],
                         ids=["fully_masked_rows", "padded_keys"])
def test_ragged_rows_follow_attention_ref(Sq, Sk, window):
    """Causal Sq > Sk: keys at or past Sk are masked and a row with no live
    key is 0, as in the JAX `attention_ref`. The Pallas kernel disagrees on
    both (ROADMAP.md queue 3): a fully masked row comes out as a mean of v,
    and it pads Sk = 200 to its 128-key block with zero keys that rows at
    or past 200 attend to. The model path never calls it with Sq != Sk."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, Sq, Sk, 64, 5)
    masks = dict(causal=True, window=window)
    want = _f32(jref.attention_ref(jq, jk, jv, **masks))
    got = _f32(ops.attention(tq, tk, tv, **masks))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    if window:  # rows whose window ends before Sk have no live key
        assert np.all(got[:, :, Sk + window - 1:] == 0)
    pallas = _f32(flash_attention(jq, jk, jv, interpret=True, **masks))
    assert np.abs(pallas - want).max() > 1e-2


def test_unmasked_ragged_keys_refused_like_the_reference():
    """The reference's Pallas kernel refuses unmasked attention when Sk is
    not a multiple of min(128, Sk), because it pads keys with zeros that
    an unmasked row would attend to. The port masks keys at or past Sk, so
    it takes any Sk and gives the JAX `attention_ref`'s value there (an
    encoder or a cross-attention over 200 frames)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 1, 64, 200, 32, 6)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(jq, jk, jv, causal=False, interpret=True)
    np.testing.assert_allclose(
        _f32(ops.attention(tq, tk, tv, causal=False)),
        _f32(jref.attention_ref(jq, jk, jv, causal=False)), rtol=2e-5,
        atol=2e-5)
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 1, 64, 96, 32, 6)  # one 96-key block
    np.testing.assert_allclose(
        _f32(ops.attention(tq, tk, tv, causal=False)),
        _f32(jref.attention_ref(jq, jk, jv, causal=False)), rtol=2e-5,
        atol=2e-5)


def test_flash_wrapper_refuses_cpu_tensors():
    """Called directly, the kernel wrapper raises on a CPU tensor instead of
    computing anything (no fallback to the plain version)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = torch.randn(1, 1, 32, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)


@pytest.mark.parametrize("dtype,D,aligned,want", [
    (torch.bfloat16, 128, True, "wgmma"),
    (torch.bfloat16, 64, True, "wgmma"),
    (torch.bfloat16, 128, False, "mma_sync"),
    (torch.bfloat16, 96, True, "mma_sync"),
    (torch.bfloat16, 40, True, "mma_sync"),
    (torch.bfloat16, 20, True, "mma_sync"),
    (torch.float32, 128, True, "f32"),
    (torch.float32, 64, False, "f32"),
    (torch.bfloat16, 256, True, "wgmma"),
    (torch.float32, 256, True, "f32"),
    (torch.bfloat16, 256, False, "mma_sync"),
    (torch.float32, 256, False, "f32"),
])
def test_flash_variant_routes_by_shape(dtype, D, aligned, want):
    """bf16 at D in {64, 128, 256} and 16-byte aligned goes to the wgmma
    kernel, other bf16 head dims and unaligned bf16 to mma.sync, f32 to the
    FMA kernel."""
    assert flash_variant(dtype, D, aligned) == want


def test_flash_variant_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        flash_variant(torch.float16, 64, True)


def test_granite_prefill_routes_to_the_wgmma_kernel():
    """granite-8b's bf16 prefill (head dim 128) takes the wgmma kernel; its
    f32 reduced form takes the FMA kernel."""
    from repro_torch.configs import get_config, reduced
    cfg = get_config("granite-8b")
    q = torch.zeros(1, cfg.num_heads, 24, cfg.resolved_head_dim,
                    dtype=torch.bfloat16)
    assert route(q, q, q) == "wgmma"
    qr = torch.zeros(1, 2, 24, reduced(cfg).resolved_head_dim)
    assert route(qr, qr, qr) == "f32"


def test_route_reads_alignment_from_the_tensors():
    """A view that starts 2 bytes off a 16-byte boundary cannot be read by
    the TMA, so it routes to the mma.sync kernel."""
    q = torch.zeros(1, 1, 8, 128, dtype=torch.bfloat16)
    assert q.data_ptr() % 16 == 0 and route(q, q, q) == "wgmma"
    off = torch.zeros(1 + 8 * 128, dtype=torch.bfloat16)[1:].view(1, 1, 8, 128)
    assert route(off, q, q) == "mma_sync" and route(q, q, off) == "mma_sync"


def test_cpu_attention_counts_no_launch_by_kernel():
    ops.reset_launches()
    (_, _, _), (tq, tk, tv) = _qkv(1, 2, 40, 40, 64, 3, "bfloat16")
    ops.attention(tq, tk, tv)
    assert ops.launches["flash_attention"] == 0
    assert ops.flash_launches == {"wgmma": 0, "mma_sync": 0, "f32": 0}
