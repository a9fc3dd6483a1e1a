"""The port's kernel modules against the JAX package, on identical numpy
inputs: each plain PyTorch version (`repro_torch.kernels.ref`, the CPU path
of `repro_torch.kernels.ops`) is held against the JAX plain function and
against the Pallas kernel in interpret mode, at the reference tests'
tolerances and shape sweeps (`tests/test_kernels.py`,
`tests/test_consensus_engine.py`, `tests/test_krasulina_engine.py`).

The hand-written kernels themselves are held against these plain versions
on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmix
from repro.kernels import ref as jref
from repro.kernels.consensus import gossip_mix_pallas
from repro.kernels.krasulina_update import (krasulina_xi_gossip_pallas,
                                            krasulina_xi_pallas)
from repro_torch.core import mixing as tmix
from repro_torch.kernels import _cuda, ops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(shape, seed, dtype="float32"):
    """The same numbers as a JAX and a torch array (bf16 rounds identically
    from the same f32 values in both)."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _split(sched):
    return tuple(s for s, _ in sched), tuple(w for _, w in sched)


# ---------------------------------------------------------------------------
# krasulina_xi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,d", [(8, 16), (256, 128), (300, 257), (1024, 64),
                                 (5, 3072)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_krasulina_xi_plain_matches_jax_and_pallas(B, d, dtype):
    """rtol 1e-4 / atol 5e-4 (f32) and 5e-2 (bf16), the reference's bounds
    for its tiled kernel against its one-shot oracle."""
    jw, tw = _pair((d,), 0, dtype)
    jz, tz = _pair((B, d), 1, dtype)
    got = ops.krasulina_xi(tw, tz)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (d,)
    rtol, atol = (1e-4, 5e-4) if dtype == "float32" else (5e-2, 5e-2)
    for want in (jref.krasulina_xi_ref(jw, jz),
                 krasulina_xi_pallas(jw, jz, interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol)


def test_krasulina_xi_plain_matches_problem_definition():
    """`kernels.ref` against the algorithm's definition in `core.problems`,
    in both packages (rtol 1e-5 / atol 1e-6)."""
    from repro.core.problems import krasulina_xi as jcore_xi
    from repro_torch.core.problems import krasulina_xi as core_xi
    jw, tw = _pair((32,), 6)
    jz, tz = _pair((64, 32), 7)
    got = tref.krasulina_xi_ref(tw, tz).numpy()
    for want in (core_xi(tw, tz).numpy(), np.asarray(jcore_xi(jw, jz))):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shared_w", [True, False])
def test_krasulina_xi_batched_matches_vmap(shared_w):
    """The port's batched form (its stand-in for `jax.vmap`): w [G, d] or a
    shared [d], z [G, B, d] -> [G, d]. rtol 1e-5 / atol 1e-6."""
    G, B, d = 4, 7, 33
    jw, tw = _pair((d,) if shared_w else (G, d), 2)
    jz, tz = _pair((G, B, d), 3)
    if shared_w:
        want = jax.vmap(lambda zb: jref.krasulina_xi_ref(jw, zb))(jz)
    else:
        want = jax.vmap(jref.krasulina_xi_ref)(jw, jz)
    np.testing.assert_allclose(_f32(ops.krasulina_xi(tw, tz)), _f32(want),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# krasulina_xi_gossip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,Bn,d,R,block_d", [
    (4, 2, 32, 1, 32),
    (8, 4, 70, 3, 32),   # ragged d
    (8, 3, 256, 8, 64),
])
def test_krasulina_xi_gossip_plain_matches_jax_and_pallas(N, Bn, d, R, block_d):
    """The composed-schedule plain version against the reference's strict
    per-round oracle and its Pallas kernel: rtol 1e-4 / atol 1e-5."""
    jw, tw = _pair((N, d), 0)
    jz, tz = _pair((N, Bn, d), 1)
    sched = jmix.schedule("ring", N)
    got = ops.krasulina_xi_gossip(tw, tz, tmix.schedule("ring", N), R)
    oracle = jref.gossip_mix_ref(jax.vmap(jref.krasulina_xi_ref)(jw, jz),
                                 sched, R)
    kern = krasulina_xi_gossip_pallas(jw, jz, *_split(sched), R,
                                      block_d=block_d, interpret=True)
    for want in (oracle, kern, jref.krasulina_xi_gossip_ref(jw, jz, sched, R)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-5)
    # the port's own strict per-round form agrees too
    strict = tref.gossip_mix_ref(tref.krasulina_xi_ref(tw, tz), sched, R)
    np.testing.assert_allclose(_f32(got), _f32(strict), rtol=1e-4, atol=1e-5)


def test_krasulina_xi_gossip_zero_rounds_is_plain_xi():
    jw, tw = _pair((4, 16), 2)
    jz, tz = _pair((4, 3, 16), 3)
    got = ops.krasulina_xi_gossip(tw, tz, tmix.schedule("ring", 4), 0)
    want = jax.vmap(jref.krasulina_xi_ref)(jw, jz)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# gossip_mix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(8, 64), (16, 512), (16, 700), (5, 33)])
@pytest.mark.parametrize("topo,rounds", [("ring", 1), ("ring", 8),
                                         ("circulant2", 4)])
def test_gossip_mix_plain_matches_jax_and_pallas(n, d, topo, rounds):
    """rtol / atol 1e-5, the reference's bound for its kernel."""
    jx, tx = _pair((n, d), 4)
    sched = jmix.schedule(topo, n)
    got = ops.gossip_mix(tx, tmix.schedule(topo, n), rounds)
    for want in (jref.gossip_mix_ref(jx, sched, rounds),
                 gossip_mix_pallas(jx, *_split(sched), rounds, interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def test_gossip_mix_bf16_and_trailing_dims():
    """bf16 in, bf16 out, against the f32 dense operator at the reference's
    bf16 bound (5e-2); trailing dims are flattened and restored."""
    n = 16
    jx, tx = _pair((n, 4, 64), 5, "bfloat16")
    sched = tmix.schedule("ring", n)
    got = ops.gossip_mix(tx, sched, 4)
    assert got.dtype == torch.bfloat16 and got.shape == (n, 4, 64)
    A4 = np.linalg.matrix_power(tmix.schedule_matrix(sched, n), 4)
    want = (A4 @ _f32(tx).reshape(n, -1)).reshape(n, 4, 64)
    np.testing.assert_allclose(_f32(got), want, rtol=5e-2, atol=5e-2)
    kern = gossip_mix_pallas(jx, *_split(sched), 4, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(kern), rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# Dispatch and launch helpers (CPU)
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_plain_version_and_count_no_launch():
    ops.reset_launches()
    w, z = torch.randn(3, 8), torch.randn(3, 5, 8)
    sched = tmix.schedule("ring", 3)
    ops.krasulina_xi(w, z)
    ops.krasulina_xi_gossip(w, z, sched, 2)
    ops.gossip_mix(w, sched, 2)
    assert ops.launches == {"krasulina_xi": 0, "krasulina_xi_gossip": 0,
                            "gossip_mix": 0}


def test_dispatch_refuses_other_devices():
    """Only all-CPU (plain) or all-CUDA (kernel) inputs are taken."""
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="devices"):
        ops.gossip_mix(x, tmix.schedule("ring", 4), 1)


def test_kernel_wrappers_refuse_cpu_tensors():
    """Called directly, a kernel wrapper raises on a CPU tensor instead of
    computing anything (no fallback to the plain version)."""
    from repro_torch.kernels.consensus import gossip_mix_cuda
    from repro_torch.kernels.krasulina_update import (krasulina_xi_cuda,
                                                      krasulina_xi_gossip_cuda)
    w, z = torch.randn(3, 8), torch.randn(3, 5, 8)
    sched = tmix.schedule("ring", 3)
    with pytest.raises(ValueError, match="CUDA"):
        gossip_mix_cuda(w, sched, 1)
    with pytest.raises(ValueError, match="CUDA"):
        krasulina_xi_cuda(w, z)
    with pytest.raises(ValueError, match="CUDA"):
        krasulina_xi_gossip_cuda(w, z, sched, 1)


@pytest.mark.parametrize("n,d,fixed,want", [
    (10, 3072, 0, 32),       # ~96 tiles for 132 SMs
    (16, 32768, 0, 256),     # 128 tiles
    (10, 70, 0, 32),
    (4, 10_000_000, 0, 512),  # capped at 512 columns
    (200, 32768, 0, 128),    # shared memory caps the width
])
def test_tile_width(n, d, fixed, want):
    assert _cuda.tile_width(n, d, fixed) == want
    assert 2 * 4 * n * want + fixed <= _cuda.SMEM_BYTES


def test_tile_width_refuses_rows_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.tile_width(1000, 64)


def test_schedule_args_normalise_shifts():
    n_terms, shifts, weights = _cuda.schedule_args(tmix.schedule("ring", 10),
                                                   10)
    assert n_terms == 3
    assert list(shifts) == [0, 9, 1]
    np.testing.assert_allclose(list(weights), [1 / 3] * 3, rtol=1e-6)
    with pytest.raises(ValueError, match="terms"):
        _cuda.schedule_args(tuple((s, 0.01) for s in range(40)), 64)
