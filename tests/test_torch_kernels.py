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
from repro.kernels.consensus import gossip_mix_pallas, gossip_mix_quant_pallas
from repro.kernels.krasulina_update import (krasulina_xi_gossip_pallas,
                                            krasulina_xi_pallas)
from repro_torch.core import mixing as tmix
from repro_torch.kernels import _cuda, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.consensus import (MAX_GOSSIP_NODES, gossip_design,
                                           gossip_mix_cuda, gossip_taps,
                                           gossip_tile_width)

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


@pytest.mark.parametrize("shared_w", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_krasulina_xi_batched_matches_vmapped_pallas(shared_w, dtype):
    """The plain version the cluster-slab kernel is held to on the card,
    batched over G = 4 groups (B = 12, d = 320), against `jax.vmap` of the
    Pallas kernel (interpret mode) and of the JAX package's oracle: rtol
    1e-4 / atol 5e-4 (f32) and 5e-2 (bf16), the reference's bounds."""
    G, B, d = 4, 12, 320
    jw, tw = _pair((d,) if shared_w else (G, d), 30, dtype)
    jz, tz = _pair((G, B, d), 31, dtype)
    got = ops.krasulina_xi(tw, tz)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (G, d)
    if shared_w:
        kern = jax.vmap(lambda zb: krasulina_xi_pallas(jw, zb))(jz)
        oracle = jax.vmap(lambda zb: jref.krasulina_xi_ref(jw, zb))(jz)
    else:
        kern = jax.vmap(lambda wb, zb: krasulina_xi_pallas(wb, zb))(jw, jz)
        oracle = jax.vmap(jref.krasulina_xi_ref)(jw, jz)
    rtol, atol = (1e-4, 5e-4) if dtype == "float32" else (5e-2, 5e-2)
    for want in (kern, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("G,B,d,dtype,want", [
    (10, 100, 3072, torch.float32, "cluster-slab"),   # paths (b)-(e)
    (10, 100, 3072, torch.bfloat16, "cluster-slab"),
    (16, 4, 32768, torch.float32, "cluster-slab"),    # the wide shape
    (16, 4, 32768, torch.bfloat16, "cluster-slab"),
    (1, 5, 32768, torch.float32, "cluster-slab"),
    (10, 268, 3072, torch.float32, "cluster-slab"),   # the last slab that fits
    (10, 269, 3072, torch.float32, "two-pass"),       # just past shared memory
    (10, 492, 3072, torch.bfloat16, "cluster-slab"),
    (10, 493, 3072, torch.bfloat16, "two-pass"),
    (1, 1000, 3072, torch.float32, "two-pass"),       # 768 KB even at C = 16
    (1, 300, 257, torch.float32, "two-pass"),         # a row stride of 1028 B
    (4, 12, 320, torch.float32, "cluster-slab"),
])
def test_xi_design(G, B, d, dtype, want):
    """cluster-slab wherever one block's slice of a group at C = 16 fits its
    shared memory and the TMA can take the rows (a 16-byte multiple of a
    row stride); its shared memory is then within a block's."""
    from repro_torch.kernels.krasulina_update import xi_design, xi_slab_smem
    assert xi_design(G, B, d, dtype) == want
    fits = xi_slab_smem(B, d, 16, dtype.itemsize) <= _cuda.SMEM_BYTES
    assert fits == (want == "cluster-slab" or d % 4 != 0)


def test_xi_design_needs_aligned_rows():
    from repro_torch.kernels.krasulina_update import xi_design
    assert xi_design(10, 100, 3072, torch.float32,
                     aligned=False) == "two-pass"
    assert xi_design(10, 100, 3068, torch.bfloat16) == "two-pass"


@pytest.mark.parametrize("B,d,C,elem,want,smem", [
    # the main path: 16 slices of 192 columns, four boxes of 25 rows
    (100, 3072, 16, 4, (192, 192, 1, 25, 4), 89584),
    (100, 3072, 16, 2, (192, 192, 1, 25, 4), 50800),
    # the wide shape: 2,048 columns in eight 256-column boxes of 4 rows
    (4, 32768, 16, 4, (2048, 256, 8, 4, 1), 41968),
    (5, 32768, 16, 4, (2048, 256, 8, 5, 1), 50192),
    # 24-column rows of 96 bytes: boxes of 4 rows keep 128-byte lines
    (12, 320, 16, 4, (24, 24, 1, 4, 3), 3536),
    (12, 320, 16, 2, (24, 24, 1, 8, 2), 3152),
    (1000, 3072, 16, 4, (192, 192, 1, 250, 4), 849184),
    # two chunks of 152 columns, rows of 608 bytes: boxes of 4 rows
    (8, 4800, 16, 4, (304, 152, 2, 4, 2), 15872),
])
def test_xi_slab_layout(B, d, C, elem, want, smem):
    """The mirror of the kernel's `slab_args`: the boxes cover the slice
    (cw C >= d, B rows), stay within the TMA's 256 x 256 and start on
    128-byte lines; the shared memory adds up as the kernel lays it out."""
    from repro_torch.kernels.krasulina_update import (xi_slab_shape,
                                                      xi_slab_smem)
    cw, bc, nbc, br, nbr = xi_slab_shape(B, d, C, elem)
    assert (cw, bc, nbc, br, nbr) == want
    assert cw == nbc * bc and cw * C >= d and cw % 8 == 0
    assert bc <= 256 and br <= 256 and nbr * br >= B > (nbr - 1) * br
    assert br * bc * elem % 128 == 0
    assert xi_slab_smem(B, d, C, elem) == smem


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


@pytest.mark.parametrize("topo", ["ring", "circulant2", "torus"])
@pytest.mark.parametrize("n", [1, 5, 10, 16, 64])
@pytest.mark.parametrize("rounds", [0, 1, 8])
def test_gossip_mix_composed_taps_match_matrix_power(topo, n, rounds):
    """The taps the gossip_mix wrapper hands its kernel are the circulant of
    schedule_matrix(sched, n)**R (at most n of them, shifts in [0, n)); one
    pass over them in f32, as the kernel makes it, agrees with the JAX
    package's round-by-round gossip at the reference's 1e-5."""
    sched = tmix.schedule(topo, n)
    shifts, weights = gossip_taps(sched, rounds, n)
    assert len(shifts) <= n and all(0 <= s < n for s in shifts)
    rows = np.arange(n)
    A = np.zeros((n, n))
    for s, w in zip(shifts, weights):
        A[rows, (rows - s) % n] += w
    want = np.linalg.matrix_power(tmix.schedule_matrix(sched, n), rounds)
    np.testing.assert_allclose(A, want, rtol=0, atol=1e-12)
    jx, tx = _pair((n, 33), 9)
    one_pass = sum(np.float32(w) * np.roll(_f32(tx), s, 0)
                   for s, w in zip(shifts, weights))
    np.testing.assert_allclose(
        one_pass, _f32(jref.gossip_mix_ref(jx, jmix.schedule(topo, n), rounds)),
        rtol=1e-5, atol=1e-5)


def test_gossip_mix_taps_are_composed_once_per_schedule():
    """The callers pass the same one-round schedule every round: the taps are
    composed once per (schedule, R, n), whatever sequence type holds it."""
    sched = tmix.schedule("ring", 10)
    first = gossip_taps(sched, 8, 10)
    assert gossip_taps([list(t) for t in sched], 8, 10) is first
    assert gossip_taps(sched, 7, 10) is not first


def test_gossip_mix_refuses_nodes_beyond_its_taps():
    """The composed design's taps travel in a struct of MAX_GOSSIP_NODES
    entries, so `gossip_taps` refuses more nodes, naming the size; the route
    takes 65 nodes and more to the "rounds" design instead, which needs no
    taps, and the wrapper reaches the tensor check (no kernel on the CPU)."""
    assert MAX_GOSSIP_NODES == 64
    assert len(gossip_taps(tmix.schedule("circulant2", 64), 8, 64)[0]) <= 64
    sched = tmix.schedule("ring", 65)
    with pytest.raises(ValueError, match="65 nodes"):
        gossip_taps(sched, 1, 65)
    assert gossip_design(64) == "composed" and gossip_design(65) == "rounds"
    with pytest.raises(ValueError, match="CUDA"):
        gossip_mix_cuda(torch.zeros(65, 8), sched, 1)
    with pytest.raises(ValueError, match="rounds"):
        gossip_taps(sched, -1, 8)
    with pytest.raises(ValueError, match="rounds"):
        gossip_mix_cuda(torch.zeros(65, 8), sched, -1)


@pytest.mark.parametrize("n,want", [(1, "composed"), (64, "composed"),
                                    (65, "rounds"), (100, "rounds"),
                                    (300, "rounds"), (908, "rounds")])
def test_gossip_design(n, want):
    """Up to 64 nodes one pass of the composed taps; beyond, the one-round
    schedule R times on a tile that `_cuda.tile_width` sizes, which takes
    two f32 [n, 32] tiles up to 908 nodes and refuses 909, naming the
    size."""
    assert gossip_design(n) == want
    if want == "rounds":
        bd = _cuda.tile_width(n, 3072)
        assert bd % 32 == 0 and 8 * n * bd <= _cuda.SMEM_BYTES
    with pytest.raises(ValueError, match="909 rows"):
        _cuda.tile_width(909, 3072)


@pytest.mark.parametrize("n", [65, 100])
@pytest.mark.parametrize("topo,rounds", [("ring", 8), ("circulant2", 3)])
def test_gossip_mix_plain_matches_jax_beyond_the_taps(n, topo, rounds):
    """The plain version the "rounds" kernel is held to on the card, at node
    counts the composed kernel does not take, against the reference's
    round-by-round oracle and its Pallas kernel: rtol / atol 1e-5."""
    jx, tx = _pair((n, 40), 32)
    sched = jmix.schedule(topo, n)
    got = ops.gossip_mix(tx, tmix.schedule(topo, n), rounds)
    for want in (jref.gossip_mix_ref(jx, sched, rounds),
                 gossip_mix_pallas(jx, *_split(sched), rounds, interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d,want", [
    (10, 3072, 16),     # 192 tiles for 132 SMs
    (16, 32768, 64),    # 512 tiles of 64 columns x 4 row groups
    (64, 32773, 16),    # 16 row groups
    (16, 21, 8),        # the convex track's wire: the narrowest tile
    (1, 10_000_000, 256),
])
def test_gossip_tile_width(n, d, want):
    """A power of two with at least a tile per SM (or the narrowest), and at
    most 256 threads to a block: one per column and group of 4 rows."""
    bd = gossip_tile_width(n, d)
    assert bd == want and bd & (bd - 1) == 0
    assert bd == 8 or -(-d // bd) >= _cuda.N_SMS
    assert bd * -(-n // 4) <= 256 and 4 * n * bd <= _cuda.SMEM_BYTES


# ---------------------------------------------------------------------------
# gossip_mix_quant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bd,want", [
    (512, 16),   # the main path's and the wide shape's block_d: 16 x 32
    (8, 1),      # path (f)'s tile width
    (1, 1), (31, 1), (32, 1), (63, 1),
    (64, 2), (127, 2), (128, 4), (255, 4), (256, 8), (511, 8),
    (1024, 16), (8192, 16),  # never more than 16 blocks to a cluster
])
def test_quant_cluster_size(bd, want):
    """The largest of 16, 8, 4, 2, 1 blocks per statistic tile that leaves
    each block at least 32 of the tile's columns (or the whole tile)."""
    from repro_torch.kernels.consensus import (quant_cluster_size,
                                               quant_slice_columns)
    assert quant_cluster_size(bd) == want
    cw, padded = quant_slice_columns(bd, want)
    assert cw == -(-bd // want) and (want == 1 or cw >= 32)
    assert padded >= max(cw, 8) and padded & (padded - 1) == 0
    assert padded < 2 * max(cw, 8)


@pytest.mark.parametrize("n,d,block_d,want", [
    (10, 3072, 512, "cluster-tile"),    # paths (d), (e): 16 slices of 32
    (16, 21, 8, "cluster-tile"),        # path (f)'s wire
    (64, 3072, 512, "cluster-tile"),
    (65, 3072, 512, "cluster-tile"),    # 32 columns x 5 groups of 16 rows
    (300, 3072, 512, "cluster-tile"),   # 32 x 19
    # one block per tile: 64 padded columns x 19 row groups is more than
    # 1,024 threads, but two f32 copies (115,200 bytes) fit one block
    (300, 1000, 48, "resident-tile"),
    (64, 48, 48, "cluster-tile"),       # 64 x 4 threads
])
def test_quant_design(n, d, block_d, want):
    """cluster-tile where a block of the tile's cluster holds its slice (one
    thread per padded column and group of up to 16 rows, at most 1,024),
    else resident-tile where one block holds the tile twice in f32."""
    from repro_torch.kernels.consensus import (quant_cluster_fits,
                                               quant_design,
                                               quant_resident_fits)
    bd = min(block_d, d)
    assert quant_design(n, d, block_d) == want
    assert quant_cluster_fits(n, bd) == (want == "cluster-tile")
    assert want == "cluster-tile" or quant_resident_fits(n, bd)


@pytest.mark.parametrize("n,d,want", [
    (3, 637_554_688, "resident-tile"),   # the trainer's cohort, path (k1)
    (4, 637_554_688, "resident-tile"),   # the trainer, paths (h2), (k1)
    (16, 637_554_688, "resident-tile"),
    (4, 132 * 512, "resident-tile"),     # one tile per SM
    (4, 131 * 512, "cluster-tile"),
    (9, 3072, "cluster-tile"),           # the PCA cohorts, path (i)
    (8, 3072, "cluster-tile"),
    (16, 1 << 18, "resident-tile"),
    (17, 1 << 18, "cluster-tile"),       # beyond the node counts measured
])
def test_quant_design_by_tile_count(n, d, want):
    """At up to 16 nodes a buffer of at least as many [n, 512] tiles as the
    card has SMs takes the resident-tile kernel (one block per tile fills
    the card); fewer tiles keep the cluster-tile kernel."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.consensus import (QUANT_RESIDENT_MAX_NODES,
                                               quant_cluster_fits,
                                               quant_design)
    assert quant_design(n, d, 512) == want
    assert quant_cluster_fits(n, 512)
    assert (want == "resident-tile") == (
        n <= QUANT_RESIDENT_MAX_NODES and -(-d // 512) >= _cuda.N_SMS)


@pytest.mark.parametrize("n,d,block_d", [(64, 16384, 16384),
                                         (1000, 3072, 48)])
def test_quant_design_refuses_what_neither_kernel_holds(n, d, block_d):
    """The route's error names both limits: a cluster-tile block's 1,024
    threads of 16 values and a resident-tile block's shared memory."""
    from repro_torch.kernels.consensus import quant_design
    with pytest.raises(ValueError, match="fits neither kernel") as err:
        quant_design(n, d, block_d)
    assert "1024 threads of 16 values" in str(err.value)
    assert f"need {8 * n * min(block_d, d)} bytes of shared memory" in str(
        err.value)


def test_launch_counters_name_every_design():
    """Each kernel's launches by design add up to its count in
    `ops.launches`: a resident-tile gossip_mix_quant launch counts under its
    own key, not under one block per tile."""
    assert set(ops.xi_launches) == {"cluster-slab", "two-pass"}
    assert set(ops.gossip_launches) == {"composed", "rounds"}
    assert set(ops.quant_launches) == {16, 8, 4, 2, 1, "resident-tile"}
    ops.reset_launches()
    assert all(v == 0 for counts in (ops.xi_launches, ops.gossip_launches,
                                     ops.quant_launches)
               for v in counts.values())


@pytest.mark.parametrize("N,Bn,d,dtype,want", [
    (10, 100, 3072, torch.float32, "one-read"),    # HIGHD, path (a)
    (10, 100, 3072, torch.bfloat16, "one-read"),
    (16, 4, 32768, torch.float32, "one-read"),     # the wide shape
    (16, 4, 32768, torch.bfloat16, "one-read"),
    (17, 100, 3072, torch.float32, "one-read"),    # the last slab that fits
    (18, 100, 3072, torch.float32, "two-pass"),    # just past shared memory
    (33, 100, 3072, torch.bfloat16, "one-read"),
    (34, 100, 3072, torch.bfloat16, "two-pass"),
    (10, 100, 32768, torch.float32, "two-pass"),   # a 1.0 MB slab per block
    (8, 3, 70, torch.float32, "two-pass"),         # a row stride of 280 bytes
    (65, 1, 3072, torch.float32, "two-pass"),      # more nodes than taps
    (10, 257, 3072, torch.float32, "two-pass"),    # more rows than a TMA box
    (4, 4, 33793, torch.float32, "two-pass"),      # 512-column tiles
])
def test_xi_gossip_design(N, Bn, d, dtype, want):
    """one-read wherever one block's [N, Bn, bd] slab fits its shared memory
    and the TMA can take the rows; the tiles then cover d with at most one
    block per SM."""
    from repro_torch.kernels.krasulina_update import (one_read_smem,
                                                      one_read_tile_width,
                                                      xi_gossip_design)
    assert xi_gossip_design(N, Bn, d, dtype) == want
    bd = one_read_tile_width(d)
    assert bd & (bd - 1) == 0 and -(-d // bd) <= _cuda.N_SMS
    fits = one_read_smem(N, Bn, bd, dtype.itemsize) <= _cuda.SMEM_BYTES
    assert fits or want == "two-pass"


def test_xi_gossip_design_needs_an_aligned_z_and_enough_sms():
    from repro_torch.kernels.krasulina_update import xi_gossip_design
    assert xi_gossip_design(10, 100, 3072, torch.float32,
                            aligned=False) == "two-pass"
    # a card with half the SMs takes 64-column tiles: a 265 KB slab at
    # Bn = 100, 136 KB at Bn = 50
    assert xi_gossip_design(10, 100, 3072, torch.float32,
                            n_sms=66) == "two-pass"
    assert xi_gossip_design(10, 50, 3072, torch.float32,
                            n_sms=66) == "one-read"

@pytest.mark.parametrize("quant", ["sign", "int8"])
@pytest.mark.parametrize("n,d,block_d", [(8, 64, 64), (8, 130, 32), (5, 33, 16),
                                         (10, 700, 512)])
@pytest.mark.parametrize("topo,rounds", [("ring", 3), ("circulant2", 1),
                                         ("ring", 8)])
def test_gossip_mix_quant_plain_matches_jax_and_pallas(quant, n, d, block_d,
                                                       topo, rounds):
    """The plain version against the reference's tile chain and its Pallas
    kernel in interpret mode, over the sweep of
    tests/test_consensus_engine.py: rtol / atol 1e-5 (its bound). int8
    levels come out identical; sign scales differ by summation order."""
    jx, tx = _pair((n, d), 20)
    sched = jmix.schedule(topo, n)
    got = ops.quant_gossip_mix(tx, tmix.schedule(topo, n), rounds, quant,
                               block_d=block_d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    for want in (jref.gossip_mix_quant_ref(jx, sched, rounds, quant,
                                           block_d=block_d),
                 gossip_mix_quant_pallas(jx, *_split(sched), rounds, quant,
                                         block_d=block_d, interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", ["sign", "int8"])
def test_gossip_mix_quant_valid_d_masks_pad_columns(quant):
    """Zero pad columns past valid_d leave every tile statistic alone: the
    plain version on the padded buffer equals the reference's (and its
    kernel's) on the same buffer, and the unmasked form differs (the zeros
    would enter the mean-|x| count). rtol / atol 1e-5."""
    n, d, pad = 8, 40, 9
    sched = jmix.schedule("circulant2", n)
    jx, tx = _pair((n, d + pad), 21)
    jx, tx = jx.at[:, d:].set(0), tx.clone()
    tx[:, d:] = 0
    got = ops.quant_gossip_mix(tx, tmix.schedule("circulant2", n), 2, quant,
                               block_d=16, valid_d=d)
    for want in (jref.gossip_mix_quant_ref(jx, sched, 2, quant, block_d=16,
                                           valid_d=d),
                 gossip_mix_quant_pallas(jx, *_split(sched), 2, quant,
                                         block_d=16, valid_d=d,
                                         interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)
    unmasked = ops.quant_gossip_mix(tx, tmix.schedule("circulant2", n), 2,
                                    quant, block_d=16)
    if quant == "sign":
        assert not np.allclose(_f32(got)[:, :d], _f32(unmasked)[:, :d],
                               atol=1e-6)


@pytest.mark.parametrize("quant", ["sign", "int8"])
@pytest.mark.parametrize("valid_d", [None, 30])
def test_gossip_mix_quant_per_node_matches_jax(quant, valid_d):
    """Sender-local row-tile statistics (`stats="node"`): rtol / atol
    1e-5."""
    n, d = 6, 37
    jx, tx = _pair((n, d), 22)
    if valid_d is not None:
        jx, tx = jx.at[:, valid_d:].set(0), tx.clone()
        tx[:, valid_d:] = 0
    sched = jmix.schedule("ring", n)
    got = ops.quant_gossip_mix(tx, sched, 3, quant, block_d=8,
                               valid_d=valid_d, per_node=True)
    want = jref.gossip_mix_quant_ref(jx, sched, 3, quant, block_d=8,
                                     valid_d=valid_d, per_node=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def test_gossip_mix_quant_bf16_rounds_once():
    """bf16 in: the rounds run in f32 and the result is rounded to bf16
    once, so it equals the f32 chain rounded (exactly) and the reference's
    bf16 chain within one bf16 ulp (rtol 1e-2)."""
    n = 16
    jx, tx = _pair((n, 4, 64), 5, "bfloat16")
    sched = tmix.schedule("ring", n)
    got = ops.quant_gossip_mix(tx, sched, 4, "int8", block_d=32)
    assert got.dtype == torch.bfloat16 and got.shape == (n, 4, 64)
    f32 = ops.quant_gossip_mix(tx.float(), sched, 4, "int8", block_d=32)
    np.testing.assert_array_equal(_f32(got), _f32(f32.bfloat16()))
    want = jref.gossip_mix_quant_ref(jx, sched, 4, "int8", block_d=32)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-2, atol=1e-2)


def test_gossip_mix_quant_stochastic_is_keyed():
    """int8_stoch takes the plain chain on every device: the same key gives
    the same result, another key another; round 1 lands every message on
    an integer level next to its value."""
    _, tx = _pair((4, 50), 23)
    sched = tmix.schedule("ring", 4)
    a = ops.quant_gossip_mix(tx, sched, 2, "int8_stoch", block_d=16, key=5)
    assert torch.equal(a, ops.quant_gossip_mix(tx, sched, 2, "int8_stoch",
                                               block_d=16, key=5))
    assert not torch.equal(a, ops.quant_gossip_mix(tx, sched, 2, "int8_stoch",
                                                   block_d=16, key=6))
    np.testing.assert_allclose(
        _f32(tref.gossip_mix_quant_ref(tx, sched, 2, "int8_stoch", block_d=16,
                                       key=5)), _f32(a), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown compressor"):
        ops.quant_gossip_mix(tx, sched, 2, "int4")


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
    ops.quant_gossip_mix(w, sched, 2, "int8", block_d=4)
    ops.attention(z[None], z[None], z[None])
    assert ops.launches == {"krasulina_xi": 0, "krasulina_xi_gossip": 0,
                            "gossip_mix": 0, "gossip_mix_quant": 0,
                            "flash_attention": 0}


def test_dispatch_refuses_other_devices():
    """Only all-CPU (plain), all-CUDA (kernel) or all-meta (the kernel's
    footprint, for the planner) inputs are taken; mixed devices are
    refused."""
    x = torch.empty((4, 8), device="meta")
    out = ops.gossip_mix(x, tmix.schedule("ring", 4), 1)
    assert out.device.type == "meta" and out.shape == x.shape
    with pytest.raises(ValueError, match="devices"):
        ops.krasulina_xi(torch.empty((8,), device="meta"),
                         torch.zeros((5, 8)))


def test_kernel_wrappers_refuse_cpu_tensors():
    """Called directly, a kernel wrapper raises on a CPU tensor instead of
    computing anything (no fallback to the plain version)."""
    from repro_torch.kernels.consensus import (gossip_mix_cuda,
                                               gossip_mix_quant_cuda)
    from repro_torch.kernels.krasulina_update import (krasulina_xi_cuda,
                                                      krasulina_xi_gossip_cuda)
    w, z = torch.randn(3, 8), torch.randn(3, 5, 8)
    sched = tmix.schedule("ring", 3)
    with pytest.raises(ValueError, match="CUDA"):
        gossip_mix_cuda(w, sched, 1)
    with pytest.raises(ValueError, match="CUDA"):
        gossip_mix_quant_cuda(w, sched, 1, "sign")
    with pytest.raises(ValueError, match="sign or int8"):
        gossip_mix_quant_cuda(w, sched, 1, "int8_stoch")
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


def test_every_source_has_an_entry_point():
    assert set(_cuda.SIGNATURES) == set(_cuda.SOURCES)
    for name in _cuda.SOURCES:
        assert (_cuda.CSRC / f"{name}.cu").exists()


def test_library_path_hashes_every_included_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc/ header it includes,
    directly or through another header, so an edited header rebuilds exactly
    the libraries that include it."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    assert [p.name for p in _cuda.local_includes(
        csrc / "flash_attention_sm90.cu")] == [
        "flash_attention_sm90.cu", "attention.cuh", "common.cuh", "hopper.cuh"]
    before = {name: _cuda.library_path(name) for name in _cuda.SOURCES}
    (csrc / "attention.cuh").write_text(
        (csrc / "attention.cuh").read_text() + "// edited\n")
    after = {name: _cuda.library_path(name) for name in _cuda.SOURCES}
    assert sorted(n for n in _cuda.SOURCES if before[n] != after[n]) == [
        "flash_attention", "flash_attention_sm90"]
    (csrc / "common.cuh").write_text(
        (csrc / "common.cuh").read_text() + "// edited\n")
    assert all(_cuda.library_path(n) != after[n] for n in _cuda.SOURCES)
