"""The port's hand-written Hopper kernels against their plain PyTorch
versions on a CUDA card, at the main path's shapes and ragged ones:
f32 within rtol 1e-4 of max|plain| (+1e-5), bf16 within 5e-2 (the plain
bf16 versions round after every gossip round, the kernels once).

Without a card every test skips; the decision is made inside the `cuda`
fixture, never at import. This file imports neither jax nor the JAX
package, so it runs on the machine with the card:
`PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py`.
"""
import math

import pytest
import torch

from repro_torch.core import mixing as tmix
from repro_torch.kernels import _cuda, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import route


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, rtol):
    """max |kernel - plain| <= rtol * max |plain| + 1e-5."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * want.float().abs().max().item() + 1e-5, err


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("wshape,zshape", [((3072,), (1000, 3072)),
                                           ((257,), (300, 257)),
                                           ((10, 3072), (10, 100, 3072))])
def test_cuda_krasulina_xi_matches_plain(cuda, dtype, rtol, wshape, zshape):
    w = torch.randn(wshape, device=cuda).to(dtype)
    z = torch.randn(zshape, device=cuda).to(dtype)
    got = ops.krasulina_xi(w, z)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _close(got, tref.krasulina_xi_ref(w, z), rtol)


# chip_smoke.py's krasulina_xi check: (w kind, z shape); one w per call
# ("shared", also across a batch of groups) or one per group ("groups");
# B = 300 and d = 257 are ragged
XI_CASES = [("shared", (1000, 3072)), ("shared", (300, 257)),
            ("shared", (5, 32768)), ("shared", (10, 100, 3072)),
            ("groups", (10, 100, 3072)), ("groups", (16, 4, 32768))]


@pytest.mark.parametrize("wkind,zshape", XI_CASES)
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("design", ["routed", "cluster-slab", "two-pass"])
def test_cuda_krasulina_xi_designs(cuda, wkind, zshape, dtype, rtol, design):
    """Each design, routed and forced, against the plain version, the same
    bits from a second launch (the cluster-slab kernel sums its cluster's
    partials in rank order), and the routed launch counted under the design
    `xi_route` names; forcing cluster-slab where its slab does not fit (B =
    1000) or the TMA cannot take the rows (d = 257) raises."""
    from repro_torch.kernels.krasulina_update import (krasulina_xi_cuda,
                                                      xi_route)
    z = torch.randn(zshape, device=cuda).to(dtype)
    d = zshape[-1]
    w = torch.randn((zshape[0], d) if wkind == "groups" else (d,),
                    device=cuda).to(dtype)
    route = xi_route(w, z)
    assert route == ("two-pass" if zshape[0] in (1000, 300)
                     else "cluster-slab")
    if design == "cluster-slab" and route != "cluster-slab":
        with pytest.raises(ValueError, match="cluster-slab"):
            krasulina_xi_cuda(w, z, _design=design)
        return
    ops.reset_launches()
    if design == "routed":
        got, again = ops.krasulina_xi(w, z), ops.krasulina_xi(w, z)
        assert ops.xi_launches == {k: 2 * (k == route)
                                   for k in ops.xi_launches}
    else:
        got = krasulina_xi_cuda(w, z, _design=design)
        again = krasulina_xi_cuda(w, z, _design=design)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert got.shape == ((d,) if len(zshape) == 2 else (zshape[0], d))
    assert torch.equal(got, again)
    _close(got, tref.krasulina_xi_ref(w, z), rtol)


@pytest.mark.parametrize("G,B,d", [(3, 8, 4800), (2, 5, 32768), (4, 12, 320),
                                   (1, 3, 8)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
def test_cuda_krasulina_xi_cluster_slab_layouts(cuda, G, B, d, dtype, rtol):
    """The cluster-slab kernel's box layouts against the plain version: two
    column boxes to a slice (d = 4800), eight of 5 rows (d = 32768),
    24-column slices with blocks past d (d = 320), and a slice of 8 columns
    in a cluster of blocks that are almost all past d, its boxes taller than
    B (d = 8)."""
    from repro_torch.kernels.krasulina_update import xi_route
    w = torch.randn((G, d), device=cuda).to(dtype)
    z = torch.randn((G, B, d), device=cuda).to(dtype)
    assert xi_route(w, z) == "cluster-slab"
    got = ops.krasulina_xi(w, z)
    torch.cuda.synchronize()
    _close(got, tref.krasulina_xi_ref(w, z), rtol)


def test_cuda_krasulina_xi_cluster_slab_replays_from_a_graph(cuda):
    """The cluster-slab launch captures into a CUDA graph, and its replays
    give the eager result, bit for bit."""
    w = torch.randn((10, 3072), device=cuda)
    z = torch.randn((10, 100, 3072), device=cuda)
    eager = ops.krasulina_xi(w, z)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.krasulina_xi(w, z)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = ops.krasulina_xi(w, z)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(eager, captured)


@pytest.mark.parametrize("N,Bn,d", [(10, 100, 3072), (16, 4, 32768),
                                    (8, 3, 70)])
@pytest.mark.parametrize("rounds", [0, 1, 8])
def test_cuda_krasulina_xi_gossip_matches_plain(cuda, N, Bn, d, rounds):
    w = torch.randn((N, d), device=cuda)
    z = torch.randn((N, Bn, d), device=cuda)
    sched = tmix.schedule("circulant2", N)
    got = ops.krasulina_xi_gossip(w, z, sched, rounds)
    torch.cuda.synchronize()
    _close(got, tref.krasulina_xi_gossip_ref(w, z, sched, rounds), 1e-4)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("n,d", [(5, 33), (10, 3072), (16, 32773)])
def test_cuda_gossip_mix_matches_plain(cuda, dtype, rtol, n, d):
    x = torch.randn((n, d), device=cuda).to(dtype)
    sched = tmix.schedule("ring", n)
    got = ops.gossip_mix(x, sched, 8)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _close(got, tref.gossip_mix_ref(x, sched, 8), rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gossip_mix_zero_rounds_and_one_node(cuda, dtype):
    """R = 0 is a copy and n = 1 is x * 1 (one tap, weight 1), each one
    launch of the kernel."""
    x = torch.randn((10, 3072), device=cuda).to(dtype)
    before = ops.launches["gossip_mix"]
    assert torch.equal(ops.gossip_mix(x, tmix.schedule("ring", 10), 0), x)
    one = torch.randn((1, 777), device=cuda).to(dtype)
    assert torch.equal(ops.gossip_mix(one, tmix.schedule("ring", 1), 8), one)
    torch.cuda.synchronize()
    assert ops.launches["gossip_mix"] == before + 2


@pytest.mark.parametrize("topo", ["ring", "circulant2", "torus"])
@pytest.mark.parametrize("n", [16, 64])
def test_cuda_gossip_mix_composed_matches_rounds(cuda, topo, n):
    """One pass of the composed schedule against the round-by-round plain
    version, up to the node count the kernel takes."""
    x = torch.randn((n, 4099), device=cuda)
    sched = tmix.schedule(topo, n)
    got = ops.gossip_mix(x, sched, 8)
    torch.cuda.synchronize()
    _close(got, tref.gossip_mix_ref(x, sched, 8), 1e-4)


@pytest.mark.parametrize("topo", ["ring", "circulant2", "torus"])
@pytest.mark.parametrize("n", [65, 100, 256])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
def test_cuda_gossip_mix_rounds_beyond_the_taps(cuda, topo, n, dtype, rtol):
    """Above 64 nodes the launch takes the "rounds" design (the one-round
    schedule R times on a resident tile) and agrees with the round-by-round
    plain version."""
    x = torch.randn((n, 4099), device=cuda).to(dtype)
    sched = tmix.schedule(topo, n)
    ops.reset_launches()
    got = ops.gossip_mix(x, sched, 8)
    torch.cuda.synchronize()
    assert ops.gossip_launches == {"composed": 0, "rounds": 1}
    assert got.dtype == dtype
    _close(got, tref.gossip_mix_ref(x, sched, 8), rtol)


def _close_quant(got, want, dtype):
    """The gossip_mix_quant bounds of chip_smoke.py: f32 rtol / atol 1e-5 of
    max|plain| (the bound of tests/test_consensus_engine.py), bf16 5e-2 and
    1e-3 (both round once, from the same f32 rounds)."""
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (5e-2, 1e-3)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * want.float().abs().max().item() + atol, err


@pytest.mark.parametrize("quant", ["sign", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(5, 33), (10, 3072), (16, 32773)])
@pytest.mark.parametrize("block_d", [16, 512])
@pytest.mark.parametrize("topo,rounds", [("ring", 8), ("circulant2", 1)])
def test_cuda_gossip_mix_quant_matches_plain(cuda, quant, dtype, n, d, block_d,
                                             topo, rounds):
    x = torch.randn((n, d), device=cuda).to(dtype)
    sched = tmix.schedule(topo, n)
    before = ops.launches["gossip_mix_quant"]
    got = ops.quant_gossip_mix(x, sched, rounds, quant, block_d=block_d)
    torch.cuda.synchronize()
    assert ops.launches["gossip_mix_quant"] == before + 1
    assert got.dtype == dtype
    _close_quant(got, tref.gossip_mix_quant_ref(x, sched, rounds, quant,
                                                block_d=block_d), dtype)


# the statistics at the reference's positions: (layouts of one reference
# row, model extent, this rank's index, block_d): wk-like runs of 16
# columns a rank under 64-column tiles, a row split beside a kept-whole
# leaf, and a stack of two layers whose sizes the tile does not divide
SLOT_CASES = [([((256, 64), 1)], 4, 1, 64),
              ([((40, 24), 0), ((7,), None), ((4, 32), 1)], 2, 1, 16),
              ([((300, 10), None), ((300, 10), None)], 1, 0, 512)]


@pytest.mark.parametrize("quant", ["sign", "int8"])
@pytest.mark.parametrize("case", range(len(SLOT_CASES)))
def test_cuda_slot_kernels_match_plain(cuda, quant, case):
    """The two slot entry points of gossip_mix_quant.cu against their plain
    versions on one rank's blocks: the slots' statistics (one launch a
    leaf) and one round with given scales (one launch a leaf), each
    counted under its own key."""
    from repro_torch.core import quantize as tq

    layouts, M, m, block_d = SLOT_CASES[case]
    maps = tq.block_maps(layouts, M, m)
    width = sum(bm.span for bm in maps)
    slots = tq.Slots(maps, min(block_d, width), width, width, index=m)
    n = 4
    sched = tmix.schedule("ring", n)
    hs = [torch.randn((n, bm.size), device=cuda) for bm in maps]
    got = torch.zeros((1, slots.n_slots), dtype=torch.float64, device=cuda)
    want = got.clone()
    before = dict(ops.launches)
    for i, h in enumerate(hs):
        ops.quant_slot_stats(h, slots, i, got, quant)
        lo, hi = slots.counted_range(i)
        bm = maps[i]
        tref.quant_slot_stats_ref(h, bm.offset, bm.w, bm.L, bm.m, slots.bd,
                                  lo, hi, want, quant)
    torch.cuda.synchronize()
    # a leaf with no slot to count (a kept-whole leaf whose only slot
    # straddles, on a rank after the group's first) launches nothing
    counted = sum(1 for i in range(len(hs))
                  if slots.counted_range(i)[1] > slots.counted_range(i)[0])
    assert ops.launches["quant_slot_stats"] == \
        before["quant_slot_stats"] + counted
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    scale = tq.slot_scales(got.float(), slots, quant, n)
    for i, h in enumerate(hs):
        bm = maps[i]
        out = ops.quant_slot_round(h, slots, i, scale, sched, quant)
        torch.cuda.synchronize()
        ref = tref.quant_slot_round_ref(h, bm.offset, bm.w, bm.L, bm.m,
                                        slots.bd, scale, sched, quant)
        _close_quant(out, ref, torch.float32)
    assert ops.launches["quant_slot_round"] == \
        before["quant_slot_round"] + len(hs)


@pytest.mark.parametrize("quant", ["none", "sign", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fig9_wire_matches_plain(cuda, quant, dtype):
    """The convex Fig. 9 wire: N = 16, d = 21, ring R = 2, tile width 8 (three
    tiles, the last 5 columns wide)."""
    x = torch.randn((16, 21), device=cuda).to(dtype)
    sched = tmix.schedule("ring", 16)
    if quant == "none":
        got = ops.gossip_mix(x, sched, 2)
        torch.cuda.synchronize()
        _close(got, tref.gossip_mix_ref(x, sched, 2),
               1e-4 if dtype == torch.float32 else 5e-2)
    else:
        got = ops.quant_gossip_mix(x, sched, 2, quant, block_d=8)
        torch.cuda.synchronize()
        _close_quant(got, tref.gossip_mix_quant_ref(x, sched, 2, quant,
                                                    block_d=8), dtype)


@pytest.mark.parametrize("quant", ["sign", "int8"])
def test_cuda_gossip_mix_quant_valid_d(cuda, quant):
    """Pad columns past valid_d stay out of the statistics on the card as in
    the plain version; unmasked, the sign scale changes."""
    n, d, pad = 8, 40, 9
    x = torch.randn((n, d + pad), device=cuda)
    x[:, d:] = 0
    sched = tmix.schedule("circulant2", n)
    got = ops.quant_gossip_mix(x, sched, 2, quant, block_d=16, valid_d=d)
    _close_quant(got, tref.gossip_mix_quant_ref(x, sched, 2, quant,
                                                block_d=16, valid_d=d),
                 torch.float32)
    unmasked = ops.quant_gossip_mix(x, sched, 2, quant, block_d=16)
    torch.cuda.synchronize()
    if quant == "sign":
        assert not torch.allclose(got[:, :d], unmasked[:, :d], atol=1e-6)


def test_cuda_gossip_mix_quant_refuses_tiles_beyond_shared_memory(cuda):
    """A cluster of 16 blocks splits a tile 16 ways; a [64, 16384] tile
    still leaves each block a [64, 1024] slice, more than its 1,024 threads
    of 16 values hold, and two f32 copies of the tile exceed a
    resident-tile block's shared memory: the route names both limits. The
    resident-tile kernel, forced, refuses a [64, 1024] tile."""
    from repro_torch.kernels.consensus import gossip_mix_quant_cuda
    sched = tmix.schedule("ring", 64)
    with pytest.raises(ValueError, match="fits neither kernel"):
        gossip_mix_quant_cuda(torch.randn((64, 16384), device=cuda), sched, 1,
                              "int8", block_d=16384)
    with pytest.raises(ValueError, match="shared memory"):
        gossip_mix_quant_cuda(torch.randn((64, 1024), device=cuda), sched, 1,
                              "int8", block_d=512, _design="resident-tile")


# (block_d, d, blocks per tile): every cluster size the picker chooses; d is
# not a multiple of block_d, and the slices of 50, 50, 38 and 63 columns are
# not multiples of 32
QUANT_CLUSTER_CASES = [(24, 100, 1), (100, 250, 2), (200, 1000, 4),
                       (300, 1000, 8), (512, 3149, 16), (1000, 2500, 16)]


@pytest.mark.parametrize("block_d,d,cluster", QUANT_CLUSTER_CASES)
@pytest.mark.parametrize("quant", ["sign", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("topo,rounds", [("ring", 8), ("circulant2", 3)])
def test_cuda_gossip_mix_quant_every_cluster_size(cuda, block_d, d, cluster,
                                                  quant, dtype, topo, rounds):
    """Every cluster size against the plain version, and against the
    one-block-per-tile kernel bit for bit (both round every operation
    alike); the launch counts under the picker's cluster size."""
    from repro_torch.kernels.consensus import (gossip_mix_quant_cuda,
                                               quant_cluster_size)
    assert quant_cluster_size(block_d) == cluster
    x = torch.randn((10, d), device=cuda).to(dtype)
    sched = tmix.schedule(topo, 10)
    ops.reset_launches()
    got = ops.quant_gossip_mix(x, sched, rounds, quant, block_d=block_d)
    old = gossip_mix_quant_cuda(x, sched, rounds, quant, block_d=block_d,
                                _design="resident-tile")
    torch.cuda.synchronize()
    assert ops.quant_launches == {c: int(c == cluster)
                                  for c in ops.quant_launches}
    _close_quant(got, tref.gossip_mix_quant_ref(x, sched, rounds, quant,
                                                block_d=block_d), dtype)
    assert torch.equal(got, old)


@pytest.mark.parametrize("quant", ["sign", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gossip_mix_quant_routes_to_resident_tile(cuda, quant, dtype):
    """A [300, 48] tile: one block per tile, 64 padded columns x 19 groups of
    16 rows is more than a cluster-tile block's 1,024 threads, but two f32
    copies (115 KB) fit a resident-tile block. The launch is counted under
    "resident-tile", agrees with the plain version and equals the forced
    resident-tile run bit for bit."""
    from repro_torch.kernels.consensus import gossip_mix_quant_cuda
    x = torch.randn((300, 1000), device=cuda).to(dtype)
    sched = tmix.schedule("ring", 300)
    ops.reset_launches()
    got = ops.quant_gossip_mix(x, sched, 8, quant, block_d=48)
    forced = gossip_mix_quant_cuda(x, sched, 8, quant, block_d=48,
                                   _design="resident-tile")
    torch.cuda.synchronize()
    assert ops.quant_launches == {c: int(c == "resident-tile")
                                  for c in ops.quant_launches}
    assert torch.equal(got, forced)
    _close_quant(got, tref.gossip_mix_quant_ref(x, sched, 8, quant,
                                                block_d=48), dtype)
    with pytest.raises(ValueError, match="more than a block holds"):
        gossip_mix_quant_cuda(x, sched, 8, quant, block_d=48,
                              _design="cluster-tile")


@pytest.mark.parametrize("quant", ["sign", "int8"])
def test_cuda_gossip_mix_quant_valid_d_inside_a_slice(cuda, quant):
    """valid_d = 612 falls inside block 3 of tile 1's cluster of 16 (32
    columns each), not at a tile or slice edge."""
    n, d, valid = 10, 1024, 612
    x = torch.randn((n, d), device=cuda)
    x[:, valid:] = 0
    sched = tmix.schedule("ring", n)
    got = ops.quant_gossip_mix(x, sched, 8, quant, block_d=512,
                               valid_d=valid)
    _close_quant(got, tref.gossip_mix_quant_ref(x, sched, 8, quant,
                                                block_d=512, valid_d=valid),
                 torch.float32)
    unmasked = ops.quant_gossip_mix(x, sched, 8, quant, block_d=512)
    torch.cuda.synchronize()
    if quant == "sign":
        assert not torch.allclose(got[:, :valid], unmasked[:, :valid],
                                  atol=1e-6)


def test_cuda_gossip_mix_quant_sign_over_many_exponents(cuda):
    """A tile whose |h| spans 2^-40 to 2^40: the sign scale is summed in f64
    and rounded once, so the cluster's partials summed in rank order give
    the plain version's bits."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((10, 3072), device=cuda, generator=g)
    x *= torch.exp2(torch.randint(-40, 41, (10, 3072), device=cuda,
                                  generator=g).float())
    sched = tmix.schedule("ring", 10)
    got = ops.quant_gossip_mix(x, sched, 8, "sign", block_d=512)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.gossip_mix_quant_ref(x, sched, 8, "sign",
                                                      block_d=512))


# (N, Bn, d, dtype, design): both sides of the one-read kernel's
# shared-memory limit at d = 3072 (f32: N = 17 fits, 18 does not; bf16, half
# the slab: 33 and 34), the wide shape, and a row stride the TMA cannot take
XI_GOSSIP_DESIGN_CASES = [
    (10, 100, 3072, torch.float32, "one-read"),
    (17, 100, 3072, torch.float32, "one-read"),
    (18, 100, 3072, torch.float32, "two-pass"),
    (16, 4, 32768, torch.float32, "one-read"),
    (8, 3, 70, torch.float32, "two-pass"),
    (10, 100, 3072, torch.bfloat16, "one-read"),
    (33, 100, 3072, torch.bfloat16, "one-read"),
    (34, 100, 3072, torch.bfloat16, "two-pass"),
    (16, 4, 32768, torch.bfloat16, "one-read"),
    (8, 3, 70, torch.bfloat16, "two-pass"),
]


@pytest.mark.parametrize("N,Bn,d,dtype,design", XI_GOSSIP_DESIGN_CASES)
@pytest.mark.parametrize("rounds", [0, 1, 8])
def test_cuda_krasulina_xi_gossip_designs(cuda, N, Bn, d, dtype, design,
                                          rounds):
    """Each design against the plain version (f32 within rtol 1e-4 of
    max|plain| + 1e-5, bf16 5e-2 + 1e-3), the launch counted under the
    design the picker names, and the same bits from a second launch (the
    one-read kernel reduces across the grid in a fixed order)."""
    w = torch.randn((N, d), device=cuda).to(dtype)
    z = torch.randn((N, Bn, d), device=cuda).to(dtype)
    sched = tmix.schedule("ring", N)
    ops.reset_launches()
    got = ops.krasulina_xi_gossip(w, z, sched, rounds)
    again = ops.krasulina_xi_gossip(w, z, sched, rounds)
    torch.cuda.synchronize()
    assert ops.xi_gossip_launches == {k: 2 * (k == design)
                                      for k in ops.xi_gossip_launches}
    assert torch.equal(got, again)
    want = tref.krasulina_xi_gossip_ref(w, z, sched, rounds)
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (5e-2, 1e-3)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * want.float().abs().max().item() + atol, err


def test_cuda_krasulina_xi_gossip_forced_designs(cuda):
    """The two designs agree at the main shape; the one-read kernel refuses
    a slab it cannot hold."""
    from repro_torch.kernels.krasulina_update import krasulina_xi_gossip_cuda
    w = torch.randn((10, 3072), device=cuda)
    z = torch.randn((10, 100, 3072), device=cuda)
    sched = tmix.schedule("ring", 10)
    one = krasulina_xi_gossip_cuda(w, z, sched, 8)
    two = krasulina_xi_gossip_cuda(w, z, sched, 8, _design="two-pass")
    torch.cuda.synchronize()
    _close(one, two, 1e-4)
    big = torch.randn((18, 100, 3072), device=cuda)
    with pytest.raises(ValueError, match="one-read"):
        krasulina_xi_gossip_cuda(big[:, 0].contiguous(), big,
                                 tmix.schedule("ring", 18), 8,
                                 _design="one-read")


def test_cuda_one_read_on_two_streams_at_once(cuda):
    """One-read krasulina_xi_gossip launches on two streams at once, each
    with its own grid-barrier word: every result equals the plain version.
    Both grids (96 small blocks each) fit the card together, so they can
    overlap."""
    from repro_torch.kernels.krasulina_update import xi_gossip_route
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    inputs = [(torch.randn((4, 3072), device=cuda),
               torch.randn((4, 8, 3072), device=cuda)) for _ in streams]
    sched = tmix.schedule("ring", 4)
    assert all(xi_gossip_route(w, z) == "one-read" for w, z in inputs)
    wants = [tref.krasulina_xi_gossip_ref(w, z, sched, 8) for w, z in inputs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(50):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[k].append(ops.krasulina_xi_gossip(*inputs[k], sched, 8))
    torch.cuda.synchronize()
    for k in range(2):
        for got in outs[k]:
            _close(got, wants[k], 1e-4)


def test_cuda_redesigned_kernels_replay_from_a_graph(cuda):
    """The cluster launch and the cooperative one-read launch capture into
    a CUDA graph, and its replays give the eager results."""
    x = torch.randn((10, 3072), device=cuda)
    w = torch.randn((10, 3072), device=cuda)
    z = torch.randn((10, 100, 3072), device=cuda)
    sched = tmix.schedule("ring", 10)
    run = lambda: (ops.quant_gossip_mix(x, sched, 8, "int8", block_d=512),
                   ops.krasulina_xi_gossip(w, z, sched, 8))
    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))


# ---------------------------------------------------------------------------
# flash_attention (tolerances of tests/test_kernels.py:85: 2e-5 f32, 3e-2
# bf16, relative and absolute)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # tests/test_kernels.py CASES: (B, H, Sq, Sk, D, causal, window, chunk)
    (1, 2, 128, 128, 64, True, 0, 0),
    (2, 2, 256, 256, 64, True, 0, 0),
    (1, 1, 256, 256, 128, True, 64, 0),
    (1, 2, 256, 256, 64, True, 0, 128),
    (1, 1, 200, 200, 64, True, 0, 0),
    (1, 1, 128, 384, 64, True, 0, 0),
    # granite-8b's prefill (H = 32, D = 128), and ragged edges: Sq > Sk with a
    # window (rows with no live key are 0), odd D, unmasked
    (1, 32, 512, 512, 128, True, 0, 0),
    (1, 32, 200, 200, 128, True, 0, 0),
    (1, 2, 96, 40, 64, True, 16, 0),
    (2, 3, 70, 70, 40, True, 0, 32),
    (1, 1, 50, 50, 20, True, 0, 0),
    (1, 2, 64, 256, 96, False, 0, 0),
    # the wgmma kernel's edge tiles: every mask kind at D = 128 with Sq and Sk
    # not multiples of its 128-row tiles, and B*H > 132 SMs with Sq < Sk
    (1, 8, 333, 333, 128, True, 0, 0),
    (1, 8, 333, 333, 128, True, 100, 0),
    (1, 8, 333, 333, 128, True, 0, 96),
    (1, 8, 190, 96, 128, False, 0, 0),
    (1, 150, 130, 300, 128, True, 0, 0),
    # D = 256 (recurrentgemma-9b's local attention: the wgmma kernel with
    # 64-key tiles, the f32 kernel's wider accumulator): every mask kind
    # with Sq and Sk not multiples of 64, Sq < Sk unmasked, and unmasked
    # over a ragged key count
    (1, 4, 333, 333, 256, True, 0, 0),
    (1, 4, 333, 333, 256, True, 100, 0),
    (1, 4, 333, 333, 256, True, 0, 96),
    (1, 4, 190, 96, 256, False, 0, 0),
    (2, 3, 72, 256, 256, False, 0, 0),
    (1, 4, 200, 200, 256, False, 0, 0),
    (2, 3, 72, 200, 256, False, 0, 0),
    # D = 256 with rows that have no live key (Sq > Sk under a window: 0),
    # and with B*H > 132 SMs
    (1, 2, 96, 40, 256, True, 16, 0),
    (1, 150, 130, 300, 256, True, 0, 0),
    # seamless-m4t-medium's cross-attention shape (wgmma, unmasked, Sq < Sk),
    # and its encoder and cross-attention over 200 frames (ragged)
    (4, 16, 64, 4096, 64, False, 0, 0),
    (2, 16, 200, 200, 64, False, 0, 0),
    (2, 16, 24, 200, 64, False, 0, 0),
]


def _close_attention(got, want, dtype):
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _bf16_rounding_limit(q, k, v, masks):
    """The plain attention in f32, and the bound of bf16 rounding around it
    (unit roundoff u = 2^-8), element by element: 2^-6 |plain| + 2^-8
    (P |v|). Each side rounds its output to bf16 (u |out| each: 2u, taken
    twice over), and the kernel rounds each softmax weight to bf16 before
    the P V product, which moves an output by at most u sum_j p_j |v_j|.
    P |v| is the plain attention of |v| in f32."""
    want = tref.attention_ref(q, k, v, **masks).float()
    mag = tref.attention_ref(q, k, v.float().abs(), **masks)
    return want, 2.0 ** -6 * want.abs() + 2.0 ** -8 * mag


def _close_bf16_rounding(got, q, k, v, masks):
    """bf16 attention within the bound of bf16 rounding of the plain version,
    element by element (`_bf16_rounding_limit`)."""
    want, limit = _bf16_rounding_limit(q, k, v, masks)
    diff = (got.float() - want).abs()
    assert bool((diff <= limit).all()), (
        f"max |kernel - plain| {diff.max().item():.3e}, largest share of "
        f"the bound {(diff / limit.clamp_min(1e-30)).max().item():.3f}")


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,window,chunk", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(cuda, B, H, Sq, Sk, D, causal,
                                            window, chunk, dtype):
    q = torch.randn((B, H, Sq, D), device=cuda).to(dtype)
    k = torch.randn((B, H, Sk, D), device=cuda).to(dtype)
    v = torch.randn((B, H, Sk, D), device=cuda).to(dtype)
    masks = dict(causal=causal, window=window, chunk=chunk)
    kind = route(q, k, v)
    before = ops.launches["flash_attention"], ops.flash_launches[kind]
    got = ops.attention(q, k, v, **masks)
    torch.cuda.synchronize()
    assert (ops.launches["flash_attention"],
            ops.flash_launches[kind]) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16 and (D == 256 or Sk == 200):
        _close_bf16_rounding(got, q, k, v, masks)
    else:
        _close_attention(got, tref.attention_ref(q, k, v, **masks), dtype)


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 96, "mma_sync"), (torch.bfloat16, 40, "mma_sync"),
    (torch.float32, 128, "f32"), (torch.bfloat16, 256, "wgmma"),
    (torch.float32, 256, "f32")])
def test_cuda_flash_attention_counts_launches_by_kernel(cuda, dtype, D, want):
    """Each launch counts once in launches["flash_attention"] and once under
    the kernel its shape routes to."""
    q = torch.randn((1, 2, 130, D), device=cuda).to(dtype)
    ops.reset_launches()
    got = ops.attention(q, q, q)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == 1
    assert ops.flash_launches == {v: int(v == want) for v in ops.flash_launches}
    _close_attention(got, tref.attention_ref(q, q, q), dtype)


def test_cuda_flash_attention_unaligned_bf16_takes_mma_sync(cuda):
    """A bf16 view 2 bytes off a 16-byte boundary cannot be read by the TMA:
    it routes to the mma.sync kernel and gives the same answer."""
    buf = torch.randn(1 + 2 * 64 * 128, device=cuda).to(torch.bfloat16)
    q = buf[1:].view(1, 2, 64, 128)
    ops.reset_launches()
    got = ops.attention(q, q, q)
    torch.cuda.synchronize()
    assert ops.flash_launches["mma_sync"] == 1
    _close_attention(got, tref.attention_ref(q, q, q), torch.bfloat16)


def _mma_sync_attention(q, k, v, causal=True, window=0, chunk=0):
    """bf16 attention through the mma.sync kernel's own entry point, whatever
    the shape routes to."""
    out = torch.empty_like(q)
    B, H, Sq, D = q.shape
    _cuda.call("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), B * H, Sq, k.shape[2], D, int(causal), window,
               chunk, 1 / math.sqrt(D), _cuda.DTYPE_CODES[q.dtype], 1,
               _cuda.stream_of(q))
    return out


def test_cuda_flash_wgmma_and_mma_sync_agree_at_head_dim_256(cuda):
    """The same inputs through the mma.sync kernel's entry point and through
    the wgmma kernel that their shape routes to agree within the bound of
    bf16 rounding (each is also within it of the plain version)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((1, 4, 333, 256), generator=gen, device=cuda)
               .bfloat16() for _ in range(3))
    masks = dict(causal=True, window=100, chunk=0)
    ops.reset_launches()
    wgmma = ops.attention(q, k, v, **masks)
    mma = _mma_sync_attention(q, k, v, **masks)
    torch.cuda.synchronize()
    assert ops.flash_launches["wgmma"] == 1
    _, limit = _bf16_rounding_limit(q, k, v, masks)
    assert bool(((wgmma.float() - mma.float()).abs() <= limit).all())
    _close_bf16_rounding(mma, q, k, v, masks)


def test_cuda_flash_attention_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = torch.randn((1, 1, 32, 64), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(*(torch.randn((1, 1, 32, 264), device=cuda),) * 3)
    with pytest.raises(TypeError, match="dtypes differ"):
        flash_attention_cuda(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(2, 3), q, q)


def test_cuda_model_prefill_takes_the_kernel(cuda):
    """A reduced granite-8b prefill of 24 tokens on the card launches the
    kernel once per layer and agrees with the CPU's plain path."""
    from repro_torch import convert
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import registry
    cfg = reduced(get_config("granite-8b"))
    params = registry.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    want, _ = registry.prefill(params, cfg, {"tokens": toks},
                               registry.init_cache(cfg, 2, 32, torch.float32,
                                                   device="cpu"))
    on_card = convert.tree_map(lambda t: t.to(cuda), params)
    ops.reset_launches()
    got, _ = registry.prefill(on_card, cfg, {"tokens": toks.to(cuda)},
                              registry.init_cache(cfg, 2, 32, torch.float32,
                                                  device=cuda))
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("B,S,window", [(1, 600, 256), (2, 4096, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mqa_window_prefill_at_head_dim_256(cuda, dtype, B, S, window):
    """recurrentgemma-9b's local attention on the model's route
    (`layers._flash`: one KV head broadcast to 16, causal, with a window;
    600 tokens, and the model's own prefill of 2 x 4096 past its 2048
    window) against the plain version of the broadcast heads, through the
    wgmma kernel in bf16."""
    from repro_torch.models import layers as L
    q = torch.randn((B, S, 16, 256), device=cuda).to(dtype)
    k, v = (torch.randn((B, S, 1, 256), device=cuda).to(dtype)
            for _ in range(2))
    ops.reset_launches()
    got = L._flash(q, k, v, window=window).transpose(1, 2)
    torch.cuda.synchronize()
    want_kind = "f32" if dtype == torch.float32 else "wgmma"
    assert ops.flash_launches == {v: int(v == want_kind)
                                  for v in ops.flash_launches}
    heads = lambda t: t.transpose(1, 2).expand(B, 16, S, 256).contiguous()
    qh, kh, vh = q.transpose(1, 2), heads(k), heads(v)
    masks = dict(causal=True, window=window)
    if dtype == torch.bfloat16:
        _close_bf16_rounding(got, qh, kh, vh, masks)
    else:
        _close_attention(got, tref.attention_ref(qh, kh, vh, **masks), dtype)


@pytest.mark.parametrize("arch,layers,per_prefill,frames", [
    ("mamba2-2.7b", 2, 0, 0), ("recurrentgemma-9b", 5, 1, 0),
    ("seamless-m4t-medium", 2, 6, 0), ("seamless-m4t-medium", 2, 6, 200)])
def test_cuda_recurrent_and_encdec_families_match_the_cpu(cuda, arch, layers,
                                                          per_prefill,
                                                          frames):
    """Each family reduced, in f32, the same parameters on the card and the
    CPU: prefill logits within 1e-3 and the f32 flash kernel once per
    attention layer (none for the SSD; encoder, self and cross layers for
    the encoder-decoder, also over 200 frames: unmasked attention over a
    key count that is not a multiple of 64 or 128)."""
    from repro_torch import convert
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import registry
    cfg = reduced(get_config(arch), layers=layers)
    params = registry.init_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    batch = registry.synth_batch(gen, cfg, 2, 24, mode="prefill")
    if frames:
        batch["frames"] = torch.randn((2, frames, cfg.frontend_embed_dim),
                                      generator=gen)
    want, _ = registry.prefill(params, cfg, batch, registry.init_cache(
        cfg, 2, 32, torch.float32, device="cpu"))
    on_card = convert.tree_map(lambda t: t.to(cuda), params)
    ops.reset_launches()
    got, _ = registry.prefill(on_card, cfg,
                              {k: v.to(cuda) for k, v in batch.items()},
                              registry.init_cache(cfg, 2, 32, torch.float32,
                                                  device=cuda))
    torch.cuda.synchronize()
    assert ops.flash_launches == {"wgmma": 0, "mma_sync": 0,
                                  "f32": per_prefill}
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def test_cuda_attention_refuses_a_differentiable_call(cuda):
    """The flash kernel has no backward: on the card, a call that autograd
    would differentiate raises and names the differentiable route; the same
    call without grad mode launches the kernel."""
    q = torch.randn((1, 2, 64, 64), device=cuda, requires_grad=True)
    k, v = torch.randn_like(q), torch.randn_like(q)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="blockwise_attention"):
        ops.attention(q, k, v)
    assert ops.launches["flash_attention"] == 0
    with torch.no_grad():
        ops.attention(q, k, v)
    assert ops.launches["flash_attention"] == 1


# n = 4 rows of d > 2^31 / n columns: the last row's tail lies past the
# int32 range of element offsets
BIG_D = (1 << 29) + 4099


@pytest.mark.parametrize("quant", [None, "int8", "sign"])
def test_cuda_gossip_kernels_past_int32_offsets(cuda, quant):
    """Both gossip kernels on a bf16 [4, 2^29 + 4099] buffer (4.3 GB; row 3
    ends past element 2^31) against the plain version on the first and the
    last columns, cut at statistic tile boundaries (block_d = 512)."""
    n, rounds = 4, 2
    sched = tmix.schedule("ring", n)
    x = torch.randn((n, BIG_D), device=cuda, dtype=torch.bfloat16)
    if quant is None:
        got = ops.gossip_mix(x, sched, rounds)
        plain = lambda part: tref.gossip_mix_ref(part, sched, rounds)
    else:
        got = ops.quant_gossip_mix(x, sched, rounds, quant, block_d=512)
        plain = lambda part: tref.gossip_mix_quant_ref(part, sched, rounds,
                                                       quant, block_d=512)
    torch.cuda.synchronize()
    tail = (BIG_D - 65536) // 512 * 512
    for cut in (slice(0, 65536), slice(tail, BIG_D)):
        part = x[:, cut].contiguous()
        _close(got[:, cut], plain(part), 5e-2)
    del x, got
    torch.cuda.empty_cache()


def _reduced_training(dev, quant, steps=3):
    """Reduced granite-8b in f32, N = 4, ring R = 2, Adam: per-round losses,
    the final state, and the first round's per-node wq / wk / wv
    gradients, from seed 0 on `dev`."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
    from repro_torch.data.lm import MarkovTokenStream
    from repro_torch.train import trainer
    cfg = reduced(get_config("granite-8b"))
    avg = AveragingConfig("gossip", 2, quantization=quant,
                          quant_stats="tile", quant_block_d=512)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], averaging=avg,
                    optimizer="adam", learning_rate=1e-4,
                    param_dtype="float32")
    st = trainer.replicate_for_nodes(
        trainer.init_state(run, torch.Generator().manual_seed(0)), 4)
    state = trainer.TrainState(tree_to(st.params, dev), st.opt._replace(
        m=tree_to(st.opt.m, dev), v=tree_to(st.opt.v, dev)))
    data = MarkovTokenStream(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    step = trainer.build_train_step(run, None, n_nodes=4, device=dev)
    losses, first = [], None
    for s in range(steps):
        toks = data.sample(rng, 8, 65)
        b = trainer.make_node_batch({"tokens": toks[:, :-1],
                                     "labels": toks[:, 1:]}, 4)
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if s == 0:
            first = [trainer.loss_and_grad(
                run, tree_index(state.params, i), {k: v[i] for k, v in
                                                   b.items()})[2]
                     ["blocks"][0]["attn"] for i in range(4)]
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, state, first


def tree_to(tree, dev):
    from repro_torch.core.packing import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def tree_index(tree, i):
    from repro_torch.core.packing import tree_map
    return tree_map(lambda t: t[i], tree)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cuda_training_matches_the_cpu(cuda, quant):
    """Three rounds on the card and on the CPU from the same state: losses
    within rtol 1e-4; 99.9% of the parameters within 1e-4 and every one
    within 3 lr per round (Adam moves an entry whose gradient is float noise
    by up to its step); each node's wq / wk / wv gradient nonzero and
    within 1e-4 of its largest entry. The exact wire launches gossip_mix
    once per round, int8 tile statistics gossip_mix_quant; flash_attention
    never launches."""
    import numpy as np
    from repro_torch.core.packing import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launches()
    card_losses, card, card_g = _reduced_training(cuda, quant)
    counts = dict(ops.launches)
    cpu_losses, cpu, cpu_g = _reduced_training(torch.device("cpu"), quant)
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-4)
    d = torch.cat([(a.cpu() - b).abs().ravel() for a, b in
                   zip(tree_leaves(card.params), tree_leaves(cpu.params))])
    assert float((d <= 1e-4).float().mean()) >= 0.999
    assert float(d.max()) <= 3 * 1e-4 * 3
    for gc, gp in zip(card_g, cpu_g):
        for name in ("wq", "wk", "wv"):
            scale = float(gp[name].abs().max())
            assert scale > 0
            assert float((gc[name].cpu() - gp[name]).abs().max()) \
                <= 1e-4 * scale
    kernel = "gossip_mix" if quant == "none" else "gossip_mix_quant"
    assert counts[kernel] == 3 and counts["flash_attention"] == 0
    assert sum(counts.values()) == 3


# ---------------------------------------------------------------------------
# The elastic slice's cohort shapes: a death on the PCA path leaves 9 or 8
# of 10 nodes (B = 1000 snapped onto the cohort's ladder: Bn = 112 or 125;
# 111 for a ladder that rounds down), one in the trainer leaves 3 of 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 8, 9])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("d", [3072, 1 << 18])
def test_cuda_gossip_mix_at_cohort_sizes(cuda, n, dtype, rtol, d):
    x = torch.randn((n, d), device=cuda).to(dtype)
    sched = tmix.schedule("ring", n)
    for rounds in (2, 8):
        got = ops.gossip_mix(x, sched, rounds)
        torch.cuda.synchronize()
        _close(got, tref.gossip_mix_ref(x, sched, rounds), rtol)


@pytest.mark.parametrize("n", [3, 8, 9])
@pytest.mark.parametrize("quant", ["sign", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3072, 1 << 18])
def test_cuda_gossip_mix_quant_at_cohort_sizes(cuda, n, quant, dtype, d):
    """Against the plain version, routed as `quant_route` names (3072
    columns: 6 tiles, cluster-tile; 2^18: 512 tiles, resident-tile), the
    launch counted under that design."""
    from repro_torch.kernels.consensus import quant_cluster_size, quant_route
    x = torch.randn((n, d), device=cuda).to(dtype)
    sched = tmix.schedule("ring", n)
    route = quant_route(x, 512)
    assert route == ("cluster-tile" if d == 3072 else "resident-tile")
    ops.reset_launches()
    got = ops.quant_gossip_mix(x, sched, 2, quant, block_d=512)
    torch.cuda.synchronize()
    key = quant_cluster_size(512) if route == "cluster-tile" else route
    assert ops.quant_launches[key] == 1
    _close_quant(got, tref.gossip_mix_quant_ref(x, sched, 2, quant,
                                                block_d=512), dtype)


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("quant", ["sign", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3072, 1 << 18])
def test_cuda_gossip_mix_quant_routes_agree_bit_for_bit(cuda, n, quant,
                                                        dtype, d):
    """The trainer's node counts: the cluster-tile and resident-tile
    kernels give the same bits (both round every operation alike), so the
    tile-count route changes the time, not the answer."""
    from repro_torch.kernels.consensus import gossip_mix_quant_cuda
    x = torch.randn((n, d), device=cuda).to(dtype)
    sched = tmix.schedule("ring", n)
    a = gossip_mix_quant_cuda(x, sched, 2, quant, block_d=512,
                              _design="cluster-tile")
    b = gossip_mix_quant_cuda(x, sched, 2, quant, block_d=512,
                              _design="resident-tile")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("N,Bn", [(9, 111), (9, 112), (8, 125)])
@pytest.mark.parametrize("rounds", [2, 8])
def test_cuda_krasulina_xi_gossip_at_cohort_sizes(cuda, N, Bn, rounds):
    """The PCA cohorts' shapes through the routed (one-read) kernel, then a
    second call on another stream, which takes that stream's own
    grid-barrier word: both agree with the plain version and with each
    other bit for bit."""
    from repro_torch.kernels.krasulina_update import xi_gossip_route
    w = torch.randn((N, 3072), device=cuda)
    z = torch.randn((N, Bn, 3072), device=cuda)
    sched = tmix.schedule("ring", N)
    assert xi_gossip_route(w, z) == "one-read"
    ops.reset_launches()
    first = ops.krasulina_xi_gossip(w, z, sched, rounds)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        second = ops.krasulina_xi_gossip(w, z, sched, rounds)
    torch.cuda.synchronize()
    assert ops.xi_gossip_launches["one-read"] == 2
    _close(first, tref.krasulina_xi_gossip_ref(w, z, sched, rounds), 1e-4)
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("G,Bn", [(9, 111), (9, 112), (8, 125)])
def test_cuda_krasulina_xi_at_cohort_sizes(cuda, dtype, rtol, G, Bn):
    w = torch.randn((G, 3072), device=cuda).to(dtype)
    z = torch.randn((G, Bn, 3072), device=cuda).to(dtype)
    got = ops.krasulina_xi(w, z)
    torch.cuda.synchronize()
    _close(got, tref.krasulina_xi_ref(w, z), rtol)


@pytest.mark.parametrize("name", ["tv_rte/clean/iid_pca", "ring/lossy/iid_pca",
                                  "geometric/lossy/skew_logreg"])
def test_cuda_scheduled_mix_matches_the_cpu(cuda, name):
    """The scenario's `ScheduledMixOp` on the card (its tables there, the
    round index an int or a 0-dim card tensor) against the same op on the
    CPU, f32, at every round of its period."""
    from repro_torch.core import scenarios
    scn = scenarios.get_scenario(name)
    on_card = scenarios.build_mix(scn, device=cuda)
    on_cpu = scenarios.build_mix(scn, device="cpu")
    assert on_card.A_stack.is_cuda and on_card.phase_by_round.is_cuda
    x = torch.randn((scn.n_nodes, 4099))
    xc = x.to(cuda)
    for t in range(1, on_cpu.period + 2):
        want = on_cpu(x, t=t)
        for tt in (t, torch.tensor(t, device=cuda)):
            got = on_card(xc, t=tt)
            torch.cuda.synchronize()
            _close(got.cpu(), want, 1e-5)


@pytest.mark.parametrize("quant", ["none", "sign", "int8"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
def test_cuda_error_feedback_matches_the_cpu(cuda, quant, dtype, rtol):
    """`ef_average_and_error` on the card (the linear mix through the
    gossip_mix kernel, a ragged last tile, three chunks of columns) against
    the same call on the CPU: the mixed tree and the new residual."""
    from repro_torch.configs.base import AveragingConfig
    from repro_torch.core import averaging
    from repro_torch.core.packing import tree_leaves
    cfg = AveragingConfig(mode="gossip", rounds=2, quantization=quant,
                          quant_block_d=64, error_feedback="grads")
    g = {"a": torch.randn(4, 100).to(dtype), "b": torch.randn(4, 7, 33)
         .to(dtype)}
    e = {k: 0.1 * torch.randn(v.shape).to(dtype) for k, v in g.items()}
    old = averaging.EF_CHUNK_ENTRIES
    averaging.EF_CHUNK_ENTRIES = 4 * 128  # chunks of 128 columns
    try:
        outs = [averaging.ef_average_and_error(
            {k: v.to(d) for k, v in g.items()},
            {k: v.to(d) for k, v in e.items()}, cfg, n_nodes=4, device=d)
            for d in (cuda, torch.device("cpu"))]
    finally:
        averaging.EF_CHUNK_ENTRIES = old
    torch.cuda.synchronize()
    for part in (0, 1):
        for a, b in zip(tree_leaves(outs[0][part]), tree_leaves(outs[1][part])):
            _close(a.cpu(), b, rtol)


# ---------------------------------------------------------------------------
# Durability and publication on the card: the snapshotter's pinned staging
# and the publisher's copies, ordered on the training stream
# ---------------------------------------------------------------------------

def _stub_driver(state, step=1):
    """What `RunSnapshotter.maybe_snapshot` reads of a driver."""
    import types

    import numpy as np

    from repro_torch.configs.base import StreamConfig
    from repro_torch.core import rates
    from repro_torch.data.pipeline import StreamingPipeline

    pipe = StreamingPipeline(
        lambda rng, n: {"x": np.zeros((n, 2), np.float32)},
        StreamConfig(), n_nodes=1, rounds_R=1, batch=4)
    return types.SimpleNamespace(
        state=state, pipeline=pipe, _supersteps_done=step,
        _last_splitter_state=None, _last_round_s=None, _sig_seen={},
        _hysteresis=rates.BucketHysteresis(2), _estimator=None,
        _straggler=None, _membership=None, _publisher=None)


def test_cuda_snapshot_holds_the_values_from_before_an_in_place_update(
        cuda, tmp_path):
    """The D2H copy of a 256 MB leaf is still in flight when an in-place
    update of it is enqueued on the same stream: the checkpoint holds the
    values from before the update."""
    from repro_torch.train import checkpoint
    from repro_torch.train.snapshot import RunSnapshotter

    w = torch.randn(64 << 20, device=cuda)
    before = w.to("cpu", copy=True)
    d = _stub_driver({"w": w})
    with RunSnapshotter(str(tmp_path), every=1, overhead_budget=0) as sn:
        assert sn.maybe_snapshot(d) is not None
        w.mul_(0.0).add_(7.0)
        sn.flush()
    assert sn.stats.failures == 0 and sn.stats.saves == 1
    out = checkpoint.restore(checkpoint.step_dir(str(tmp_path), 1),
                             {"w": torch.zeros_like(w)})
    assert out["w"].device.type == "cuda"
    assert torch.equal(out["w"].cpu(), before)
    assert bool((w == 7.0).all())


def test_cuda_published_snapshot_is_not_changed_by_the_next_superstep(cuda):
    """An exact-mode LM run (the optimizer writes the parameters in place)
    publishes its parameters through the clone; the next superstep leaves
    the published tensors as they were."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
    from repro_torch.core.packing import tree_leaves
    from repro_torch.data.lm import MarkovTokenStream
    from repro_torch.serve.publisher import SnapshotPublisher
    from repro_torch.train import trainer
    from repro_torch.train.driver import EngineConfig, StreamingDriver

    cfg = dataclasses.replace(reduced(get_config("granite-8b"), layers=1,
                                      d_model=64), vocab_size=64)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"],
                    averaging=AveragingConfig("exact", 1), optimizer="adam",
                    learning_rate=1e-2, param_dtype="float32")
    state = trainer.init_state(run, torch.Generator(device=cuda).manual_seed(0))
    data = MarkovTokenStream(64, seed=0)

    def sample(rng, n):
        toks = data.sample(rng, n, 17)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    pub = SnapshotPublisher(overhead_budget=0.0)
    with StreamingDriver(run, None, state, sample, batch=4, n_nodes=1,
                         publisher=pub, device=cuda,
                         engine=EngineConfig(superstep=1, prefetch_depth=1,
                                             replan_every=0)) as drv:
        state, _ = drv.run(1)
        snap = pub.snapshot()
        kept = [t.clone() for t in tree_leaves(snap.params)]
        live = tree_leaves(state.params)
        assert all(a.data_ptr() != b.data_ptr() for a, b in
                   zip(tree_leaves(snap.params), live))
        state, _ = drv.run(1)
    torch.cuda.synchronize()
    assert pub.version == 2 and pub._back is snap
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(snap.params), kept))
    assert not all(torch.equal(a, b) for a, b in
                   zip(kept, tree_leaves(state.params)))


def test_cuda_bf16_leaf_round_trips_through_pinned_staging(cuda, tmp_path):
    """A bf16 leaf (every finite pattern's neighbours, infinities, a NaN)
    goes card -> pinned host buffer -> `<V2` file -> card bit for bit."""
    import numpy as np

    from repro_torch.train import checkpoint
    from repro_torch.train.snapshot import RunSnapshotter

    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    w = bits.view(torch.bfloat16).to(cuda).reshape(256, 256)
    d = _stub_driver({"w": w, "t": 3})
    with RunSnapshotter(str(tmp_path), every=1, overhead_budget=0,
                        block=True) as sn:
        sn.maybe_snapshot(d)
    path = checkpoint.step_dir(str(tmp_path), 1)
    ent = checkpoint.load_manifest(path)["leaves"]["w"]
    assert ent["dtype"] == "bfloat16" and ent["shape"] == [256, 256]
    raw = np.load(f"{path}/{ent['file']}")
    assert raw.dtype == np.dtype("V2")
    assert raw.tobytes() == bits.numpy().tobytes()
    out = checkpoint.restore(path, {"w": torch.zeros_like(w), "t": 0})
    assert out["t"] == 3
    assert torch.equal(out["w"].view(torch.int16).cpu(),
                       bits.reshape(256, 256))
