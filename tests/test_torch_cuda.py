"""The port's hand-written Hopper kernels against their plain PyTorch
versions on a CUDA card, at the main path's shapes and ragged ones:
f32 within rtol 1e-4 of max|plain| (+1e-5), bf16 within 5e-2 (the plain
bf16 versions round after every gossip round, the kernels once).

Without a card every test skips; the decision is made inside the `cuda`
fixture, never at import. This file imports neither jax nor the JAX
package, so it runs on the machine with the card:
`PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py`.
"""
import pytest
import torch

from repro_torch.core import mixing as tmix
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref


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
    from repro_torch.kernels.consensus import gossip_mix_quant_cuda
    x = torch.randn((64, 1024), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        gossip_mix_quant_cuda(x, tmix.schedule("ring", 64), 1, "int8",
                              block_d=512)
