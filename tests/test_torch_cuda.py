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
