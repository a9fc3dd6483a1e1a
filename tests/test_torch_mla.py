"""The port's MLA block (`models/layers.py:apply_mla`) against the JAX
package's, in f32 on the CPU on reduced minicpm3-4b with the reference's
weights, inputs drawn from numpy seeds, within rtol = atol = 1e-4: without a
cache (short and long queries: both `blockwise_attention` branches), with a
cache at a scalar index (a prefill at 0, a decode, a chunk at a later
index) and with a per-slot index vector; the cache comes back updated in
place, equal to the reference's new one. Also `init_mla`'s shapes, the MLA
cache layout, and the serving engine's `init_serve` and slot insert on an
MLA cache."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import layers as JL
from repro.models import registry as jreg
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import registry
from repro_torch.serve import engine

torch.set_num_threads(1)

RTOL = ATOL = 1e-4


def _close(got, want, tol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _pair(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.fixture(scope="module")
def mla():
    jcfg = jreduced(jget_config("minicpm3-4b"))
    tcfg = reduced(get_config("minicpm3-4b"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp = JL.init_mla(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


def test_init_mla_shapes(mla):
    jcfg, tcfg, jp, _ = mla
    own = TL.init_mla(torch.Generator().manual_seed(0), tcfg, torch.float32)
    assert (convert.tree_map(lambda t: tuple(t.shape), own)
            == jax.tree.map(np.shape, jp))
    assert torch.equal(own["norm_kv"], torch.ones(tcfg.mla.kv_lora_rank))


@pytest.mark.parametrize("S", [12, 40])
def test_apply_mla_without_cache(mla, S):
    jcfg, tcfg, jp, tp = mla
    jx, tx = _pair((2, S, tcfg.d_model), S)
    pos = np.broadcast_to(np.arange(S)[None], (2, S))
    jout, _ = JL.apply_mla(jp, jcfg, jx, jnp.asarray(pos))
    ops.reset_launches()
    tout, cache = TL.apply_mla(tp, tcfg, tx, torch.from_numpy(pos.copy()))
    assert cache is None
    _close(tout, jout)


MLA_CACHE_CASES = [
    # (S, index): prefill at 0, decode at a scalar index, a chunk at a later
    # index, per-slot decode
    (20, 0), (1, 9), (6, 7), (1, [3, 12]),
]


@pytest.mark.parametrize("S,index", MLA_CACHE_CASES,
                         ids=["prefill", "decode", "chunk", "per_slot"])
def test_apply_mla_with_cache(mla, S, index):
    jcfg, tcfg, jp, tp = mla
    m = tcfg.mla
    jx, tx = _pair((2, S, tcfg.d_model), 7)
    jc1, tc1 = _pair((2, 32, m.kv_lora_rank), 8)
    jc2, tc2 = _pair((2, 32, 1, m.qk_rope_head_dim), 9)
    vec = isinstance(index, list)
    base = np.asarray(index)[:, None] if vec else index
    pos = np.broadcast_to(np.arange(S)[None] + base, (2, S))
    jout, jcache = JL.apply_mla(jp, jcfg, jx, jnp.asarray(pos),
                                cache={"ckv": jc1, "krope": jc2},
                                cache_index=jnp.asarray(index, jnp.int32))
    tcache = {"ckv": tc1.clone(), "krope": tc2.clone()}
    tout, tnew = TL.apply_mla(tp, tcfg, tx, torch.from_numpy(pos.copy()),
                              cache=tcache,
                              cache_index=torch.tensor(index) if vec else index)
    assert tnew is tcache
    _close(tout, jout)
    _close(tcache["ckv"], jcache["ckv"])
    _close(tcache["krope"], jcache["krope"])


def test_mla_cache_layout_and_engine(mla):
    """An MLA model's cache is one {"ckv", "krope"} per layer, shaped as the
    reference's; `init_serve` takes its device from it (it has no "k"), and
    the continuous engine's slot insert copies both tensors into the row."""
    jcfg, tcfg, _, _ = mla
    cache = registry.init_cache(tcfg, 3, 24, torch.float32, device="cpu")
    jcache = jreg.init_cache(jcfg, 3, 24, jnp.float32)
    assert len(cache) == tcfg.num_layers
    for i, c in enumerate(cache):
        assert set(c) == {"ckv", "krope"}
        for name in c:
            assert tuple(c[name].shape) == jcache["layers"][0][name].shape[1:]
    st = engine.init_serve(tcfg, 3, 24, torch.float32, device="cpu")
    assert st.last_tokens.device.type == "cpu" and st.index == 0
    one = registry.init_cache(tcfg, 1, 24, torch.float32, device="cpu")
    for c in one:
        for t in c.values():
            t.normal_(generator=torch.Generator().manual_seed(1))
    engine._insert_fn(cache, one, 2)
    for dst, src in zip(cache, one):
        for name in ("ckv", "krope"):
            assert torch.equal(dst[name][2], src[name][0])
            assert not dst[name][:2].any()
