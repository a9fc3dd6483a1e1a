"""The port's tree averaging (`repro_torch.core.averaging`) against
`repro.core.averaging` on the same trees (the generator of
`tests/test_packing.py`): packed and per-leaf gossip, every quantizer
statistic, hierarchical reduce-scatter with its padded `valid_d`, and the
consensus-error diagnostics.

Tolerances: f32 leaves rtol 2e-5 / atol 2e-6 (the reference's own bound for
its impls) unquantized and rtol / atol 1e-5 quantized (the bound of
`tests/test_consensus_engine.py`); bf16 and f16 leaves 1e-2, one ulp of
their type (both packages round the f32-accumulated product once, not
necessarily the same way); consensus errors rtol 1e-4 (as in
`tests/test_packing.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AveragingConfig as JAveragingConfig
from repro.core import averaging as javg
from repro_torch.configs.base import AveragingConfig
from repro_torch.core import averaging as tavg
from repro_torch.core import mixing as tmix
from repro_torch.core import packing as tpack
from test_torch_packing import rand_trees

FLOATS = ("float32", "bfloat16", "float16")


def _cfgs(**kw):
    return AveragingConfig(**kw), JAveragingConfig(**kw)


def _close(got, want, f32_tol):
    """Leaf by leaf, in the reference's leaf order."""
    gl, wl = tpack.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert tuple(a.shape) == b.shape
        tol = f32_tol if a.dtype == torch.float32 else dict(rtol=1e-2,
                                                            atol=1e-2)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), **tol)


UNQ = dict(rtol=2e-5, atol=2e-6)
QTOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtypes", [("float32",), FLOATS])
@pytest.mark.parametrize("topology,rounds", [("circulant2", 5), ("ring", 1),
                                             ("torus", 3)])
def test_gossip_average_matches_reference(packed, dtypes, topology, rounds):
    n = 8
    jt, tt = rand_trees(11, 7, n, dtypes=dtypes)
    cfg, jcfg = _cfgs(mode="gossip", rounds=rounds, topology=topology,
                      packed=packed)
    _close(tavg.gossip_average(tt, n, cfg, device="cpu"),
           javg.gossip_average(jt, n, jcfg), UNQ)


@pytest.mark.parametrize("impl", ["roll", "matmul", "kernel"])
def test_packed_gossip_every_impl_matches_reference(impl):
    n, rounds = 8, 5
    jt, tt = rand_trees(1, 7, n, dtypes=("float32",))
    cfg, jcfg = _cfgs(mode="gossip", rounds=rounds, topology="circulant2")
    mix = tmix.circulant_mix_op(tmix.schedule("circulant2", n), n, rounds,
                                impl=impl, device="cpu")
    _close(tavg.gossip_average(tt, n, cfg, mix),
           javg.gossip_average(jt, n, jcfg), UNQ)


@pytest.mark.parametrize("quant", ["sign", "int8"])
@pytest.mark.parametrize("stats", ["global", "segment", "tile", "node"])
@pytest.mark.parametrize("packed", [True, False])
def test_quantized_gossip_average_matches_reference(quant, stats, packed):
    n = 8
    jt, tt = rand_trees(4, 7, n, dtypes=("float32",))
    cfg, jcfg = _cfgs(mode="gossip", rounds=4, quantization=quant,
                      quant_stats=stats, quant_block_d=16, packed=packed)
    _close(tavg.gossip_average(tt, n, cfg, device="cpu"),
           javg.gossip_average(jt, n, jcfg), QTOL)


@pytest.mark.parametrize("quant,stats", [("sign", "global"), ("int8", "tile"),
                                         ("sign", "tile"), ("int8", "segment"),
                                         (None, None)])
@pytest.mark.parametrize("per_pod,feat", [(3, 7), (4, 5), (2, 8)])
def test_hierarchical_average_matches_reference(quant, stats, per_pod, feat):
    """feat not a multiple of per_pod pads the reduce-scatter; the pad
    columns reach the quantized mix as `valid_d` and stay out of every
    statistic. rtol / atol 1e-5."""
    pods = 4
    n = pods * per_pod
    a = np.random.default_rng(25).standard_normal((n, feat)).astype(np.float32)
    b = np.random.default_rng(26).standard_normal((n, 3, 2)).astype(np.float32)
    kw = dict(mode="hierarchical", rounds=3, topology="ring")
    if quant is not None:
        kw.update(quantization=quant, quant_stats=stats, quant_block_d=4)
    cfg, jcfg = _cfgs(**kw)
    got = tavg.hierarchical_average(
        {"g": torch.from_numpy(a), "h": torch.from_numpy(b)}, pods, per_pod,
        cfg, device="cpu")
    want = javg.hierarchical_average({"g": jnp.asarray(a), "h": jnp.asarray(b)},
                                     pods, per_pod, jcfg)
    _close(got, want, QTOL)
    via = tavg.average_gradients(
        {"g": torch.from_numpy(a), "h": torch.from_numpy(b)}, cfg,
        n_nodes=n, pods=pods, device="cpu")
    _close(via, want, QTOL)


@pytest.mark.parametrize("quant", ["sign", "int8"])
def test_hierarchical_padded_matches_unpadded_broadcast(quant):
    """The zero-padded reduce-scatter form equals the unpadded broadcast
    form (pod means gossiped with global-stats compression): the pad
    columns do not leak into the scales. rtol / atol 1e-5."""
    from repro_torch.core.quantize import COMPRESSORS

    pods, per_pod, feat = 4, 3, 7
    v = torch.from_numpy(np.random.default_rng(25).standard_normal(
        (pods * per_pod, feat)).astype(np.float32))
    cfg = AveragingConfig(mode="hierarchical", rounds=3, quantization=quant)
    got = tavg.hierarchical_average({"g": v}, pods, per_pod, cfg,
                                    device="cpu")["g"]
    x = v.reshape(pods, per_pod, feat).mean(1)
    for _ in range(3):
        x = tmix.roll_mix(x, tmix.schedule("ring", pods), COMPRESSORS[quant])
    np.testing.assert_allclose(got.numpy(),
                               x.repeat_interleave(per_pod, 0).numpy(), **QTOL)


@pytest.mark.parametrize("mode", ["exact", "gossip", "hierarchical"])
@pytest.mark.parametrize("quant", ["none", "sign"])
def test_average_and_error_matches_reference(mode, quant):
    n = 8
    jt, tt = rand_trees(7, 6, n, dtypes=("float32",))
    cfg, jcfg = _cfgs(mode=mode, rounds=2, quantization=quant,
                      quant_stats="tile", quant_block_d=8)
    mixed, err = tavg.average_and_error(tt, cfg, n_nodes=n, pods=4,
                                        device="cpu")
    jmixed, jerr = javg.average_and_error(jt, jcfg, n_nodes=n, pods=4)
    _close(mixed, jmixed, QTOL)
    np.testing.assert_allclose(float(err), float(jerr), rtol=1e-4, atol=1e-7)
    if mode != "exact":
        np.testing.assert_allclose(
            float(err), float(tavg.consensus_error_per_leaf(mixed)),
            rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("seed", range(6))
def test_consensus_error_matches_reference(seed):
    n = 2 + seed
    jt, tt = rand_trees(seed, 1 + seed, n, dtypes=("float32", "bfloat16"))
    want = float(javg.consensus_error(jt))
    np.testing.assert_allclose(float(tavg.consensus_error(tt)), want,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tavg.consensus_error_per_leaf(tt)),
                               float(javg.consensus_error_per_leaf(jt)),
                               rtol=1e-4, atol=1e-6)
    assert float(tavg.consensus_error({})) == 0.0


def test_exact_average_and_mode_dispatch():
    jt, tt = rand_trees(3, 5, 4, dtypes=("float32",))
    cfg, jcfg = _cfgs(mode="exact")
    _close(tavg.average_gradients(tt, cfg, n_nodes=4),
           javg.average_gradients(jt, jcfg, n_nodes=4), UNQ)
    with pytest.raises(ValueError, match="unknown averaging mode"):
        tavg.average_gradients(tt, AveragingConfig(mode="ring"), n_nodes=4)
    with pytest.raises(ValueError, match="pods"):
        tavg.average_gradients(tt, AveragingConfig(mode="hierarchical"),
                               n_nodes=4, pods=3, device="cpu")


def test_stochastic_key_reaches_the_compressor():
    """int8_stoch: the same per-step key gives the same mix, another key
    another; the mean over nodes is kept within the rounding noise."""
    tree = {"a": torch.randn(4, 24, generator=torch.Generator().manual_seed(0)),
            "b": torch.randn(4, 8, generator=torch.Generator().manual_seed(1))}
    cfg = AveragingConfig(mode="gossip", rounds=2, quantization="int8_stoch",
                          quant_stats="segment")
    mix = tavg.make_gossip_mix(cfg, 4, device="cpu")
    s0 = tavg.average_gradients(tree, cfg, n_nodes=4, mix=mix, key=100)
    again = tavg.average_gradients(tree, cfg, n_nodes=4, mix=mix, key=100)
    s1 = tavg.average_gradients(tree, cfg, n_nodes=4, mix=mix, key=101)
    assert torch.equal(s0["a"], again["a"])
    assert not torch.equal(s0["a"], s1["a"])
    np.testing.assert_allclose(s0["a"].mean(0).numpy(),
                               tree["a"].mean(0).numpy(), atol=0.05)


def test_resolve_packed_and_error_feedback_refusal():
    """Error feedback refuses a nonlinear (per-round quantized) operator, as
    the reference does; its outputs are held against the reference's in
    tests/test_torch_error_feedback.py."""
    assert tavg.resolve_packed(AveragingConfig())
    assert not tavg.resolve_packed(AveragingConfig(packed=False))
    quantized = tavg.make_gossip_mix(
        AveragingConfig(mode="gossip", quantization="sign"), 4,
        device="cpu")
    tree = {"a": torch.ones(4, 3)}
    with pytest.raises(ValueError, match="LINEAR"):
        tavg.ef_average_and_error(tree, tree, AveragingConfig(
            mode="gossip", quantization="sign", error_feedback="grads"),
            n_nodes=4, mix=quantized)
