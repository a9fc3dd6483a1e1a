"""The port's consensus engine (`repro_torch.core.mixing`,
`repro_torch.core.averaging`) against `repro.core.mixing` on the same
numbers: schedules and their composition exactly, the MixOp impls at
rtol / atol 1e-5 (the reference's own bound for its impls)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AveragingConfig as JAveragingConfig
from repro.core import averaging as javg
from repro.core import mixing as jmix
from repro_torch.configs.base import AveragingConfig
from repro_torch.core import averaging, mixing
from repro_torch.dist import Mesh

TOPOS = ("ring", "circulant2", "torus")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 10, 16])
@pytest.mark.parametrize("topo", TOPOS)
def test_schedules_and_matrices_match_reference(n, topo):
    sched = mixing.schedule(topo, n)
    assert sched == jmix.schedule(topo, n)
    assert mixing.schedule(topo, n, 0.5) == jmix.schedule(topo, n, 0.5)
    A = mixing.schedule_matrix(sched, n)
    np.testing.assert_array_equal(A, jmix.schedule_matrix(sched, n))
    assert mixing.is_doubly_stochastic(A) == jmix.is_doubly_stochastic(A)
    assert mixing.lambda2(A) == jmix.lambda2(A)


@pytest.mark.parametrize("n", [3, 8, 10])
@pytest.mark.parametrize("rounds", [0, 1, 3, 8])
@pytest.mark.parametrize("topo", TOPOS)
def test_compose_schedule_matches_reference(n, rounds, topo):
    sched = mixing.schedule(topo, n)
    got = mixing.compose_schedule(sched, rounds, n)
    assert got == jmix.compose_schedule(sched, rounds, n)
    # and it is the R-th power of the one-round operator
    np.testing.assert_allclose(
        mixing.schedule_matrix(got, n),
        np.linalg.matrix_power(mixing.schedule_matrix(sched, n), rounds),
        atol=1e-12)


@pytest.mark.parametrize("n,deg", [(8, 2), (10, 4), (12, 3)])
def test_metropolis_weights_of_regular_graph_match_reference(n, deg):
    adj = mixing._circulant_regular(n, deg)
    np.testing.assert_array_equal(adj, jmix._circulant_regular(n, deg))
    A = mixing.metropolis_weights(adj.astype(float))
    np.testing.assert_array_equal(
        A, jmix.metropolis_weights(adj.astype(float)))
    assert mixing.is_doubly_stochastic(A)


@pytest.mark.parametrize("impl", ["roll", "matmul", "kernel"])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("topo,n,rounds", [("ring", 8, 3), ("circulant2", 6, 5),
                                           ("torus", 12, 2), ("ring", 1, 4)])
def test_mix_op_matches_reference(impl, fuse, topo, n, rounds):
    sched = mixing.schedule(topo, n)
    x = np.random.default_rng(0).standard_normal((n, 3, 5)).astype(np.float32)
    op = mixing.circulant_mix_op(sched, n, rounds, impl=impl, fuse=fuse,
                                 device="cpu")
    got = op(torch.from_numpy(x)).numpy()
    ref_impl = "matmul" if impl == "kernel" else impl
    want = np.asarray(jmix.circulant_mix_op(sched, n, rounds, impl=ref_impl,
                                            fuse=fuse)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got.shape == x.shape


def test_auto_impl_on_cpu_and_roll_mix():
    assert mixing.resolve_auto_impl("cpu") == "matmul"
    op = mixing.circulant_mix_op(mixing.schedule("ring", 4), 4, 2,
                                 device="cpu")
    assert op.impl == "matmul" and op.A_eff.shape == (4, 4)
    x = np.random.default_rng(1).standard_normal((4, 7)).astype(np.float32)
    sched = mixing.schedule("ring", 4)
    np.testing.assert_allclose(
        mixing.roll_mix(torch.from_numpy(x), sched).numpy(),
        np.asarray(jmix.roll_mix(jnp.asarray(x), sched, lambda m: m)),
        rtol=1e-6, atol=1e-6)


def test_make_gossip_mix_matches_reference_schedule():
    cfg = AveragingConfig(mode="gossip", rounds=4, topology="circulant2")
    op = averaging.make_gossip_mix(cfg, 8, device="cpu")
    ref = javg.make_gossip_mix(
        JAveragingConfig(mode="gossip", rounds=4, topology="circulant2"), 8)
    assert op.sched == ref.sched and op.fused_sched == ref.fused_sched
    assert op.rounds == 4 and op.n == 8


def test_auto_impl_without_device_needs_the_card():
    """`device=None` means the CUDA card; without one the builder raises and
    says how to ask for the CPU."""
    if torch.cuda.is_available():
        assert mixing.resolve_auto_impl() == "kernel"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mixing.resolve_auto_impl()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        averaging.make_gossip_mix(AveragingConfig(mode="gossip"), 4)


@pytest.mark.parametrize("kwargs,match", [
    ({"quantization": "sign"}, "quantized"),
    ({"quantization": "int8"}, "quantized"),
    ({"impl": "shard", "mesh": Mesh((1, 2), ("data", "model"))}, "sharded"),
])
def test_later_slices_raise_not_implemented(kwargs, match):
    """A mesh with a model axis still raises (the sharded model layouts of
    queue 1 item 3); `impl="shard"` without a mesh falls back to the roll,
    as the reference's does (a node-only mesh takes the shard rule:
    tests/test_torch_shard.py); quantized ops (ported with the
    quantized-wire slice) build and match the reference's per-round
    global-stats loop at rtol / atol 1e-5."""
    sched = mixing.schedule("ring", 4)
    if "quantization" not in kwargs:
        with pytest.raises(NotImplementedError, match=match):
            mixing.circulant_mix_op(sched, 4, 2, device="cpu", **kwargs)
        op = mixing.circulant_mix_op(sched, 4, 2, device="cpu", impl="shard")
        jop = jmix.circulant_mix_op(sched, 4, 2, impl="shard")
        assert op.impl == jop.impl == "roll" and op.mesh is None
        x = np.random.default_rng(2).standard_normal((4, 9)).astype(
            np.float32)
        np.testing.assert_allclose(op(torch.from_numpy(x)).numpy(),
                                   np.asarray(jop(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)
        return
    op = mixing.circulant_mix_op(sched, 4, 2, device="cpu", **kwargs)
    assert op.fused_sched is None and op.A_eff is None
    x = np.random.default_rng(2).standard_normal((4, 9)).astype(np.float32)
    want = jmix.circulant_mix_op(sched, 4, 2, **kwargs)(jnp.asarray(x))
    np.testing.assert_allclose(op(torch.from_numpy(x)).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_make_gossip_mix_refuses_quantized_and_error_feedback():
    """A quantized config builds the reference's op: the same schedule,
    quantization, statistics and tile width; with error feedback on, both
    packages drop the per-round compressor (the rounds are linear, the
    compression happens once per step outside the op)."""
    cfg = AveragingConfig(mode="gossip", quantization="sign",
                          quant_stats="tile", quant_block_d=64)
    op = averaging.make_gossip_mix(cfg, 4, device="cpu")
    ref = javg.make_gossip_mix(
        JAveragingConfig(mode="gossip", quantization="sign",
                         quant_stats="tile", quant_block_d=64), 4)
    for field in ("sched", "fused_sched", "n", "rounds", "quantization",
                  "stats", "block_d", "seed"):
        assert getattr(op, field) == getattr(ref, field), field
    op = averaging.make_gossip_mix(
        AveragingConfig(mode="gossip", quantization="sign",
                        error_feedback="on"), 4, device="cpu")
    ref = javg.make_gossip_mix(
        JAveragingConfig(mode="gossip", quantization="sign",
                         error_feedback="on"), 4)
    assert op.quantization == ref.quantization == "none"
    for field in ("sched", "fused_sched", "n", "rounds", "stats", "block_d"):
        assert getattr(op, field) == getattr(ref, field), field


QUANTS = ("sign", "int8")


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("stats", ["global", "segment", "tile", "node"])
@pytest.mark.parametrize("topo,n,rounds", [("ring", 8, 3), ("circulant2", 5, 2),
                                           ("torus", 12, 4)])
def test_quantized_mix_op_matches_reference(quant, stats, topo, n, rounds):
    """Every statistic granularity of the quantized `CirculantMixOp`
    against the reference's, on a buffer whose last 5 columns are pad
    (`valid_d`) and, for "segment", with the segment widths passed: rtol /
    atol 1e-5 (the bound of tests/test_consensus_engine.py)."""
    sched = mixing.schedule(topo, n)
    x = np.random.default_rng(3).standard_normal((n, 45)).astype(np.float32)
    x[:, 40:] = 0
    kw = dict(quantization=quant, stats=stats, block_d=16)
    op = mixing.circulant_mix_op(sched, n, rounds, device="cpu", **kw)
    ref = jmix.circulant_mix_op(sched, n, rounds, **kw)
    call = {"seg_widths": (20, 25)} if stats == "segment" else {"valid_d": 40}
    np.testing.assert_allclose(op(torch.from_numpy(x), **call).numpy(),
                               np.asarray(ref(jnp.asarray(x), **call)),
                               rtol=1e-5, atol=1e-5)


def test_quantized_mix_op_keeps_per_round_operator():
    """No collapsing under quantization: the result differs from the linear
    composed operator's."""
    n, rounds = 8, 5
    sched = mixing.schedule("ring", n)
    op = mixing.circulant_mix_op(sched, n, rounds, quantization="sign",
                                 device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (n, 16)).astype(np.float32))
    collapsed = mixing.circulant_mix_op(sched, n, rounds, device="cpu")(x)
    assert not torch.allclose(op(x), collapsed, atol=1e-4)


@pytest.mark.parametrize("stats", ["global", "segment", "tile", "node"])
def test_stochastic_mix_op_per_step_key(stats):
    """int8_stoch draws round r from (seed, key, r): the same key gives the
    same mix, another key (or none) another, and the node mean is kept
    within the rounding noise."""
    op = mixing.circulant_mix_op(mixing.schedule("ring", 4), 4, 3,
                                 quantization="int8_stoch", stats=stats,
                                 seed=11, device="cpu")
    x = torch.randn(4, 96, generator=torch.Generator().manual_seed(5))
    kw = {"seg_widths": (32, 64)} if stats == "segment" else {}
    a = op(x, key=7, **kw)
    assert torch.equal(a, op(x, key=7, **kw))
    assert not torch.equal(a, op(x, key=8, **kw))
    assert not torch.equal(a, op(x, **kw))
    assert torch.equal(op(x, **kw), op(x, **kw))
    np.testing.assert_allclose(a.mean().item(), x.mean().item(), atol=0.05)


def test_deterministic_compressors_ignore_the_key():
    op = mixing.circulant_mix_op(mixing.schedule("ring", 4), 4, 2,
                                 quantization="int8", device="cpu")
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(6))
    assert torch.equal(op(x), op(x, key=42))


def test_circulant_mix_op_checks_its_arguments():
    sched = mixing.schedule("ring", 4)
    for kw, match in (({"stats": "leaf"}, "stats"),
                      ({"quantization": "int4"}, "quantization"),
                      ({"impl": "gather"}, "impl")):
        with pytest.raises(ValueError, match=match):
            mixing.circulant_mix_op(sched, 4, 2, device="cpu", **kw)


@pytest.mark.parametrize("n,deg,seed", [(16, 6, 0), (8, 4, 1), (12, 3, 2)])
def test_graph_builders_match_reference(n, deg, seed):
    """numpy, so the same seed gives the reference's matrices exactly."""
    np.testing.assert_array_equal(mixing.random_regular_expander(n, deg, seed),
                                  jmix.random_regular_expander(n, deg, seed))
    np.testing.assert_array_equal(mixing.random_geometric(n, seed),
                                  jmix.random_geometric(n, seed))
    np.testing.assert_array_equal(mixing.ring_matrix(n), jmix.ring_matrix(n))
    adj = mixing.random_regular_expander(n, deg, seed) > 0
    assert mixing._connected(adj) and mixing.is_doubly_stochastic(
        mixing.random_regular_expander(n, deg, seed))
    with pytest.raises(ValueError, match="degree"):
        mixing.random_regular_expander(4, 4)
    assert mixing.random_geometric(1).shape == (1, 1)


def test_mix_op_refuses_wrong_node_axis():
    op = mixing.circulant_mix_op(mixing.schedule("ring", 4), 4, 2,
                                 device="cpu")
    with pytest.raises(ValueError, match="n=4"):
        op(torch.zeros(5, 3))


def test_membership_matches_reference():
    m = mixing.Membership.full(5).drop(1, 3)
    r = jmix.Membership.full(5).drop(1, 3)
    assert m.to_json() == r.to_json()
    assert (m.n_active, m.active_ids, m.is_full) == (r.n_active, r.active_ids,
                                                     r.is_full)
    assert mixing.Membership.from_json(m.rejoin(1, 3).to_json()).is_full
    with pytest.raises(ValueError):
        mixing.Membership(3, (False, False, False))
