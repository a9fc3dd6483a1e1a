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
    ({"impl": "shard"}, "sharded"),
])
def test_later_slices_raise_not_implemented(kwargs, match):
    sched = mixing.schedule("ring", 4)
    with pytest.raises(NotImplementedError, match=match):
        mixing.circulant_mix_op(sched, 4, 2, device="cpu", **kwargs)


def test_make_gossip_mix_refuses_quantized_and_error_feedback():
    with pytest.raises(NotImplementedError, match="quantized"):
        averaging.make_gossip_mix(
            AveragingConfig(mode="gossip", quantization="sign"), 4,
            device="cpu")
    with pytest.raises(NotImplementedError, match="LM slice"):
        averaging.make_gossip_mix(
            AveragingConfig(mode="gossip", quantization="sign",
                            error_feedback="on"), 4, device="cpu")


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
