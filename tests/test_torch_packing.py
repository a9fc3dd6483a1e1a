"""The port's flat-buffer packing (`repro_torch.core.packing`) against
`repro.core.packing` on the same mixed-dtype trees (those of
`tests/test_packing.py`): the same segment map, buffers equal bit for bit,
and exact round trips."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro_torch.core import packing as tpack

DTYPES = ("float32", "bfloat16", "float16", "int32")


def rand_trees(seed, n_leaves, n, dtypes=DTYPES, lead=1):
    """The same random nested tree as a JAX pytree and as a torch tree:
    every leaf shares the leading [n] axis (lead=1) or none (lead=0), with
    mixed trailing ranks and dtypes (the generator of tests/test_packing.py)."""
    rng = np.random.default_rng(seed)
    jt, tt = {"sub": {}, "flat": []}, {"sub": {}, "flat": []}
    for i in range(n_leaves):
        rank = int(rng.integers(0, 3))
        shape = ((n,) if lead else ()) + tuple(
            int(rng.integers(1, 5)) for _ in range(rank))
        dt = dtypes[int(rng.integers(len(dtypes)))]
        if dt == "int32":
            a = rng.integers(-99, 99, size=shape).astype(np.int32)
            jl, tl = jnp.asarray(a), torch.from_numpy(a)
        else:
            a = rng.normal(size=shape).astype(np.float32)
            jl = jnp.asarray(a, dt)
            tl = torch.from_numpy(a).to(getattr(torch, dt))
        if i % 3 == 0:
            jt["sub"][f"l{i}"], tt["sub"][f"l{i}"] = jl, tl
        else:
            jt["flat"].append(jl)
            tt["flat"].append(tl)
    return jt, tt


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x, np.float32 if jnp.issubdtype(x.dtype, jnp.floating)
                      else None)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("lead", [1, 0])
def test_pack_matches_reference_and_round_trips(seed, lead):
    n_leaves = 1 + seed % 9
    n = 1 + seed % 8
    jt, tt = rand_trees(seed, n_leaves, n, lead=lead)
    jbufs, jspec = jpack.pack_tree(jt, lead=lead)
    tbufs, tspec = tpack.pack_tree(tt, lead=lead)
    assert tspec.trailing == jspec.trailing
    assert tspec.dtypes == jspec.dtypes
    assert tspec.groups == jspec.groups and tspec.lead == lead
    for g, (a, b) in enumerate(zip(tbufs, jbufs)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(tspec.segment_ids(g),
                                      jspec.segment_ids(g))
        assert tspec.group_width(g) == jspec.group_width(g)
    back = tpack.unpack_tree(tbufs, tspec)
    assert set(back) == {"sub", "flat"} and isinstance(back["flat"], list)
    for a, b in zip(tpack.tree_leaves(back), tpack.tree_leaves(tt)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_np(a), _np(b))
    # the leaves come in the reference's order (sorted dict keys)
    for a, b in zip(tpack.tree_leaves(tt), jax.tree.leaves(jt)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_tuples_none_and_tree_map_keep_structure():
    tree = {"b": (torch.ones(2, 3), None), "a": [torch.zeros(2)]}
    bufs, spec = tpack.pack_tree(tree)
    assert bufs[0].shape == (2, 4)
    back = tpack.unpack_tree(bufs, spec)
    assert isinstance(back["b"], tuple) and back["b"][1] is None
    doubled = tpack.tree_map(lambda x: 2 * x, tree)
    assert torch.equal(doubled["b"][0], 2 * tree["b"][0])
    with pytest.raises(TypeError, match="tensors"):
        tpack.pack_tree({"a": 1.0})


def test_pack_spec_reuse_across_lead_sizes():
    """A spec built from [N, ...] leaves repacks trees of another node
    count."""
    _, spec = tpack.pack_tree({"a": torch.ones(4, 3), "b": torch.zeros(4, 2, 2)})
    bufs, _ = tpack.pack_tree({"a": torch.ones(9, 3),
                               "b": torch.zeros(9, 2, 2)}, spec)
    assert bufs[0].shape == (9, 7)
    assert tpack.unpack_tree(bufs, spec)["b"].shape == (9, 2, 2)


def test_pack_rejects_mismatched_leading_axes():
    with pytest.raises(ValueError, match="leading"):
        tpack.pack_tree({"a": torch.ones(4, 3), "b": torch.ones(5, 3)})
    _, spec = tpack.pack_tree({"a": torch.ones(4, 3)})
    with pytest.raises(ValueError, match="trailing"):
        tpack.pack_tree({"a": torch.ones(4, 7)}, spec)
    with pytest.raises(ValueError, match="leaf count"):
        tpack.pack_tree({"a": torch.ones(4, 3), "b": torch.ones(4, 1)}, spec)


@pytest.mark.parametrize("widths", [(3, 5, 8), (1, 40, 0, 7), ()])
def test_segment_sums_match_reference(widths):
    a = np.random.default_rng(1).standard_normal(
        (4, sum(widths))).astype(np.float32)
    got = tpack.segment_sums(torch.from_numpy(a), widths)
    want = jpack.segment_sums(jnp.asarray(a), widths)
    assert tuple(got.shape) == want.shape == (4, len(widths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_segment_sums_no_cancellation_after_large_leaf():
    """A small segment after a large one keeps its exact sum (the static
    split does not subtract running sums)."""
    v = torch.cat([torch.full((1_000_000,), 1e4), torch.tensor([1e-3, 2e-3])])
    got = tpack.segment_sums(v, (1_000_000, 2))
    assert abs(float(got[1]) - 3e-3) < 1e-9
