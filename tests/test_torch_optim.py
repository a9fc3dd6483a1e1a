"""The port's tree optimizers (`repro_torch.optim`) against the JAX package's
`repro.optim` on the same trees and the same gradients, step after step:
SGD with and without momentum, Adam, accelerated SGD (eqs. 9-11), weight
decay, f32 masters under bf16 parameters, and Polyak-Ruppert averaging
(eq. 7). f32 parameters and moments agree within rtol = atol = 1e-6 (the
updates are the reference's operations in the reference's order; only the
last bit of a power or a fused multiply-add may differ); bf16 parameters
within one bf16 rounding (rtol 1e-2), their f32 masters within 1e-6. Also
the contracts of tests/test_optim.py, on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.core.packing import tree_leaves, tree_map
from repro_torch.optim import optimizers as topt

TOL = 1e-6


def _trees(seed):
    """A nested tree of numpy arrays (dict and list, as the LM params)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"blocks": [{"w": mk(3, 4), "b": mk(4)}, {"w": mk(3, 4), "b": mk(4)}],
            "embed": mk(5, 3)}


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, dtype) for v in tree]
    return torch.from_numpy(np.array(tree)).to(dtype)


def _all_torch(tree):
    if isinstance(tree, dict):
        return all(_all_torch(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_all_torch(v) for v in tree)
    return isinstance(tree, torch.Tensor)


def _np_leaves(tree):
    """f32 numpy leaves in tree order (the same order in both packages)."""
    if _all_torch(tree):
        return [t.detach().float().numpy() for t in tree_leaves(tree)]
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _close(got, want, tol=TOL):
    for g, w in zip(_np_leaves(got), _np_leaves(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


CASES = [
    # (name, kwargs of make_optimizer, param dtype, master weights)
    ("sgd", dict(lr=0.1), "float32", False),
    ("sgd", dict(lr=0.1, momentum=0.9), "float32", False),
    ("sgd", dict(lr=0.1, momentum=0.9, weight_decay=0.05), "float32", False),
    ("adam", dict(lr=1e-2), "float32", False),
    ("adam", dict(lr=1e-2, weight_decay=0.1, b2=0.999), "float32", False),
    ("adam", dict(lr=1e-2), "bfloat16", True),
    ("adam", dict(lr=1e-2, weight_decay=0.1), "bfloat16", True),
    ("adam", dict(lr=1e-2, lr_schedule=lambda s: 1.0 / s), "float32", False),
    ("accel", dict(lr=0.05), "float32", False),
]


@pytest.mark.parametrize("name,kw,dtype,master", CASES)
def test_update_matches_reference(name, kw, dtype, master):
    """Five steps on the same gradients: parameters and every moment."""
    params = _trees(0)
    jp = _to_jax(params, getattr(jnp, dtype))
    tp = _to_torch(params, getattr(torch, dtype))
    js = jopt.init_optimizer(name, jp, master_weights=master)
    ts = topt.init_optimizer(name, tp, master_weights=master)
    kw = dict(kw)
    lr = kw.pop("lr")
    jupd = jopt.make_optimizer(name, lr, **kw)
    tupd = topt.make_optimizer(name, lr, **kw)
    ptol = 1e-2 if dtype == "bfloat16" else TOL
    for step in range(5):
        grads = _trees(10 + step)
        jp, js = jupd(_to_jax(grads, getattr(jnp, dtype)), js, jp)
        tp, ts = tupd(_to_torch(grads, getattr(torch, dtype)), ts, tp)
        assert ts.step == int(js.step) == step + 1
        _close(tp, jp, ptol)
        _close(ts.m, js.m)
        _close(ts.v, js.v)
        if master:
            _close(ts.master, js.master)
            assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
            assert all(t.dtype == torch.float32 for t in tree_leaves(ts.m))


@pytest.mark.parametrize("step", [0, 3])
def test_accel_point_matches_reference(step):
    params = _trees(1)
    jp, tp = _to_jax(params, jnp.float32), _to_torch(params, torch.float32)
    js = jopt.init_optimizer("accel", jp)._replace(
        step=jnp.asarray(step, jnp.int32),
        m=_to_jax(_trees(2), jnp.float32))
    ts = topt.init_optimizer("accel", tp)._replace(
        step=step, m=_to_torch(_trees(2), torch.float32))
    _close(topt.accel_point(ts, tp), jopt.accel_point(js, jp))


def test_polyak_matches_reference():
    etas = [0.5, 0.25, 1.0, 0.125]
    ws = [_trees(20 + i) for i in range(len(etas))]
    js = jopt.polyak_init(_to_jax(ws[0], jnp.float32))
    ts = topt.polyak_init(_to_torch(ws[0], torch.float32))
    for eta, w in zip(etas, ws):
        js = jopt.polyak_update(js, _to_jax(w, jnp.float32), jnp.asarray(eta))
        ts = topt.polyak_update(ts, _to_torch(w, torch.float32), eta)
    np.testing.assert_allclose(ts.eta_sum, float(js.eta_sum), rtol=TOL)
    _close(ts.avg, js.avg)


@pytest.mark.parametrize("name,lr", [("sgd", 0.1), ("adam", 0.2),
                                     ("accel", 0.05)])
def test_optimizers_minimize_quadratic(name, lr):
    """tests/test_optim.py's contract on the port (gradient at u_t for
    accel)."""
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor([1.0])}
    state = topt.init_optimizer(name, params)
    update = topt.make_optimizer(name, lr)
    for _ in range(200):
        at = topt.accel_point(state, params) if name == "accel" else params
        grads = tree_map(lambda p: 2.0 * p.float(), at)
        params, state = update(grads, state, params)
    assert sum(float((p ** 2).sum()) for p in tree_leaves(params)) < 1e-2


def test_bf16_updates_need_masters():
    """Tiny updates move the f32 masters; without them they vanish in
    bf16 (tests/test_optim.py's contract)."""
    update = topt.make_optimizer("adam", 1e-4)
    p = {"w": torch.ones(2, dtype=torch.bfloat16)}
    s = topt.init_optimizer("adam", p, master_weights=True)
    g = {"w": torch.full((2,), 1e-3, dtype=torch.bfloat16)}
    for _ in range(10):
        p, s = update(g, s, p)
    assert p["w"].dtype == torch.bfloat16 and float(s.master["w"][0]) != 1.0
    p2 = {"w": torch.ones(2, dtype=torch.bfloat16)}
    s2 = topt.init_optimizer("adam", p2)
    for _ in range(10):
        p2, s2 = update(g, s2, p2)
    assert float(p2["w"][0]) == 1.0


def test_update_writes_in_place_and_leaves_gradients():
    """The update writes into the tensors it was given (the reference's new
    trees would not fit beside the old at 8B-class widths) and never into
    the gradients."""
    p = {"w": torch.ones(3)}
    s = topt.init_optimizer("adam", p)
    g = {"w": torch.full((3,), 0.5)}
    w, m = p["w"], s.m["w"]
    p2, s2 = topt.make_optimizer("adam", 0.1)(g, s, p)
    assert p2["w"] is w and s2.m["w"] is m and s2.step == 1
    assert torch.equal(g["w"], torch.full((3,), 0.5))
    assert not torch.equal(w, torch.ones(3))
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("lion", 0.1)
