"""The port's RG-LRU block and the recurrentgemma-9b family (Griffin hybrid)
against the JAX package, in f32 on the CPU, on identical numpy-seeded
inputs and the reference's weights (`convert.lm_params`):

* `_rglru_scan`, the port's log-depth doubling scan against the
  reference's `lax.associative_scan`, with and without `h0`, S from 1 to
  4096, within rtol = atol = 1e-5 (both reassociate the same f32
  products; the recurrence is a contraction, |a| < 1, so errors do not
  grow with S);
* `apply_rglru`: a prefill without a state, a prefill into a state, then
  decode steps (the O(1) update), outputs and states within 1e-5;
* reduced recurrentgemma-9b at 5 layers (one (rglru, rglru, local
  attention) period and a (rglru, rglru) tail, window 128): `forward`
  logits and `loss_fn` within 1e-4 at S = 24 and at S = 160, where the
  window binds; prefill then decode steps (a scalar index, then per-slot
  indices) within 1e-4; the port's decode against its own teacher-forced
  forward; the continuous-batching engine token for token against the
  reference's engine; the `convert` round trip. One flash launch per
  prefill of more than 16 tokens (the attention layer).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import registry as jreg
from repro.models import rglru as jrglru
from repro.models import transformer as jtransformer
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.models import registry, rglru, transformer
from repro_torch.serve import engine

torch.set_num_threads(1)

# the reference's functions jitted (cfg static): one compile per shape in
# place of an op-by-op dispatch, several times faster on the CPU
_jit = lambda fn: jax.jit(fn, static_argnums=1)
jforward, jloss_fn = _jit(jreg.forward), _jit(jreg.loss_fn)
jprefill, jdecode_step = _jit(jreg.prefill), _jit(jreg.decode_step)
japply = _jit(jrglru.apply_rglru)
jscan = jax.jit(jrglru._rglru_scan)

TOL = 1e-5  # one block in f32
MODEL_TOL = 1e-4  # a whole model in f32 (the other arch files' bound)
LAYERS = 5  # one period (rglru, rglru, attn) and a tail (rglru, rglru)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _cfgs(layers=LAYERS):
    jcfg = jreduced(jget_config("recurrentgemma-9b"), layers=layers)
    tcfg = reduced(get_config("recurrentgemma-9b"), layers=layers)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _pair(rng, shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("S,W", [(1, 64), (7, 64), (64, 64), (513, 32),
                                 (4096, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(S, W, with_h0):
    rng = np.random.default_rng(S + W)
    jx, tx = _pair(rng, (2, S, W))
    sig = lambda a: (1 / (1 + np.exp(-a))).astype(np.float32)
    rg = sig(rng.standard_normal((2, S, W)))
    ig = sig(rng.standard_normal((2, S, W)))
    lam = np.log(np.linspace(0.9, 0.999, W) ** (1 / 8)
                 / (1 - np.linspace(0.9, 0.999, W) ** (1 / 8))
                 ).astype(np.float32)
    jh0 = th0 = None
    if with_h0:
        jh0, th0 = _pair(rng, (2, W))
    jy, jh = jscan(jx, jnp.asarray(rg), jnp.asarray(ig), jnp.asarray(lam),
                   jh0)
    ty, th = rglru._rglru_scan(tx, torch.from_numpy(rg), torch.from_numpy(ig),
                               torch.from_numpy(lam), th0)
    assert ty.shape == (2, S, W) and th.shape == (2, W)
    _close(ty, jy, TOL)
    _close(th, jh, TOL)


def test_apply_rglru_prefill_state_and_decode_match_jax():
    jcfg, tcfg = _cfgs()
    jp = jrglru.init_rglru(jax.random.PRNGKey(4), jcfg, jnp.float32)
    jp["conv_b"] = jnp.full_like(jp["conv_b"], 0.05)  # exercise the bias
    tp = convert.tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                          jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 50, tcfg.d_model))
    jout, _ = japply(jp, jcfg, jx)
    tout, tst = rglru.apply_rglru(tp, tcfg, tx)
    assert tst is None
    _close(tout, jout, TOL)
    jstate = jrglru.init_rglru_state(jcfg, 2)
    tstate = rglru.init_rglru_state(tcfg, 2, device="cpu")
    for S in (30, 1, 1, 5):  # a prefill, two decode steps, a prefill from h
        jx, tx = _pair(rng, (2, S, tcfg.d_model))
        jout, jstate = japply(jp, jcfg, jx, state=jstate)
        tout, tstate = rglru.apply_rglru(tp, tcfg, tx, state=tstate)
        _close(tout, jout, TOL)
        for k in ("h", "conv"):
            _close(tstate[k], jstate[k], TOL)


def test_hybrid_plan_matches_reference():
    """recurrentgemma-9b's plan: (rglru, rglru, window-attn at 2048) x 12
    and a (rglru, rglru) tail, 38 layers; the same specs as the
    reference's."""
    cfg = get_config("recurrentgemma-9b")
    period, n, tail = transformer.build_plan(cfg)
    jperiod, jn, jtail = jtransformer.build_plan(jget_config(
        "recurrentgemma-9b"))
    assert (n, len(tail)) == (jn, len(jtail)) == (12, 2)
    assert [tuple(s) for s in period + tail] == [tuple(s) for s in
                                                  jperiod + jtail]
    specs = transformer.layer_specs(cfg)
    assert len(specs) == 38
    attn = [s for s in specs if s.kind == "attn"]
    assert len(attn) == 12 and {(s.attn_mode, s.window) for s in attn} == {
        ("window", 2048)}
    assert transformer.layer_specs(get_config("mamba2-2.7b")) == [
        transformer.LayerSpec("ssd")] * 64


_MODEL = {}


def _model():
    if not _MODEL:
        jcfg, tcfg = _cfgs()
        jp = jreg.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        _MODEL["m"] = (jcfg, tcfg, jp, convert.lm_params(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODEL["m"]


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@pytest.mark.parametrize("S", [24, 160])
def test_recurrentgemma_forward_and_loss_match_jax(S):
    jcfg, tcfg, jp, tp = _model()
    toks, labels = _tokens(tcfg, 2, S, S), _tokens(tcfg, 2, S, S + 1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jl, _, _ = jforward(jp, jcfg, jb)
    tl, _, _ = registry.forward(tp, tcfg, tb)
    assert tl.shape == (2, S, tcfg.vocab_size)
    _close(tl, jl, MODEL_TOL)
    (jloss, jm), (tloss, tm) = (jloss_fn(jp, jcfg, jb),
                                registry.loss_fn(tp, tcfg, tb))
    _close(tloss, jloss, MODEL_TOL)
    _close(tm["ce"], jm["ce"], MODEL_TOL)


def test_recurrentgemma_prefill_then_decode_match_jax():
    """Prefill 150 tokens (past the 128 window), a decode at a scalar index,
    then one at per-slot indices; logits, the RG-LRU states and the
    attention layer's cache as the reference's."""
    jcfg, tcfg, jp, tp = _model()
    toks = _tokens(tcfg, 2, 150, 1)
    jc = jreg.init_cache(jcfg, 2, 160, jnp.float32)
    tc = registry.init_cache(tcfg, 2, 160, torch.float32, device="cpu")
    ops.reset_launches()
    jl, jc = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = registry.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                              tc)
    _close(tl, jl, MODEL_TOL)
    assert ops.launches["flash_attention"] == 0  # the CPU's plain path
    nxt = np.array([[3], [77]])
    for idx in (150, np.array([151, 151])):
        jl, jc = jdecode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                  jnp.asarray(idx, jnp.int32))
        tl, tc = registry.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                      torch.as_tensor(idx) if
                                      isinstance(idx, np.ndarray) else idx)
        _close(tl, jl, MODEL_TOL)
    # the port's layers: period (0, 1, 2) once, then the tail (3, 4)
    want = [jc["layers"][i] for i in range(3)] + jc["tail"]
    for i, (layer, ref) in enumerate(zip(tc, want, strict=True)):
        if i < 3:
            ref = jax.tree.map(lambda a: a[0], ref)
        assert set(layer) == set(ref)
        for k in layer:
            _close(layer[k], ref[k], MODEL_TOL)


def test_recurrentgemma_decode_matches_own_prefill():
    _, tcfg, _, tp = _model()
    toks = torch.from_numpy(_tokens(tcfg, 1, 24, 2))
    full, _, _ = registry.forward(tp, tcfg, {"tokens": toks})
    cache = registry.init_cache(tcfg, 1, 24, torch.float32, device="cpu")
    logits, cache = registry.prefill(tp, tcfg, {"tokens": toks[:, :18]},
                                     cache)
    _close(logits, full[:, :18].numpy(), MODEL_TOL)
    steps = []
    for i in range(18, 24):
        lg, cache = registry.decode_step(tp, tcfg, toks[:, i:i + 1], cache, i)
        steps.append(lg)
    _close(torch.cat(steps, 1), full[:, 18:].numpy(), MODEL_TOL)


def test_continuous_recurrentgemma_matches_jax_engine():
    jcfg, tcfg, jp, tp = _model()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in (20, 9, 33)]
    eng = engine.ContinuousBatchingEngine(tcfg, tp, slots=2, max_len=48)
    jeng = jengine.ContinuousBatchingEngine(jcfg, jp, slots=2, max_len=48)
    rids = [eng.submit(p, 10) for p in prompts]
    jrids = [jeng.submit(p, 10) for p in prompts]
    eng.drain()
    jeng.drain()
    for rid, jrid in zip(rids, jrids):
        assert eng.result(rid).tokens == jeng.result(jrid).tokens


def test_convert_round_trip_keeps_lam_f32():
    jcfg, tcfg, jp, tp = _model()
    back = convert.lm_tree(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_array_equal(a, b)
    own = registry.init_params(torch.Generator().manual_seed(0), tcfg,
                               torch.bfloat16)
    kinds = [s.kind for s in transformer.layer_specs(tcfg)]
    assert kinds == ["rglru", "rglru", "attn", "rglru", "rglru"]
    for kind, blk in zip(kinds, own["blocks"]):
        if kind == "rglru":
            assert blk["attn"]["lam"].dtype == torch.float32
            assert blk["attn"]["w_rec_gate"].dtype == torch.bfloat16
