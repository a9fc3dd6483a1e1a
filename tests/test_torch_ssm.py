"""The port's Mamba-2 SSD block and the mamba2-2.7b family against the JAX
package, in f32 on the CPU, on identical numpy-seeded inputs and the
reference's weights (`convert.lm_params`):

* `ssd_chunked` (the intra-chunk dual form, chunk-final states and the
  inter-chunk recurrence), from zero and from a given state, within
  rtol = atol = 1e-4;
* `apply_ssd`: a prefill without a state, a prefill into a state at a
  padded length (S not a multiple of the chunk), then decode steps from
  that state (the O(1) update), outputs and states within 1e-4;
* reduced mamba2-2.7b (2 layers): `forward` logits and `loss_fn` within
  1e-4, prefill then decode steps (a scalar index, then per-slot
  indices) within 1e-4, the port's decode against its own teacher-forced
  forward (1e-4), greedy `generate` and the continuous-batching engine
  token for token against the reference's engine (as
  tests/test_serve.py::test_continuous_mamba_family_rides_same_plumbing
  does), and the `convert` round trip. No attention layer: no flash
  launch.
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
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.models import registry, ssm
from repro_torch.serve import engine

torch.set_num_threads(1)

# the reference's functions jitted (cfg static): one compile per shape in
# place of an op-by-op dispatch, several times faster on the CPU
_jit = lambda fn: jax.jit(fn, static_argnums=1)
jforward, jloss_fn = _jit(jreg.forward), _jit(jreg.loss_fn)
jprefill, jdecode_step = _jit(jreg.prefill), _jit(jreg.decode_step)
japply = _jit(jssm.apply_ssd)

# f32, the other arch files' bound: the chunked form sums up to S * N
# products of unit-scale inputs into outputs of ~10 in another order than
# XLA's (measured: ~2e-5 absolute at worst)
TOL = MODEL_TOL = 1e-4


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _cfgs(layers=2):
    jcfg = jreduced(jget_config("mamba2-2.7b"), layers=layers)
    tcfg = reduced(get_config("mamba2-2.7b"), layers=layers)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _pair(rng, shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("S,chunk,with_state", [(64, 16, False),
                                                (128, 32, True),
                                                (48, 48, False)])
def test_ssd_chunked_matches_jax(S, chunk, with_state):
    rng = np.random.default_rng(S + chunk)
    b, H, P, G, N = 2, 4, 8, 2, 16
    jx, tx = _pair(rng, (b, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = np.linspace(1.0, 4.0, H).astype(np.float32)
    jB, tB = _pair(rng, (b, S, G, N))
    jC, tC = _pair(rng, (b, S, G, N))
    jh0 = th0 = None
    if with_state:
        jh0, th0 = _pair(rng, (b, H, P, N))
    jy, jh = jssm.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                              chunk, init_state=jh0)
    ty, th = ssm.ssd_chunked(tx, torch.from_numpy(dt), torch.from_numpy(A),
                             tB, tC, chunk, init_state=th0)
    assert ty.shape == (b, S, H, P) and th.shape == (b, H, P, N)
    _close(ty, jy, TOL)
    _close(th, jh, TOL)


def _block_params(jcfg, seed):
    jp = jssm.init_ssd(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    # move the zero-initialised bias off zero so that it is exercised
    jp["conv_b"] = jnp.full_like(jp["conv_b"], 0.05)
    return jp, convert.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)),
        jax.tree.map(np.asarray, jp))


def test_apply_ssd_prefill_padded_and_decode_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg, 3)
    rng = np.random.default_rng(0)
    # no state: S = 128, two chunks of 64
    jx, tx = _pair(rng, (2, 128, tcfg.d_model))
    jout, jst = japply(jp, jcfg, jx)
    tout, tst = ssm.apply_ssd(tp, tcfg, tx)
    assert jst is None and tst is None
    _close(tout, jout, TOL)
    # into a state at S = 100 (padded to 128), then 3 decode steps
    jstate = jssm.init_ssd_state(jcfg, 2)
    tstate = ssm.init_ssd_state(tcfg, 2, device="cpu")
    jx, tx = _pair(rng, (2, 100, tcfg.d_model))
    jout, jstate = japply(jp, jcfg, jx, state=jstate)
    tout, tstate = ssm.apply_ssd(tp, tcfg, tx, state=tstate)
    _close(tout, jout, TOL)
    for k in ("h", "conv"):
        _close(tstate[k], jstate[k], TOL)
    for _ in range(3):
        jx, tx = _pair(rng, (2, 1, tcfg.d_model))
        jout, jstate = japply(jp, jcfg, jx, state=jstate)
        tout, tstate = ssm.apply_ssd(tp, tcfg, tx, state=tstate)
        _close(tout, jout, TOL)
        for k in ("h", "conv"):
            _close(tstate[k], jstate[k], TOL)
    assert tstate["h"].dtype == torch.float32


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


@pytest.mark.parametrize("S", [24, 100])
def test_mamba_forward_and_loss_match_jax(S):
    jcfg, tcfg, jp, tp = _model()
    toks, labels = _tokens(tcfg, 2, S, S), _tokens(tcfg, 2, S, S + 1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    ops.reset_launches()
    jl, _, _ = jforward(jp, jcfg, jb)
    tl, taux, _ = registry.forward(tp, tcfg, tb)
    assert tl.shape == (2, S, tcfg.vocab_size)
    _close(tl, jl, MODEL_TOL)
    assert float(taux) == 0.0
    (jloss, jm), (tloss, tm) = (jloss_fn(jp, jcfg, jb),
                                registry.loss_fn(tp, tcfg, tb))
    _close(tloss, jloss, MODEL_TOL)
    _close(tm["ce"], jm["ce"], MODEL_TOL)
    assert ops.launches["flash_attention"] == 0


def test_mamba_prefill_then_decode_match_jax():
    """Prefill 40 tokens (a padded chunk), a decode at a scalar index, then
    one at per-slot indices; logits and every layer's state as the
    reference's."""
    jcfg, tcfg, jp, tp = _model()
    toks = _tokens(tcfg, 2, 40, 1)
    jc = jreg.init_cache(jcfg, 2, 48, jnp.float32)
    tc = registry.init_cache(tcfg, 2, 48, torch.float32, device="cpu")
    jl, jc = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = registry.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                              tc)
    _close(tl, jl, MODEL_TOL)
    nxt = np.array([[3], [77]])
    for idx in (40, np.array([41, 41])):
        jl, jc = jdecode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                  jnp.asarray(idx, jnp.int32))
        tl, tc = registry.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                      torch.as_tensor(idx) if
                                      isinstance(idx, np.ndarray) else idx)
        _close(tl, jl, MODEL_TOL)
    assert len(tc) == tcfg.num_layers and not jc["tail"]
    for i, layer in enumerate(tc):
        for k in ("h", "conv"):
            _close(layer[k], jc["layers"][0][k][i], MODEL_TOL)


def test_mamba_decode_matches_own_prefill():
    """Incremental decoding reproduces the port's teacher-forced logits
    (tests/test_models_smoke.py::test_decode_matches_prefill)."""
    _, tcfg, _, tp = _model()
    toks = torch.from_numpy(_tokens(tcfg, 1, 16, 2))
    full, _, _ = registry.forward(tp, tcfg, {"tokens": toks})
    cache = registry.init_cache(tcfg, 1, 16, torch.float32, device="cpu")
    logits, cache = registry.prefill(tp, tcfg, {"tokens": toks[:, :8]}, cache)
    _close(logits, full[:, :8].numpy(), MODEL_TOL)
    steps = []
    for i in range(8, 16):
        lg, cache = registry.decode_step(tp, tcfg, toks[:, i:i + 1], cache, i)
        steps.append(lg)
    _close(torch.cat(steps, 1), full[:, 8:].numpy(), MODEL_TOL)


def test_continuous_mamba_family_rides_same_plumbing():
    """Three requests through 2 slots: each request's tokens equal the
    port's `generate` of its prompt and the reference engine's."""
    jcfg, tcfg, jp, tp = _model()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, 10) for _ in range(3)]
    eng = engine.ContinuousBatchingEngine(tcfg, tp, slots=2, max_len=48)
    jeng = jengine.ContinuousBatchingEngine(jcfg, jp, slots=2, max_len=48)
    rids = [eng.submit(p, 12) for p in prompts]
    jrids = [jeng.submit(p, 12) for p in prompts]
    eng.drain()
    jeng.drain()
    for rid, jrid, p in zip(rids, jrids, prompts):
        ref = engine.generate(tp, tcfg, {"tokens": torch.from_numpy(p[None])},
                              48, 12, dtype=torch.float32)
        assert ref[0].tolist() == eng.result(rid).tokens
        assert eng.result(rid).tokens == jeng.result(jrid).tokens
    assert len(set(map(tuple, (eng.result(r).tokens for r in rids)))) > 1


def test_convert_round_trip_keeps_f32_leaves():
    """The reference's tree carried across and back is the same numbers;
    in a bf16 model A_log, D and dt_bias stay f32 in both packages."""
    jcfg, tcfg, jp, tp = _model()
    back = convert.lm_tree(tp, tcfg)
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_array_equal(a, b)
    jb = jreg.init_params(jax.random.PRNGKey(1), jcfg, jnp.bfloat16)
    tb = convert.lm_params(jax.tree.map(np.asarray, jb), device="cpu")
    np.testing.assert_array_equal(tb["embed"].float().numpy(),
                                  np.asarray(jb["embed"], np.float32))
    own = registry.init_params(torch.Generator().manual_seed(0), tcfg,
                               torch.bfloat16)
    for blocks in (tb["blocks"], own["blocks"]):
        for blk in blocks:
            for k in ("A_log", "D", "dt_bias"):
                assert blk["attn"][k].dtype == torch.float32
            assert blk["attn"]["w_in"].dtype == torch.bfloat16
            assert set(blk) == {"norm1", "attn"}  # the SSD is the whole layer
