"""The six attention-based archs of this slice (phi4-mini-3.8b,
starcoder2-15b, chameleon-34b, minicpm3-4b, qwen2-moe-a2.7b,
llama4-scout-17b-a16e) against the JAX package, in f32 on the CPU at
`reduced(...)` sizes with the reference's weights (`convert.lm_params`),
inputs drawn from numpy seeds, within rtol = atol = 1e-4 and token ids
equal: forward logits and `loss_fn` (ce and aux; llama4 with `patches`),
with sliding windows and chunks that bind; prefill and two decode steps
(a scalar index, then a per-slot vector); `engine.generate` and
`ContinuousBatchingEngine` token for token against the JAX engine; and the
`convert` round trip. llama4 runs 4 layers, its iRoPE period, so that the
NoPE global layer is reached.

Then the ring-buffer KV cache of a sliding-window layer (reduced
starcoder2-15b, W = 128): prefill 100 and 150 tokens and decode 10 against
the reference's ring and against the port's full cache, and continuous
batching with per-slot indices that wrap the ring against the JAX engine."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import registry as jreg
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.serve import engine

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
ARCHS = ["phi4-mini-3.8b", "starcoder2-15b", "chameleon-34b", "minicpm3-4b",
         "qwen2-moe-a2.7b", "llama4-scout-17b-a16e"]
LAYERS = {"llama4-scout-17b-a16e": 4}  # one iRoPE period: 3 chunked + NoPE


def _close(got, want, tol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _cfgs(arch, **changes):
    layers = LAYERS.get(arch, 2)
    jcfg = dataclasses.replace(jreduced(jget_config(arch), layers=layers),
                               **changes)
    tcfg = dataclasses.replace(reduced(get_config(arch), layers=layers),
                               **changes)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


_MODELS = {}


def _model(arch):
    """(jcfg, tcfg, reference params, the port's copy), once per arch."""
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        jp = jreg.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        _MODELS[arch] = (jcfg, tcfg, jp, convert.lm_params(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[arch]


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
         "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.frontend_embed_dim:
        b["patches"] = rng.standard_normal(
            (B, 6, cfg.frontend_embed_dim)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


# S = 24: the prefill takes `ops.attention`; S = 160 binds starcoder2's
# window and llama4's chunk (both 128 when reduced)
FORWARD = [(a, 24) for a in ARCHS] + [("starcoder2-15b", 160),
                                      ("llama4-scout-17b-a16e", 160)]


@pytest.mark.parametrize("arch,S", FORWARD)
def test_forward_and_loss_match_jax(arch, S):
    jcfg, tcfg, jp, tp = _model(arch)
    jb, tb = _batch(tcfg, 2, S, seed=S)
    jl, jaux, _ = jreg.forward(jp, jcfg, jb)
    tl, taux, _ = registry.forward(tp, tcfg, tb)
    assert tl.shape == (2, S, tcfg.vocab_size)
    _close(tl, jl)
    _close(taux, jaux)
    assert (float(taux) > 0) == (tcfg.moe is not None)
    (jloss, jm), (tloss, tm) = (jreg.loss_fn(jp, jcfg, jb),
                                registry.loss_fn(tp, tcfg, tb))
    for k in ("ce", "aux"):
        _close(tm[k], jm[k])
    _close(tloss, jloss)
    if tcfg.frontend_embed_dim:
        # the patches reach the logits
        plain = {k: v for k, v in tb.items() if k != "patches"}
        other, _, _ = registry.forward(tp, tcfg, plain)
        assert (other[:, :6] - tl[:, :6]).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax(arch):
    """Prefill 24 tokens, then a decode at a scalar index and one at a
    per-slot vector; the logits and the caches equal the reference's."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 24))
    jc = jreg.init_cache(jcfg, 2, 40, jnp.float32)
    tc = registry.init_cache(tcfg, 2, 40, torch.float32, device="cpu")
    ops.reset_launches()
    jl, jc = jreg.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = registry.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                              tc)
    _close(tl, jl)
    nxt = np.array([[3], [77]])
    jl, jc = jreg.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                              jnp.asarray(24, jnp.int32))
    tl, tc = registry.decode_step(tp, tcfg, torch.from_numpy(nxt), tc, 24)
    _close(tl, jl)
    idx = np.array([25, 25])
    jl, jc = jreg.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                              jnp.asarray(idx, jnp.int32))
    tl, tc = registry.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                  torch.from_numpy(idx))
    _close(tl, jl)
    # the port's layer i is the reference's period position i % P, repeat
    # i // P (no arch here has a tail)
    P = len(jc["layers"])
    assert not jc["tail"]
    for i, layer in enumerate(tc):
        r, j = divmod(i, P)
        for name in layer:
            _close(layer[name], jc["layers"][j][name][r])


def _prompts(cfg, n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=length) for _ in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_and_engine_equal_jax(arch):
    """`generate` (2 prompts of 24 tokens, 6 steps) and the continuous
    engine (3 requests of 20 tokens through 2 slots, 5 new tokens each)
    give the JAX engine's token ids; at decode the slot pool is one MoE
    group, so the requests compete for expert capacity as in the
    reference."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = np.stack(_prompts(tcfg, 2, 24, seed=3))
    want = jengine.generate(jp, jcfg, {"tokens": jnp.asarray(toks)}, 32, 6,
                            dtype=jnp.float32)
    got = engine.generate(tp, tcfg, {"tokens": torch.from_numpy(toks)}, 32,
                          6, dtype=torch.float32)
    assert got.tolist() == np.asarray(want).tolist()
    prompts = _prompts(tcfg, 3, 20, seed=4)
    jeng = jengine.ContinuousBatchingEngine(jcfg, jp, slots=2, max_len=28)
    eng = engine.ContinuousBatchingEngine(tcfg, tp, slots=2, max_len=28)
    jrids = [jeng.submit(p, 5) for p in prompts]
    rids = [eng.submit(p, 5) for p in prompts]
    jeng.drain()
    eng.drain()
    assert eng.decode_steps == jeng.decode_steps
    for jrid, rid in zip(jrids, rids):
        assert eng.result(rid).tokens == jeng.result(jrid).tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_round_trip(arch):
    """The reference's tree goes to the port and back leaf for leaf (the
    MoE, MLA and frontend leaves included, each in its dtype); the port's
    own init gives the same structure, shapes and dtypes."""
    jcfg, tcfg, jp, tp = _model(arch)
    tree = jax.tree.map(np.asarray, jp)
    back = convert.lm_tree(tp, tcfg)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    own = registry.init_params(torch.Generator().manual_seed(0), tcfg)
    assert (jax.tree.map(np.shape, convert.lm_tree(own, tcfg))
            == jax.tree.map(np.shape, tree))
    assert ("frontend_proj" in own) == bool(tcfg.frontend_embed_dim)
    bf16 = registry.init_params(torch.Generator().manual_seed(0), tcfg,
                                torch.bfloat16)
    if tcfg.moe is not None:
        assert bf16["blocks"][0]["ffn"]["router"].dtype == torch.float32
        assert bf16["blocks"][0]["ffn"]["we_up"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the ring-buffer KV cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ring():
    jcfg, tcfg = _cfgs("starcoder2-15b", ring_buffer_cache=True)
    assert tcfg.sliding_window == 128
    _, _, jp, tp = _model("starcoder2-15b")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("prefill_len", [100, 150])
def test_ring_cache_matches_reference_and_full_cache(ring, prefill_len):
    """tests/test_ring_cache.py's run in both packages: the ring holds
    min(total, W) slots; prefill, then 10 decode steps (a scalar index),
    logits equal to the reference's ring and to the port's full cache."""
    jcfg, tcfg, jp, tp = ring
    total = prefill_len + 10
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (1, total))
    jc = jreg.init_cache(jcfg, 1, total, jnp.float32)
    tc = registry.init_cache(tcfg, 1, total, torch.float32, device="cpu")
    full_cfg = dataclasses.replace(tcfg, ring_buffer_cache=False)
    fc = registry.init_cache(full_cfg, 1, total, torch.float32, device="cpu")
    assert tc[0]["k"].shape[1] == min(128, total)
    assert fc[0]["k"].shape[1] == total
    head = {"tokens": toks[:, :prefill_len]}
    jl, jc = jreg.prefill(jp, jcfg, {"tokens": jnp.asarray(head["tokens"])},
                          jc)
    tl, tc = registry.prefill(tp, tcfg, {"tokens": torch.from_numpy(
        head["tokens"])}, tc)
    fl, fc = registry.prefill(tp, full_cfg, {"tokens": torch.from_numpy(
        head["tokens"])}, fc)
    _close(tl, jl)
    _close(tl, fl.numpy())
    _close(tc[0]["k"], jc["layers"][0]["k"][0])
    for i in range(prefill_len, total):
        t = toks[:, i:i + 1]
        jl, jc = jreg.decode_step(jp, jcfg, jnp.asarray(t), jc,
                                  jnp.asarray(i, jnp.int32))
        tl, tc = registry.decode_step(tp, tcfg, torch.from_numpy(t), tc, i)
        fl, fc = registry.decode_step(tp, full_cfg, torch.from_numpy(t), fc,
                                      i)
        _close(tl, jl)
        _close(tl, fl.numpy())
    _close(tc[1]["v"], jc["layers"][0]["v"][1])


def test_ring_cache_continuous_batching_equals_jax(ring):
    """Per-slot indices on the ring: prompts of 120, 60 and 135 tokens (the
    last one wraps at prefill) with 14 new tokens each through 2 slots of
    max_len 160, so the decode wraps the ring; token ids equal the JAX
    engine's and the port's full-cache engine's."""
    jcfg, tcfg, jp, tp = ring
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n) for n in (120, 60,
                                                                  135)]
    jeng = jengine.ContinuousBatchingEngine(jcfg, jp, slots=2, max_len=160)
    eng = engine.ContinuousBatchingEngine(tcfg, tp, slots=2, max_len=160)
    full = engine.ContinuousBatchingEngine(
        dataclasses.replace(tcfg, ring_buffer_cache=False), tp, slots=2,
        max_len=160)
    assert eng.cache[0]["k"].shape[1] == 128
    out = []
    for e in (jeng, eng, full):
        rids = [e.submit(p, 14) for p in prompts]
        e.drain()
        out.append([e.result(r).tokens for r in rids])
    assert out[1] == out[0] and out[2] == out[0]


def test_ring_cache_init_serve_and_insert(ring):
    """`init_serve` on a ring cache, and the engine's slot insert copies a
    prefilled ring row (its W slots) into the pool, leaving the other rows
    as they were."""
    _, tcfg, _, _ = ring
    st = engine.init_serve(tcfg, 2, 300, torch.float32, device="cpu")
    assert st.last_tokens.shape == (2, 1) and st.cache[0]["k"].shape[1] == 128
    one = registry.init_cache(tcfg, 1, 300, torch.float32, device="cpu")
    for c in one:
        for t in c.values():
            t.normal_(generator=torch.Generator().manual_seed(2))
    engine._insert_fn(st.cache, one, 1)
    for dst, src in zip(st.cache, one):
        for name in ("k", "v"):
            assert torch.equal(dst[name][1], src[name][0])
            assert not dst[name][0].any()
