"""The port's LM layers and assembly against the JAX package, in f32 on the
CPU, on reduced granite-8b with the reference's weights carried across by
`convert.lm_params`: norms, RoPE, both `blockwise_attention` branches, the
cached attention block, `forward`, prefill and decode, within rtol = atol =
1e-4 (2e-4 for the attention kernels' model-path bound)."""
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
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import registry

RTOL = ATOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _pair(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _cfgs(**changes):
    """The reduced granite-8b config of both packages, with `changes`."""
    jcfg = dataclasses.replace(jreduced(jget_config("granite-8b")), **changes)
    tcfg = dataclasses.replace(reduced(get_config("granite-8b")), **changes)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jreg.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, tcfg, jp, convert.lm_params(jax.tree.map(np.asarray, jp),
                                             device="cpu")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

PORTED = ["granite-8b", "phi4-mini-3.8b", "starcoder2-15b", "chameleon-34b",
          "minicpm3-4b", "qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
          "mamba2-2.7b", "recurrentgemma-9b", "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", PORTED)
def test_arch_registry_mirrors_reference(arch):
    """Every arch resolves to the reference's config, field for field, and
    with it the reference's parameter count; an unknown id is refused."""
    from repro.configs import ARCH_IDS as JARCH
    assert ARCH_IDS == JARCH and sorted(PORTED) == sorted(ARCH_IDS)
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(jget_config(arch)))
    assert get_config(arch).param_count() == jget_config(arch).param_count()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


def test_unported_blocks_raise():
    """Every block family is ported now: the SSD, RG-LRU and
    encoder-decoder archs build through the registry (their numbers are
    held against the reference by tests/test_torch_ssm.py,
    test_torch_rglru.py and test_torch_encdec.py) and train
    (tests/test_torch_family_trainer.py). What still raises is the
    launcher on the encoder-decoder: its token stream carries no frames,
    as the reference's launcher's does not."""
    from repro_torch.launch import train as launch_train
    gen = torch.Generator().manual_seed(0)
    for arch, key in (("mamba2-2.7b", "blocks"),
                      ("recurrentgemma-9b", "blocks"),
                      ("seamless-m4t-medium", "encoder")):
        p = registry.init_params(gen, reduced(get_config(arch)))
        assert key in p
    with pytest.raises(ValueError, match="no frames"):
        launch_train.main(["--arch", "seamless-m4t-medium", "--reduced",
                           "--device", "cpu"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(kind):
    jx, tx = _pair((2, 5, 64), 0, 3.0)
    js, ts = _pair((64,), 1)
    jb, tb = _pair((64,), 2)
    jp, tp = {"scale": js, "bias": jb}, {"scale": ts, "bias": tb}
    _close(TL.apply_norm(tp, tx, kind), JL.apply_norm(jp, jx, kind))
    _close(TL.rms_norm_headdim(tx), JL.rms_norm_headdim(jx))


def test_apply_rope_matches_jax():
    jx, tx = _pair((2, 24, 4, 64), 3)
    pos = np.arange(24)[None] + np.array([[0], [90]])
    _close(TL.apply_rope(tx, torch.from_numpy(pos), 1e7),
           JL.apply_rope(jx, jnp.asarray(pos), 1e7))
    _close(TL.rope_frequencies(64, 1e7), JL.rope_frequencies(64, 1e7))


BLOCKWISE = [
    # (Sq, Sk, causal, window, chunk, q_offset, kv_valid, kv_block)
    (1, 40, True, 0, 0, 17, 18, 512),                 # decode, scalars
    (1, 40, True, 0, 0, [5, 30], [6, 31], 512),       # decode, per row
    (4, 40, True, 8, 0, [10, 33], [14, 37], 512),     # window, per row
    (8, 40, True, 0, 16, 12, 20, 512),                # chunk, scalar
    (16, 16, True, 0, 0, 0, None, 512),               # short prompt
    (48, 48, True, 0, 0, 0, None, 16),                # scan
    (40, 100, True, 24, 0, 30, 70, 32),               # scan, window
    (40, 100, True, 0, 32, [0, 50], [40, 90], 32),    # scan, chunk, per row
    (20, 20, False, 0, 0, 0, None, 8),                # scan, unmasked
]


@pytest.mark.parametrize("Sq,Sk,causal,window,chunk,qoff,kvv,kvb", BLOCKWISE)
def test_blockwise_attention_matches_jax(Sq, Sk, causal, window, chunk, qoff,
                                         kvv, kvb):
    """Both branches (Sq <= 16: one masked dot; Sq > 16: the kv-block scan)
    with scalar and per-row offsets, windows and chunks; GQA 4:2."""
    jq, tq = _pair((2, Sq, 4, 32), 4)
    jk, tk = _pair((2, Sk, 2, 32), 5)
    jv, tv = _pair((2, Sk, 2, 32), 6)
    kw = dict(causal=causal, window=window, chunk=chunk, kv_block=kvb)
    j_extra = dict(q_offset=jnp.asarray(qoff),
                   kv_valid=None if kvv is None else jnp.asarray(kvv))
    t_extra = dict(q_offset=torch.tensor(qoff),
                   kv_valid=None if kvv is None else torch.tensor(kvv))
    _close(TL.blockwise_attention(tq, tk, tv, **kw, **t_extra),
           JL.blockwise_attention(jq, jk, jv, **kw, **j_extra))


@pytest.mark.parametrize("S,index", [(1, 9), (1, [3, 12]), (20, 0), (5, 0),
                                     (6, 7)])
def test_apply_attention_with_cache_matches_jax(model, S, index):
    """The cached attention block: scalar and per-slot write offsets, and a
    prefill (cache_index 0) long enough to take `ops.attention`. The cache
    comes back updated in place, equal to the reference's new cache."""
    jcfg, tcfg, jp, tp = model
    jx, tx = _pair((2, S, tcfg.d_model), 7)
    jck, tck = _pair((2, 32, tcfg.num_kv_heads, tcfg.resolved_head_dim), 8)
    jcv, tcv = _pair((2, 32, tcfg.num_kv_heads, tcfg.resolved_head_dim), 9)
    vec = isinstance(index, list)
    base = np.asarray(index)[:, None] if vec else index
    pos = np.broadcast_to(np.arange(S)[None] + base, (2, S))
    jout, jcache = JL.apply_attention(
        jax.tree.map(lambda a: a[0], jp["layers"][0]["attn"]), jcfg, jx,
        jnp.asarray(pos), cache={"k": jck, "v": jcv},
        cache_index=jnp.asarray(index, jnp.int32))
    tcache = {"k": tck.clone(), "v": tcv.clone()}
    tout, tnew = TL.apply_attention(
        tp["blocks"][0]["attn"], tcfg, tx, torch.from_numpy(pos.copy()),
        cache=tcache, cache_index=torch.tensor(index) if vec else index)
    assert tnew is tcache
    _close(tout, jout)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_unembed_pads_vocab_and_masks():
    jx, tx = _pair((1, 3, 16), 10)
    je, te = _pair((40, 16), 11)  # 40 is not a multiple of 16
    got = TL.unembed_logits(te, tx)
    assert got.shape == (1, 3, 48)
    _close(got, JL.unembed_logits(je, jx))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_apply_ffn_matches_jax(kind):
    jp = JL.init_ffn(jax.random.PRNGKey(3), 32, 64, kind, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), jp)
    jx, tx = _pair((2, 5, 32), 12)
    cfg = _cfgs(ffn=kind, d_model=32, d_ff=64)[1]
    _close(TL.apply_ffn(tp, tx, cfg), JL.apply_ffn(jp, jx, kind))


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

CHUNKED = dict(num_layers=5, chunk_attn_window=16, global_attn_every=2)


@pytest.mark.parametrize("changes,window_override", [
    ({}, 0), ({}, 12), (CHUNKED, 0)],
    ids=["causal", "window_override", "chunked_irope"])
def test_forward_logits_match_jax(changes, window_override):
    """Logits of a 24-token batch (the attention takes `ops.attention`) on
    granite's causal layers, a sliding-window override, and a chunked-local
    period of 2 with NoPE global layers and a tail layer."""
    jcfg, tcfg = _cfgs(**changes)
    jp = jreg.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32,
                          window_override=window_override)
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 24))
    jl, _, _ = jreg.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                            window_override=window_override)
    ops.reset_launches()
    tl, aux, _ = registry.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                                  window_override=window_override)
    assert float(aux) == 0.0
    assert tl.shape == (2, 24, tcfg.vocab_size)
    _close(tl, jl)


@pytest.mark.parametrize("prompt_len", [12, 24])
def test_prefill_then_decode_matches_jax(model, prompt_len):
    """Prefill (masked dot at 12 tokens, `ops.attention` at 24), then two
    decode steps, one at a scalar index and one at a per-slot vector."""
    jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(1).integers(0, 512, (2, prompt_len))
    jc = jreg.init_cache(jcfg, 2, 40, jnp.float32)
    tc = registry.init_cache(tcfg, 2, 40, torch.float32, device="cpu")
    jl, jc = jreg.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = registry.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                              tc)
    _close(tl, jl)
    nxt = np.array([[3], [77]])
    jl, jc = jreg.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                              jnp.asarray(prompt_len, jnp.int32))
    tl, tc = registry.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                  prompt_len)
    _close(tl, jl)
    idx = np.array([prompt_len + 1, prompt_len + 1])
    jl, jc = jreg.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                              jnp.asarray(idx, jnp.int32))
    tl, tc = registry.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                  torch.from_numpy(idx))
    _close(tl, jl)
    for lj, lt in zip(jc["layers"][0]["k"], tc):
        _close(lt["k"], lj)


# ---------------------------------------------------------------------------
# convert.lm_params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("changes", [{}, CHUNKED], ids=["granite", "chunked"])
def test_lm_params_round_trip(changes):
    """The reference's tree goes to the port and back unchanged, leaf for
    leaf, for the stacked "layers" (interleaved by period position) and the
    "tail"; the port's own init gives the same structure and shapes."""
    jcfg, tcfg = _cfgs(**changes)
    tree = jax.tree.map(np.asarray, jreg.init_params(jax.random.PRNGKey(2),
                                                     jcfg, jnp.float32))
    tp = convert.lm_params(tree, device="cpu")
    assert len(tp["blocks"]) == tcfg.num_layers
    back = convert.lm_tree(tp, tcfg)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    own = convert.lm_tree(registry.init_params(
        torch.Generator().manual_seed(0), tcfg), tcfg)
    assert (jax.tree.map(np.shape, own) == jax.tree.map(np.shape, tree))


def test_init_params_follow_generator(model):
    """Parameters come from the explicit generator: same seed, same numbers;
    the dense init has the reference's scale (std 1/sqrt(fan_in))."""
    _, tcfg, _, _ = model
    a = registry.init_params(torch.Generator().manual_seed(5), tcfg)
    b = registry.init_params(torch.Generator().manual_seed(5), tcfg)
    assert torch.equal(a["blocks"][1]["ffn"]["w_down"],
                       b["blocks"][1]["ffn"]["w_down"])
    w = a["blocks"][0]["ffn"]["w_up"]
    assert abs(w.std().item() * tcfg.d_model ** 0.5 - 1.0) < 0.05
