"""The port's encoder-decoder (seamless-m4t-medium) against the JAX package,
in f32 on the CPU at `reduced(...)` size (2 encoder and 2 decoder layers),
with the reference's weights (`convert.lm_params`) and numpy-seeded
frames and tokens, within rtol = atol = 1e-4 and token ids equal:

* `encode` at 40 frames and at 200 (a key count the reference's Pallas
  kernel refuses unmasked); both take `ops.attention`'s route, its plain
  version on the CPU;
* `_dec_block` with its cross-attention into the memory;
* `forward` logits and `loss_fn`; prefill, then two decode steps
  (logits, every layer's self k/v and the memory); the port's decode
  against its own teacher-forced forward; greedy `generate` against the
  reference's; the `convert` round trip;
* `registry.synth_batch` gives frames, `init_cache` an `ENC_LEN` memory,
  and `launch/serve.py --arch seamless-m4t-medium` serves the static
  batch; the continuous engine refuses the family, as the reference's
  does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import encdec as jencdec
from repro.models import registry as jreg
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import encdec, registry
from repro_torch.serve import engine

torch.set_num_threads(1)

TOL = 1e-4  # f32, a whole model (the other arch files' bound)

_jit = lambda fn: jax.jit(fn, static_argnums=1)
jforward, jloss_fn = _jit(jreg.forward), _jit(jreg.loss_fn)
jprefill, jdecode_step = _jit(jreg.prefill), _jit(jreg.decode_step)
jencode = _jit(jencdec.encode)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


_MODEL = {}


def _model():
    if not _MODEL:
        jcfg = jreduced(jget_config("seamless-m4t-medium"))
        tcfg = reduced(get_config("seamless-m4t-medium"))
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert tcfg.is_encdec and tcfg.encoder_layers == tcfg.num_layers == 2
        jp = jreg.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        _MODEL["m"] = (jcfg, tcfg, jp, convert.lm_params(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODEL["m"]


def _batch(cfg, B, Se, Sd, seed):
    rng = np.random.default_rng(seed)
    b = {"frames": rng.standard_normal(
             (B, Se, cfg.frontend_embed_dim)).astype(np.float32),
         "tokens": rng.integers(0, cfg.vocab_size, (B, Sd)),
         "labels": rng.integers(0, cfg.vocab_size, (B, Sd))}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("Se", [40, 200])
def test_encode_matches_jax(Se):
    jcfg, tcfg, jp, tp = _model()
    jb, tb = _batch(tcfg, 2, Se, 4, Se)
    ops.reset_launches()
    want = jencode(jp, jcfg, jb["frames"])
    got = encdec.encode(tp, tcfg, tb["frames"])
    assert got.shape == (2, Se, tcfg.d_model)
    _close(got, want)
    assert ops.launches["flash_attention"] == 0  # the CPU's plain path


def test_dec_block_with_cross_kv_matches_jax():
    jcfg, tcfg, jp, tp = _model()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24)[None], (2, 24))
    jblk = jax.tree.map(lambda a: a[1], jp["decoder"])
    want, _ = jax.jit(jencdec._dec_block, static_argnums=(0, 5, 6, 7))(
        jcfg, jblk, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(mem), None,
        None, 0)
    got = encdec._dec_block(tcfg, tp["decoder"][1], torch.from_numpy(x),
                            torch.from_numpy(np.array(pos)),
                            torch.from_numpy(mem), None, None, 0)
    _close(got, want)


def test_forward_and_loss_match_jax():
    jcfg, tcfg, jp, tp = _model()
    jb, tb = _batch(tcfg, 2, 40, 24, 1)
    jl, _, _ = jforward(jp, jcfg, jb)
    tl, taux, _ = registry.forward(tp, tcfg, tb)
    assert tl.shape == (2, 24, tcfg.vocab_size) and float(taux) == 0.0
    _close(tl, jl)
    (jloss, jm), (tloss, tm) = (jloss_fn(jp, jcfg, jb),
                                registry.loss_fn(tp, tcfg, tb))
    _close(tloss, jloss)
    _close(tm["ce"], jm["ce"])
    # the frames reach the logits
    other = dict(tb, frames=tb["frames"].flip(1))
    assert (registry.forward(tp, tcfg, other)[0] - tl).abs().max() > 1e-3


def test_prefill_then_decode_match_jax():
    jcfg, tcfg, jp, tp = _model()
    jb, tb = _batch(tcfg, 2, 40, 24, 2)
    prompt = lambda b: {k: b[k] for k in ("frames", "tokens")}
    jc = jreg.init_cache(jcfg, 2, 32, jnp.float32)
    tc = registry.init_cache(tcfg, 2, 32, torch.float32, device="cpu")
    assert tc["memory"].shape == (2, registry.ENC_LEN, tcfg.d_model)
    jl, jc = jprefill(jp, jcfg, prompt(jb), jc)
    tl, tc = registry.prefill(tp, tcfg, prompt(tb), tc)
    _close(tl, jl)
    nxt = np.array([[3], [77]])
    for idx in (24, 25):  # the reference's decoder takes a scalar index
        jl, jc = jdecode_step(jp, jcfg, jnp.asarray(nxt), jc,
                              jnp.asarray(idx, jnp.int32))
        tl, tc = registry.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                      idx)
        _close(tl, jl)
    _close(tc["memory"], jc["memory"])
    for i, layer in enumerate(tc["decoder"]):
        for k in ("k", "v"):
            _close(layer[k], jc["decoder"]["self"][k][i])


def test_decode_matches_own_prefill():
    _, tcfg, _, tp = _model()
    _, tb = _batch(tcfg, 1, 40, 24, 3)
    full, _, _ = registry.forward(tp, tcfg, tb)
    cache = registry.init_cache(tcfg, 1, 24, torch.float32, device="cpu")
    logits, cache = registry.prefill(
        tp, tcfg, {"frames": tb["frames"], "tokens": tb["tokens"][:, :18]},
        cache)
    _close(logits, full[:, :18].numpy())
    steps = []
    for i in range(18, 24):
        lg, cache = registry.decode_step(tp, tcfg, tb["tokens"][:, i:i + 1],
                                         cache, i)
        steps.append(lg)
    _close(torch.cat(steps, 1), full[:, 18:].numpy())


def test_generate_matches_jax_and_engine_refuses():
    jcfg, tcfg, jp, tp = _model()
    jb, tb = _batch(tcfg, 2, 40, 20, 4)
    prompt = lambda b: {k: b[k] for k in ("frames", "tokens")}
    want = jengine.generate(jp, jcfg, prompt(jb), 32, 8, dtype=jnp.float32)
    got = engine.generate(tp, tcfg, prompt(tb), 32, 8, dtype=torch.float32)
    assert got.shape == (2, 8)
    assert got.tolist() == np.asarray(want).tolist()
    with pytest.raises(NotImplementedError, match="decoder-only"):
        engine.ContinuousBatchingEngine(tcfg, tp)


def test_convert_round_trip():
    jcfg, tcfg, jp, tp = _model()
    assert len(tp["encoder"]) == len(tp["decoder"]) == 2
    back = convert.lm_tree(tp, tcfg)
    ref = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    own = registry.init_params(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree.structure(convert.lm_tree(own, tcfg)) == \
        jax.tree.structure(ref)


def test_synth_batch_and_launcher_serve_the_family(capsys):
    _, tcfg, _, _ = _model()
    b = registry.synth_batch(torch.Generator().manual_seed(0), tcfg, 2, 24,
                             mode="prefill")
    assert set(b) == {"tokens", "frames"}
    assert b["frames"].shape == (2, 24, tcfg.frontend_embed_dim)
    launch_serve.main(["--arch", "seamless-m4t-medium", "--reduced",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "20", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=seamless-m4t-medium" in out and "sample token ids:" in out
    with pytest.raises(NotImplementedError, match="decoder-only"):
        launch_serve.main(["--arch", "seamless-m4t-medium", "--reduced",
                           "--device", "cpu", "--continuous"])
