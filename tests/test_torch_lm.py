"""The port's LM training pieces against the JAX package, in f32 on the CPU:
`MarkovTokenStream` draws bit for bit, `cross_entropy` with masked labels
(rtol = atol = 1e-6), and `loss_fn` with its gradients on reduced granite-8b
from the reference's parameters carried across by `convert.lm_params`, with
activation checkpointing on and off (loss within rtol 1e-5, every gradient
within rtol = atol = 1e-5 of the largest entry of its leaf). Also: the
loss's attention takes the differentiable `blockwise_attention` route, never
`ops.attention`, and serving still takes `ops.attention`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data.lm import MarkovTokenStream as JMarkovTokenStream
from repro.models import layers as JL
from repro.models import registry as jreg
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.packing import tree_leaves, tree_map
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import registry

B, S = 8, 64  # batches of 8 x 64 tokens


@pytest.mark.parametrize("vocab,branch,seed", [(512, 32, 0), (49152, 32, 3),
                                               (97, 5, 11)])
def test_markov_stream_draws_are_bit_identical(vocab, branch, seed):
    ref = JMarkovTokenStream(vocab, branch=branch, seed=seed)
    port = MarkovTokenStream(vocab, branch=branch, seed=seed)
    np.testing.assert_array_equal(port.unigram, ref.unigram)
    a = ref.sample(np.random.default_rng(seed + 1), B, S + 1)
    b = port.sample(np.random.default_rng(seed + 1), B, S + 1)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    ja, tb = next(ref.batches(4, 16, seed)), next(port.batches(4, 16, seed))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(ja[k], tb[k])


@pytest.mark.parametrize("masked", [0, 7, B * S])
def test_cross_entropy_matches_reference(masked):
    """Mean CE over labels >= 0: `masked` labels set to -1 (all of them
    gives 0, the reference's max(count, 1))."""
    rng = np.random.default_rng(masked)
    logits = (rng.standard_normal((B, S, 512)) * 3).astype(np.float32)
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels.reshape(-1)[rng.permutation(B * S)[:masked]] = -1
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    assert got.dtype == torch.float32


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("granite-8b"))
    tcfg = reduced(get_config("granite-8b"))
    jp = jreg.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    toks = MarkovTokenStream(tcfg.vocab_size, seed=0).sample(
        np.random.default_rng(0), B, S + 1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return jcfg, tcfg, jp, tp, batch


def _torch_loss_and_grads(tp, tcfg, batch, remat):
    leaves = tree_leaves(tp)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    params = tree_map(lambda _: next(it), tp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = registry.loss_fn(params, tcfg, tb, remat=remat)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference(model, remat):
    jcfg, tcfg, jp, tp, batch = model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jreg.loss_fn(p, jcfg, jb, remat=remat), has_aux=True)(jp)
    loss, metrics, grads = _torch_loss_and_grads(tp, tcfg, batch, remat)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(jm["ce"]),
                               rtol=1e-5)
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    want = convert.lm_params(jax.tree.map(np.asarray, jgrads), device="cpu")
    for g, w in zip(grads, tree_leaves(want), strict=True):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)
        assert scale > 0  # every leaf, wq / wk / wv included, has a gradient


def test_remat_gives_the_same_gradients(model):
    _, tcfg, _, tp, batch = model
    _, _, on = _torch_loss_and_grads(tp, tcfg, batch, True)
    _, _, off = _torch_loss_and_grads(tp, tcfg, batch, False)
    for a, b in zip(on, off, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_loss_attention_takes_the_differentiable_route(model, monkeypatch):
    """`loss_fn` never reaches `ops.attention` (the flash kernel on the card
    has no backward); every layer runs `blockwise_attention`. Serving's
    prefill of the same tokens still goes through `ops.attention`."""
    _, tcfg, _, tp, batch = model
    calls = {"blockwise": 0, "ops": 0}
    real_blockwise, real_ops = TL.blockwise_attention, ops.attention

    def blockwise(*a, **k):
        calls["blockwise"] += 1
        return real_blockwise(*a, **k)

    def flash(*a, **k):
        calls["ops"] += 1
        return real_ops(*a, **k)

    monkeypatch.setattr(TL, "blockwise_attention", blockwise)
    monkeypatch.setattr(ops, "attention", flash)
    _torch_loss_and_grads(tp, tcfg, batch, remat=True)
    # remat replays each layer's forward in the backward
    assert calls == {"blockwise": 2 * tcfg.num_layers, "ops": 0}
    calls.update(blockwise=0, ops=0)
    tokens = torch.from_numpy(batch["tokens"])
    registry.prefill(tp, tcfg, {"tokens": tokens},
                     registry.init_cache(tcfg, B, S, torch.float32,
                                         device="cpu"))
    assert calls == {"blockwise": 0, "ops": tcfg.num_layers}


def test_loss_fn_masks_labels_and_mirrors_registry(model):
    """Labels of -1 leave the mean, as in the reference; the registry's
    `loss_fn` is the transformer's."""
    jcfg, tcfg, jp, tp, batch = model
    masked = dict(batch, labels=np.where(np.arange(S) % 3 == 0, -1,
                                         batch["labels"]).astype(np.int32))
    jl, _ = jreg.loss_fn(jp, jcfg, {k: jnp.asarray(v) for k, v in
                                     masked.items()}, remat=False)
    tl, _ = registry.loss_fn(tp, tcfg, {k: torch.from_numpy(v) for k, v in
                                        masked.items()}, remat=False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_wide_init_predicts_the_input_token():
    """At granite's widths the initial loss is far above ln(V), in both
    packages: the input embedding, scaled by sqrt(d_model), reaches the
    tied unembedding through the residual stream, so the input token's own
    logit dominates (about sqrt(d) * d * 0.02^2 after the final norm).
    Here d_model = 2048 (vocab 512): the losses agree within rtol 1e-5,
    exceed 2 ln(V), and labels equal to the inputs cost under 0.1."""
    import dataclasses
    changes = dict(d_model=2048, num_heads=16, num_kv_heads=4, head_dim=128,
                   d_ff=512)
    jcfg = dataclasses.replace(jreduced(jget_config("granite-8b")), **changes)
    tcfg = dataclasses.replace(reduced(get_config("granite-8b")), **changes)
    jp = jreg.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    toks = MarkovTokenStream(512, seed=0).sample(np.random.default_rng(0), 2,
                                                 33)
    for labels, check in ((toks[:, 1:], lambda l: l > 2 * np.log(512)),
                          (toks[:, :-1], lambda l: l < 0.1)):
        batch = {"tokens": toks[:, :-1], "labels": labels}
        jl, _ = jreg.loss_fn(jp, jcfg, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, remat=False)
        tl, _ = registry.loss_fn(tp, tcfg, {k: torch.from_numpy(v) for k, v
                                            in batch.items()}, remat=False)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        assert check(float(tl)), float(tl)
