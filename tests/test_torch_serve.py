"""The port's serving path against the JAX package's contracts
(`tests/test_serve.py`), in f32 on the CPU on reduced granite-8b with the
reference's weights (`convert.lm_params`): greedy token ids of `generate`
and of `ContinuousBatchingEngine` equal the JAX package's token for token;
swaps lose no request and keep versions monotone; the pool is validated;
encoder-decoder families are refused; `launch/serve.py` runs both modes."""
import dataclasses
from typing import Any, NamedTuple

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
from repro_torch.launch import serve as launch_serve
from repro_torch.models import registry
from repro_torch.serve import engine
from repro_torch.serve.engine import ContinuousBatchingEngine


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(jget_config("granite-8b"))
    cfg = reduced(get_config("granite-8b"))
    jp = jreg.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    params = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, params


def _prompts(cfg, n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=length) for _ in range(n)]


@pytest.mark.parametrize("prompt_len", [16, 24])
def test_generate_equals_jax_token_for_token(setup, prompt_len):
    """Prompts of 16 (masked-dot prefill) and 24 tokens (`ops.attention`)."""
    jcfg, jp, cfg, params = setup
    toks = np.stack(_prompts(cfg, 2, prompt_len, seed=prompt_len))
    want = jengine.generate(jp, jcfg, {"tokens": jnp.asarray(toks)}, 40, 8,
                            dtype=jnp.float32)
    got = engine.generate(params, cfg, {"tokens": torch.from_numpy(toks)}, 40,
                          8, dtype=torch.float32)
    assert got.shape == (2, 8)
    assert got.tolist() == np.asarray(want).tolist()


def test_continuous_equals_jax_and_generate(setup):
    """More requests than slots: admissions churn through the pool, and every
    request's token ids equal the JAX engine's and the port's static batch-1
    generate path."""
    jcfg, jp, cfg, params = setup
    prompts = _prompts(cfg, 5, 20, seed=1)
    jeng = jengine.ContinuousBatchingEngine(jcfg, jp, slots=2, max_len=32)
    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=32)
    jrids = [jeng.submit(p, 6) for p in prompts]
    rids = [eng.submit(p, 6) for p in prompts]
    jeng.drain()
    eng.drain()
    assert eng.decode_steps == jeng.decode_steps
    for jrid, rid, p in zip(jrids, rids, prompts):
        req = eng.result(rid)
        assert len(req.tokens) == 6
        assert req.tokens == jeng.result(jrid).tokens
        ref = engine.generate(params, cfg,
                              {"tokens": torch.from_numpy(p[None])}, 32, 6,
                              dtype=torch.float32)
        assert ref[0].tolist() == req.tokens


def test_greedy_decode_deterministic(setup):
    _, _, cfg, params = setup
    prompt = registry.synth_batch(torch.Generator().manual_seed(2), cfg, 1, 16,
                                  mode="prefill")
    assert set(prompt) == {"tokens"}
    a = engine.generate(params, cfg, prompt, 32, 6, dtype=torch.float32)
    b = engine.generate(params, cfg, prompt, 32, 6, dtype=torch.float32)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()


def test_temperature_sampling_follows_generator(setup):
    _, _, cfg, params = setup
    prompt = registry.synth_batch(torch.Generator().manual_seed(3), cfg, 1, 16,
                                  mode="prefill")
    st = engine.init_serve(cfg, 1, 24, torch.float32, device="cpu")
    st = engine.prefill(params, cfg, prompt, st)
    draws = []
    for seed in (1, 1, 7):
        _, t = engine.serve_step(params, cfg, st, temperature=2.0,
                                 generator=torch.Generator().manual_seed(seed))
        draws.append(t)
    _, g = engine.serve_step(params, cfg, st)
    assert draws[0].shape == g.shape == (1, 1)
    assert torch.equal(draws[0], draws[1])


def test_serve_state_index_advances(setup):
    _, _, cfg, params = setup
    st = engine.init_serve(cfg, 1, 24, torch.float32, device="cpu")
    prompt = registry.synth_batch(torch.Generator().manual_seed(4), cfg, 1, 8,
                                  mode="prefill")
    st = engine.prefill(params, cfg, prompt, st)
    assert st.index == 8
    st, _ = engine.serve_step(params, cfg, st)
    assert st.index == 9


def _negated(params):
    """Parameters with every leaf negated (definitely different logits)."""
    return convert.tree_map(lambda t: -t, params)


def test_decode_spanning_swap_bit_identical(setup):
    """A request alive across a version flip produces exactly the token ids
    of decoding each segment under its own params (zero in-flight loss, no
    cache invalidation)."""
    _, _, cfg, params = setup
    p_b = _negated(params)
    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=48)
    prompt = _prompts(cfg, 1, 20, seed=5)[0]
    rid = eng.submit(prompt, 10)
    for _ in range(4):
        eng.step()
    n_a = len(next(iter(eng._active.values())).tokens)  # tokens under v0
    assert 0 < n_a < 10
    eng.swap_params(p_b, version=1)
    eng.drain()
    req = eng.result(rid)
    assert req.versions == [0] * n_a + [1] * (10 - n_a)

    # segmented reference on the scalar serve path
    st = engine.init_serve(cfg, 1, 48, torch.float32, device="cpu")
    st = engine.prefill(params, cfg, {"tokens": torch.from_numpy(prompt[None])},
                        st)
    ref = [int(st.last_tokens[0, 0])]
    for _ in range(9):
        p = params if len(ref) < n_a else p_b
        st, t = engine.serve_step(p, cfg, st)
        ref.append(int(t[0, 0]))
    assert ref == req.tokens


def test_zero_loss_across_three_swaps(setup):
    """Traffic continues across >= 3 swaps: every submitted request completes
    with exactly max_new tokens and the per-token version trace is
    monotone."""
    _, _, cfg, params = setup
    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=32)
    rids = [eng.submit(p, 8) for p in _prompts(cfg, 6, 18, seed=7)]
    swaps = 0
    while eng.n_active or eng.n_queued:
        eng.step()
        if swaps < 3 and eng.decode_steps % 3 == 0 and eng.decode_steps > 0:
            eng.swap_params(convert.tree_map(lambda t: t * 0.99, eng.params))
            swaps += 1
    assert swaps == 3 and eng.swaps == 3
    spanning = 0
    for rid in rids:
        req = eng.result(rid)
        assert len(req.tokens) == 8, "request dropped tokens across a swap"
        assert req.versions == sorted(req.versions), "non-monotone versions"
        spanning += len(set(req.versions)) > 1
    assert spanning >= 1


def test_engine_validates_pool_and_monotone_versions(setup):
    _, _, cfg, params = setup
    with pytest.raises(ValueError, match="bad pool"):
        ContinuousBatchingEngine(cfg, params, slots=0)
    eng = ContinuousBatchingEngine(cfg, params, slots=1, max_len=16)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(np.arange(10), 8)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.zeros((0,)), 4)
    eng.swap_params(params, version=3)
    with pytest.raises(ValueError, match="non-monotone"):
        eng.swap_params(params, version=3)


def test_idle_slot_index_is_clamped(setup):
    """An idle slot's index never walks past max_len - 1, however long the
    pool keeps decoding (the reference's engine.py:114 clamp)."""
    _, _, cfg, params = setup
    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=20)
    eng.submit(np.arange(4), 15)
    eng.drain()
    assert eng.decode_steps == 14
    # slot 0 parked at 0 on retire; idle slot 1 advanced once per step
    assert eng.index.tolist() == [0, 14]
    eng.index[1] = 19
    eng.submit(np.arange(4), 3)
    eng.step()
    assert int(eng.index.max()) <= 19


def test_encdec_family_rejected():
    cfg = dataclasses.replace(reduced(get_config("granite-8b")),
                              encoder_layers=2)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ContinuousBatchingEngine(cfg, params=None)
    # the registry builds its cache: generate serves it
    cache = registry.init_cache(cfg, 1, 8, device="cpu")
    assert cache["memory"].shape == (1, registry.ENC_LEN, cfg.d_model)
    assert len(cache["decoder"]) == cfg.num_layers


class _Snapshot(NamedTuple):
    version: int
    params: Any


class _Publisher:
    """Anything with `.snapshot()` returning None or (version, params)."""

    def __init__(self):
        self.snap = None

    def snapshot(self):
        return self.snap


def test_engine_poll_adopts_only_newer_versions(setup):
    _, _, cfg, params = setup
    pub = _Publisher()
    eng = ContinuousBatchingEngine(cfg, params, slots=1, max_len=16)
    assert not eng.poll(pub)  # nothing published yet
    pub.snap = _Snapshot(1, params)
    assert eng.poll(pub) and eng.version == 1
    assert not eng.poll(pub)  # same version: no swap
    assert eng.swaps == 1


@pytest.mark.parametrize("mode", ["static", "continuous"])
def test_launch_serve_runs_on_cpu(mode, capsys):
    args = ["--arch", "granite-8b", "--reduced", "--device", "cpu",
            "--prompt-len", "20", "--gen", "4"]
    if mode == "continuous":
        args += ["--continuous", "--slots", "2", "--requests", "3"]
    else:
        args += ["--batch", "2"]
    ops.reset_launches()
    launch_serve.main(args)
    out = capsys.readouterr().out
    assert "arch=granite-8b" in out and "device=cpu" in out
    assert ("continuous decode:" if mode == "continuous" else "prefill:") in out
    assert "sample token ids:" in out
    assert ops.launches["flash_attention"] == 0


@pytest.mark.parametrize("arch", [
    "phi4-mini-3.8b", "starcoder2-15b", "chameleon-34b", "minicpm3-4b",
    "qwen2-moe-a2.7b", "llama4-scout-17b-a16e"])
def test_launch_serve_takes_every_ported_arch(arch, capsys):
    """`--arch` resolves each ported arch: a reduced static batch and the
    continuous engine run on the CPU; the engine refuses the
    encoder-decoder, which `generate` serves (tests/test_torch_encdec.py)."""
    base = ["--arch", arch, "--reduced", "--device", "cpu", "--prompt-len",
            "20", "--gen", "4"]
    launch_serve.main(base + ["--batch", "2"])
    launch_serve.main(base + ["--continuous", "--slots", "2",
                              "--requests", "3"])
    out = capsys.readouterr().out
    assert out.count(f"arch={arch}") == 2 and "continuous decode:" in out
    with pytest.raises(NotImplementedError, match="decoder-only"):
        launch_serve.main(["--arch", "seamless-m4t-medium", "--reduced",
                           "--device", "cpu", "--continuous"])
