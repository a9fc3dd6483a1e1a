"""The port's streaming trainer on the ssm, hybrid and encoder-decoder
families against the JAX package's, in f32 on the CPU, from the same
numbers (`convert.train_state` of the reference's state):

* reduced mamba2-2.7b (2 layers) at S = 128, reduced recurrentgemma-9b
  (5 layers: one period of RG-LRU, RG-LRU, local attention and a tail of
  two RG-LRU layers) at S = 160, reduced seamless-m4t-medium (2 encoder
  and 2 decoder layers) at S = 64 with [n, 64, 128] standard-normal
  frames; B = 8 over N = 4 nodes, ring R = 2;
* the consensus error pools a per-layer leaf of the port with the others
  of the reference's stacked leaf (`trainer.layer_pools`): the
  encoder-decoder's "encoder" and "decoder" stacks as the decoder-only
  "layers" and "tail";
* one train step per family on the exact wire (SGD), the gossip wire
  (Adam) and the int8 tile wire (SGD), at tests/test_torch_trainer.py's
  bounds (`METRIC_TOL`, `_agree`). The int8 tiles run over the reference's
  packed buffer: an SSD block's [heads] leaves are narrower than a tile,
  so its tiles hold entries of several leaves and layers;
* one `StreamingDriver` run per family (K = 2, 2 supersteps, no
  re-planning) against the reference's driver with the same `sample_fn`
  (frames for seamless): losses and the consensus error within rtol
  1e-5, parameters within 1e-5;
* mamba2 in bf16 with f32 masters: the SSD's f32 leaves stay f32 in the
  parameters and the masters, and the gradients pack into two buffers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import AveragingConfig as JAveragingConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import SHAPES as JSHAPES
from repro.core import averaging as javeraging
from repro.models import registry as jreg
from repro.train import trainer as jtrainer
from repro.train.driver import EngineConfig as JEngineConfig
from repro.train.driver import StreamingDriver as JStreamingDriver
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
from repro_torch.core import averaging, packing
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.models import registry
from repro_torch.train import trainer
from repro_torch.train.driver import EngineConfig, StreamingDriver
from test_torch_trainer import METRIC_TOL, _agree, _mesh_rules

torch.set_num_threads(1)

N, B = 4, 8
# arch: (layers, tokens a sample, frames a sample or 0)
FAMILIES = {"mamba2-2.7b": (2, 128, 0),
            "recurrentgemma-9b": (5, 160, 0),
            "seamless-m4t-medium": (2, 64, 64)}
ARCHS = list(FAMILIES)
WIRES = [("exact", "none", "sgd"), ("gossip", "none", "adam"),
         ("gossip", "int8", "sgd")]


def _runs(arch, mode, quant="none", optimizer="sgd", dtype="float32"):
    layers = FAMILIES[arch][0]
    lr = 0.5 if optimizer == "sgd" else 2e-3
    q = dict(quantization=quant, quant_stats="tile", quant_block_d=64)
    common = dict(optimizer=optimizer, learning_rate=lr, param_dtype=dtype)
    jrun = JRunConfig(model=jreduced(jget_config(arch), layers=layers),
                      shape=JSHAPES["train_4k"],
                      averaging=JAveragingConfig(mode, 2, **q), **common)
    trun = RunConfig(model=reduced(get_config(arch), layers=layers),
                     shape=SHAPES["train_4k"],
                     averaging=AveragingConfig(mode, 2, **q), **common)
    assert dataclasses.asdict(jrun.model) == dataclasses.asdict(trun.model)
    return jrun, trun


def _sampler(arch):
    """sample_fn(rng, n): Markov tokens and labels, and for the
    encoder-decoder standard-normal frames, all from `rng`."""
    _, S, Se = FAMILIES[arch]
    data = MarkovTokenStream(512, seed=0)
    frame_dim = reduced(get_config(arch)).frontend_embed_dim

    def sample(rng, n):
        toks = data.sample(rng, n, S + 1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if Se:
            out["frames"] = rng.standard_normal(
                (n, Se, frame_dim)).astype(np.float32)
        return out

    return sample


_INIT = {}


def _states(jrun, trun):
    """The reference's initial state and the port's copy of it. The
    reference's draw (op by op, seconds at these sizes) is made once an
    arch: SGD and Adam start from the same f32 state."""
    mesh, rules = _mesh_rules(jrun)
    name = jrun.model.name
    with rules():
        if name not in _INIT:
            _INIT[name] = jax.tree.map(np.asarray, jtrainer.init_state(
                jrun, jax.random.PRNGKey(0)))
        js = jax.tree.map(jnp.asarray, _INIT[name])
        if jrun.averaging.mode != "exact":
            js = jtrainer.replicate_for_nodes(js, N)
    ts = convert.train_state(*jax.tree.map(np.asarray, tuple(js)),
                             trun.model, device="cpu")
    return mesh, rules, js, ts


_STEPS = {}


def _one_step(arch, mode, quant, optimizer):
    """(port metrics, reference metrics, port state as the reference's
    tree, reference state) after one train step from the same state and
    batch; computed once a case."""
    key = (arch, mode, quant, optimizer)
    if key not in _STEPS:
        jrun, trun = _runs(arch, mode, quant, optimizer)
        mesh, rules, js, ts = _states(jrun, trun)
        b = _sampler(arch)(np.random.default_rng(1), B)
        if mode != "exact":
            b = trainer.make_node_batch(b, N)
        with rules():
            jstep = jax.jit(jtrainer.build_train_step(jrun, mesh,
                                                      n_nodes=N)[0])
            js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        tstep = trainer.build_train_step(trun, None, n_nodes=N, device="cpu")
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        _STEPS[key] = ({k: float(v) for k, v in tm.items()},
                       {k: float(v) for k, v in jm.items()},
                       convert.train_tree(ts, trun.model),
                       jax.tree.map(np.asarray, js))
    return _STEPS[key]


def _node_tree(arch, seed):
    """A reference-layout parameter tree with a node axis, each leaf drawn
    apart from `seed` with its own spread over the nodes."""
    cfg = jreduced(jget_config(arch), layers=FAMILIES[arch][0])
    shapes = jax.eval_shape(lambda: jreg.init_params(
        jax.random.PRNGKey(0), cfg, jnp.float32))
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(shapes)
    drawn = [(rng.standard_normal((N,) + l.shape)
              * rng.uniform(0.1, 2.0, (N,) + (1,) * len(l.shape))
              + rng.standard_normal(l.shape)).astype(np.float32)
             for l in leaves]
    return jax.tree.unflatten(treedef, drawn)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_pools_give_the_reference_consensus_error(arch):
    """The port's per-layer leaves pooled by `layer_pools` (the hybrid's
    period and tail; the encoder-decoder's two stacks) give the
    reference's consensus error of its stacked leaves, and the pools in
    order are the reference's leaves in its packing order."""
    tree = _node_tree(arch, 3)
    want = float(javeraging.consensus_error(
        jax.tree.map(jnp.asarray, tree)))
    _, trun = _runs(arch, "gossip")
    params = convert.lm_params(tree, device="cpu", node_axis=True)
    pools = trainer.layer_pools(params, trun.model)
    got = float(averaging.consensus_error(params, pools))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # pooled in the reference's leaf order: its flat buffer, column for
    # column
    leaves = packing.tree_leaves(params)
    flat = np.concatenate([leaves[i].reshape(N, -1).numpy()
                           for pool in pools for i in pool], axis=1)
    ref = np.concatenate([np.asarray(l).reshape(N, -1)
                          for l in jax.tree.leaves(tree)], axis=1)
    np.testing.assert_array_equal(flat, ref)


def test_seamless_gossip_consensus_error_is_the_reference():
    """The train step's consensus error on seamless's gossip wire is the
    reference's (the max over its stacked leaves), within 1e-5 relative."""
    tm, jm, _, _ = _one_step("seamless-m4t-medium", "gossip", "none", "adam")
    assert tm["consensus_err"] > 0
    np.testing.assert_allclose(tm["consensus_err"], jm["consensus_err"],
                               rtol=1e-5)


@pytest.mark.parametrize("mode,quant,optimizer", WIRES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, mode, quant, optimizer):
    tm, jm, got, want = _one_step(arch, mode, quant, optimizer)
    for k in ("loss", "ce", "consensus_err"):
        np.testing.assert_allclose(tm[k], jm[k], atol=1e-7, err_msg=k,
                                   rtol=METRIC_TOL[quant != "none"][k])
    np.testing.assert_array_equal(got["step"], np.asarray(want.opt.step))
    lr = 0.5 if optimizer == "sgd" else 2e-3
    if quant != "none":
        _agree(got["params"], want.params, 1e-5, frac=0.99, bound=1e-2)
    elif optimizer == "adam":
        _agree(got["params"], want.params, 1e-5, frac=0.999, bound=6 * lr)
        for k in ("m", "v"):
            scale = np.abs(np.concatenate([np.ravel(x) for x in
                                           jax.tree.leaves(
                                               getattr(want.opt, k))])).max()
            _agree(got[k], getattr(want.opt, k), 1e-4 * scale, frac=0.999,
                   bound=1e-2 * scale)
    else:
        _agree(got["params"], want.params, 1e-5)
    if mode != "exact":
        assert tm["consensus_err"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_matches_reference(arch):
    """`StreamingDriver` with the trainer's own builder against the
    reference's driver, the same `sample_fn` (frames dealt, split over the
    nodes and stacked per superstep with the tokens) and splitter seed."""
    jrun, trun = _runs(arch, "gossip")
    mesh, rules, js, ts = _states(jrun, trun)
    sample = _sampler(arch)
    with rules():
        with JStreamingDriver(jrun, mesh, js, sample, batch=B, n_nodes=N,
                              engine=JEngineConfig(superstep=2,
                                                   prefetch_depth=0,
                                                   replan_every=0)) as jdrv:
            js, jhist = jdrv.run(2)
    with StreamingDriver(trun, None, ts, sample, batch=B, n_nodes=N,
                         device="cpu",
                         engine=EngineConfig(superstep=2, prefetch_depth=2,
                                             replan_every=0)) as drv:
        ts, hist = drv.run(2)
    assert [r["round"] for r in hist] == [2, 4] and ts.opt.step == (4,) * N
    for r, jr in zip(hist, jhist, strict=True):
        for k in ("loss", "consensus_err"):
            np.testing.assert_allclose(r["metrics"][k], jr["metrics"][k],
                                       rtol=1e-5, err_msg=k)
    _agree(convert.train_tree(ts, trun.model)["params"],
           jax.tree.map(np.asarray, js.params), 1e-5)


def test_bf16_keeps_the_ssd_leaves_f32():
    """mamba2 in bf16 with f32 masters through a gossip Adam step: A_log,
    D and dt_bias stay f32 in the parameters and the masters, every other
    leaf stays bf16, and the gradients pack into two buffers."""
    _, trun = _runs("mamba2-2.7b", "gossip", optimizer="adam",
                    dtype="bfloat16")
    state = trainer.replicate_for_nodes(
        trainer.init_state(trun, torch.Generator().manual_seed(0)), N)
    f32 = {"A_log", "D", "dt_bias"}

    def dtypes(tree):
        return {(k, v.dtype) for blk in tree["blocks"]
                for k, v in blk["attn"].items()}

    want = {(k, torch.float32 if k in f32 else torch.bfloat16)
            for k, _ in dtypes(state.params)}
    pools = trainer.layer_pools(state.params, trun.model)
    bufs, _ = packing.pack_tree(state.params,
                                order=[i for p in pools for i in p])
    assert [b.dtype for b in bufs] == [torch.bfloat16, torch.float32]
    b = _sampler("mamba2-2.7b")(np.random.default_rng(1), B)
    b = trainer.make_node_batch(b, N)
    step = trainer.build_train_step(trun, None, n_nodes=N, device="cpu")
    state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert np.isfinite(float(m["loss"])) and float(m["consensus_err"]) > 0
    assert dtypes(state.params) == want
    assert all(v.dtype == torch.float32
               for blk in state.opt.master["blocks"]
               for v in blk["attn"].values())
    for k in f32:  # the master and the parameter are one number
        p = state.params["blocks"][0]["attn"][k]
        assert torch.equal(p, state.opt.master["blocks"][0]["attn"][k])
