"""The port's MoE FFN (`models/moe.py`) against the JAX package's, in f32 on
the CPU at reduced sizes, inputs drawn from numpy seeds, within rtol = atol
= 1e-4: the output and the aux loss of reduced qwen2-moe-a2.7b (top-4 of 4
experts, and of 8) and llama4-scout-17b-a16e (top-1 with a shared expert),
a token count that halves the dispatch group, and a capacity factor low
enough that assignments are dropped. Then, on reduced qwen2-moe, one
decentralized trainer superstep against the reference trainer, a
checkpoint of its state byte for byte (f32, and bf16 with the f32
routers), a bf16 state's step, packing and publication with its f32
routers, and `launch/train.py` on the two MoE archs.

Ties: `torch.topk` and `lax.top_k` may order equal probabilities
differently, and the two packages' f32 logits differ in their last bits. So
every case first requires, on the reference's probabilities, a gap of more
than 1e-5 between each token's k-th and (k+1)-th probability: no rounding
of either package can then change a choice."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import AveragingConfig as JAveragingConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import SHAPES as JSHAPES
from repro.launch.mesh import make_mesh
from repro.launch.sharding import activation_rules
from repro.models import moe as jmoe
from repro.models.common import mesh_rules
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AveragingConfig, RunConfig, SHAPES
from repro_torch.core.packing import tree_leaves
from repro_torch.data.lm import MarkovTokenStream
from repro_torch.models import moe as tmoe
from repro_torch.models import registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer

# one intra-op thread: pytest-xdist runs several workers on the machine's
# cores (see tests/test_torch_trainer.py)
torch.set_num_threads(1)

RTOL = ATOL = 1e-4


def _close(got, want, tol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _cfgs(arch, experts=4, d_model=256, **moe_changes):
    """Reduced `arch` in both packages, with `moe_changes` to its MoE."""
    jcfg = jreduced(jget_config(arch), experts=experts, d_model=d_model)
    tcfg = reduced(get_config(arch), experts=experts, d_model=d_model)
    if moe_changes:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_changes))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, **moe_changes))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _top_k_margin(jp, jcfg, x):
    """The smallest gap between a token's k-th and (k+1)-th routing
    probability (inf where every expert is chosen)."""
    K, E = jcfg.moe.top_k, jcfg.moe.num_experts
    if K == E:
        return np.inf
    logits = np.asarray(x, np.float64).reshape(-1, x.shape[-1]) @ np.asarray(
        jp["router"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    srt = -np.sort(-probs, axis=-1)
    return float((srt[:, K - 1] - srt[:, K]).min())


def _moe_pair(jcfg, shape, seed):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    assert _top_k_margin(jp, jcfg, x) > 1e-5
    return jp, tp, x


MOE_CASES = [
    # (arch, experts, [B, S], moe changes, group tokens or None)
    ("qwen2-moe-a2.7b", 4, (2, 24), {}, None),     # top-4 of 4, shared
    ("qwen2-moe-a2.7b", 8, (2, 24), {}, None),     # top-4 of 8
    ("llama4-scout-17b-a16e", 4, (2, 24), {}, None),  # top-1, shared
    ("qwen2-moe-a2.7b", 8, (3, 16), {}, 32),       # group 32 -> 16, G = 3
    ("llama4-scout-17b-a16e", 4, (3, 2048), {}, None),  # 4096 -> 2048, G = 3
    ("qwen2-moe-a2.7b", 8, (2, 24), {"capacity_factor": 0.5}, None),
    ("llama4-scout-17b-a16e", 4, (2, 24), {"capacity_factor": 0.3}, None),
]


@pytest.mark.parametrize("arch,experts,shape,changes,group", MOE_CASES,
                         ids=["qwen2_top4of4", "qwen2_top4of8", "llama4_top1",
                              "group_halves", "group_halves_full_size",
                              "qwen2_drops", "llama4_drops"])
def test_apply_moe_matches_jax(monkeypatch, arch, experts, shape, changes,
                               group):
    d_model = 64 if shape[1] > 1000 else 256
    jcfg, tcfg = _cfgs(arch, experts, d_model, **changes)
    if group is not None:
        monkeypatch.setattr(jmoe, "GROUP_TOKENS", group)
        monkeypatch.setattr(tmoe, "GROUP_TOKENS", group)
    jp, tp, x = _moe_pair(jcfg, (*shape, d_model), seed=len(MOE_CASES))
    jy, jaux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x))
    ty, taux = tmoe.apply_moe(tp, tcfg, torch.from_numpy(x))
    T = shape[0] * shape[1]
    want_group = group or min(tmoe.GROUP_TOKENS, T)
    while T % want_group:
        want_group //= 2
    assert tmoe.group_size(T) == want_group
    if group is not None or T > tmoe.GROUP_TOKENS:
        assert want_group < min(group or tmoe.GROUP_TOKENS, T)  # it halved
    assert ty.shape == tuple(shape) + (d_model,) and taux.dim() == 0
    _close(ty, jy)
    _close(taux, jaux)
    if changes:
        # the low capacity factor drops assignments: the output differs from
        # the same layer with room for every assignment
        roomy = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=100.0))
        full, _ = tmoe.apply_moe(tp, roomy, torch.from_numpy(x))
        assert (full - ty).abs().max() > 1e-3


def test_capacity_and_dropped_gates():
    """C = max(K, int(cf * group * K / E)) per group; with one slot per
    expert, the first token to pick an expert keeps it and the others are
    dropped (their routed output is 0: only the shared expert remains)."""
    _, tcfg = _cfgs("llama4-scout-17b-a16e", 4, capacity_factor=0.01)
    assert tmoe.capacity(tcfg.moe, 512) == 1
    assert tmoe.capacity(dataclasses.replace(tcfg.moe, capacity_factor=1.25),
                         512) == 160
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, tcfg, torch.float32)
    x = torch.randn(1, 1, tcfg.d_model, generator=gen).expand(1, 6, -1)
    x = x.contiguous()  # six equal tokens: all pick one expert
    y, _ = tmoe.apply_moe(p, tcfg, x)
    shared = dict(p, we_down=torch.zeros_like(p["we_down"]))
    y_shared, _ = tmoe.apply_moe(shared, tcfg, x)
    assert not torch.allclose(y[0, 0], y_shared[0, 0])
    torch.testing.assert_close(y[0, 1:], y_shared[0, 1:])


def test_init_moe_keeps_router_f32():
    """The router is f32 in a bf16 model, as in the reference; the expert
    weights take the model's dtype and the reference's shapes."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", 8)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["we_gate"].dtype == tp["shared"]["w_down"].dtype == \
        torch.bfloat16
    assert (jax.tree.map(np.shape, jp)
            == convert.tree_map(lambda t: tuple(t.shape), tp))
    assert jp["router"].dtype == jnp.float32


# ---------------------------------------------------------------------------
# the trainer and the checkpoint on reduced qwen2-moe
# ---------------------------------------------------------------------------

N, B, S = 4, 8, 32


def _runs(param_dtype="float32", mode="gossip", optimizer="sgd"):
    common = dict(optimizer=optimizer, learning_rate=0.5,
                  param_dtype=param_dtype)
    jrun = JRunConfig(model=jreduced(jget_config("qwen2-moe-a2.7b")),
                      shape=JSHAPES["train_4k"],
                      averaging=JAveragingConfig(mode, 2), **common)
    trun = RunConfig(model=reduced(get_config("qwen2-moe-a2.7b")),
                     shape=SHAPES["train_4k"],
                     averaging=AveragingConfig(mode, 2), **common)
    return jrun, trun


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


def test_trainer_superstep_matches_reference():
    """One K = 2 superstep of the decentralized trainer (4 nodes, ring
    gossip R = 2, SGD) on reduced qwen2-moe, from the reference's state and
    the same token draws: losses, ce, aux and the consensus error within
    rtol 1e-5, the parameters within rtol = atol = 1e-5
    (tests/test_torch_trainer.py's bounds), and aux > 0."""
    jrun, trun = _runs()
    mesh = make_mesh((1, 1), ("data", "model"))
    with mesh_rules(mesh, activation_rules(mesh, jrun.shape, node_axis=True)):
        js = jtrainer.replicate_for_nodes(
            jtrainer.init_state(jrun, jax.random.PRNGKey(0)), N)
        ts = convert.train_state(*jax.tree.map(np.asarray, tuple(js)),
                                 trun.model, device="cpu")
        toks = MarkovTokenStream(512, seed=0).sample(
            np.random.default_rng(1), 2 * B, S + 1)
        b = {"tokens": toks[:, :-1].reshape(2, B, S),
             "labels": toks[:, 1:].reshape(2, B, S)}
        b = trainer.make_node_batch(b, N, axis=1)
        jsup = jax.jit(jtrainer.build_superstep(jrun, mesh, n_nodes=N)[0])
        js, jm = jsup(js, {k: jnp.asarray(v) for k, v in b.items()})
    sup = trainer.build_superstep(trun, None, n_nodes=N, device="cpu")
    ts, tm = sup(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "ce", "aux", "consensus_err"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert (tm["aux"] > 0).all() and (tm["consensus_err"] > 0).all()
    got = _flat(convert.train_tree(ts, trun.model)["params"])
    want = _flat(jax.tree.map(np.asarray, js.params))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _bf16_put(key, arr):
    if arr.dtype == np.dtype("V2"):
        arr = arr.view(ml_dtypes.bfloat16)
    return jnp.asarray(arr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_interchangeable_with_reference(tmp_path, dtype):
    """A reduced qwen2-moe training state (Adam, 3 nodes; in bf16 with f32
    masters and the f32 router) with every float leaf drawn from a seed:
    the port's checkpoint and the reference's have the same manifest and
    the same bytes, and each package restores the other's."""
    jrun, trun = _runs(dtype, optimizer="adam")
    js = jtrainer.replicate_for_nodes(
        jtrainer.init_state(jrun, jax.random.PRNGKey(0)), 3)
    rng = np.random.default_rng(2)
    f32 = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), (js.params, js.opt.m, js.opt.v, js.opt.master))
    steps = np.arange(7, 10, dtype=np.int32)
    js = jtrainer.TrainState(
        jax.tree.map(lambda a, p: jnp.asarray(a).astype(p.dtype), f32[0],
                     js.params),
        js.opt._replace(step=jnp.asarray(steps),
                        m=jax.tree.map(jnp.asarray, f32[1]),
                        v=jax.tree.map(jnp.asarray, f32[2]),
                        master=jax.tree.map(jnp.asarray, f32[3])))
    ts = convert.train_state(f32[0], js.opt._replace(
        step=steps, m=f32[1], v=f32[2], master=f32[3]), trun.model,
        device="cpu")
    ts = ts._replace(params=_model_dtype(ts.params, getattr(torch, dtype)))
    router = ts.params["blocks"][0]["ffn"]["router"]
    assert router.dtype == torch.float32
    assert ts.params["embed"].dtype == getattr(torch, dtype)

    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jpath, js, step=5, meta={"who": "either"})
    ckpt.save(tpath, ts, step=5, meta={"who": "either"}, model=trun.model)
    jm, tm = jckpt.load_manifest(jpath), ckpt.load_manifest(tpath)
    assert list(tm["leaves"]) == list(jm["leaves"]) and tm == jm
    assert any(k.endswith("router") for k in tm["leaves"])
    for ent in jm["leaves"].values():
        with open(os.path.join(jpath, ent["file"]), "rb") as a, \
                open(os.path.join(tpath, ent["file"]), "rb") as c:
            assert a.read() == c.read(), ent["file"]

    like = trainer.TrainState(convert.tree_map(torch.zeros_like, ts.params),
                              ts.opt._replace(m=convert.tree_map(
                                  torch.zeros_like, ts.opt.m)))
    got = ckpt.restore(jpath, like, model=trun.model)
    assert got.opt.step == ts.opt.step
    for name in ("params", "m", "v", "master"):
        for a, c in zip(tree_leaves(_part(got, name)),
                        tree_leaves(_part(ts, name)), strict=True):
            assert a.dtype == c.dtype and torch.equal(a, c)
    back = jckpt.restore(tpath, jax.eval_shape(lambda: js), put=_bf16_put)
    for a, c in zip(jax.tree.leaves(js), jax.tree.leaves(back), strict=True):
        assert a.dtype == c.dtype and a.shape == c.shape
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      np.asarray(c.astype(jnp.float32)))


def _part(state, name):
    return state.params if name == "params" else getattr(state.opt, name)


def _model_dtype(params, dtype):
    """`params` in the model's dtype, each router kept f32 (the reference's
    `init_moe`)."""
    out = convert.tree_map(lambda t: t.to(dtype), params)
    for blk, src in zip(out["blocks"], params["blocks"]):
        blk["ffn"]["router"] = src["ffn"]["router"].float()
    return out


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"])
def test_launch_train_takes_moe_archs(arch, capsys):
    """`launch/train.py --arch` trains a reduced MoE arch, 2 gossip nodes
    on the CPU; the encoder-decoder arch raises (no frames in the token
    stream, as in the reference's launcher)."""
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "2", "--superstep", "2", "--averaging",
                       "gossip", "--rounds", "2", "--nodes", "2", "--batch",
                       "4", "--seq", "16"])
    rounds = [line for line in capsys.readouterr().out.splitlines()
              if line.startswith("round")]
    assert len(rounds) == 1 and "loss" in rounds[0]
    with pytest.raises(ValueError, match="no frames"):
        launch_train.main(["--arch", "seamless-m4t-medium", "--reduced",
                           "--device", "cpu"])


def test_bf16_state_with_f32_router_trains_packs_and_publishes():
    """A bf16 reduced qwen2-moe state keeps its routers f32 through the
    decentralized step (2 nodes, gossip, Adam with f32 masters): the packed
    gradient buffer splits by dtype (a bf16 buffer and an f32 one of the
    routers), and the publisher's consensus mean keeps each leaf's dtype."""
    from repro_torch.core.packing import pack_tree
    _, trun = _runs("bfloat16", optimizer="adam")
    trun = dataclasses.replace(trun, learning_rate=1e-3)
    state = trainer.replicate_for_nodes(trainer.init_state(
        trun, torch.Generator().manual_seed(0)), 2)
    router = lambda s: s.params["blocks"][1]["ffn"]["router"]
    assert router(state).dtype == torch.float32
    assert state.opt.master["blocks"][1]["ffn"]["router"].dtype == \
        torch.float32
    bufs, spec = pack_tree(state.params, lead=1)
    assert sorted(str(b.dtype) for b in bufs) == ["torch.bfloat16",
                                                   "torch.float32"]
    f32 = next(b for b in bufs if b.dtype == torch.float32)
    assert f32.shape == (2, trun.model.num_layers * trun.model.d_model
                         * trun.model.moe.num_experts)
    before = router(state).clone()
    toks = MarkovTokenStream(512, seed=0).sample(np.random.default_rng(0),
                                                 4, S + 1)
    batch = trainer.make_node_batch({"tokens": toks[:, :-1],
                                     "labels": toks[:, 1:]}, 2)
    step = trainer.build_train_step(trun, None, n_nodes=2, device="cpu")
    state, m = step(state, {k: torch.from_numpy(v) for k, v in
                            batch.items()})
    assert torch.isfinite(m["loss"]) and float(m["aux"]) > 0
    assert router(state).dtype == torch.float32
    assert state.params["embed"].dtype == torch.bfloat16
    assert not torch.equal(router(state), before)
    served = trainer.publish_extract(2)(state, torch.ones(2))
    assert served["blocks"][1]["ffn"]["router"].dtype == torch.float32
    assert served["embed"].dtype == torch.bfloat16
    torch.testing.assert_close(served["blocks"][1]["ffn"]["router"],
                               router(state).mean(0))
