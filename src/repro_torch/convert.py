"""Carry the JAX package's numbers (as numpy) into the port's objects, so
both packages can compute the same thing from the same numbers — a
`KrasulinaState`, a `PCAStream` built from the reference's covariance, a
`LogRegStream` built from the reference's ground truth, a circulant
schedule, LM parameters (`lm_params`, and `lm_tree` back) and a whole LM
training state, error-feedback residuals included (`train_state`, and
`train_tree` back). Over a mesh with a model axis, `lm_params` and
`train_state` give this rank's blocks of the reference's whole tree and
`train_tree` gathers them again. Nothing here imports the JAX package:
callers pass `np.asarray(...)` of its arrays.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_logreg import LogRegConfig
from repro_torch.core.krasulina import KrasulinaState
from repro_torch.core.mixing import Schedule
from repro_torch.data.synthetic import LogRegStream, PCAStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import model_extent
from repro_torch.launch.sharding import gather_tree, shard_tree
from repro_torch.models.transformer import build_plan
from repro_torch.optim import OptState
from repro_torch.train.trainer import TrainState, rest_specs


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # numpy's bf16 extension type: by its bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.as_tensor(a, device=device)


def krasulina_state(w, t, *, device: DeviceLike = None) -> KrasulinaState:
    """A superstep carry from the reference's `KrasulinaState(w, t)`."""
    return KrasulinaState(_tensor(w, resolve_device(device)), int(t))


def pca_stream(cov, sqrt_cov, top_eigvec, lambda1: float, eigengap: float, *,
               device: DeviceLike = None) -> PCAStream:
    """A `PCAStream` over the reference stream's covariance: its
    `make_pca_host_sampler` then gives the reference's draws exactly."""
    dev = resolve_device(device)
    return PCAStream(_tensor(cov, dev), _tensor(top_eigvec, dev),
                     float(lambda1), float(eigengap), _tensor(sqrt_cov, dev))


def logreg_stream(cfg: LogRegConfig, w_star, mus=None, *,
                  device: DeviceLike = None) -> LogRegStream:
    """A `LogRegStream` over the reference stream's problem: its `w_star`
    and, for the conditional Gaussians (FIG9), its class means [2, d]. The
    draws then come from the same distribution as the reference's (not the
    same numbers)."""
    dev = resolve_device(device)
    if (mus is None) != (cfg.generator == "logistic_link"):
        raise ValueError(f"the {cfg.generator} generator "
                         f"{'takes no' if mus is not None else 'needs its'} "
                         f"class means")
    return LogRegStream(cfg, _tensor(w_star, dev).float(),
                        None if mus is None else _tensor(mus, dev).float())


def schedule(sched) -> Schedule:
    """A circulant schedule with plain Python numbers."""
    return tuple((int(s), float(w)) for s, w in sched)


def tree_map(fn: Callable, tree):
    """`fn` on every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# the optional top-level leaves of an LM tree, beside embed and final_norm
_TOP_LEAVES = ("frontend_proj", "unembed")


def lm_params(tree, *, device: DeviceLike = None, node_axis: bool = False,
              mesh=None, cfg: ModelConfig = None,
              zero1: bool = False) -> Dict[str, Any]:
    """The port's LM parameters from the reference's `init_params` tree with
    numpy leaves: {"embed", "final_norm", "layers": [per period position, a
    dict of leaves stacked [n_rep, ...]], "tail": [dicts]} (+ "unembed").
    Layer r * period + i of the port is `layers[i]` at index r, followed by
    the tail, the order in which the reference's scan runs them. An
    encoder-decoder's tree {"embed", "frontend_proj", "encoder", "decoder",
    "final_norm"}, each stack [n_layers, ...], becomes a list of per-layer
    dicts under "encoder" and "decoder". With `node_axis`, every leaf leads
    with the decentralized node axis ([N, n_rep, ...] in "layers"), and so
    does every port leaf. The leaves keep their dtypes (a MoE router, an
    SSD's A_log, D and dt_bias, an RG-LRU's lam stay f32 in a bf16
    model). Over a `mesh` with a model axis (and the tree's `cfg`): this
    rank's blocks (`train.trainer.rest_specs`: the model shards, or the
    ZeRO-1 blocks with `zero1`)."""
    whole = _lm_params(tree, resolve_device(device), node_axis)
    if model_extent(mesh) == 1:
        return whole
    return shard_tree(whole, rest_specs(cfg, mesh, zero1, node_axis), mesh)


def _lm_params(tree, dev: torch.device, node_axis: bool) -> Dict[str, Any]:
    conv = lambda a: _tensor(a, dev)
    ax = 1 if node_axis else 0
    take = lambda a, r: np.take(np.asarray(a), r, axis=ax)
    unstack = lambda stack: [
        tree_map(lambda a, r=r: conv(take(a, r)), stack)
        for r in range(np.asarray(_first_leaf(stack)).shape[ax])]
    if "encoder" in tree:
        return {"embed": conv(tree["embed"]),
                "frontend_proj": conv(tree["frontend_proj"]),
                "encoder": unstack(tree["encoder"]),
                "decoder": unstack(tree["decoder"]),
                "final_norm": tree_map(conv, tree["final_norm"])}
    period = tree["layers"]
    n_rep = np.asarray(_first_leaf(period[0])).shape[ax] if period else 0
    blocks = [tree_map(lambda a, r=r: conv(take(a, r)), spec)
              for r in range(n_rep) for spec in period]
    blocks += [tree_map(conv, block) for block in tree["tail"]]
    out = {"embed": conv(tree["embed"]),
           "final_norm": tree_map(conv, tree["final_norm"]), "blocks": blocks}
    for name in _TOP_LEAVES:
        if name in tree:
            out[name] = conv(tree[name])
    return out


def lm_tree(params: Dict[str, Any], cfg: ModelConfig,
            window_override: int = 0, *,
            node_axis: bool = False) -> Dict[str, Any]:
    """The inverse of `lm_params`: the reference's tree, as numpy, with the
    period positions stacked again as `cfg`'s plan lays them out (after the
    node axis, with `node_axis`)."""
    npy = lambda t: t.detach().cpu().numpy()
    ax = 1 if node_axis else 0
    if "encoder" in params:
        stack = lambda blocks: _stack([tree_map(npy, b) for b in blocks], ax)
        return {"embed": npy(params["embed"]),
                "frontend_proj": npy(params["frontend_proj"]),
                "encoder": stack(params["encoder"]),
                "decoder": stack(params["decoder"]),
                "final_norm": tree_map(npy, params["final_norm"])}
    period, n_rep, tail = build_plan(cfg, window_override)
    blocks = params["blocks"]
    P = len(period)
    layers = [_stack([tree_map(npy, blocks[r * P + i]) for r in range(n_rep)],
                     ax) for i in range(P)]
    out = {"embed": npy(params["embed"]),
           "final_norm": tree_map(npy, params["final_norm"]), "layers": layers,
           "tail": [tree_map(npy, b) for b in blocks[P * n_rep:]]}
    for name in _TOP_LEAVES:
        if name in params:
            out[name] = npy(params[name])
    return out


def train_state(params_tree, opt_state, cfg: ModelConfig, *,
                device: DeviceLike = None, mesh=None) -> TrainState:
    """A `train.trainer.TrainState` from the reference's `TrainState`
    (`jax.tree.map(np.asarray, ...)` of it): the parameters and the
    optimizer's `step`, `m`, `v`, `master` and `ef_residual` (`()` where the
    reference has none), with or without the leading node axis of a
    decentralized run (read off `opt_state.step`, which
    `replicate_for_nodes` stacks too: the port's state then keeps a tuple
    of the nodes' steps). The port's `torch.Generator` init cannot draw the
    reference's numbers, so both packages start from these. Over a `mesh`
    with a model axis, this rank's blocks: ZeRO-1 in the exact mode (no
    node axis), the model shards of every node otherwise."""
    step = np.asarray(opt_state.step)
    node_axis = step.ndim > 0
    conv = lambda t: (() if isinstance(t, tuple) and t == () else
                      lm_params(t, device=device, node_axis=node_axis,
                                mesh=mesh, cfg=cfg, zero1=not node_axis))
    opt = OptState(tuple(int(s) for s in step) if node_axis else int(step),
                   conv(opt_state.m),
                   conv(opt_state.v), conv(opt_state.master),
                   conv(opt_state.ef_residual))
    return TrainState(conv(params_tree), opt)


def train_tree(state: TrainState, cfg: ModelConfig,
               mesh=None) -> Dict[str, Any]:
    """The inverse of `train_state`, as numpy: {"params", "step", "m", "v",
    "master", "ef_residual"} in the reference's layout (`master` and
    `ef_residual` are `()` where the state has none). Over a `mesh` with a
    model axis the rank's blocks are gathered first (on every rank)."""
    node_axis = state.params["embed"].dim() == 3
    spec = (rest_specs(cfg, mesh, not node_axis, node_axis)
            if model_extent(mesh) > 1 else None)

    def conv(t):
        if isinstance(t, tuple) and t == ():
            return ()
        if spec is not None:
            t = gather_tree(t, spec, mesh)
        return lm_tree(t, cfg, node_axis=node_axis)
    opt = state.opt
    return {"params": conv(state.params), "step": np.asarray(opt.step),
            "m": conv(opt.m), "v": conv(opt.v), "master": conv(opt.master),
            "ef_residual": conv(opt.ef_residual)}


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _stack(trees, axis: int = 0):
    """Stack same-structured trees of numpy leaves along a new `axis`."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], axis) for k in first}
    return np.stack(trees, axis=axis)
