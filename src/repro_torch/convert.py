"""Carry the JAX package's numbers (as numpy) into the port's objects, so
both packages can compute the same thing from the same numbers — a
`KrasulinaState`, a `PCAStream` built from the reference's covariance, a
`LogRegStream` built from the reference's ground truth, a circulant
schedule, LM parameters (`lm_params`, and `lm_tree` back) and a whole LM
training state, error-feedback residuals included (`train_state`, and
`train_tree` back). Nothing here imports
the JAX package: callers pass `np.asarray(...)` of its arrays.
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
from repro_torch.models.transformer import build_plan
from repro_torch.optim import OptState
from repro_torch.train.trainer import TrainState


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), device=device)


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


def lm_params(tree, *, device: DeviceLike = None,
              node_axis: bool = False) -> Dict[str, Any]:
    """The port's LM parameters from the reference's `init_params` tree with
    numpy leaves: {"embed", "final_norm", "layers": [per period position, a
    dict of leaves stacked [n_rep, ...]], "tail": [dicts]} (+ "unembed").
    Layer r * period + i of the port is `layers[i]` at index r, followed by
    the tail, the order in which the reference's scan runs them. With
    `node_axis`, every leaf leads with the decentralized node axis
    ([N, n_rep, ...] in "layers"), and so does every port leaf."""
    dev = resolve_device(device)
    conv = lambda a: _tensor(a, dev)
    ax = 1 if node_axis else 0
    period = tree["layers"]
    n_rep = np.asarray(_first_leaf(period[0])).shape[ax] if period else 0
    take = lambda a, r: np.take(np.asarray(a), r, axis=ax)
    blocks = [tree_map(lambda a, r=r: conv(take(a, r)), spec)
              for r in range(n_rep) for spec in period]
    blocks += [tree_map(conv, block) for block in tree["tail"]]
    out = {"embed": conv(tree["embed"]),
           "final_norm": tree_map(conv, tree["final_norm"]), "blocks": blocks}
    if "unembed" in tree:
        out["unembed"] = conv(tree["unembed"])
    return out


def lm_tree(params: Dict[str, Any], cfg: ModelConfig,
            window_override: int = 0, *,
            node_axis: bool = False) -> Dict[str, Any]:
    """The inverse of `lm_params`: the reference's tree, as numpy, with the
    period positions stacked again as `cfg`'s plan lays them out (after the
    node axis, with `node_axis`)."""
    period, n_rep, tail = build_plan(cfg, window_override)
    npy = lambda t: t.detach().cpu().numpy()
    blocks = params["blocks"]
    P = len(period)
    ax = 1 if node_axis else 0
    layers = [_stack([tree_map(npy, blocks[r * P + i]) for r in range(n_rep)],
                     ax) for i in range(P)]
    out = {"embed": npy(params["embed"]),
           "final_norm": tree_map(npy, params["final_norm"]), "layers": layers,
           "tail": [tree_map(npy, b) for b in blocks[P * n_rep:]]}
    if "unembed" in params:
        out["unembed"] = npy(params["unembed"])
    return out


def train_state(params_tree, opt_state, cfg: ModelConfig, *,
                device: DeviceLike = None) -> TrainState:
    """A `train.trainer.TrainState` from the reference's `TrainState`
    (`jax.tree.map(np.asarray, ...)` of it): the parameters and the
    optimizer's `step`, `m`, `v`, `master` and `ef_residual` (`()` where the
    reference has none), with or without the leading node axis of a
    decentralized run (read off `opt_state.step`, which
    `replicate_for_nodes` stacks too: the port's state then keeps a tuple
    of the nodes' steps). The port's `torch.Generator` init cannot draw the
    reference's numbers, so both packages start from these."""
    step = np.asarray(opt_state.step)
    node_axis = step.ndim > 0
    conv = lambda t: (() if isinstance(t, tuple) and t == () else
                      lm_params(t, device=device, node_axis=node_axis))
    opt = OptState(tuple(int(s) for s in step) if node_axis else int(step),
                   conv(opt_state.m),
                   conv(opt_state.v), conv(opt_state.master),
                   conv(opt_state.ef_residual))
    return TrainState(conv(params_tree), opt)


def train_tree(state: TrainState, cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of `train_state`, as numpy: {"params", "step", "m", "v",
    "master", "ef_residual"} in the reference's layout (`master` and
    `ef_residual` are `()` where the state has none)."""
    node_axis = state.params["embed"].dim() == 3
    conv = lambda t: (() if isinstance(t, tuple) and t == () else
                      lm_tree(t, cfg, node_axis=node_axis))
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
