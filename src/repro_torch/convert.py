"""Carry the JAX package's numbers (as numpy) into the port's objects, so
both packages can compute the same thing from the same numbers — a
`KrasulinaState`, a `PCAStream` built from the reference's covariance, a
`LogRegStream` built from the reference's ground truth, a circulant
schedule, and LM parameters (`lm_params`, and `lm_tree` back). Nothing here
imports the JAX package: callers pass `np.asarray(...)` of its arrays.
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


def lm_params(tree, *, device: DeviceLike = None) -> Dict[str, Any]:
    """The port's LM parameters from the reference's `init_params` tree with
    numpy leaves: {"embed", "final_norm", "layers": [per period position, a
    dict of leaves stacked [n_rep, ...]], "tail": [dicts]} (+ "unembed").
    Layer r * period + i of the port is `layers[i]` at index r, followed by
    the tail, the order in which the reference's scan runs them."""
    dev = resolve_device(device)
    conv = lambda a: _tensor(a, dev)
    period = tree["layers"]
    n_rep = len(np.asarray(_first_leaf(period[0]))) if period else 0
    blocks = [tree_map(lambda a, r=r: conv(np.asarray(a)[r]), spec)
              for r in range(n_rep) for spec in period]
    blocks += [tree_map(conv, block) for block in tree["tail"]]
    out = {"embed": conv(tree["embed"]),
           "final_norm": tree_map(conv, tree["final_norm"]), "blocks": blocks}
    if "unembed" in tree:
        out["unembed"] = conv(tree["unembed"])
    return out


def lm_tree(params: Dict[str, Any], cfg: ModelConfig,
            window_override: int = 0) -> Dict[str, Any]:
    """The inverse of `lm_params`: the reference's tree, as numpy, with the
    period positions stacked again as `cfg`'s plan lays them out."""
    period, n_rep, tail = build_plan(cfg, window_override)
    npy = lambda t: t.detach().cpu().numpy()
    blocks = params["blocks"]
    P = len(period)
    layers = [_stack([tree_map(npy, blocks[r * P + i]) for r in range(n_rep)])
              for i in range(P)]
    out = {"embed": npy(params["embed"]),
           "final_norm": tree_map(npy, params["final_norm"]), "layers": layers,
           "tail": [tree_map(npy, b) for b in blocks[P * n_rep:]]}
    if "unembed" in params:
        out["unembed"] = npy(params["unembed"])
    return out


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _stack(trees):
    """Stack same-structured trees of numpy leaves along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)
