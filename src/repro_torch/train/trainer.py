"""LM trainer of the port: the train step and the K-round superstep for a
`RunConfig`, with the paper's averaging mode as a first-class switch.

* **exact** (paper-faithful DMB, Alg. 1): the gradient of the mean loss over
  the global batch (B = global batch; on one device the reference's
  AllReduce is the mean itself), with `microbatches` sequential slices
  accumulated in f32 when asked for.
* **gossip / hierarchical** (D-SGD, Algs. 3-4): every leaf carries a leading
  node axis. Each node takes its loss and gradient on its B/N share, in a
  Python loop over the node axis (the reference vmaps; here
  `torch.utils.checkpoint` and the kernel wrappers have no batching rule
  under `torch.func.vmap`, and the loop keeps one node's activations alive
  at a time). `core.averaging.average_and_error` then mixes the packed
  gradient buffer (the `gossip_mix` kernel on the card, or
  `gossip_mix_quant` for tile statistics) and each node applies its own
  optimizer update: the update is elementwise and every node shares the
  step, so it runs once on the stacked [N, ...] leaves.

Gradients come from `torch.autograd.grad` of `models.registry.loss_fn`,
whose attention takes the differentiable `blockwise_attention` route (the
flash kernel has no backward, in the reference as here). The optimizer's
step is the round clock `t`: the stochastic int8 compressor folds it into
its key, so its noise matches the reference's in distribution only.

Not here yet (they raise, naming their slice): a device mesh, cohort
supersteps (elastic membership), error-feedback compression and the
publisher's `publish_extract`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.averaging import (average_and_error, make_gossip_mix,
                                        resolve_packed)
from repro_torch.core.packing import tree_leaves, tree_map
from repro_torch.core.quantize import STOCHASTIC
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import registry
from repro_torch.models.transformer import build_plan
from repro_torch.optim import OptState, init_optimizer, make_optimizer

Tree = Any


class TrainState(NamedTuple):
    params: Tree
    opt: OptState


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with the port's {slice_name} "
                               f"slice")


def _check_supported(run, mesh) -> None:
    if mesh is not None:
        raise _later("training on a device mesh", "sharded")
    if run.averaging.error_feedback != "off":
        raise _later("error-feedback compressed gossip",
                     "elastic and error-feedback")


def init_state(run, gen: torch.Generator) -> TrainState:
    """Parameters drawn from `gen` (on its device) and the optimizer state:
    f32 masters when the parameters are not f32 and `run.master_weights`;
    moments f32."""
    _check_supported(run, None)
    dtype = getattr(torch, run.param_dtype)
    params = registry.init_params(gen, run.model, dtype)
    use_master = run.master_weights and dtype != torch.float32
    return TrainState(params, init_optimizer(run.optimizer, params,
                                             master_weights=use_master))


def replicate_for_nodes(state: TrainState, n_nodes: int) -> TrainState:
    """Attach the decentralized node axis: n identical copies of every
    tensor (copies, not a broadcast view: the updates write in place)."""
    rep = lambda t: t.unsqueeze(0).repeat(n_nodes, *([1] * t.dim()))
    opt = state.opt
    return TrainState(tree_map(rep, state.params), opt._replace(
        m=tree_map(rep, opt.m), v=tree_map(rep, opt.v),
        master=tree_map(rep, opt.master)))


def _rebuild(like: Tree, leaves) -> Tree:
    """`like`'s structure with `leaves` in its leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def loss_and_grad(run, params: Tree, batch: Dict[str, torch.Tensor]):
    """(loss, {"ce", "aux"}, grads) of `loss_fn` at `params`, gradients in
    the parameters' dtype (zeros for a parameter the loss does not read)."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, metrics = registry.loss_fn(_rebuild(params, live), run.model,
                                         batch, remat=run.remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _rebuild(params, grads))


def layer_pools(params: Tree, cfg) -> Tuple[Tuple[int, ...], ...]:
    """The leaves of `params` (by index, in packing order) that the
    reference holds as ONE leaf: its scan stacks layer r * period + i of
    every weight kind into one [n_rep, ...] leaf of period position i, and
    its consensus error is a max over leaves. Pooling the port's per-layer
    leaves the same way (`core.averaging.average_and_error(pools=...)`)
    gives the reference's number."""
    period, n_rep, _ = build_plan(cfg)
    P = len(period)
    keys: List[tuple] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for j, x in enumerate(t):
                walk(x, path + (j,))
        else:
            keys.append(path)

    walk(params, ())
    pools: Dict[tuple, List[int]] = {}
    for idx, path in enumerate(keys):
        if path[0] == "blocks":
            layer = path[1]
            path = (("layers", layer % P) if layer < P * n_rep
                    else ("tail", layer - P * n_rep)) + path[2:]
        pools.setdefault(path, []).append(idx)
    return tuple(tuple(v) for v in pools.values())


def _split(batch: Dict[str, torch.Tensor], parts: int, j: int):
    """Slice j of `parts` contiguous slices of the leading axis."""
    return {k: v.reshape(parts, v.shape[0] // parts, *v.shape[1:])[j]
            for k, v in batch.items()}


def build_train_step(run, mesh=None, *, n_nodes: Optional[int] = None,
                     device: DeviceLike = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    Exact mode: batch leaves [B, ...]. Decentralized: [N, B/N, ...], state
    leaves [N, ...]. `n_nodes` is the decentralized node count (default 1,
    what the reference's host mesh gives on one device); passing N emulates
    the paper's N-node network on one card; the consensus engine is built
    from `run.averaging` on `device` (the reference's `mix` override serves
    the scenario harness and comes with it). The state's tensors are
    updated in place and returned in the new state; metrics are 0-dim
    tensors on the device ({"ce", "aux", "loss", "consensus_err"})."""
    _check_supported(run, mesh)
    dev = resolve_device(device)
    avg = dataclasses.replace(run.averaging,
                              packed=resolve_packed(run.averaging))
    update = make_optimizer(run.optimizer, run.learning_rate,
                            weight_decay=run.weight_decay)

    if avg.mode == "exact":
        def train_step(state: TrainState, batch):
            mb = run.microbatches
            if mb > 1:
                # gradient accumulation: the local mini-batch in `mb`
                # sequential slices (paper Section II-C, compute-limited)
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device),
                    state.params)
                loss = torch.zeros((), device=dev)
                metrics = {"ce": torch.zeros((), device=dev),
                           "aux": torch.zeros((), device=dev)}
                for j in range(mb):
                    l, m, g = loss_and_grad(run, state.params,
                                             _split(batch, mb, j))
                    for acc, gj in zip(tree_leaves(grads), tree_leaves(g)):
                        acc.add_(gj.float() / mb)
                    del g
                    loss = loss + l / mb
                    metrics = {k: metrics[k] + m[k] / mb for k in metrics}
            else:
                loss, metrics, grads = loss_and_grad(run, state.params,
                                                      batch)
            params, opt = update(grads, state.opt, state.params)
            metrics = dict(metrics, loss=loss,
                           consensus_err=torch.zeros((), device=loss.device))
            return TrainState(params, opt), metrics
        return train_step

    n_nodes = n_nodes or 1
    pods = 1  # one card: the reference's mesh without a pod axis
    mix = make_gossip_mix(avg, pods if avg.mode == "hierarchical"
                          else n_nodes, device=dev)
    stochastic = avg.quantization in STOCHASTIC
    pools: List[Optional[tuple]] = [None]  # from the first state's tree

    def train_step(state: TrainState, batch):
        params = state.params
        if pools[0] is None:
            pools[0] = layer_pools(params, run.model)
        # the nodes' gradients, [N, ...] per leaf, one node at a time
        grads = tree_map(torch.empty_like, params)
        losses, node_metrics = [], []
        for i in range(n_nodes):
            l, m, g = loss_and_grad(run, tree_map(lambda p: p[i], params),
                                     {k: v[i] for k, v in batch.items()})
            for buf, gi in zip(tree_leaves(grads), tree_leaves(g)):
                buf[i].copy_(gi)
            del g
            losses.append(l)
            node_metrics.append(m)
        # the optimizer's step is the round clock: the stochastic compressor
        # folds it into its key, so every round draws fresh noise
        t = state.opt.step
        mixed, cerr = average_and_error(grads, avg, n_nodes=n_nodes,
                                        pods=pods, mix=mix,
                                        key=t if stochastic else None,
                                        pools=pools[0])
        del grads  # the unpacked gradients; `mixed` views the mixed buffer
        params, opt = update(mixed, state.opt, params)
        metrics = {k: torch.stack([m[k] for m in node_metrics]).mean()
                   for k in node_metrics[0]}
        metrics = dict(metrics, loss=torch.stack(losses).mean(),
                       consensus_err=cerr)
        return TrainState(params, opt), metrics

    return train_step


def build_superstep(run, mesh=None, *, n_nodes: Optional[int] = None,
                    device: DeviceLike = None) -> Callable:
    """The K-round superstep: K consecutive train steps in one call (the
    reference's `lax.scan`; paper Fig. 4's amortization of fixed per-round
    costs). `superstep(state, batches) -> (state, metrics)`: batch leaves
    carry a leading K axis ([K, B, ...] exact / [K, N, B/N, ...]
    decentralized) and metric leaves come back stacked [K], on the device,
    so the driver pays one metric fetch per K rounds."""
    train_step = build_train_step(run, mesh, n_nodes=n_nodes, device=device)

    def superstep(state: TrainState, batches):
        K = next(iter(batches.values())).shape[0]
        rounds = []
        for j in range(K):
            state, metrics = train_step(state, {k: v[j] for k, v in
                                                batches.items()})
            rounds.append(metrics)
        return state, {k: torch.stack([m[k] for m in rounds])
                       for k in rounds[0]}

    return superstep


def superstep_builder(run, mesh=None, *, n_nodes: Optional[int] = None,
                      device: DeviceLike = None) -> Callable[..., Callable]:
    """Bucket-keyed superstep factory for the adaptive-B governor
    (`train.driver.StreamingDriver`): `build(B) -> superstep`. The K-round
    loop reads K, B and the node split from its batch shapes, so one
    superstep serves every bucket; it is built on the first call.

    `build(B, membership)` with a partial `core.mixing.Membership` (a
    cohort superstep) comes with the port's elastic slice and raises."""
    _check_supported(run, mesh)
    built = []

    def build(B: int, membership=None) -> Callable:
        if membership is not None and not membership.is_full:
            raise _later("cohort supersteps (elastic membership)", "elastic")
        if not built:
            built.append(build_superstep(run, mesh, n_nodes=n_nodes,
                                         device=device))
        return built[0]

    return build


def make_node_batch(batch: Dict[str, np.ndarray], n_nodes: int,
                    axis: int = 0) -> Dict[str, np.ndarray]:
    """[B, ...] -> [n_nodes, B/n_nodes, ...] (the splitter of Fig. 3(c)).
    `axis=1` splits superstep batches [K, B, ...] -> [K, n_nodes, B/n_nodes, ...].
    Works on numpy arrays and torch tensors alike (a reshape of each leaf)."""
    def split(a):
        shp = a.shape
        return a.reshape(*shp[:axis], n_nodes, shp[axis] // n_nodes,
                         *shp[axis + 1:])
    return {k: split(v) for k, v in batch.items()}
