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
  optimizer update. The update is elementwise, so it runs once on the
  stacked rows of each contiguous run of nodes at one optimizer step: once
  on the whole [N, ...] leaves while every node is at the same step.

Gradients come from `torch.autograd.grad` of `models.registry.loss_fn`,
whose attention takes the differentiable `blockwise_attention` route (the
flash kernel has no backward, in the reference as here). The optimizer's
step is the round clock `t`: the stochastic int8 compressor folds it into
its key (so its noise matches the reference's in distribution only), and a
time-varying `ScheduledMixOp` (the scenario harness's `mix` override) picks
its phase by it.

Error feedback (`AveragingConfig.error_feedback`, gossip only) compresses
the residual-corrected gradients once per step and mixes them linearly
(`core.averaging.ef_average_and_error`), carrying the residual in
`OptState.ef_residual`.

A cohort superstep (elastic membership) runs the same step on the active
rows of the full [N, ...] state in place — each active node's loss and
gradient, the mix over the m-node cohort, and the optimizer update on row
views (contiguous runs of rows) — so the state is never gathered: at an
8B-class width one node's weights, masters and moments are 9 GB. It equals
the reference's gather, run and scatter, the optimizer step included: a
state with the node axis keeps one step per node (a tuple of ints), and
only the active nodes' steps advance, so a node that rejoins without a
sync takes Adam's bias correction at its own step, as in the reference.

`publish_extract` maps the live state to the params a serving replica
loads (`serve.publisher.SnapshotPublisher`): the consensus mean over the
active nodes.

Over a mesh that splits the node axis across the ranks of a process group
(`repro_torch/dist.py`), each rank runs the step on its rows. On the
decentralized modes it steps its n_local nodes and mixes through the
mesh's gossip op (the shard rules: halo rows between ranks,
`core.mixing.CirculantMixOp(impl="shard")`). On the exact mode each rank
keeps a replica of the parameters, takes the gradient of its share of the
global batch and all-reduces the mean gradient (in f32), so every replica
takes the same update; the reference's ZeRO-1 layout holds the same
numbers in less memory and comes with the model axis (ROADMAP.md queue 1
item 3). The metrics are means over all nodes. The hierarchical mode,
error feedback and cohort supersteps on a sharded axis are not ported yet
and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import dist as rdist
from repro_torch.core.averaging import (average_and_error,
                                        check_sharded_mode,
                                        ef_average_and_error, make_gossip_mix,
                                        resolve_packed)
from repro_torch.core.mixing import ScheduledMixOp
from repro_torch.core.packing import map_tensors, tree_leaves, tree_map
from repro_torch.core.quantize import STOCHASTIC
from repro_torch.data.pipeline import exact_split_error
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import check_mesh, is_sharded, n_data_nodes, n_local
from repro_torch.models import registry
from repro_torch.models.transformer import build_plan
from repro_torch.optim import OptState, init_optimizer, make_optimizer

Tree = Any


class TrainState(NamedTuple):
    params: Tree
    opt: OptState


def _check_supported(run, mesh) -> None:
    if mesh is not None:
        check_mesh(mesh)
    check_sharded_mode(run.averaging, mesh)
    if is_sharded(mesh) and run.averaging.error_feedback != "off":
        raise NotImplementedError("error feedback on a sharded node axis is "
                                  "not ported yet (ROADMAP.md)")
    if run.averaging.error_feedback != "off" and run.averaging.mode != "gossip":
        raise ValueError(f"error-feedback compression (error_feedback="
                         f"{run.averaging.error_feedback!r}) requires "
                         f"averaging mode 'gossip' (got "
                         f"{run.averaging.mode!r})")


def init_state(run, gen: torch.Generator) -> TrainState:
    """Parameters drawn from `gen` (on its device) and the optimizer state:
    f32 masters when the parameters are not f32 and `run.master_weights`;
    moments f32; error-feedback residuals (zero, the gradient dtype) when
    `run.averaging.error_feedback` is on in gossip mode."""
    dtype = getattr(torch, run.param_dtype)
    params = registry.init_params(gen, run.model, dtype)
    use_master = run.master_weights and dtype != torch.float32
    use_ef = (run.averaging.error_feedback != "off"
              and run.averaging.mode == "gossip")
    return TrainState(params, init_optimizer(run.optimizer, params,
                                             master_weights=use_master,
                                             error_feedback=use_ef))


def replicate_for_nodes(state: TrainState, n_nodes: int) -> TrainState:
    """Attach the decentralized node axis: n identical copies of every
    tensor (copies, not a broadcast view: the updates write in place) and
    one optimizer step per node."""
    rep = lambda t: t.unsqueeze(0).repeat(n_nodes, *([1] * t.dim()))
    opt = state.opt
    return TrainState(tree_map(rep, state.params), opt._replace(
        step=(opt.step,) * n_nodes, m=tree_map(rep, opt.m), v=tree_map(rep, opt.v),
        master=tree_map(rep, opt.master),
        ef_residual=tree_map(rep, opt.ef_residual)))


def publish_extract(n_nodes: Optional[int] = None) -> Callable:
    """Extract fn for `serve.publisher.SnapshotPublisher`: map the live
    state to the params a serving replica should load, in the port's own
    parameter structure (`ContinuousBatchingEngine.poll` serves it as it
    is).

    Exact-averaging runs (`n_nodes=None`) publish `state.params` as they
    are. A decentralized run passes `n_nodes` and a [N] float membership
    mask as the publisher's `aux`: every tensor leaf whose leading dimension
    is N is reduced to the *consensus iterate*, the mask-weighted mean over
    the active nodes (what eq. 17's averaging drives every node toward), so
    dropped nodes' stale rows never reach the served weights. The mean
    accumulates in f32 and is cast to the leaf's dtype, as the reference's
    `tensordot(w_f32, p).astype(p.dtype)`; it runs leaf by leaf and node by
    node, so its f32 temporary is one node's row of one leaf."""
    @torch.no_grad()
    def extract(state, mask=None):
        params = state.params if hasattr(state, "params") else state
        if n_nodes is None or mask is None:
            return params
        w = mask.float() / mask.float().sum()

        def consensus(p):
            if p.dim() == 0 or p.shape[0] != n_nodes:
                return p
            acc = torch.zeros(p.shape[1:], dtype=torch.float32,
                              device=p.device)
            for i in range(n_nodes):
                acc.addcmul_(p[i], w[i])
            return acc.to(p.dtype)

        return map_tensors(consensus, params)

    return extract


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


def _row_runs(ids: Tuple[int, ...],
              steps: Tuple[int, ...]) -> List[Tuple[int, int, int]]:
    """Maximal runs of consecutive node ids at one optimizer step: (first
    cohort row, first node, end node), so rows j0.. of the cohort's buffers
    are nodes a..end-1."""
    runs: List[Tuple[int, int, int]] = []
    for j, i in enumerate(ids):
        if runs and runs[-1][2] == i and steps[i] == steps[i - 1]:
            j0, a, _ = runs[-1]
            runs[-1] = (j0, a, i + 1)
        else:
            runs.append((j, i, i + 1))
    return runs


def _mean_over_ranks(values: List[torch.Tensor], mesh,
                     weight: float) -> List[torch.Tensor]:
    """`values` (0-dim) summed over the mesh's ranks, times `weight`, in one
    all-reduce."""
    total = torch.stack([v.float() for v in values])
    return list((rdist.all_reduce_(total, mesh) * weight).unbind())


def build_train_step(run, mesh=None, *, n_nodes: Optional[int] = None,
                     mix: Optional[Any] = None,
                     device: DeviceLike = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    Exact mode: batch leaves [B, ...]. Decentralized: [N, B/N, ...], state
    leaves [N, ...]. `n_nodes` is the decentralized node count (default: one
    per rank of `mesh`, 1 without one, what the reference's host mesh gives
    on one device); passing N emulates the paper's N-node network. On a
    `mesh` that splits the node axis over ranks, the batch and the state
    are this rank's rows ([n_local, ...]; exact mode: its share of the
    batch, and a replica of the state). `mix` overrides the consensus
    engine built from `run.averaging` on `device`: the scenario harness
    passes a time-varying `ScheduledMixOp`, whose phase clock is the
    optimizer step; scheduled operators are linear, so a quantized config
    refuses one. The state's tensors are updated in place and returned in
    the new state; metrics are 0-dim tensors on the device ({"ce", "aux",
    "loss", "consensus_err"}, plus "ef_norm" and "ef_rel" with error
    feedback)."""
    _check_supported(run, mesh)
    mesh = mesh if is_sharded(mesh) else None
    if run.averaging.mode == "exact":
        return _build_exact_step(run, device, mesh)
    n = n_nodes or (n_data_nodes(mesh) if mesh is not None else 1)
    step = _build_node_step(run, n, mix, device, mesh)
    every = tuple(range(n_local(mesh, n)))
    return lambda state, batch: step(state, batch, every, None)


def _build_exact_step(run, device: DeviceLike, mesh=None) -> Callable:
    dev = resolve_device(device)
    update = make_optimizer(run.optimizer, run.learning_rate,
                            weight_decay=run.weight_decay)

    # every rank holds an equal share of the batch (`shard_batch` refuses
    # an uneven split), so the mean of the ranks' means is the batch mean
    E = n_data_nodes(mesh) if mesh is not None else 1

    def all_reduce_mean(grads: Tree) -> Tree:
        """Each rank's gradient of its share of the batch -> the mean over
        ranks, reduced in f32 and cast back, leaf by leaf."""
        def mean(g):
            g32 = g.float().contiguous()
            rdist.all_reduce_(g32, mesh).div_(E)
            return g32.to(g.dtype)
        return tree_map(mean, grads)

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
            loss, metrics, grads = loss_and_grad(run, state.params, batch)
        if mesh is not None:
            grads = all_reduce_mean(grads)
            loss, ce, aux = _mean_over_ranks(
                [loss, metrics["ce"], metrics["aux"]], mesh, 1.0 / E)
            metrics = {"ce": ce, "aux": aux}
        params, opt = update(grads, state.opt, state.params)
        metrics = dict(metrics, loss=loss,
                       consensus_err=torch.zeros((), device=loss.device))
        return TrainState(params, opt), metrics

    return train_step


def _build_node_step(run, n_nodes: int, mix: Optional[Any],
                     device: DeviceLike, mesh=None) -> Callable:
    """The decentralized step over `n_nodes` nodes:
    step(state, batch, ids, idx) -> (state, metrics). `ids` are the state
    rows that take part (batch row j belongs to row ids[j]): every row, or
    an elastic run's cohort; the rest of the state's rows are left as they
    are. `idx` is `ids` as a tensor on the device where they are not every
    row of the state (an elastic run's cohort), else None. On a sharded
    `mesh` the state's rows are this rank's n_local nodes of the n_nodes."""
    dev = resolve_device(device)
    avg = dataclasses.replace(run.averaging,
                              packed=resolve_packed(run.averaging, mesh))
    update = make_optimizer(run.optimizer, run.learning_rate,
                            weight_decay=run.weight_decay)
    ef_on = avg.error_feedback != "off"
    # the reference's pods: its mesh's "pod" axis, 1 on one rank (on a
    # sharded axis the hierarchical mode raises, `check_sharded_mode`)
    pods = 1
    if mix is None:
        mix = make_gossip_mix(avg, pods if avg.mode == "hierarchical"
                              else n_nodes, device=dev, mesh=mesh)
    elif isinstance(mix, ScheduledMixOp) and avg.quantization != "none":
        raise ValueError("ScheduledMixOp is linear-only: quantized averaging "
                         "configs keep their static per-round operator")
    stochastic = avg.quantization in STOCHASTIC
    pools: List[Optional[tuple]] = [None]  # from the first state's tree

    def step(state: TrainState, batch, ids: Tuple[int, ...],
             idx: Optional[torch.Tensor]):
        params, opt = state.params, state.opt
        if pools[0] is None:
            pools[0] = layer_pools(params, run.model)
        steps = opt.step  # one per node (`replicate_for_nodes`)
        # the nodes' gradients, [len(ids), ...] per leaf, one node at a time
        grads = tree_map(lambda p: p.new_empty((len(ids), *p.shape[1:])),
                         params)
        losses, node_metrics = [], []
        for j, i in enumerate(ids):
            l, m, g = loss_and_grad(run, tree_map(lambda p: p[i], params),
                                     {k: v[j] for k, v in batch.items()})
            for buf, gi in zip(tree_leaves(grads), tree_leaves(g)):
                buf[j].copy_(gi)
            del g
            losses.append(l)
            node_metrics.append(m)
        # the first active node's optimizer step is the round clock: the
        # stochastic compressor folds it into its key, and a ScheduledMixOp
        # picks its phase by it
        t = steps[ids[0]]
        key = t if stochastic else None
        extra = {}
        if ef_on:
            ef = opt.ef_residual
            if idx is not None:
                ef = tree_map(lambda e: e.index_select(0, idx), ef)
            mixed, new_ef, cerr, ef_norm, ef_rel = ef_average_and_error(
                grads, ef, avg, n_nodes=n_nodes, mix=mix, key=key, t=t,
                pools=pools[0])
            # into the state's residual tensors, in place (the update rules
            # never touch them), so the packed residual buffer is freed
            # before the update's temporaries and a caller still holding
            # the state does not keep the old residual alive
            for e, ne in zip(tree_leaves(opt.ef_residual),
                             tree_leaves(new_ef)):
                if idx is None:
                    e.copy_(ne)
                else:
                    e.index_copy_(0, idx, ne)
            del ef, new_ef
            extra = {"ef_norm": ef_norm, "ef_rel": ef_rel}
        else:
            mixed, cerr = average_and_error(grads, avg, n_nodes=n_nodes,
                                            pods=pods, mix=mix, key=key, t=t,
                                            pools=pools[0], mesh=mesh)
        del grads  # the unpacked gradients; `mixed` views the mixed buffer
        # the update is elementwise: run it in place on row views of each
        # contiguous run of nodes at one step (the whole leaves while every
        # node is at the same step)
        new_steps = list(steps)
        for j0, a, b in _row_runs(ids, steps):
            rows_of = lambda tree, a=a, b=b: tree_map(lambda x: x[a:b], tree)
            sub = opt._replace(step=steps[a], m=rows_of(opt.m),
                               v=rows_of(opt.v), master=rows_of(opt.master))
            _, new = update(
                tree_map(lambda g, j0=j0, w=b - a: g[j0:j0 + w], mixed),
                sub, rows_of(params))
            new_steps[a:b] = [new.step] * (b - a)
        opt = opt._replace(step=tuple(new_steps))
        names = list(node_metrics[0])
        if mesh is None:
            metrics = {k: torch.stack([m[k] for m in node_metrics]).mean()
                       for k in names}
            loss = torch.stack(losses).mean()
        else:  # the mean over every rank's nodes
            sums = _mean_over_ranks(
                [torch.stack(losses).sum()] +
                [torch.stack([m[k] for m in node_metrics]).sum()
                 for k in names], mesh, 1.0 / n_nodes)
            loss, metrics = sums[0], dict(zip(names, sums[1:]))
        metrics = dict(metrics, loss=loss, consensus_err=cerr, **extra)
        return TrainState(params, opt), metrics

    return step


def _loop(step: Callable) -> Callable:
    """K consecutive calls of step(state, batch) over the leading K axis of
    the batch leaves; the metrics stacked [K]."""
    def superstep(state: TrainState, batches):
        K = next(iter(batches.values())).shape[0]
        rounds = []
        for j in range(K):
            state, metrics = step(state, {k: v[j] for k, v in
                                          batches.items()})
            rounds.append(metrics)
        return state, {k: torch.stack([m[k] for m in rounds])
                       for k in rounds[0]}

    return superstep


def build_superstep(run, mesh=None, *, n_nodes: Optional[int] = None,
                    mix: Optional[Any] = None,
                    device: DeviceLike = None) -> Callable:
    """The K-round superstep: K consecutive train steps in one call (the
    reference's `lax.scan`; paper Fig. 4's amortization of fixed per-round
    costs). `superstep(state, batches) -> (state, metrics)`: batch leaves
    carry a leading K axis ([K, B, ...] exact / [K, N, B/N, ...]
    decentralized) and metric leaves come back stacked [K], on the device,
    so the driver pays one metric fetch per K rounds. `mix` as in
    `build_train_step`."""
    return _loop(build_train_step(run, mesh, n_nodes=n_nodes, mix=mix,
                                  device=device))


def build_cohort_superstep(run, n_active: int, *,
                           device: DeviceLike = None) -> Callable:
    """The K-round superstep of an m-node cohort of an elastic run:
    `superstep(state, ids, batches)` with the full [N, ...] state, the m
    active node ids and batch leaves [K, m, B/m, ...]; it trains the active
    rows in place (no gather of the state) with the gossip schedule
    recomposed over the cohort, and leaves the others as they are. Marked
    `takes_ids`, so `train.driver.elastic_superstep` hands it the full
    state."""
    _check_supported(run, None)
    dev = resolve_device(device)
    step = _build_node_step(run, n_active, None, dev)
    ef_on = run.averaging.error_feedback != "off"

    def superstep(state: TrainState, ids, batches):
        ids = tuple(int(i) for i in ids)
        # the rows of the residual to gather, once a superstep
        idx = torch.as_tensor(ids, device=dev) if ef_on else None
        return _loop(lambda s, b: step(s, b, ids, idx))(state, batches)

    superstep.takes_ids = True
    return superstep


def superstep_builder(run, mesh=None, *, n_nodes: Optional[int] = None,
                      mix: Optional[Any] = None,
                      device: DeviceLike = None) -> Callable[..., Callable]:
    """Bucket-keyed superstep factory for the adaptive-B governor
    (`train.driver.StreamingDriver`): `build(B) -> superstep`. The K-round
    loop reads K, B and the node split from its batch shapes, so one
    superstep serves every bucket; it is built on first use, once per
    cohort size.

    `build(B, membership)` with a partial `core.mixing.Membership` gives the
    cohort superstep (`build_cohort_superstep`), its gossip operator
    recomposed over the active cohort. The `mix` override (scenario harness)
    only applies at full membership: its operator is sized for the full
    node axis. On a sharded `mesh` (`n_nodes` default: one node per rank)
    only the full membership is built: churn on a sharded node axis is not
    ported yet (ROADMAP.md); and in the exact mode a B that does not split
    evenly over the ranks raises."""
    _check_supported(run, mesh)
    n_full = n_nodes or (n_data_nodes(mesh) if mesh is not None else 1)
    cohort_cache: Dict[int, Callable] = {}

    def build(B: int, membership=None) -> Callable:
        if run.averaging.mode == "exact" and is_sharded(mesh):
            why = exact_split_error(B, n_full, n_data_nodes(mesh))
            if why:
                raise ValueError(f"exact mode on a sharded node axis: {why}")
        m = n_full if membership is None else membership.n_active
        fn = cohort_cache.get(m)
        if fn is None and m != n_full and is_sharded(mesh):
            raise NotImplementedError(
                "elastic membership on a sharded node axis is not ported "
                "yet (ROADMAP.md)")
        if fn is None:
            fn = (build_superstep(run, mesh, n_nodes=n_full, mix=mix,
                                  device=device) if m == n_full else
                  build_cohort_superstep(run, m, device=device))
            cohort_cache[m] = fn
        return fn

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
