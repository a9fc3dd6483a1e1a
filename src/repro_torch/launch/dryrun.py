"""Dry-run planner of the port: what one rank of a mesh holds and does for
one step of an (architecture x input shape x mesh), without the hardware,
from `repro.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k --mesh 1x1

For every combination this builds the port's real step (the train step of
`train/trainer.py`, exact or decentralized over the node axis;
`serve/engine.py`'s prefill with the serve state; `serve_step`, one token
against a seq_len cache) with meta tensors for its arguments (no
allocation: `models/common.py` `MetaGenerator`, `models/registry.py`
`input_specs`) and runs it once under `PlanMode`, a `TorchDispatchMode`
that counts the FLOPs (`torch.utils.flop_counter`'s formulas, and the
kernels' own counts from `kernels/ops.py`'s meta branch, which returns
each kernel's footprint), tracks the live bytes of every storage the step
allocates to a peak (freed through weakref finalizers), and sums twice the
bytes of every op's outputs as the HBM estimate (the reference's
`hbm_bytes_est`). The placements come from `launch/sharding.py`'s rules
over the mesh (`launch/mesh.py` `abstract_mesh`: the reference's 16 x 16
and 2 x 16 x 16 as H100s, or one card, 1 x 1).

What the trace stands for. It runs the step as the port executes it: the
parameters and optimizer state whole on each rank in the exact mode (the
port keeps replicas), this rank's rows of the node axis in the
decentralized mode, and the batch and cache split over the data axes. The
argument bytes are those of the planned placements (ZeRO-1 and the model
axis included).

On a model axis of extent above 1 the train step of every family (the
trainer executes them all there) is traced as each rank runs it
(`train/trainer.py`), at any extent (the production 16 x 16 included):
the rank's blocks of
the state at rest (ZeRO-1 in the exact mode, the model shards of its node
rows in the decentralized one), its tensor-parallel layers (with the
pieces of the heads a split cuts), and every message of both axes through
`dist.py`, whose collectives are shape-only no-ops on
meta that count what they would move on the card (`dist.log`); the record
carries those counts (`collectives`, the model axis's apart in
`collectives_model`; the quantized and error-feedback wires' slot
statistics as "slot all-reduce" messages). Serving on a model axis
keeps it planned, not executed: its temporaries are the unsplit upper
bound (`temp_unsplit_over_model`), the Megatron split's activation
all-reduces are planned (`collectives_planned`), and `model_axis_refused`
says why (`model_axis_refusal`).

On the node axis alone collectives are derived: what `dist.py` moves on
each rank for the step (the exact mode's f32 gradient all-reduce; the
gossip mode's R rounds of halo rows to both neighbours, then the
consensus error's reductions; the metrics' reduction), under the
reference's kind names, counted as messages the way `dist.stats` counts
them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import weakref
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import dist as rdist
from repro_torch.configs import get_config
from repro_torch.configs.base import (AveragingConfig, ModelConfig,
                                      RunConfig, SHAPES, ShapeConfig)
from repro_torch.core.packing import tree_leaves
from repro_torch.kernels import ops
from repro_torch.kernels.consensus import halo_reach, halo_wire
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import abstract_mesh, production_shape
from repro_torch.models import registry
from repro_torch.models.common import MetaGenerator
from repro_torch.models.transformer import build_plan
from repro_torch.serve import engine
from repro_torch.train import trainer

Tree = Any
META = torch.device("meta")
GIB = 2 ** 30

# the reference's configuration: default gradient-accumulation factor per
# arch for train shapes, and the archs whose long_500k runs a sliding window
TRAIN_MICROBATCHES = {
    "llama4-scout-17b-a16e": 16,
    "chameleon-34b": 16,
    "recurrentgemma-9b": 4,
    "starcoder2-15b": 2,
    "seamless-m4t-medium": 4,
}
WINDOWED_FOR_500K = {
    "granite-8b": 8192,
    "phi4-mini-3.8b": 8192,
    "minicpm3-4b": 8192,
    "chameleon-34b": 8192,
    "seamless-m4t-medium": 8192,
}

# one H100 80GB HBM3's memory where no card is present
H100_MEMORY_BYTES = 80 * GIB


def window_override_for(arch: str, shape_name: str) -> int:
    if shape_name == "long_500k":
        return WINDOWED_FOR_500K.get(arch, 0)
    return 0


def card_memory_bytes() -> int:
    """The memory of the card this runs beside, else an H100 80GB's."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_MEMORY_BYTES


def parse_mesh(text: str):
    """"DxM" -> a (data, model) abstract mesh; "PxDxM" -> (pod, data,
    model)."""
    sizes = tuple(int(s) for s in text.lower().split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(sizes))
    if axes is None:
        raise ValueError(f"mesh {text!r}: give DxM or PxDxM")
    return abstract_mesh(sizes, axes)


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.sizes)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class PlanMode(TorchDispatchMode):
    """One pass of a step on meta tensors: `flops` (matmul-class ops by
    `torch.utils.flop_counter`'s formulas, plus each kernel's count from its
    meta branch), `bytes` (each op's input and output bytes, views
    excluded), `hbm_bytes_est` (twice each op's output bytes, views
    excluded), and `peak` / `live`, the bytes of the storages the step
    allocated that are alive (the arguments' storages, `hold`, are never
    counted)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.hbm_bytes_est = 0.0
        self.live = 0
        self.peak = 0
        self._tracked: Dict[int, Any] = {}
        self._held: set = set()

    def hold(self, tree) -> set:
        """Never count these tensors' storages (the step's arguments);
        returns their ids."""
        self._held.update(id(t.untyped_storage()) for t in _tensors(tree))
        return self._held

    def _kernel(self, name: str, flops: float) -> None:
        self.flops += flops

    def __enter__(self):
        ops.meta_hooks.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.meta_hooks.remove(self._kernel)
        return super().__exit__(*exc)

    def _free(self, key: int, nbytes: int) -> None:
        self.live -= nbytes
        self._tracked.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        ins = _tensors((args, kwargs))
        seen = {id(t.untyped_storage()) for t in ins}
        view = func.is_view
        for t in _tensors(out):
            nbytes = t.numel() * t.element_size()
            if not view:
                self.hbm_bytes_est += 2.0 * nbytes
                self.bytes += nbytes
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._held or key in self._tracked:
                continue
            size = st.nbytes()
            self.live += size
            self.peak = max(self.peak, self.live)
            self._tracked[key] = weakref.finalize(st, self._free, key, size)
        if not view:
            self.bytes += sum(t.numel() * t.element_size() for t in ins)
        return out


# ---------------------------------------------------------------------------
# the step and its meta arguments
# ---------------------------------------------------------------------------


class Lowerable(NamedTuple):
    """`fn(*args)` on meta tensors of the trace's local shapes; `planned`
    the same arguments at their global shapes and `specs` their placements
    on the mesh (argument bytes are `local_bytes(planned, specs)`);
    `info` what the collectives derive from."""

    fn: Any
    args: tuple
    planned: tuple
    specs: tuple
    info: dict


def _data_only(spec) -> tuple:
    """A placement with the model axis dropped (the trace cannot split
    it)."""
    def keep(d):
        if d == shlib.M:
            return None
        if isinstance(d, tuple):
            rest = tuple(a for a in d if a != shlib.M)
            return rest or None
        return d
    return tuple(keep(d) for d in spec)


def _local_meta(tree: Tree, specs: Tree, mesh, model: bool = False) -> Tree:
    """Meta tensors of the blocks one rank holds over the data axes (and
    the model axis with `model`)."""
    def make(path, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        shape = shlib.local_shape(tuple(leaf.shape),
                                  spec if model else _data_only(spec), mesh)
        return torch.empty(shape, dtype=leaf.dtype, device=META)
    return shlib.map_with_path(make, tree, specs)


def _tokens_long(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's batches carry int64 ids (`input_specs` declares the
    reference's int32)."""
    return {k: (torch.empty(v.shape, dtype=torch.long, device=META)
                if v.dtype == torch.int32 else v) for k, v in batch.items()}


def build_lowerable(arch: str, shape_name: str, mesh, averaging: str = "exact",
                    rounds: int = 1, topology: str = "ring",
                    microbatches: int = 0, master_weights: bool = True,
                    ring_cache: bool = False, remat: bool = True, *,
                    cfg: Optional[ModelConfig] = None,
                    shape: Optional[ShapeConfig] = None,
                    n_nodes: Optional[int] = None,
                    membership=None,
                    wire: Optional[dict] = None) -> Lowerable:
    """The step of (arch x shape) on `mesh` and its meta arguments. `cfg`
    and `shape` override the registry's (a cut depth, a reduced size);
    `n_nodes` (default: the mesh's data extent) plans the port's
    single-process multi-node runs on a 1 x 1 mesh. `membership` (a
    partial `core.mixing.Membership` of the n_nodes) traces an elastic
    run's cohort step on the mesh's rank `mesh.rank`: its active rows of
    the state, the cohort's batch ([its active rows, B / m, ...]; B =
    `shape.global_batch`). Only a decentralized run over a model axis that
    the trainer executes takes one (ValueError elsewhere). `wire` sets
    more of the run's `AveragingConfig` (the quantized and error-feedback
    wires: `quantization`, `quant_stats`, `quant_block_d`, `packed`,
    `error_feedback`, `self_weight`)."""
    cfg = cfg or get_config(arch)
    if ring_cache:
        cfg = dataclasses.replace(cfg, ring_buffer_cache=True)
    shape = shape or SHAPES[shape_name]
    wo = window_override_for(arch, shape_name)
    dp = rdist.data_axes(mesh)
    ndp = rdist.n_data_nodes(mesh)
    n_stacked = None if cfg.is_encdec else shlib.stacked_layers(cfg, wo)
    info = {"cfg": cfg, "shape": shape, "mesh": mesh, "mode": shape.mode}

    if shape.mode == "train":
        decentralized = averaging != "exact"
        mb = microbatches or TRAIN_MICROBATCHES.get(arch, 1)
        run = RunConfig(model=cfg, shape=shape,
                        averaging=AveragingConfig(mode=averaging,
                                                  rounds=rounds,
                                                  topology=topology,
                                                  **(wire or {})),
                        optimizer="adam", param_dtype="bfloat16",
                        microbatches=1 if decentralized else mb,
                        master_weights=master_weights, remat=remat)
        state = trainer.init_state(run, MetaGenerator())
        batch = _tokens_long(registry.input_specs(cfg, shape))
        N = n_nodes or ndp
        tp = mesh.shape.get("model", 1) > 1
        info.update(run=run, n_nodes=N, executed=tp)
        cohort = membership is not None and not membership.is_full
        if cohort and not (decentralized and tp):
            raise ValueError("a cohort step is traced only for a "
                             "decentralized run over a model axis the "
                             "trainer executes")
        if decentralized:
            if N % ndp:
                raise ValueError(f"{N} nodes do not split evenly over the "
                                 f"data extent {ndp}")
            n_local = N // ndp
            full = trainer.replicate_for_nodes(state, N)
            sspec = shlib.train_state_specs(full, mesh, node_axes=dp,
                                            n_stacked=n_stacked)
            gbatch = trainer.make_node_batch(
                batch, membership.n_active if cohort else N)
            bspec = shlib.batch_specs(gbatch, mesh, shape, node_axis=True)
            tbatch = _local_meta(gbatch, bspec, mesh)
            if tp:
                tstate = _local_meta(full, sspec, mesh, model=True)
                if cohort:
                    fn, tbatch = _cohort_step(run, mesh, N, membership,
                                              batch)
                else:
                    fn = trainer.build_train_step(run, mesh, n_nodes=N,
                                                  device=META)
            else:
                tstate = trainer.replicate_for_nodes(state, n_local)
                fn = trainer.build_train_step(run, None, n_nodes=n_local,
                                              device=META)
        else:
            full = state
            sspec = shlib.train_state_specs(full, mesh, n_stacked=n_stacked)
            bspec = shlib.batch_specs(batch, mesh, shape)
            gbatch = batch
            tbatch = _local_meta(batch, bspec, mesh)
            if tp:
                tstate = _local_meta(full, sspec, mesh, model=True)
                fn = trainer.build_train_step(run, mesh, device=META)
            else:
                tstate = state
                fn = trainer.build_train_step(run, None, device=META)
        return Lowerable(fn, (tstate, tbatch), (full, gbatch),
                         (sspec, bspec), info)

    # the serving paths share the parameters: model-split for latency, and
    # also ZeRO-split over the data axes where a model shard passes 6 GiB
    params = registry.init_params(MetaGenerator(), cfg, torch.bfloat16,
                                  window_override=wo)
    per_dev_gib = cfg.param_count() * 2 / mesh.shape["model"] / GIB
    pspec = (shlib.zero1_specs(params, mesh, n_stacked=n_stacked)
             if per_dev_gib > 6.0 else shlib.param_specs(params, mesh))
    st = engine.init_serve(cfg, shape.global_batch, shape.seq_len,
                           torch.bfloat16, window_override=wo, device=META)
    sspec = engine.ServeState(shlib.cache_specs(st.cache, mesh, shape),
                              shlib.batch_specs(st.last_tokens, mesh, shape),
                              ())
    tst = _local_meta(st, sspec, mesh)
    if shape.mode == "prefill":
        batch = _tokens_long(registry.input_specs(cfg, shape))
        bspec = shlib.batch_specs(batch, mesh, shape)

        def prefill_step(p, b, s):
            return engine.prefill(p, cfg, b, s, window_override=wo)

        return Lowerable(prefill_step,
                         (params, _local_meta(batch, bspec, mesh), tst),
                         (params, batch, st), (pspec, bspec, sspec), info)

    # decode: ONE token against a seq_len cache (the last slot)
    tst = tst._replace(index=_cache_len(tst.cache) - 1)

    def decode_step(p, s):
        return engine.serve_step(p, cfg, s, window_override=wo)

    return Lowerable(decode_step, (params, tst), (params, st),
                     (pspec, sspec), info)


def _cohort_step(run: RunConfig, mesh, n: int, membership, batch):
    """The cohort superstep of one round on this rank of `mesh`, as
    step(state, batch), and this rank's meta batch of it."""
    ids = rdist.local_ids(mesh, membership)
    m = membership.n_active
    cohort = trainer.superstep_builder(run, mesh, n_nodes=n, device=META)(
        next(iter(batch.values())).shape[0], membership)
    tbatch = {k: torch.empty((len(ids), v.shape[0] // m, *v.shape[1:]),
                             dtype=v.dtype, device=META)
              for k, v in batch.items()}

    def step(state, b):
        return cohort(state, ids, {k: v[None] for k, v in b.items()})

    return step, tbatch


SERVING_REFUSAL = ("serving on a model axis is planned, not executed "
                   "(ROADMAP.md queue 1 item 7)")


def model_axis_refusal(mode: str, mesh) -> Optional[str]:
    """Why the port does not execute a step of `mode` ("train", "prefill"
    or "decode") over `mesh`'s model axis, or None where it does (every
    train step) or the mesh has no model axis: serving is planned there,
    not executed."""
    if mesh.shape.get("model", 1) <= 1 or mode == "train":
        return None
    return SERVING_REFUSAL


def _cache_len(cache) -> int:
    """The sequence length of the cache's K (or latent) leaves; 1 where it
    holds recurrent states only."""
    lens = []
    shlib.map_with_path(lambda p, leaf: lens.append(leaf.shape[1])
                        if shlib._leaf_name(p) in ("k", "ckv") else None,
                        cache)
    return lens[0] if lens else 1


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

# the messages' payload kinds, by the reference's names
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _add(coll: dict, kind: str, nbytes: float, count: int) -> None:
    coll[kind] = coll.get(kind, 0.0) + float(nbytes)
    coll[kind + ".count"] = coll.get(kind + ".count", 0) + int(count)


def _reduce_messages(nbytes: int) -> int:
    """`dist.all_reduce_`'s messages for a tensor of `nbytes` on the card
    (chunks of STAGE_BYTES)."""
    return max(1, -(-nbytes // rdist.STAGE_BYTES))


def _routing_gathers(coll: dict, run: RunConfig, mesh) -> None:
    """The exact mode's MoE routing of the global batch
    (`models/moe.py`): each MoE layer's forward, and its recompute under
    remat, all-gathers its [groups, E] int64 counts over the data group."""
    cfg = run.model
    if cfg.moe is None:
        return
    from repro_torch.models.moe import group_size
    from repro_torch.models.transformer import layer_specs
    E = rdist.n_data_nodes(mesh)
    tokens = run.shape.global_batch * run.shape.seq_len // run.microbatches
    n = tokens // group_size(tokens) * cfg.moe.num_experts
    calls = run.microbatches * (2 if run.remat else 1) * sum(
        spec.has_moe for spec in layer_specs(cfg))
    chunks = rdist.column_chunks(n, E, 8)
    _add(coll, "all-gather", calls * (1 + E) * n * 8 / 2,
         calls * len(chunks))


def node_axis_collectives(run: RunConfig, params: Tree, mesh,
                          n_nodes: Optional[int] = None, *,
                          membership=None, scheduled: bool = False) -> dict:
    """The payload bytes and messages that `dist.py` moves on this rank of
    `mesh` (its `rank`) for one train step of `run` on the node axis:
    {kind: payload bytes (half of what the rank sends and receives; an
    all-reduce's tensor once), kind + ".count": messages as `dist.stats`
    counts them on the card}. `params` are this rank's (its rows
    [n_local, ...] of the `n_nodes`-node axis, default one node per rank,
    or the exact mode's replica). Empty where the node axis is not split.

    The gossip mode's wire follows `core.mixing`'s routing: the shard
    rule's halo rows per round (the exact wire, or a quantized one with
    per-node statistics, f32 on the wire) where it covers the split
    (`kernels.ops.node_shard_info`), else one gather of the node rows per
    step. Over a model axis `params` are the rank's blocks of its rows,
    each model index mixes its own columns leaf by leaf (unpacked, as
    `core.averaging.resolve_packed` resolves), and only the node axis's
    messages are planned here (the model group's come from the trace,
    `plan`). Error feedback mixes f32 column chunks of `ef_chunk_width`
    columns (cut from n_nodes) linearly, each its own call, and sums its
    two norms in one all-reduce. The hierarchical mode reduce-scatters
    each pod's rows over the pod's ranks, gossips each lane's block
    between the pods over its lane (or gathers every block, where a
    quantized wire's tiles do not lie inside the blocks, and over a model
    axis) and all-gathers the pod's blocks (`core.averaging._hmix_shard`). `membership` (a
    partial `core.mixing.Membership`) plans an elastic run's cohort step:
    its wire over the cohort's row table (`dist.cohort_rows`).
    `scheduled` plans a scenario's `ScheduledMixOp`: one gather per step
    and buffer, and the round clock's all-reduce."""
    coll: dict = {}
    if rdist.n_data_nodes(mesh) <= 1:
        return coll
    metrics = 3  # loss, ce, aux, in one f32 all-reduce
    if run.averaging.mode == "exact":
        for p in tree_leaves(params):  # the f32 gradient, leaf by leaf
            nbytes = 4 * p.numel()
            _add(coll, "all-reduce", nbytes, _reduce_messages(nbytes))
        _add(coll, "all-reduce", 4 * metrics, 1)
        _routing_gathers(coll, run, mesh)
        return coll
    avg = run.averaging
    if avg.mode not in ("gossip", "hierarchical"):
        raise ValueError(f"unknown averaging mode {avg.mode!r}")
    from repro_torch.core.averaging import ef_chunk_width
    from repro_torch.core.quantize import STOCHASTIC
    leaves = tree_leaves(params)
    n = n_nodes or rdist.n_data_nodes(mesh)
    if membership is not None and not membership.is_full:
        table = rdist.cohort_rows(mesh, membership)
    else:
        table = rdist.row_table(mesh, n)
    m = table[-1][1]
    # a quantized wire with global statistics mixes leaf by leaf, and so
    # does every wire over a model axis
    from repro_torch.core.averaging import resolve_packed
    packed = resolve_packed(avg, mesh) and not (
        avg.quantization != "none" and avg.quant_stats == "global")
    bufs = (_buffers(leaves) if packed else
            [(p[0].numel(), p.element_size()) for p in leaves])
    if avg.mode == "hierarchical":
        if avg.quantization != "none" and not packed:
            # a quantized wire's stacked layers are one leaf
            bufs = [(sum(leaves[i][0].numel() for i in pool),
                     leaves[pool[0]].element_size())
                    for pool in trainer.layer_pools(params, run.model)]
        _hierarchical_wire(coll, avg, mesh, n, bufs,
                           rdist.n_local(mesh, n))
    elif avg.error_feedback != "off":
        # each f32 column chunk of each buffer is one linear mix (over a
        # model axis cut on the reference's columns)
        linear = dataclasses.replace(avg, quantization="none")
        if rdist.model_extent(mesh) > 1:
            chunks = [(b - a, 4) for a, b, _ in _model_ef_chunks(
                run, params, mesh, m)]
        else:
            chunks = [(b - a, 4) for width, _ in bufs
                      for a, b in _ef_chunks(width, ef_chunk_width(
                          m, width, avg.quant_block_d))]
        _gossip_wire(coll, linear, mesh, m, table, chunks)
        _add(coll, "all-reduce", 8, 1)  # ||e'||^2 and ||v||^2
    else:
        _gossip_wire(coll, avg, mesh, m, table, bufs, scheduled)
    for p in leaves:  # each leaf's f32 node mean, for the consensus error
        nbytes = 4 * p[0].numel()
        if nbytes:
            _add(coll, "all-reduce", nbytes, _reduce_messages(nbytes))
    pools = trainer.layer_pools(params, run.model)
    _add(coll, "all-reduce", 4 * len(pools), 1)  # the pools' max
    _add(coll, "all-reduce", 4 * metrics, 1)
    if scheduled or avg.quantization in STOCHASTIC:
        _add(coll, "all-reduce", 8, 1)  # the round clock, one int64
    return coll


def _ef_chunks(d: int, width: int) -> list:
    return [(a, min(a + width, d)) for a in range(0, d, width)]


def _model_ef_chunks(run: RunConfig, params: Tree, mesh, m: int) -> list:
    """Error feedback's chunks over a model axis, every packed group's in
    turn: (first, last + 1 local column, reference columns), as
    `core.averaging.ef_average_and_error` cuts them."""
    from repro_torch.core.averaging import _EFSlots, pack

    layout = trainer.leaf_layout(run.model, mesh)
    _, spec = pack(params, trainer.layer_pools(params, run.model))
    return [c for group in spec.groups for c in _EFSlots(
        group, layout, mesh, run.averaging, None, None).chunks(m)]


def _gossip_wire(coll: dict, avg: AveragingConfig, mesh, m: int, table,
                 bufs, scheduled: bool = False) -> None:
    """One mix of each (entries a node, bytes an entry) buffer of `bufs`
    over the m-row node axis split over `mesh` as `table` says: the shard
    rule's halo rows per round where it covers the split, else one gather
    of the node rows."""
    from repro_torch.core.mixing import schedule
    top = max(b - a for a, b in table)
    sched = schedule(avg.topology, m, avg.self_weight)
    # the shard rules run the exact wire and per-node statistics (over a
    # model axis a quantized wire gathers the node rows:
    # `core.averaging.quant_slot_mix`)
    routable = avg.quantization == "none" or (
        avg.quant_stats == "node" and rdist.model_extent(mesh) == 1)
    halo = (not scheduled and routable and m > 1
            and ops.node_shard_info(mesh, m, sched, table) is not None)
    if halo:
        ru, rd = halo_reach(sched, m)
        sent, out_rows, in_rows = halo_wire(table, ru, rd,
                                            rdist.node_index(mesh))
        quantized = avg.quantization != "none"
        # a rank with no row of the cohort sends and receives nothing
        for width, elem in bufs if out_rows + in_rows else ():
            if quantized:  # f32 on the wire, chunks on tile boundaries
                elem = 4
                chunks = rdist.column_chunks(
                    width, top, elem, multiple=min(avg.quant_block_d, width))
            else:
                chunks = rdist.column_chunks(width, top, elem)
            _add(coll, "collective-permute",
                 avg.rounds * (out_rows + in_rows) * width * elem / 2,
                 len(chunks) * avg.rounds * sent)
    elif m > 1:  # one gather of the node rows a step and buffer
        for width, elem in bufs:
            chunks = rdist.column_chunks(width, top, elem)
            _add(coll, "all-gather", (top + m) * width * elem / 2,
                 len(chunks))


def _hierarchical_wire(coll: dict, avg: AveragingConfig, mesh, n: int,
                       bufs, k: int) -> None:
    """The hierarchical mode's messages of one step on this rank (its k
    rows of n): per buffer of f entries a node, the pod's rows
    reduce-scattered over its lanes, the lane's block of k * chunk
    entries gossiped between the pods (or every block gathered), and the
    pod's all-gather of the mixed blocks."""
    from repro_torch.core.quantize import STOCHASTIC
    pods = rdist.n_pods(mesh)
    lanes = rdist.axis_extent(mesh, "pod")
    per_pod = n // pods
    lane = rdist.lane_mesh(mesh)
    for f, elem in bufs:
        if not f:
            continue
        chunk = -(-f // per_pod)
        d, width = chunk * per_pod, k * chunk
        if lanes > 1:  # reduce-scatter of the k rows, in their dtype
            for a, b in rdist.column_chunks(width, lanes * k, elem):
                _add(coll, "reduce-scatter", lanes * k * (b - a) * elem, 1)
        quantized = avg.quantization != "none"
        if quantized and (rdist.model_extent(mesh) > 1 or not (
                avg.quant_stats in ("tile", "node")
                and avg.quantization not in STOCHASTIC
                and width % min(avg.quant_block_d, d) == 0)):
            E = rdist.n_data_nodes(mesh)
            for a, b in rdist.column_chunks(width, 1, elem):
                _add(coll, "all-gather", (1 + E) * (b - a) * elem / 2, 1)
            continue
        if pods > 1:
            _gossip_wire(coll, avg, lane, pods, rdist.row_table(lane, pods),
                         [(width, elem)])
        if lanes > 1:  # the pod's all-gather of the mixed blocks
            for a, b in rdist.column_chunks(width, lanes, elem):
                _add(coll, "all-gather", (1 + lanes) * (b - a) * elem / 2,
                     1)


def publish_collectives(params: Tree, mesh) -> dict:
    """The messages of one publication of a decentralized run's consensus
    iterate on this rank of a split `mesh` (`train.trainer.publish_extract`
    over `params`, its [n_local, ...] rows): one f32 all-reduce of each
    leaf's masked row sum (`dist.node_leaf`: every leaf of the rank's
    rows); and the broadcast of rank 0's verdict and
    version (`serve.publisher`), a message without a tensor."""
    coll: dict = {}
    if rdist.n_data_nodes(mesh) <= 1:
        return coll
    for p in tree_leaves(params):
        if rdist.node_leaf(p):
            nbytes = 4 * p[0].numel()
            _add(coll, "all-reduce", nbytes, _reduce_messages(nbytes))
    _add(coll, "broadcast", 0, 1)
    return coll


def rejoin_collectives(state, mesh, n_nodes: int) -> dict:
    """The messages of one rejoin sync on this rank of `mesh`
    (`train.driver.StreamingDriver._sync_rejoined`), `state` the rank's
    (its rows [n_local, ...] of the `n_nodes`-node axis, over a model axis
    its blocks of them): where the node axis is split, one f32
    all-reduce over the data group of each node leaf's donor sum (one
    row), and one of the per-node optimizer steps' sum (a float64); none
    on one node shard (a 1 x M mesh included)."""
    coll: dict = {}
    if rdist.n_data_nodes(mesh) <= 1:
        return coll
    local = rdist.n_local(mesh, n_nodes)
    for p in _tensors(state):
        if p.dim() and p.shape[0] == local:
            nbytes = 4 * p[0].numel()
            _add(coll, "all-reduce", nbytes, _reduce_messages(nbytes))
    steps = getattr(getattr(state, "opt", None), "step", None)
    if isinstance(steps, tuple) and steps:  # one step a node
        _add(coll, "all-reduce", 8, 1)
    return coll


def snapshot_collectives(mesh) -> dict:
    """The training thread's messages of one snapshot on a split `mesh`:
    the broadcast of rank 0's verdict (`train.snapshot`). The state goes
    to disk, each rank its own rows, and the writers agree over their own
    group (file names, CRC32s, the outcome: objects, no tensor); over a
    model axis the writers also send each leaf's blocks to the rank that
    writes it, over groups of their own (`train.checkpoint`), not the
    training thread's."""
    coll: dict = {}
    if rdist.n_data_nodes(mesh) > 1:
        _add(coll, "broadcast", 0, 1)
    return coll


def _buffers(leaves) -> list:
    """(entries a node, bytes an entry) of each packed gradient buffer of
    these [n_local, ...] leaves: one a dtype, as `core.packing` packs."""
    widths: Dict[torch.dtype, list] = {}
    for p in leaves:
        w = widths.setdefault(p.dtype, [0, p.element_size()])
        w[0] += p[0].numel()
    return [tuple(w) for w in widths.values()]


def staged_bytes(coll: dict) -> float:
    """The bytes `dist.stats` counts for these messages: every payload out
    of the card and back in (a halo row sent and one received, an
    all-reduce's tensor staged out and back)."""
    return 2.0 * sum(coll.get(k, 0.0) for k in KINDS)


def traced_collectives(log: dict, axis: Optional[str] = None) -> dict:
    """The messages that a traced step sent (`dist.log`, over both axes
    or `axis`): {kind: half the bytes it stages out and in (an
    all-reduce's tensor once), kind + ".count": messages}."""
    coll: dict = {}
    for (ax, kind), (messages, wire) in sorted(log.items()):
        if axis is None or ax == axis:
            _add(coll, kind, wire / 2, messages)
    return coll


def model_axis_collectives(info: dict, log: Optional[dict] = None) -> dict:
    """The model axis's messages of one step on a mesh whose model extent
    is above 1. Where the trainer executes it (`log`: the trace's
    `dist.log`), what the traced step sent over the model group: the
    row splits' f32 all-reduces (each layer's two forward, the one remat
    recomputes, the column splits' two backward), the vocab split's
    (the embedding's, the loss's max and its sums, the unembedding's
    backward), the consensus error's, and where the extent cuts a head,
    its pieces' all-gathers (forward and remat) and reduce-scatters
    (backward). Elsewhere the two activation
    all-reduces per layer forward that a Megatron split of the
    placements needs, of this rank's [tokens, d_model] in bf16; training
    adds the backward's two and remat's recomputed forward's two: planned,
    not executed."""
    mesh, cfg, shape = info["mesh"], info["cfg"], info["shape"]
    if mesh.shape.get("model", 1) <= 1:
        return {}
    if log is not None:
        return traced_collectives(log, "model")
    ndp = rdist.n_data_nodes(mesh)
    B = shape.global_batch
    b_local = B if B < mesh.shape["data"] else -(-B // ndp)
    tokens = b_local * (1 if shape.mode == "decode" else shape.seq_len)
    layers = cfg.num_layers + (cfg.encoder_layers if cfg.is_encdec else 0)
    per_layer = 2
    if shape.mode == "train":
        run = info["run"]
        per_layer *= 3 if run.remat else 2
    count = per_layer * layers
    coll: dict = {}
    _add(coll, "all-reduce", count * tokens * cfg.d_model * 2, count)
    return coll


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------


def trace(low: Lowerable) -> dict:
    """One pass of `low.fn` under `PlanMode`: its counts, and the bytes it
    returns (`alias`: in the arguments' storages, `out`: new)."""
    mode = PlanMode()
    held = mode.hold(low.args)
    t0 = time.perf_counter()
    grad = (contextlib.nullcontext() if low.info["mode"] == "train"
            else torch.no_grad())
    rdist.reset_stats()
    with grad, mode:
        out = low.fn(*low.args)
    log = {k: list(v) for k, v in rdist.log.items()}
    rdist.reset_stats()
    seconds = time.perf_counter() - t0
    alias_ids = set()
    new_out = 0
    for t in _tensors(out):
        key = id(t.untyped_storage())
        if key in held:
            alias_ids.add(key)
        else:
            new_out += t.untyped_storage().nbytes()
    return {"mode": mode, "alias_ids": alias_ids, "new_out": new_out,
            "seconds": seconds, "log": log}


def _alias_bytes(low: Lowerable, alias_ids: set) -> int:
    """Planned bytes on a rank of the argument leaves the step returns in
    place."""
    total = [0]
    mesh = low.info["mesh"]

    def add(path, leaf, pleaf, spec):
        if (isinstance(leaf, torch.Tensor)
                and id(leaf.untyped_storage()) in alias_ids):
            total[0] += math.prod(shlib.local_shape(
                tuple(pleaf.shape), spec, mesh)) * pleaf.element_size()
        return None

    for a, p, s in zip(low.args, low.planned, low.specs):
        shlib.map_with_path(add, a, p, s)
    return total[0]


def plan(arch: str, shape_name: str, mesh, *, averaging: str = "exact",
         rounds: int = 1, topology: str = "ring", microbatches: int = 0,
         ring_cache: bool = False, remat: bool = True,
         master_weights: Optional[bool] = None,
         cfg: Optional[ModelConfig] = None,
         shape: Optional[ShapeConfig] = None,
         n_nodes: Optional[int] = None, membership=None,
         wire: Optional[dict] = None) -> dict:
    """The dry-run record of one combination on `mesh` (`run_dryrun`'s,
    for any config, shape and mesh); with a partial `membership`, of an
    elastic run's cohort step on the rank `mesh.rank`, where
    `build_lowerable` traces one; `wire` as `build_lowerable`'s (the
    quantized and error-feedback wires, whose slot all-reduces the trace
    of a model axis counts as "slot all-reduce" messages). Training starts
    with f32 masters
    and drops them, as the reference does, where the planned peak passes
    the card's memory (unless `master_weights` is given, or the mesh has a
    model axis)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    wo = window_override_for(arch, shape_name)
    if cfg.is_encdec:
        layer_trips = cfg.num_layers
    else:
        _, n_rep, _ = build_plan(cfg, wo)
        layer_trips = max(n_rep, 1)
    mb_eff = ((microbatches or TRAIN_MICROBATCHES.get(arch, 1))
              if shape.mode == "train" and averaging == "exact" else 1)
    rec = {"arch": arch, "shape": shape.name,
           # the trace runs every layer and microbatch (no scan): its
           # counts need no trip scaling
           "trips": {"microbatch": mb_eff, "layer_scan": layer_trips,
                     "scale": 1},
           "microbatches": (TRAIN_MICROBATCHES.get(arch, 1)
                            if shape.mode == "train" else 0),
           "mesh": mesh_name(mesh), "chips": mesh.size,
           "averaging": averaging, "rounds": rounds, "mode": shape.mode,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "window_override": wo, "ring_cache": ring_cache}
    card = card_memory_bytes()
    kw = dict(cfg=cfg, shape=shape, n_nodes=n_nodes, membership=membership,
              wire=wire)

    def once(master: bool):
        low = build_lowerable(arch, shape.name, mesh, averaging, rounds,
                              topology, microbatches, master, ring_cache,
                              remat, **kw)
        return low, trace(low)

    master = shape.mode == "train" if master_weights is None else master_weights
    low, tr = once(master)
    mem = _memory(low, tr)
    model = mesh.shape.get("model", 1)
    if (shape.mode == "train" and master_weights is None
            and (model == 1 or low.info["executed"])
            and mem["peak_gib"] * GIB > card):
        # f32 masters do not fit beside this model: bf16 weight updates
        # (on a model axis that is only planned the temporaries are an
        # unsplit upper bound, too loose to decide by)
        master = False
        low, tr = once(False)
        mem = _memory(low, tr)
    mode = tr["mode"]
    rec["master_weights"] = master
    rec["n_nodes"] = low.info.get("n_nodes", 1)
    rec["trace_s"] = round(tr["seconds"], 2)
    rec["memory"] = mem
    rec["card_memory_gib"] = card / GIB
    rec["fits"] = mem["peak_gib"] * GIB <= card
    executed = low.info.get("executed", False)
    rec["temp_unsplit_over_model"] = model > 1 and not executed
    rec["cost"] = {"flops": mode.flops, "bytes": mode.bytes}
    if executed:
        coll = traced_collectives(tr["log"])
    elif shape.mode == "train":
        coll = node_axis_collectives(low.info["run"], low.args[0].params,
                                     mesh, low.info["n_nodes"])
    else:
        coll = {}
    coll["hbm_bytes_est"] = mode.hbm_bytes_est
    rec["collectives"] = coll
    if executed:
        rec["collectives_model"] = model_axis_collectives(low.info,
                                                          tr["log"])
    elif model > 1:
        rec["model_axis_refused"] = model_axis_refusal(shape.mode, mesh)
    rec["collectives_planned"] = ({} if executed
                                  else model_axis_collectives(low.info))
    rec["staged_bytes"] = staged_bytes(coll)
    return rec


def _memory(low: Lowerable, tr: dict) -> dict:
    mesh = low.info["mesh"]
    argument = sum(shlib.local_bytes(p, s, mesh)
                   for p, s in zip(low.planned, low.specs))
    alias = _alias_bytes(low, tr["alias_ids"])
    new_out = tr["new_out"]
    temp = max(tr["mode"].peak - new_out, 0)
    output = alias + new_out
    return {"argument_gib": argument / GIB, "output_gib": output / GIB,
            "temp_gib": temp / GIB, "alias_gib": alias / GIB,
            # live per-rank working set: args + outputs - aliased + temps
            "peak_gib": (argument + output + temp - alias) / GIB}


# the CI size of tests/test_dryrun_small.py: the reduced config at this
# sequence length and global batch
REDUCED_SEQ, REDUCED_BATCH = 256, 8


def run_dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
               averaging: str = "exact", rounds: int = 1,
               topology: str = "ring", microbatches: int = 0,
               ring_cache: bool = False, remat: bool = True,
               print_analysis: bool = True, mesh=None,
               n_nodes: Optional[int] = None, reduced: bool = False) -> dict:
    """The record of (arch x shape) on the reference's production mesh as
    H100s (16 x 16, or 2 x 16 x 16 with `multi_pod`), or on `mesh` (an
    abstract mesh, e.g. `parse_mesh("1x1")` for one card). `reduced`
    plans the arch's reduced config at REDUCED_SEQ x REDUCED_BATCH."""
    mesh = mesh or abstract_mesh(*production_shape(multi_pod))
    cfg = shape = None
    if reduced:
        from repro_torch.configs import reduced as cut
        cfg = cut(get_config(arch))
        shape = dataclasses.replace(SHAPES[shape_name], seq_len=REDUCED_SEQ,
                                    global_batch=REDUCED_BATCH)
    rec = plan(arch, shape_name, mesh, averaging=averaging, rounds=rounds,
               topology=topology, microbatches=microbatches,
               ring_cache=ring_cache, remat=remat, n_nodes=n_nodes, cfg=cfg,
               shape=shape)
    if print_analysis:
        print(json.dumps(rec, indent=1))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="DxM or PxDxM in place of the production mesh "
                         "(1x1: one card)")
    ap.add_argument("--nodes", type=int, default=0,
                    help="decentralized nodes (default: the data extent)")
    ap.add_argument("--averaging", default="exact",
                    choices=["exact", "gossip", "hierarchical"])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--ring-cache", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help=f"the reduced config at {REDUCED_SEQ} tokens x "
                         f"{REDUCED_BATCH} sequences")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    rec = run_dryrun(args.arch, args.shape, multi_pod=args.multi_pod,
                     averaging=args.averaging, rounds=args.rounds,
                     topology=args.topology, microbatches=args.microbatches,
                     ring_cache=args.ring_cache, remat=not args.no_remat,
                     mesh=parse_mesh(args.mesh) if args.mesh else None,
                     n_nodes=args.nodes or None, reduced=args.reduced)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
