"""Algorithm 2 — the D(M)-Krasulina family: distributed mini-batch Krasulina's
method for streaming 1-PCA, with mu discarded samples per round
(under-provisioned regime, Theorem 5) and the averaging of the per-node
pseudo-gradients xi as a first-class knob:

* **exact** (`run_dm_krasulina`, DM-Krasulina [75]): the mean over the node
  axis — Alg. 2 step 6 verbatim. All nodes share one iterate. This is the
  R -> infinity oracle of the gossip variant.
* **gossip** (`run_d_krasulina` with an `AveragingConfig`): each node keeps its
  own iterate; the xi's are averaged through the consensus engine
  (`core.mixing.CirculantMixOp`, optionally quantized per Section VI). On
  the card the per-node xi and all R gossip rounds fuse into one kernel
  (`kernels.ops.krasulina_xi_gossip`) when the wire is exact; a quantized
  wire runs `krasulina_xi` and then the `gossip_mix_quant` kernel, and a
  time-varying or dense operator (`ScheduledMixOp`, `DenseMixOp`: the
  scenario harness) runs `krasulina_xi` and then its matmul.

The per-node pseudo-gradient goes through `kernels.ops.krasulina_xi`, so the
hand-written kernels are on the hot path on the card (the plain PyTorch
versions serve the CPU).

`build_krasulina_superstep` packages K rounds for
`train.driver.StreamingDriver`, which provisions the PCA stream with the
governed splitter / prefetch ring / closed-loop (B, mu) governor (Fig. 3(c),
eq. 4). Where the reference scans a donated carry, the port loops in Python
and updates the iterate in place; each such place says so.

Over a mesh that splits the node axis across ranks (`repro_torch/dist.py`),
the superstep runs on each rank's node rows: w, the samples and the iterate
are [n_local, ...], xi stays node-local, the gossip rounds exchange halo
rows (`kernels.ops.sharded_krasulina_xi_gossip`), and the exact mean, the
node-mean iterate and the consensus spread are all-reduces. An elastic
run's cohort superstep there runs on each rank's active rows (the cohort's
row table, `dist.cohort_rows`: uneven, and a rank may hold none), with the
same rules over the m cohort rows and the reductions over the cohort.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.distributed import ReduceOp

from repro_torch import dist as rdist
from repro_torch.configs.base import AveragingConfig
from repro_torch.core.averaging import make_gossip_mix
from repro_torch.core.mixing import (CirculantMixOp, DenseMixOp,
                                     ScheduledMixOp)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import check_mesh, is_sharded, n_local
from repro_torch.kernels.ops import (krasulina_xi, krasulina_xi_gossip,
                                     sharded_krasulina_xi_gossip)


class KrasulinaResult(NamedTuple):
    w: torch.Tensor
    trace_t_prime: torch.Tensor
    trace_metric: torch.Tensor


class DKrasulinaResult(NamedTuple):
    w_nodes: torch.Tensor  # [N, d] final per-node iterates
    w: torch.Tensor  # [d] node-mean iterate (== w_nodes[i] in exact mode)
    trace_t_prime: torch.Tensor
    trace_metric: torch.Tensor  # metric of the node-mean iterate per round


def _resolve_fuse_xi(mix: CirculantMixOp, fuse_xi: Optional[bool],
                     device: DeviceLike) -> bool:
    """The combined xi+gossip kernel replaces `mix(xi)` on the card, where it
    keeps the consensus state in shared memory for all R rounds; on the CPU
    the MixOp's composed-schedule impl over the plain xi is the fast path.
    (The reference fuses on TPU only; the port's CUDA branch takes the TPU
    branch, or the card would never run the fused kernel.) Quantized configs
    never fuse, whatever `fuse_xi` asks: the fused kernel mixes an exact
    wire, and the compressor is nonlinear per round; nor do time-varying
    (`ScheduledMixOp`) or dense (`DenseMixOp`) operators, which have no
    circulant schedule for the kernel to take."""
    if isinstance(mix, (ScheduledMixOp, DenseMixOp)):
        return False
    if mix.quantization != "none":
        return False
    if fuse_xi is not None:
        return fuse_xi
    return resolve_device(device).type == "cuda"


def _gossip_xi(w: torch.Tensor, z: torch.Tensor, mix: CirculantMixOp,
               fused: bool, t: int) -> torch.Tensor:
    """Gossip-averaged pseudo-gradients: xi per node, R consensus rounds.
    The round counter `t` reaches the MixOp as its key: stochastic
    compressors fold it into the op's seed, so every step draws fresh
    per-round noise (deterministic ones ignore it). A time-varying
    `ScheduledMixOp` takes `t` itself as its schedule clock. Quantized
    configs run `mix(krasulina_xi(w, z))`: on the card, the `krasulina_xi`
    then the `gossip_mix_quant` kernel. On a sharded node axis the fused
    form is the shard rule (`sharded_krasulina_xi_gossip`: xi per rank,
    then the halo rounds), where it covers the layout."""
    if fused and getattr(mix, "mesh", None) is not None:
        if mix.impl == "shard":
            return sharded_krasulina_xi_gossip(w, z, mix.sched, mix.rounds,
                                               mix.mesh, mix.rows)
        fused = False  # a layout the rule does not cover: the op gathers
    if fused:
        return krasulina_xi_gossip(w, z, mix.sched, mix.rounds)
    h = krasulina_xi(w, z)
    if isinstance(mix, ScheduledMixOp):
        return mix(h, t=t)
    if isinstance(mix, DenseMixOp):
        return mix(h)  # linear only, no key to thread
    return mix(h, key=t)


def _check_averaging(averaging: AveragingConfig) -> None:
    """The PCA track averages one [N, d] vector — pod-structured hierarchical
    reduce-scatter has no meaning without a mesh; reject it loudly instead of
    silently running flat gossip with reinterpreted semantics."""
    if averaging.mode not in ("exact", "gossip"):
        raise ValueError(
            f"D-Krasulina supports exact|gossip averaging, got "
            f"{averaging.mode!r}")


def _zero_metric(w: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), device=w.device)


def _stack(metrics) -> torch.Tensor:
    return torch.stack(metrics) if metrics else torch.zeros((0,))


def run_d_krasulina(
    draw: Callable,  # draw(generator, n) -> z [n, d]
    w0: torch.Tensor,  # [d] common init
    *,
    N: int,
    B: int,
    mu: int = 0,
    steps: int,
    stepsize: Callable,  # stepsize(t) -> eta_t (Thm 5: c/(Q+t))
    averaging: Optional[AveragingConfig] = None,  # None -> exact (DM-Krasulina)
    mix=None,  # prebuilt consensus engine override
    trace_metric: Optional[Callable] = None,
    fuse_xi: Optional[bool] = None,  # None -> auto (fused kernel on CUDA)
    seed: int = 0,
    device: DeviceLike = None,
) -> DKrasulinaResult:
    """The D-Krasulina family: `averaging=None` (or mode="exact") is
    DM-Krasulina with exact xi averaging; a gossip `AveragingConfig`
    replaces step 6 with R rounds of circulant consensus through the MixOp
    engine, with per-node iterates. Samples come from `draw` with a
    `torch.Generator` seeded from `seed`, on `device`."""
    if B % N:
        raise ValueError(f"B={B} must split evenly over N={N} nodes")
    if averaging is not None:
        _check_averaging(averaging)
    dev = resolve_device(device)
    metric = trace_metric or _zero_metric
    exact = averaging is None or averaging.mode == "exact"
    t_prime = torch.arange(1, steps + 1, device=dev) * (B + mu)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w0 = torch.as_tensor(w0, device=dev)
    if not exact:
        if mix is None:
            mix = make_gossip_mix(averaging, N, device=dev)
        fused = _resolve_fuse_xi(mix, fuse_xi, dev)
    # the iterate is updated in place below (the reference donates its scan
    # carry); clone so the caller keeps w0
    w = w0.clone() if exact else w0.unsqueeze(0).repeat(N, 1)
    metrics = []
    for t in range(1, steps + 1):
        z = draw(gen, B + mu)[:B].reshape(N, B // N, -1)
        if exact:
            h = krasulina_xi(w, z).mean(0)  # steps 3-5, exact averaging (6)
        else:
            h = _gossip_xi(w, z, mix, fused, t)  # steps 3-6, consensus form
        w.add_(h, alpha=stepsize(t))  # step 7, in place
        metrics.append(metric(w if exact else w.mean(0)))
    if exact:
        return DKrasulinaResult(w.unsqueeze(0).expand(N, -1), w, t_prime,
                                _stack(metrics))
    return DKrasulinaResult(w, w.mean(0), t_prime, _stack(metrics))


def run_dm_krasulina(
    draw: Callable,
    w0: torch.Tensor,
    *,
    N: int,
    B: int,
    mu: int = 0,
    steps: int,
    stepsize: Callable,
    trace_metric: Optional[Callable] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> KrasulinaResult:
    """Exact-averaging DM-Krasulina (Alg. 2 as printed) — the R -> infinity
    oracle of the gossip family."""
    res = run_d_krasulina(draw, w0, N=N, B=B, mu=mu, steps=steps,
                          stepsize=stepsize, trace_metric=trace_metric,
                          seed=seed, device=device)
    return KrasulinaResult(res.w, res.trace_t_prime, res.trace_metric)


# ---------------------------------------------------------------------------
# Superstep integration (train.driver)
# ---------------------------------------------------------------------------


class KrasulinaState(NamedTuple):
    """Carry of the K-round PCA superstep: the iterate(s) and the global round
    counter t that Theorem 5's stepsize c/(Q+t) indexes."""

    w: torch.Tensor  # [d] (exact) or [N, d] (decentralized)
    t: int  # rounds completed


def init_krasulina_state(w0, averaging: AveragingConfig, n_nodes: int, *,
                         device: DeviceLike = None,
                         mesh=None) -> KrasulinaState:
    """Initial superstep carry on `device`: exact mode shares one iterate,
    gossip mode replicates it per node (on a sharded `mesh`, this rank's
    rows of the node axis). Always a fresh copy of w0, because the
    superstep updates `w` in place."""
    w0 = torch.as_tensor(w0, device=resolve_device(device)).clone()
    if averaging.mode != "exact":
        w0 = w0.unsqueeze(0).repeat(n_local(mesh, n_nodes), 1)
    return KrasulinaState(w0, 0)


def build_krasulina_superstep(averaging: AveragingConfig, n_nodes: int,
                              stepsize: Callable, *,
                              metric: Optional[Callable] = None,
                              mix=None,
                              fuse_xi: Optional[bool] = None,
                              device: DeviceLike = None,
                              mesh=None, rows=None) -> Callable:
    """The PCA superstep consumed by `train.driver.StreamingDriver` (pass it
    as `superstep_fn`).

    superstep(state, batches) -> (state, metrics): batches = {"z": ...} with a
    leading K axis — [K, B, d] in exact mode, [K, N, B/N, d] decentralized
    (the driver's splitter does the node split); metric leaves come back
    stacked [K], on the device. Metrics: `metric` of the node-mean iterate
    (or zeros) and the consensus spread max_n ||w_n - w_bar|| / ||w_bar||.
    `state.w` is updated in place (the reference donates its carry) and
    returned in the new state. `mix` overrides the consensus engine built
    from `averaging` (a `ScheduledMixOp` of the scenario harness, or a
    `DenseMixOp`).

    On a sharded `mesh` the batches and the iterate are this rank's rows:
    [K, B * n_local / N, d] in exact mode (`w` is every rank's copy of the
    one iterate), [K, n_local, B/N, d] decentralized. `rows` (a
    `dist.RowTable`) is the split of an elastic run's m-node cohort
    (`dist.cohort_rows`, n_nodes = m), where a rank may hold no row."""
    _check_averaging(averaging)
    dev = resolve_device(device)
    exact = averaging.mode == "exact"
    metric_fn = metric or _zero_metric
    sharded = is_sharded(mesh)
    n_rows = n_local(mesh, n_nodes)
    if not exact and mix is None:
        mix = make_gossip_mix(averaging, n_nodes, device=dev,
                              mesh=mesh if sharded else None, rows=rows)
    fused = False if exact else _resolve_fuse_xi(mix, fuse_xi, dev)

    def node_mean(x: torch.Tensor) -> torch.Tensor:
        """The mean over all nodes of x [rows, ...]."""
        if not sharded:
            return x.mean(0)
        return rdist.all_reduce_(x.sum(0), mesh).div_(n_nodes)

    def round_fn(w: torch.Tensor, t: int, z: torch.Tensor):
        if exact:
            zn = z.reshape(n_rows, z.shape[0] // n_rows, -1)
            w.add_(node_mean(krasulina_xi(w, zn)), alpha=stepsize(t))
            return metric_fn(w), torch.zeros((), device=w.device)
        h = _gossip_xi(w, z, mix, fused, t)
        w.add_(h, alpha=stepsize(t))  # in place
        wbar = node_mean(w)
        num = torch.linalg.vector_norm(w - wbar, dim=1)
        # a rank whose cohort rows are all out adds 0 to the max over ranks
        num = num.max() if num.numel() else num.new_zeros(())
        if sharded:
            num = rdist.all_reduce_(num.reshape(1), mesh, ReduceOp.MAX)[0]
        spread = num / (torch.linalg.vector_norm(wbar) + 1e-30)
        return metric_fn(wbar), spread

    def superstep(state: KrasulinaState, batches):
        w, t = state
        metrics, spreads = [], []
        for z in batches["z"]:
            t += 1
            m, spread = round_fn(w, t, z)
            metrics.append(m)
            spreads.append(spread)
        return KrasulinaState(w, t), {"metric": torch.stack(metrics),
                                      "consensus_err": torch.stack(spreads)}

    return superstep


def krasulina_superstep_builder(averaging: AveragingConfig, n_nodes: int,
                                stepsize: Callable, *,
                                metric: Optional[Callable] = None,
                                mix=None,
                                fuse_xi: Optional[bool] = None,
                                device: DeviceLike = None,
                                mesh=None) -> Callable[..., Callable]:
    """Bucket-keyed PCA superstep factory for the adaptive-B governor,
    consumable as `StreamingDriver(superstep_builder=...)`. The K-round loop
    derives every shape (K, the per-node share B/N) from its batch, so one
    superstep serves all buckets (docs/DESIGN.md §Adaptive batch buckets).

    `build(B, membership=None)`: a partial `core.mixing.Membership` asks for
    the cohort superstep — the same loop built (once per cohort size, then
    cached) at n_nodes = n_active, with the gossip schedule recomposed over
    the active cohort (docs/DESIGN.md §Elastic membership); the driver wraps
    it with the full-axis gather/scatter (`train.driver.elastic_superstep`).
    The prebuilt `mix` override only applies at full membership, since its
    operator is sized for the full node axis. On a sharded `mesh` a cohort
    superstep takes each rank's active rows and mixes over the cohort's row
    table (`dist.cohort_rows`), so it is built once per table, not per
    size. A model axis is refused: the PCA path has none."""
    if mesh is not None:
        check_mesh(mesh, "the PCA path")
    full = build_krasulina_superstep(averaging, n_nodes, stepsize,
                                     metric=metric, mix=mix, fuse_xi=fuse_xi,
                                     device=device, mesh=mesh)
    cohort_cache = {n_nodes: full}

    def build(B: int, membership=None) -> Callable:
        if membership is None or membership.is_full:
            return full
        m = membership.n_active
        table = (rdist.cohort_rows(mesh, membership) if is_sharded(mesh)
                 else None)
        key = m if table is None else table
        fn = cohort_cache.get(key)
        if fn is None:
            fn = build_krasulina_superstep(averaging, m, stepsize,
                                           metric=metric, fuse_xi=fuse_xi,
                                           device=device, mesh=mesh,
                                           rows=table)
            cohort_cache[key] = fn
        return fn

    return build


def theorem5_Q(d: int, kappa: float, sigma_B2: float, c: float, delta: float = 0.25):
    """Q1 + Q2 from Theorem 5 (eq. 22) — the stepsize offset."""
    e = math.e
    Q1 = 64 * e * d * kappa**4 * max(1.0, c**2) / delta**2 * math.log(4 / delta)
    Q2 = 512 * e**2 * d**2 * sigma_B2 * max(1.0, c**2) / delta**4 * math.log(4 / delta)
    return Q1 + Q2
