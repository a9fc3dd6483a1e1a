"""Algorithms 3 & 4 — D-SGD and AD-SGD: distributed stochastic (accelerated)
gradient descent with *inexact* averaging via R rounds of averaging consensus
(eq. 17) over a doubly-stochastic mixing matrix A.

Decentralized-parameter model: every node keeps its own iterate; the state is
[N, d]. Consensus mixes the *gradients* (Alg. 3 steps 7-10). D-SGD additionally
maintains the stepsize-weighted Polyak-Ruppert average per node (step 13);
AD-SGD maintains the (u, v, w) Nesterov triple per node (Alg. 4).

The consensus goes through a MixOp: by default `core.mixing.DenseMixOp`,
whose R-round operator A^R is precomputed once outside the step loop, or any
operator passed as `mix` — a quantized `CirculantMixOp` runs the Section VI
wire (on the card, the `gossip_mix_quant` kernel).

Where the reference scans a donated carry under a top-level `jax.jit`
(`jit_driver`, with the `donation_supported` probe), the port loops in
Python: PyTorch runs eagerly, so that JAX machinery has no counterpart and
is not ported. The [N, d] state is rebound every step rather than updated
in place, so a metric that returns a view of it keeps its step's value; at
the paper's d + 1 = 21 the copies cost nothing. Per-node gradients map
`grad_fn` over the node axis with `torch.func.vmap` (the reference's
`jax.vmap`). Samples come from `draw(generator, n)` with a
`torch.Generator` seeded from `seed`; per-step metrics are stacked on the
device, with no host synchronisation per step.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.mixing import dense_mix_op
from repro_torch.device import DeviceLike, resolve_device


class DSGDResult(NamedTuple):
    w: torch.Tensor  # [N, d] final iterates
    w_av: torch.Tensor  # [N, d] Polyak averages (D-SGD) or final w (AD-SGD)
    trace_t_prime: torch.Tensor
    trace_metric: torch.Tensor  # metric of node 0's averaged iterate


def consensus(h: torch.Tensor, A: torch.Tensor, rounds: int) -> torch.Tensor:
    """R rounds of averaging consensus: h <- A h (eq. 17). h: [N, d].

    Per-round oracle form — `core.mixing.dense_mix_op` matches this to
    float accuracy with a single precomputed matmul."""
    for _ in range(rounds):
        h = A @ h
    return h


def _zero_metric(w: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), device=w.device)


def _stack(metrics, device) -> torch.Tensor:
    return torch.stack(metrics) if metrics else torch.zeros((0,), device=device)


def node_split(z, N: int, per_node: int, take: Optional[int] = None):
    """One round's samples (a tensor or a tuple of tensors, leading axis the
    sample) -> a tuple of [N, per_node, ...] tensors, after keeping the
    first `take` samples (the splitter's discard)."""
    parts = z if isinstance(z, (tuple, list)) else (z,)
    return tuple((a if take is None else a[:take])
                 .reshape(N, per_node, *a.shape[1:]) for a in parts)


def node_grads(grad_fn: Callable, w_nodes: torch.Tensor, parts) -> torch.Tensor:
    """grad_fn(w_n, *z_n) for every node n: [N, d]."""
    return torch.func.vmap(grad_fn)(w_nodes, *parts)


def _setup(w0, N: int, seed: int, device: DeviceLike):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w0 = torch.as_tensor(w0, device=dev)
    return dev, gen, w0.unsqueeze(0).repeat(N, 1)


def run_dsgd(
    grad_fn: Callable,  # grad_fn(w, *z) -> gradient for one node's local batch
    draw: Callable,  # draw(generator, n) -> one round's samples
    w0: torch.Tensor,  # [d] common init
    A,  # [N, N] doubly-stochastic mixing matrix (numpy or tensor)
    *,
    B: int,
    rounds: int,  # R consensus rounds per iteration
    steps: int,
    stepsize: Callable,  # stepsize(t) -> eta_t (a float), t starts at 1
    project: Optional[Callable] = None,
    trace_metric: Optional[Callable] = None,
    accelerated: bool = False,
    beta: Optional[Callable] = None,  # AD-SGD beta_t (default (t+1)/2)
    mix: Optional[Callable] = None,  # override the consensus engine
    seed: int = 0,
    device: DeviceLike = None,
) -> DSGDResult:
    N = A.shape[0]
    if B % N:
        raise ValueError(f"B={B} must split evenly over N={N} nodes")
    dev, gen, w = _setup(w0, N, seed, device)
    proj = torch.func.vmap(project) if project is not None else None
    metric = trace_metric or _zero_metric
    beta_fn = beta or (lambda t: (t + 1.0) / 2.0)
    # the R-round operator, precomputed ONCE outside the step loop
    mix = mix if mix is not None else dense_mix_op(A, rounds, device=dev)
    t_prime = torch.arange(1, steps + 1, device=dev) * B
    metrics = []

    if not accelerated:
        w_av = torch.zeros_like(w)
        eta_sum = 0.0
        for t in range(1, steps + 1):
            g = node_grads(grad_fn, w, node_split(draw(gen, B), N, B // N))
            h = mix(g)  # steps 7-10, one pass
            eta = stepsize(t)
            w = w - eta * h  # step 12
            if proj is not None:
                w = proj(w)
            eta_sum_new = eta_sum + eta
            w_av = (eta_sum * w_av + eta * w) / eta_sum_new  # step 13
            eta_sum = eta_sum_new
            metrics.append(metric(w_av[0]))
        return DSGDResult(w, w_av, t_prime, _stack(metrics, dev))

    v = w
    for t in range(1, steps + 1):
        b = beta_fn(t)
        u = v / b + (1.0 - 1.0 / b) * w  # step 2 (eq. 9)
        g = node_grads(grad_fn, u, node_split(draw(gen, B), N, B // N))
        h = mix(g)  # steps 8-11, one pass
        v = u - stepsize(t) * h  # step 13 (eq. 10)
        if proj is not None:
            v = proj(v)
        w = v / b + (1.0 - 1.0 / b) * w  # step 14 (eq. 11)
        metrics.append(metric(w[0]))
    return DSGDResult(w, w, t_prime, _stack(metrics, dev))


def run_local_sgd(grad_fn, draw, w0, *, N, B, steps, stepsize, project=None,
                  trace_metric=None, seed=0,
                  device: DeviceLike = None) -> DSGDResult:
    """The paper's `local` baseline: nodes run SGD on their own streams with no
    collaboration (A = I, R = 0)."""
    return run_dsgd(grad_fn, draw, w0, torch.eye(N), B=B, rounds=0,
                    steps=steps, stepsize=stepsize, project=project,
                    trace_metric=trace_metric, seed=seed, device=device)


def run_dgd(
    grad_fn, draw, w0, A, *, B, steps, stepsize, project=None,
    trace_metric=None, mode: str = "minibatched", rho: float = 1.0,
    mix: Optional[Callable] = None, seed: int = 0,
    device: DeviceLike = None,
) -> DSGDResult:
    """Communications-constrained DGD adaptation (Section V-C, eq. 18):
    one consensus round on the *iterates* per step, gradient on local data.

    mode="naive": discards samples that arrive during comm rounds (keeps B/N=1
    sample per node per step, drops the rest implied by rho).
    mode="minibatched": local mini-batch of size B/N = 1/rho per step.
    """
    if mode not in ("naive", "minibatched"):
        raise ValueError(f"unknown DGD mode {mode!r}")
    N = A.shape[0]
    dev, gen, w = _setup(w0, N, seed, device)
    metric = trace_metric or _zero_metric
    proj = torch.func.vmap(project) if project is not None else None
    Bn = max(1, B // N) if mode == "minibatched" else 1
    mix = mix if mix is not None else dense_mix_op(A, 1, device=dev)
    metrics = []
    for t in range(1, steps + 1):
        g = node_grads(grad_fn, w, node_split(draw(gen, N * Bn), N, Bn))
        w = mix(w) - stepsize(t) * g  # eq. (18)
        if proj is not None:
            w = proj(w)
        metrics.append(metric(w[0]))
    # in the naive mode the system still *receives* B samples per step
    t_prime = torch.arange(1, steps + 1, device=dev) * B
    return DSGDResult(w, w, t_prime, _stack(metrics, dev))
