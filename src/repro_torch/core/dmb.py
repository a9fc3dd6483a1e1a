"""Algorithm 1 — the Distributed Mini-batch (DMB) algorithm [Dekel et al., 108].

Each round, B samples are split across N nodes; each node averages gradients
over its local B/N mini-batch; mini-batch gradients are *exactly* averaged
network-wide; every node applies the identical projected-SGD step.
Under-provisioned systems additionally discard mu samples per round at the
splitter (steps 9-11).

The reference runs one `lax.scan`; the port loops in Python, drawing each
round's samples from a `torch.Generator` seeded from `seed`, and stacks the
per-round metrics on the device. The state is rebound every round rather
than updated in place, so a metric that returns a view of it (a tree
leaf, say) keeps its round's value; at the paper's sizes (d + 1 = 6 or 21)
the copies cost nothing.

`w0` may be a tree (nested dicts, lists and tuples of tensors): it is packed
ONCE into a flat buffer (`core.packing`) before the loop, so the update /
projection / Polyak-average arithmetic runs on one contiguous vector;
`grad_fn`, `project` and `trace_metric` still see (and return) the original
tree structure, and the result is unpacked back to it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.dsgd import node_split
from repro_torch.device import DeviceLike, resolve_device


class DMBResult(NamedTuple):
    w: Any
    w_av: Any  # Polyak-Ruppert average (eq. 7, stepsize-weighted)
    trace_t_prime: torch.Tensor  # samples *arrived* (consumed + discarded)
    trace_metric: torch.Tensor


def run_dmb(
    grad_fn: Callable,  # grad_fn(w, *z_local) -> local mini-batch avg gradient
    draw: Callable,  # draw(generator, n) -> one round's samples
    w0: Any,
    *,
    N: int,
    B: int,
    mu: int = 0,
    steps: int,
    stepsize: Callable,  # stepsize(t) -> eta_t (a float), t starts at 1
    project: Optional[Callable] = None,
    trace_metric: Optional[Callable] = None,  # trace_metric(w) -> scalar
    seed: int = 0,
    device: DeviceLike = None,
) -> DMBResult:
    if B % N:
        raise ValueError(f"B={B} must split evenly across N={N} nodes "
                         f"(Section II-B)")
    dev = resolve_device(device)
    is_tree = not isinstance(w0, torch.Tensor)
    if is_tree:
        # pack the parameter tree once; user callables keep the tree view
        # through unpack/repack shims
        tree = packing.tree_map(lambda a: torch.as_tensor(a, device=dev), w0)
        bufs, spec = packing.pack_tree(tree, lead=0)
        if len(bufs) != 1:
            raise ValueError("a tree w0 must share a single dtype")
        unpack = lambda b: packing.unpack_tree((b,), spec)
        repack = lambda t: packing.pack_tree(t, spec)[0][0]
        user_grad, user_proj, user_metric = grad_fn, project, trace_metric
        grad_fn = lambda w, *z: repack(user_grad(unpack(w), *z))
        project = ((lambda w: repack(user_proj(unpack(w))))
                   if user_proj is not None else None)
        trace_metric = ((lambda w: user_metric(unpack(w)))
                        if user_metric is not None else None)
        w0 = bufs[0]
    metric = trace_metric or (lambda w: torch.zeros((), device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w = torch.as_tensor(w0, device=dev)
    w_av = torch.zeros_like(w)
    eta_sum = 0.0
    metrics = []
    for t in range(1, steps + 1):
        # the splitter receives B + mu samples and discards mu (step 10)
        parts = node_split(draw(gen, B + mu), N, B // N, take=B)
        in_dims = (None,) + (0,) * len(parts)
        g = torch.func.vmap(grad_fn, in_dims=in_dims)(w, *parts).mean(0)
        eta = stepsize(t)
        w = w - eta * g  # step 8
        if project is not None:
            w = project(w)
        # stepsize-weighted Polyak-Ruppert average (eq. 7)
        eta_sum_new = eta_sum + eta
        w_av = (eta_sum * w_av + eta * w) / eta_sum_new
        eta_sum = eta_sum_new
        metrics.append(metric(w))
    t_prime = torch.arange(1, steps + 1, device=dev) * (B + mu)
    trace = torch.stack(metrics) if metrics else torch.zeros((0,), device=dev)
    if is_tree:
        return DMBResult(unpack(w), unpack(w_av), t_prime, trace)
    return DMBResult(w, w_av, t_prime, trace)
