"""Tree optimizers for the LM trainer: SGD (with and without momentum), Adam,
and the paper's accelerated SGD (eqs. 9-11, Lan's method) on trees, plus
stepsize-weighted Polyak-Ruppert iterate averaging (eq. 7).

A tree is nested dicts and lists of tensors (`core.packing`). Every
optimizer keeps its moments (and masters) in f32 whatever the parameter
dtype. `update(grads, state, params) -> (params, state)` writes the new
moments, masters and parameters into the tensors it was given, where the
reference returns new trees: at 8B-class widths a second copy of the
optimizer state does not fit on the card beside the first. The arithmetic
is the reference's, operation for operation. The step counter is a Python
int, so the bias corrections and a schedule are host numbers and an update
never waits for the card.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.packing import tree_leaves, tree_map

Tree = Any


class OptState(NamedTuple):
    # the update's own step is an int; a state with the decentralized node
    # axis keeps one per node (`train.trainer.replicate_for_nodes`)
    step: Union[int, Tuple[int, ...]]
    m: Tree  # momentum / first moment / Nesterov v
    v: Tree  # second moment (Adam) or unused
    master: Tree = ()  # f32 master weights (mixed-precision training)
    # per-node error-feedback residuals for compressed gossip
    # (`core.averaging.ef_average_and_error`), in the gradient dtype; ()
    # unless AveragingConfig.error_feedback is on. The update rules never
    # touch it: the trainer attaches the new residual each step.
    ef_residual: Tree = ()


def _zeros_like_f32(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def init_optimizer(name: str, params: Tree, *, master_weights: bool = False,
                   error_feedback: bool = False) -> OptState:
    """Moments (and masters) in f32; with `error_feedback`, zero residuals
    in the parameters' dtype, which they pack beside the gradients in."""
    master = (tree_map(lambda p: p.to(torch.float32, copy=True), params)
              if master_weights else ())
    ef = tree_map(torch.zeros_like, params) if error_feedback else ()
    if name == "accel":
        # v iterate initialized at params (f32)
        v0 = tree_map(lambda p: p.to(torch.float32, copy=True), params)
        return OptState(0, v0, _zeros_like_f32(params), master, ef)
    return OptState(0, _zeros_like_f32(params), _zeros_like_f32(params),
                    master, ef)


def _f32(x: float) -> float:
    """A host number rounded to f32, as the reference computes it."""
    return float(np.float32(x))


def _one_minus_inv(beta: float) -> float:
    """1 - 1/beta in f32 arithmetic."""
    one = np.float32(1)
    return float(one - one / np.float32(beta))


def _each(fn: Callable, *trees: Tree) -> None:
    """`fn` on the matching leaves of same-structured trees, for its effect."""
    for leaves in zip(*(tree_leaves(t) for t in trees)):
        fn(*leaves)


def make_optimizer(name: str, lr: float, *, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                   momentum: float = 0.0,
                   lr_schedule: Optional[Callable] = None) -> Callable:
    """Returns update(grads, state, params) -> (params, state), in place."""

    def lr_at(step: int) -> float:
        base = lr_schedule(step) if lr_schedule is not None else 1.0
        return lr * base

    if name == "sgd":
        @torch.no_grad()
        def update(grads, state: OptState, params):
            step = state.step + 1
            eta = lr_at(step)

            def leaf(p, m, g):
                g32 = g.float()
                if momentum:
                    m.mul_(momentum).add_(g32)  # momentum * m + g
                    g32 = m
                p32 = p.float()
                p.copy_(p32 - eta * (g32 + weight_decay * p32))

            _each(leaf, params, state.m, grads)
            return params, state._replace(step=step)
        return update

    if name == "adam":
        @torch.no_grad()
        def update(grads, state: OptState, params):
            step = state.step + 1
            eta = lr_at(step)
            bc1 = _f32(1 - np.float32(b1) ** np.float32(step))
            bc2 = _f32(1 - np.float32(b2) ** np.float32(step))
            masters = state.master != ()

            def leaf(p, m, v, g, master=None):
                g32 = g.float()  # g itself when g is f32: not written
                m.mul_(b1).add_(g32 * (1 - b1))
                v.mul_(b2).add_(g32.square().mul_(1 - b2))
                del g32
                # delta = m_hat / (sqrt(v_hat) + eps) + wd * w
                delta = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
                target = master if masters else p
                if weight_decay:
                    delta.add_(target.float() * weight_decay)
                if masters:
                    # mixed precision: accumulate into f32 masters, cast out
                    master.sub_(delta.mul_(eta))
                    p.copy_(master)
                else:
                    p.copy_(p.float() - delta.mul_(eta))

            if masters:
                _each(leaf, params, state.m, state.v, grads, state.master)
            else:
                _each(leaf, params, state.m, state.v, grads)
            return params, state._replace(step=step)
        return update

    if name == "accel":
        # Paper eqs. (9)-(11) with beta_t = (t+1)/2: gradients must be
        # evaluated at u_t (`accel_point`).
        @torch.no_grad()
        def update(grads, state: OptState, params):
            step = state.step + 1
            beta = _f32((step + 1.0) / 2.0)
            keep = _one_minus_inv(beta)
            eta = lr_at(step)

            def leaf(w, v, g):
                v.sub_(eta * g.float())  # eq. 10 at u
                w.copy_(v / beta + keep * w.float())  # eq. 11

            _each(leaf, params, state.m, grads)
            return params, state._replace(step=step)
        return update

    raise ValueError(f"unknown optimizer {name!r}")


@torch.no_grad()
def accel_point(state: OptState, params: Tree) -> Tree:
    """u_t = beta^-1 v_t + (1 - beta^-1) w_t (eq. 9): where accelerated SGD
    takes its gradient. A new tree; nothing is written in place."""
    t = state.step + 1
    beta = _f32((t + 1.0) / 2.0)
    keep = _one_minus_inv(beta)
    u = iter([(v / beta + keep * w.float()).to(w.dtype)
              for v, w in zip(tree_leaves(state.m), tree_leaves(params))])
    return tree_map(lambda _: next(u), params)


class PolyakState(NamedTuple):
    eta_sum: float
    avg: Tree


def polyak_init(params: Tree) -> PolyakState:
    return PolyakState(0.0, _zeros_like_f32(params))


@torch.no_grad()
def polyak_update(state: PolyakState, params: Tree, eta: float) -> PolyakState:
    """avg <- (eta_sum * avg + eta * w) / (eta_sum + eta), in place."""
    s = _f32(np.float32(state.eta_sum) + np.float32(eta))
    _each(lambda a, p: a.copy_((state.eta_sum * a + eta * p.float()) / s),
          state.avg, params)
    return PolyakState(s, state.avg)
