"""RG-LRU recurrent block of the port (RecurrentGemma / Griffin).
[arXiv:2402.19427]

The block is Griffin's "recurrent block": two input branches (gate, main),
a short causal depthwise conv on the main branch, the RG-LRU

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),

and an output projection. A prefill (or a training step) runs the linear
recurrence as a log-depth scan over the sequence (`_rglru_scan`: ceil(log2
S) doubling steps of whole-tensor products, where the reference runs
`lax.associative_scan`); it never loops over tokens and never forms a
cumulative product that could overflow or underflow at long S. A decode
step is one O(1) state update. The reference has no Pallas kernel here, so
the port's code is plain PyTorch.

A state passed in is updated IN PLACE (the reference returns a new one):
{"h": [B, W] f32, "conv": [B, conv_width - 1, W]}.

Under an installed model axis (`models/common.py` `mesh_rules`) a rank
holds its block of the lru channels (`launch/sharding.py`): its columns
of w_gate_in, w_main_in, w_rec_gate, w_inp_gate and the conv, its
entries of conv_b and lam, and its rows of w_out. The gate and main
branches give its channels, and the depthwise conv runs on them with no
message. Its columns of the recurrence and input gates read the whole
conv'd main branch, which one all-gather over the model group joins
(`gather_from_model`: each rank's gradient of it is summed back to the
owners). The scan runs on its channels, and w_out's rows give an f32
partial that leaves through one all-reduce, cast once
(`layers._row_split`). A width the extent does not divide keeps the whole
block on every rank, with no message. A state (serving) over a split
raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RGLRUConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import model_extent
from repro_torch.models.common import (copy_to_model, current_mesh,
                                       dense_init, gather_from_model)
from repro_torch.models.layers import _is_block, _row_split
from repro_torch.models.ssm import causal_conv

Params = Dict[str, Any]

_C = 8.0  # Griffin's fixed exponent scale


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    """The block's parameters; `lam` is f32 whatever `dtype` is, as in the
    reference."""
    r: RGLRUConfig = cfg.rglru
    d = cfg.d_model
    w = r.lru_width or d
    # Lambda param: a = sigmoid(lam); init so that a^c lies in [0.9, 0.999]
    a_c = torch.linspace(0.9, 0.999, w, dtype=torch.float32,
                         device=gen.device) ** (1 / _C)
    return {
        "w_gate_in": dense_init(gen, (d, w), dtype),
        "w_main_in": dense_init(gen, (d, w), dtype),
        "conv_w": dense_init(gen, (r.conv_width, w), dtype,
                             fan_in=r.conv_width),
        "conv_b": torch.zeros((w,), dtype=dtype, device=gen.device),
        "w_rec_gate": dense_init(gen, (w, w), dtype),
        "w_inp_gate": dense_init(gen, (w, w), dtype),
        "lam": torch.log(a_c / (1 - a_c)),
        "w_out": dense_init(gen, (w, d), dtype, fan_in=w),
    }


def _gates(rec_gate: torch.Tensor, lam: torch.Tensor):
    """(a, sqrt(1 - a^2)) from the recurrence gate, a = sigmoid(lam)^(c r)."""
    log_a = _C * rec_gate * F.logsigmoid(lam)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return torch.exp(log_a), beta


def _linear_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + u_t from h_{-1} = 0 along axis 1: the doubling
    (Hillis-Steele) scan of the pairs (a, u) under (a1, u1) then (a2, u2)
    -> (a1 a2, a2 u1 + u2), the reference's combine. After the step of
    stride d, element t holds the composition of steps (t - 2d, t]."""
    S = a.shape[1]
    d = 1
    while d < S:
        u = torch.cat([u[:, :d], u[:, d:] + a[:, d:] * u[:, :-d]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return u


def _rglru_scan(x: torch.Tensor, rec_gate: torch.Tensor,
                inp_gate: torch.Tensor, lam: torch.Tensor,
                h0: Optional[torch.Tensor]):
    """x, gates: [B, S, W] f32. Returns (y [B, S, W], h_final [B, W])."""
    a, beta = _gates(rec_gate, lam)
    u = beta * (inp_gate * x)
    if h0 is not None:
        # fold the initial state in as a virtual first step
        u = torch.cat([h0[:, None, :], u], dim=1)
        a = torch.cat([torch.ones_like(h0)[:, None, :], a], dim=1)
    y = _linear_scan(a, u)
    if h0 is not None:
        y = y[:, 1:]
    return y, y[:, -1]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def apply_rglru(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: [B, S, D] -> (out [B, S, D], state). With a state, S == 1 is the
    O(1) decode step and a longer S a prefill from the state's h; both
    write the new state in place."""
    mesh = current_mesh()
    split = mesh is not None and _is_block(p["lam"], 0,
                                           cfg.rglru.lru_width or cfg.d_model)
    if split and state is not None:
        raise NotImplementedError(
            "an RG-LRU state over a model axis: serving on a model axis "
            "(ROADMAP.md queue 1 item 7)")
    if split:
        x = copy_to_model(x)
    gate = _gelu(x @ p["w_gate_in"])
    main, conv_tail = causal_conv(x @ p["w_main_in"], p,
                                   cfg.rglru.conv_width, state)

    mf = main.float()
    whole = (gather_from_model(main, model_extent(mesh)).float() if split
             else mf)
    rec_gate = torch.sigmoid(whole @ p["w_rec_gate"].float())
    inp_gate = torch.sigmoid(whole @ p["w_inp_gate"].float())

    if x.shape[1] == 1 and state is not None:
        a, beta = _gates(rec_gate[:, 0], p["lam"])
        h = a * state["h"] + beta * (inp_gate[:, 0] * mf[:, 0])
        y = h[:, None, :]
    else:
        h0 = state["h"] if state is not None else None
        y, h = _rglru_scan(mf, rec_gate, inp_gate, p["lam"], h0)
    if state is not None:
        state["h"].copy_(h)
        state["conv"].copy_(conv_tail)

    out = y.to(x.dtype) * gate
    return (_row_split(out, p["w_out"]) if split else out @ p["w_out"]), state


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device: DeviceLike = None) -> Params:
    r: RGLRUConfig = cfg.rglru
    w = r.lru_width or cfg.d_model
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, r.conv_width - 1, w), dtype=dtype,
                            device=dev),
    }
