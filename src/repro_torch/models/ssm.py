"""Mamba-2 SSD (state-space duality) block of the port. [arXiv:2405.21060]

A prefill (or a training step) runs the chunked dual form: quadratic within
chunks of `chunk_size` positions, linear across chunks through a state
recurrence, here a Python loop over the chunks (the reference's
`lax.scan`), never over tokens. A decode step is the O(1) recurrent update
on a persistent state. The reference's einsums are jnp code, not a Pallas
kernel, so the port keeps them as plain PyTorch; torch's einsum takes one
dtype, so each product casts its operands to the type jnp would promote
them to (a bf16 model keeps its [C B^T] products in bf16 and its decays,
scores and states in f32, as the reference does).

A state passed in is updated IN PLACE (the reference returns a new one):
{"h": [B, H, P, N] f32, "conv": [B, W - 1, conv_dim]}.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import dense_init

Params = Dict[str, Any]


def _dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    return s, d_inner, nheads


def init_ssd(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    """The block's parameters; `A_log`, `D` and `dt_bias` are f32 whatever
    `dtype` is, as in the reference."""
    s, d_inner, nheads = _dims(cfg)
    d = cfg.d_model
    conv_dim = d_inner + 2 * s.ngroups * s.state_dim
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # fused input projection: [z (gate), x, B, C, dt]
        "w_in": dense_init(gen, (d, 2 * d_inner + 2 * s.ngroups * s.state_dim
                                 + nheads), dtype),
        "conv_w": dense_init(gen, (s.conv_width, conv_dim), dtype,
                             fan_in=s.conv_width),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
        "D": torch.ones((nheads,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((nheads,), 0.01, **f32))),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=dev),
        "w_out": dense_init(gen, (d_inner, d), dtype, fan_in=d_inner),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} x[..., k]
    (-inf for j > i)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """SSD dual form. x: [b, S, H, P]; dt: [b, S, H] f32; A: [H] f32
    (positive; decay = exp(-dt * A)); Bm, Cm: [b, S, G, N], S a multiple of
    `chunk`. Returns (y [b, S, H, P] f32, final_state [b, H, P, N] f32)."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk
    rep = H // G

    xs = x.reshape(b, nc, chunk, H, P)
    dts = dt.reshape(b, nc, chunk, H)
    Bs = Bm.reshape(b, nc, chunk, G, N)
    Cs = Cm.reshape(b, nc, chunk, G, N)

    dA = -dts * A  # [b, c, q, H] log-decay per step (negative)

    # intra-chunk (diagonal blocks): y = (C B^T o L) x, L from segsum of dA
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # [b, c, H, q, q]
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cs, Bs)  # [b, c, G, q, k]
    CB = CB.repeat_interleave(rep, dim=2)  # [b, c, H, q, k]
    # weight by dt_k (jnp promotes the x-dtype CB to f32 here)
    scores = CB.float() * L * dts.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xs.float())

    # chunk-final states: sum_k exp(sum_{j>k} dA_j) * dt_k * B_k x_k
    dA_cum = torch.cumsum(dA, dim=2)  # [b, c, q, H]
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # [b, c, q, H]
    Brep = Bs.repeat_interleave(rep, dim=3)  # [b, c, q, H, N]
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_to_end * dts,
                          Brep.float(), xs.float())  # [b, c, H, P, N]

    # inter-chunk recurrence over the chunk index: h_in[c] is the state
    # entering chunk c
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])  # [b, c, H]
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)  # [b, c, H, P, N]

    # contribution of the incoming state to each position (the reference
    # rounds the state to x's dtype for this product)
    state_decay = torch.exp(dA_cum)  # decay from chunk start to q inclusive
    Crep = Cs.repeat_interleave(rep, dim=3)  # [b, c, q, H, N]
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Crep.float(),
                         h_in.to(x.dtype).float(), state_decay)
    return (y_diag + y_off).reshape(b, S, H, P), h


def causal_conv(xbc: torch.Tensor, p: Params, W: int,
                state: Optional[Params]):
    """Causal depthwise conv over time: (conv [B, S, C], the last W - 1
    inputs when a state is kept, else None)."""
    S = xbc.shape[1]
    if state is None:
        pad = F.pad(xbc, (0, 0, W - 1, 0))
        tail = None
    else:
        pad = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
        tail = pad[:, -(W - 1):]
    conv = sum(pad[:, i: i + S] * p["conv_w"][i] for i in range(W))
    return conv + p["conv_b"], tail


def apply_ssd(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              state: Optional[Params] = None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: [B, S, D] -> (out [B, S, D], state). With a state, S == 1 is the
    O(1) decode step, and a longer S is a prefill from the state (the
    chunked form, which starts from zero as in the reference); both write
    the new state in place."""
    s, d_inner, nheads = _dims(cfg)
    B, S, D = x.shape
    G, N, P = s.ngroups, s.state_dim, s.head_dim
    conv_dim = d_inner + 2 * G * N

    zxbcdt = x @ p["w_in"]
    z, xbc, dt = torch.split(zxbcdt, [d_inner, conv_dim, nheads], dim=-1)
    conv, conv_tail = causal_conv(xbc, p, s.conv_width, state)
    xbc = F.silu(conv)

    xi, Bm, Cm = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    xi = xi.reshape(B, S, nheads, P)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)
    A = torch.exp(p["A_log"])  # [H] positive
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B, S, H]

    if S == 1 and state is not None:
        # O(1) recurrent decode step
        h = state["h"]  # [B, H, P, N] f32
        dec = torch.exp(-dt[:, 0] * A)  # [B, H]
        Brep = Bm[:, 0].repeat_interleave(nheads // G, dim=1).float()
        inj = torch.einsum("bh,bhn,bhp->bhpn", dt[:, 0], Brep,
                           xi[:, 0].float())
        h_new = h * dec[:, :, None, None] + inj
        Crep = Cm[:, 0].repeat_interleave(nheads // G, dim=1).float()
        y = torch.einsum("bhn,bhpn->bhp", Crep, h_new)[:, None]  # [B,1,H,P]
    else:
        chunk = min(s.chunk_size, S)
        Spad = -(-S // chunk) * chunk
        if Spad != S:
            # padded steps have dt = 0: no decay, no input, the state holds
            pad = Spad - S
            xi = F.pad(xi, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        y, h_new = ssd_chunked(xi, dt, A, Bm, Cm, chunk)
        y = y[:, :S]
    if state is not None:
        state["h"].copy_(h_new)
        state["conv"].copy_(conv_tail)

    y = y + xi[:, :S].to(y.dtype) * p["D"][:, None]
    y = y.reshape(B, S, d_inner).to(x.dtype)

    # gated RMSNorm (Mamba-2 norm-before-out)
    yf = y.float() * F.silu(z.float())
    yf = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-6)
    y = (yf * p["norm_scale"].float()).to(x.dtype)
    return y @ p["w_out"], state


def init_ssd_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                   device: DeviceLike = None) -> Params:
    s, d_inner, nheads = _dims(cfg)
    conv_dim = d_inner + 2 * s.ngroups * s.state_dim
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, nheads, s.head_dim, s.state_dim),
                         dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                            device=dev),
    }
