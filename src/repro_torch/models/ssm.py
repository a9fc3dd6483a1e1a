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

Under an installed model axis (`models/common.py` `mesh_rules`) a rank
holds the reference's blocks (`launch/sharding.py`): its columns of the
fused w_in [z | x | B | C | dt] and of the conv's channels [x | B | C],
and its rows of norm_scale and w_out over d_inner; A_log, D and dt_bias
stay whole. The rank computes the heads that overlap its rows of w_out,
whole (a head two ranks need runs on both, as the attention heads do).
Its in-projection's and its conv's column blocks do not line up with
those heads, so it projects and convolves its own columns and
all-gathers both over the model group (`gather_from_model`: each rank's
gradient of the joined columns is summed back to their owner); every
rank then takes B, C and its heads' x, z and dt. The gated RMSNorm's
statistic sums each rank's own columns' squares over the group, and so
does its gradient. The rows of w_out give an f32 partial that leaves
through one all-reduce, cast once (`layers._row_split`). A leaf the
extent does not divide stays whole, and a whole leaf used per head
(A_log, D, dt_bias; w_in or the conv where kept whole) enters through
`copy_to_model`, so its gradient sums over the group. Where the extent
does not divide d_inner every rank computes every head, the split leaves
joined first (`gather_columns`). A state (serving) over a split raises.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import model_extent, model_index
from repro_torch.models.common import (copy_to_model, current_mesh,
                                       dense_init, gather_columns,
                                       gather_from_model, reduce_from_model)
from repro_torch.models.layers import _is_block, _row_split

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


def _dual(xi, dt, A, Bm, Cm, chunk_size: int):
    """`ssd_chunked` of S positions in chunks of min(chunk_size, S), the
    last padded: (y [b, S, H, P] f32, final state)."""
    S = xi.shape[1]
    chunk = min(chunk_size, S)
    pad = -(-S // chunk) * chunk - S
    if pad:
        # padded steps have dt = 0: no decay, no input, the state holds
        xi = F.pad(xi, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    y, h = ssd_chunked(xi, dt, A, Bm, Cm, chunk)
    return y[:, :S], h


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
    if current_mesh() is not None:
        if state is not None:
            raise NotImplementedError(
                "an SSD state over a model axis: serving on a model axis "
                "(ROADMAP.md queue 1 item 7)")
        if _is_block(p["w_out"], 0, d_inner):
            return _split_ssd(p, cfg, x), None
        p = _joined(p, d_inner + conv_dim + nheads, conv_dim)

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
        y, h_new = _dual(xi, dt, A, Bm, Cm, s.chunk_size)
    if state is not None:
        state["h"].copy_(h_new)
        state["conv"].copy_(conv_tail)

    y = y + xi.to(y.dtype) * p["D"][:, None]
    y = y.reshape(B, S, d_inner).to(x.dtype)

    # gated RMSNorm (Mamba-2 norm-before-out)
    yf = y.float() * F.silu(z.float())
    yf = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-6)
    y = (yf * p["norm_scale"].float()).to(x.dtype)
    return y @ p["w_out"], state


def _joined(p: Params, width: int, conv_dim: int) -> Params:
    """The block's parameters with w_in's and the conv's split leaves
    joined (`gather_columns`): every rank then computes every head."""
    p = dict(p)
    for k, whole in (("w_in", width), ("conv_w", conv_dim),
                     ("conv_b", conv_dim)):
        if _is_block(p[k], -1, whole):
            p[k] = gather_columns(p[k])
    return p


def _split_ssd(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """`apply_ssd` without a state on the rank's heads, w_out and
    norm_scale split over the installed model axis (module docstring)."""
    s, d_inner, nheads = _dims(cfg)
    B, S, _ = x.shape
    G, N, P = s.ngroups, s.state_dim, s.head_dim
    conv_dim = d_inner + 2 * G * N
    m, i = model_extent(current_mesh()), model_index(current_mesh())
    width = p["w_out"].shape[0]
    r0 = i * width  # its rows of w_out
    h0, h1 = r0 // P, -(-(r0 + width) // P)  # the heads over them

    if _is_block(p["w_in"], -1, d_inner + conv_dim + nheads):
        zxbcdt = gather_from_model(copy_to_model(x) @ p["w_in"], m)
    else:
        zxbcdt = copy_to_model(x @ p["w_in"])
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    if _is_block(p["conv_w"], -1, conv_dim):
        c = p["conv_w"].shape[-1]
        conv, _ = causal_conv(xbc[..., i * c:(i + 1) * c], p,
                              s.conv_width, None)
        xbc = gather_from_model(F.silu(conv), m)
    else:
        whole = {k: copy_to_model(p[k]) for k in ("conv_w", "conv_b")}
        xbc = F.silu(causal_conv(xbc, whole, s.conv_width, None)[0])

    H = h1 - h0
    xi = xbc[..., h0 * P:h1 * P].reshape(B, S, H, P)
    # B and C of the groups the heads read (one per head where the heads
    # do not cover whole groups)
    rep = nheads // G
    if h0 % rep == 0 and h1 % rep == 0:
        take = slice(h0 // rep, h1 // rep)
    else:
        take = torch.arange(h0, h1, device=x.device) // rep
    Bm = xbc[..., d_inner:d_inner + G * N].reshape(B, S, G, N)[:, :, take]
    Cm = xbc[..., d_inner + G * N:].reshape(B, S, G, N)[:, :, take]
    per_head = copy_to_model(torch.cat([p["A_log"], p["D"], p["dt_bias"]]))
    A_log, Dh, dt_bias = (t[h0:h1] for t in per_head.split(nheads))
    A = torch.exp(A_log)
    dt0 = d_inner + conv_dim
    dt = F.softplus(zxbcdt[..., dt0 + h0:dt0 + h1].float() + dt_bias)

    y, _ = _dual(xi, dt, A, Bm, Cm, s.chunk_size)
    y = y + xi.to(y.dtype) * Dh[:, None]
    y = y.reshape(B, S, H * P).to(x.dtype)

    # gated RMSNorm over the rank's own columns, its statistic summed over
    # the group forward and backward
    lo = r0 - h0 * P
    z = zxbcdt[..., r0:r0 + width]
    yf = y[..., lo:lo + width].float() * F.silu(z.float())
    ss = copy_to_model(reduce_from_model(yf.square().sum(-1, keepdim=True)))
    yf = yf * torch.rsqrt(ss / d_inner + 1e-6)
    return _row_split((yf * p["norm_scale"].float()).to(x.dtype),
                      p["w_out"])


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
