"""Mixture-of-Experts FFN of the port: top-k routing with per-group capacity,
shared experts, and the load-balance auxiliary loss, from
`repro.models.moe`.

The reference dispatches through one-hot einsums ([G, t, E, C] tensors
that XLA lowers to all-to-all over an expert-sharded mesh). On one card
the port dispatches by index: each kept (token, k) assignment is written to
row (e, g, c) of an [E, G * C, D] buffer, the experts run as three batched
matmuls over that buffer (every capacity slot, filled or not, as the
reference's einsums compute them), and each token gathers its K rows back.
The assignments kept and dropped are exactly the reference's: queue
positions come from a cumulative count in (token, k) order, and an
assignment at position C or later is dropped with its gate zeroed.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.common import dense_init

Params = Dict[str, Any]

GROUP_TOKENS = 4096  # GShard-style dispatch group size


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    """{"router" [D, E] (f32 whatever `dtype`, as in the reference),
    "we_gate", "we_up" [E, D, F], "we_down" [E, F, D], and "shared"
    {"w_gate", "w_up" [D, S * F], "w_down"} with S shared experts}."""
    m: MoEConfig = cfg.moe
    d = cfg.d_model
    eff = m.expert_d_ff or cfg.d_ff
    p: Params = {
        "router": dense_init(gen, (d, m.num_experts), torch.float32),
        "we_gate": dense_init(gen, (m.num_experts, d, eff), dtype),
        "we_up": dense_init(gen, (m.num_experts, d, eff), dtype),
        "we_down": dense_init(gen, (m.num_experts, eff, d), dtype,
                              fan_in=eff),
    }
    if m.num_shared_experts:
        sd = m.num_shared_experts * eff
        p["shared"] = {
            "w_gate": dense_init(gen, (d, sd), dtype),
            "w_up": dense_init(gen, (d, sd), dtype),
            "w_down": dense_init(gen, (sd, d), dtype, fan_in=sd),
        }
    return p


def group_size(T: int) -> int:
    """Tokens per dispatch group: GROUP_TOKENS, or T if fewer, halved until
    it divides T."""
    group = min(GROUP_TOKENS, T)
    while T % group:
        group //= 2
    return group


def capacity(m: MoEConfig, group: int) -> int:
    """Slots per expert and group: C = max(K, int(cf * group * K / E))."""
    return max(m.top_k, int(m.capacity_factor * group * m.top_k
                            / m.num_experts))


def apply_moe(p: Params, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, D] in x's dtype, aux load-balance loss, a 0-dim
    f32 tensor).

    The router's logits are the reference's: x times the router rounded to
    x's dtype, accumulated in f32. Products of two bf16 numbers are exact in
    f32, so the f32 matmul of the upcast operands gives that sum; the copy
    is one [T, D] f32 activation, not a weight. The gates of a bf16 model
    are rounded to bf16 before they weigh the experts' outputs, as the
    reference's combine tensor is."""
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    group = group_size(T)
    G = T // group
    C = capacity(m, group)
    xt = x.reshape(T, D)

    logits = xt.float() @ p["router"].to(x.dtype).float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, K, dim=-1)  # [T, K], descending
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # queue position of each assignment in its expert's queue of its group,
    # counted in (token, k) order; positions >= C are dropped
    onehot = F.one_hot(expert.reshape(G, group * K), E)  # [G, t*K, E]
    pos = ((onehot.cumsum(1) - 1) * onehot).sum(-1).reshape(T, K)
    keep = pos < C
    gate = gate * keep

    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e, every
    # assignment counted, dropped ones too
    frac_tokens = onehot.sum((0, 1)).float() / T
    aux = E * torch.sum(frac_tokens * probs.mean(0))

    # each assignment's row (e, g, c) of the experts' [E * G * C, D] buffer;
    # a dropped one writes to a spare last row and reads with gate 0. No
    # shape depends on the routing, so nothing waits for the card.
    g_of = torch.arange(T, device=x.device)[:, None] // group
    row = (expert * G + g_of) * C + pos.clamp(max=C - 1)  # [T, K]
    put = torch.where(keep, row, E * G * C).reshape(-1)
    xk = xt[:, None].expand(T, K, D).reshape(T * K, D)
    xe = x.new_zeros((E * G * C + 1, D)).index_put((put,), xk)
    xe = xe[:-1].reshape(E, G * C, D)
    h = F.silu(torch.bmm(xe, p["we_gate"])) * torch.bmm(xe, p["we_up"])
    ye = torch.bmm(h, p["we_down"]).reshape(E * G * C, D)
    w = gate.to(x.dtype).float()[..., None]  # [T, K, 1]
    y = (ye[row].float() * w).sum(1).to(x.dtype)

    if "shared" in p:
        sp = p["shared"]
        hs = F.silu(xt @ sp["w_gate"]) * (xt @ sp["w_up"])
        y = y + hs @ sp["w_down"]
    return y.reshape(B, S, D), aux
