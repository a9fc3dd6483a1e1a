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

Under an installed model axis (`models/common.py` `mesh_rules`) the
routing is replicated: the residual stream is whole on every rank, so
each computes the same router logits, top-k, queue positions, drops and
aux loss. The experts take the layout of the rank's blocks
(`launch/sharding.py`): split on E (expert-parallel), a rank dispatches
only its experts' assignments, the others going to the spare row as
dropped ones do; split on F (the reference's `_ALT_SPECS` where the
extent does not divide E), every rank dispatches every expert through
its columns of we_gate and we_up and its rows of we_down. Either way a
rank combines an f32 partial [T, D] of its share, the shared experts'
partial (split as the dense FFN) is added, and one f32 all-reduce over
the model group sums them, cast once: the reference's GSPMD all-to-all
becomes one all-reduce per layer forward. The dispatched tokens and the
gates enter the split through `copy_to_model`, since each rank's
gradient of them covers only its share. Experts the extent divides
neither way stay whole on every rank, with no message.

In the exact mode over D > 1 data ranks (`models/common.py`
`global_batch`) the ranks' batches are the consecutive shares of one
global batch, and the routing is the reference's for that batch: the
group and the capacity come from the T * D global tokens (a group may
straddle two ranks part-way), each assignment's queue position counts
the assignments of the lower data ranks in its group and expert, and the
aux loss takes f_e from the global counts. Those come from one small
all-gather of the per-(group, expert) counts over the data group a layer
forward. A rank adds E * sum_e f_e * mean over its tokens of P_e, so the
mean over the ranks that the exact step takes is the reference's aux
loss, in value and in gradient (f_e carries none).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch import dist as rdist
from repro_torch.dist import model_index
from repro_torch.models.common import (batch_mesh, copy_to_model,
                                       current_mesh, dense_init,
                                       reduce_from_model)
from repro_torch.models.layers import _is_block

Params = Dict[str, Any]

GROUP_TOKENS = 4096  # GShard-style dispatch group size

_DROPS: List[Optional[list]] = [None]


@contextlib.contextmanager
def count_drops():
    """Collect, into the yielded list, each MoE layer call's count of
    dropped assignments (a 0-dim int64 tensor on the layer's device, read
    without a sync). A checkpointed layer's recompute counts again, so
    count on a forward without remat."""
    prev, _DROPS[0] = _DROPS[0], []
    try:
        yield _DROPS[0]
    finally:
        _DROPS[0] = prev


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


def expert_split(p: Params, cfg: ModelConfig) -> Optional[int]:
    """The dim of the experts' [E, D, F] leaves that the installed model
    axis splits on this rank: 0, its experts (the reference's placement);
    -1, its columns of every expert (`_ALT_SPECS`); None, all of them (no
    model axis, or one whose extent divides neither E nor F)."""
    if current_mesh() is None:
        return None
    m = cfg.moe
    if _is_block(p["we_gate"], 0, m.num_experts):
        return 0
    eff = m.expert_d_ff or cfg.d_ff
    return -1 if _is_block(p["we_gate"], -1, eff) else None


def apply_moe(p: Params, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, D] in x's dtype, aux load-balance loss, a 0-dim
    f32 tensor).

    The router's logits are the reference's: x times the router rounded to
    x's dtype, accumulated in f32. Products of two bf16 numbers are exact in
    f32, so the f32 matmul of the upcast operands gives that sum; the copy
    is one [T, D] f32 activation, not a weight. The gates of a bf16 model
    are rounded to bf16 before they weigh the experts' outputs, as the
    reference's combine tensor is. Over a model axis that splits the
    experts, this rank's share as the module docstring says."""
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    data = batch_mesh()
    n_data = 1 if data is None else rdist.n_data_nodes(data)
    group = group_size(T * n_data)
    C = capacity(m, group)
    xt = x.reshape(T, D)
    split = expert_split(p, cfg)

    logits = xt.float() @ p["router"].to(x.dtype).float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, K, dim=-1)  # [T, K], descending
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # queue position of each assignment in its expert's queue of its group,
    # counted in (token, k) order; positions >= C are dropped. The rank's
    # tokens are global tokens [t0, t0 + T), in groups g0 .. g0 + G - 1:
    # padded to whole groups, the first from its offset `lead`.
    t0 = 0 if data is None else rdist.node_index(data) * T
    g0, lead = divmod(t0, group)
    G = -(-(lead + T) // group)
    onehot = F.one_hot(expert.reshape(T * K), E)  # [T*K, E]
    padded = F.pad(onehot, (0, 0, lead * K, (G * group - lead - T) * K))
    counts = padded.reshape(G, group * K, E)
    pos = counts.cumsum(1).reshape(G * group * K, E)
    pos = pos[lead * K:(lead + T) * K] - 1
    counts = counts.sum(1)  # [G, E]
    if data is not None:
        # the lower data ranks' assignments to each group's queues, from
        # every rank's counts of the T * n_data global tokens' groups
        every = counts.new_zeros((T * n_data // group, E))
        every[g0:g0 + G] = counts
        every = rdist.all_gather_dim(every[None], data, 0).reshape(
            n_data, -1, E)
        below = every[:rdist.node_index(data)].sum(0)[g0:g0 + G]
        g_of = (lead + torch.arange(T, device=x.device)) // group
        pos = pos + below[g_of].repeat_interleave(K, dim=0)
        counts = every.sum((0, 1))
    else:
        counts = counts.sum(0)
    pos = (pos * onehot).sum(-1).reshape(T, K)
    keep = pos < C
    gate = gate * keep
    if _DROPS[0] is not None:
        _DROPS[0].append((~keep).sum())

    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e, every
    # assignment counted, dropped ones too; f_e over the global batch
    frac_tokens = counts.float() / (T * n_data)
    aux = E * torch.sum(frac_tokens * probs.mean(0))

    # each assignment's row (e, g, c) of the experts' [E * G * C, D] buffer
    # (over the rank's E' experts where the model axis splits them on E);
    # a dropped one, or one of another rank's experts, writes to a spare
    # last row and reads with gate 0. No shape depends on the routing, so
    # nothing waits for the card.
    w = gate.to(x.dtype).float()  # [T, K]
    if split is not None:
        xt_in, w = copy_to_model(xt), copy_to_model(w)
    else:
        xt_in = xt
    n_exp = p["we_gate"].shape[0]
    g_of = (lead + torch.arange(T, device=x.device))[:, None] // group
    row = (expert * G + g_of) * C + pos.clamp(max=C - 1)  # [T, K]
    rows = n_exp * G * C
    if split == 0:
        e0 = model_index(current_mesh()) * n_exp
        own = (expert >= e0) & (expert < e0 + n_exp)
        keep = keep & own
        w = w * own
        row = (row - e0 * G * C).clamp(0, rows - 1)
    put = torch.where(keep, row, rows).reshape(-1)
    xk = xt_in[:, None].expand(T, K, D).reshape(T * K, D)
    xe = x.new_zeros((rows + 1, D)).index_put((put,), xk)
    xe = xe[:-1].reshape(n_exp, G * C, D)
    h = F.silu(torch.bmm(xe, p["we_gate"])) * torch.bmm(xe, p["we_up"])
    if split == -1:  # the rank's columns of h: an f32 partial
        ye = torch.bmm(h.float(), p["we_down"].float())
    else:
        ye = torch.bmm(h, p["we_down"])
    routed = (ye.reshape(rows, D)[row].float() * w[..., None]).sum(1)
    partial = None if split is None else routed
    y = routed.to(x.dtype) if split is None else None

    if "shared" in p:
        sp = p["shared"]
        if current_mesh() is not None and _is_block(
                sp["w_down"], 0, m.num_shared_experts * (m.expert_d_ff
                                                         or cfg.d_ff)):
            xs = copy_to_model(xt)
            hs = F.silu(xs @ sp["w_gate"]) * (xs @ sp["w_up"])
            hs = hs.float() @ sp["w_down"].float()
            partial = hs if partial is None else partial + hs
        else:
            hs = F.silu(xt @ sp["w_gate"]) * (xt @ sp["w_up"])
            hs = hs @ sp["w_down"]
            y = hs if y is None else y + hs
    if partial is not None:
        out = reduce_from_model(partial).to(x.dtype)
        y = out if y is None else y + out
    return y.reshape(B, S, D), aux
