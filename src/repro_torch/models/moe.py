"""Mixture-of-Experts: top-k router + sort-based capacity dispatch.

The port of `repro.models.moe`.  Each assignment is ranked inside its
expert by one stable sort and a running max (`_rank_in_expert`); an
expert keeps its first `capacity` assignments in token order (GShard
semantics) and the rest go to an overflow slot that is discarded.  The
(E, C, D) dispatch buffer is the one materialised intermediate; the expert
products are batched matrix products (`torch.bmm`), as the reference leaves
them to XLA, and the combine is an f32 `index_add_`.  DeepSeek's shared
experts are an always-on SwiGLU branch; the aux loss is Switch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import swiglu


def _rank_in_expert(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each assignment within its expert, in assignment order
    (int32): the stable sort groups an expert's assignments in order, and
    a running max of the group starts gives each one's offset."""
    tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(tk, dtype=torch.int32, device=flat_e.device)
    is_start = torch.ones(tk, dtype=torch.bool, device=flat_e.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - seg_start
    return rank


def route(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """(gates (T, E) f32, top-k weights renormalised (T, k), top-k experts
    (T, k)): logits in x's dtype, an f32 softmax, the k largest gates with
    ties to the lower expert (the order of `jax.lax.top_k`, by a stable
    descending sort)."""
    gates = torch.softmax((xt @ router.to(xt.dtype)).float(), dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[:, :top_k], idx[:, :top_k]
    top_vals = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9)
    return gates, top_vals, top_idx


def capacity_of(capacity_factor: float, top_k: int, t: int, n_experts: int) -> int:
    """Slots per expert: the reference's formula as written, a float ceil
    (by floor division of the negated product) with a floor of 4 so that a
    tiny decode batch never drops, and never more than the tokens."""
    capacity = int(max(4, -(-capacity_factor * top_k * t // n_experts)))
    return min(capacity, t)


def moe_block(
    x: torch.Tensor,            # (B, S, D)
    params,                     # router (D, E) f32, w_gate / w_up (E, D, F), w_down (E, F, D)
    n_experts: int,
    top_k: int,
    capacity_factor: float,
    n_shared: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D) in x's dtype, aux load-balance loss f32)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    gates, top_vals, top_idx = route(xt, params["router"], top_k)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = gates.mean(0)
    ce = F.one_hot(top_idx[:, 0], n_experts).float().mean(0)
    aux = n_experts * (me * ce).sum()

    capacity = capacity_of(capacity_factor, top_k, t, n_experts)
    flat_e = top_idx.reshape(-1).int()                          # (T*k,)
    flat_w = top_vals.reshape(-1)
    flat_t = torch.arange(t, device=x.device).repeat_interleave(top_k)
    rank = _rank_in_expert(flat_e, n_experts)
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank, n_experts * capacity).long()

    # dispatch: token rows into the (E * C [+ 1 overflow], D) buffer
    buf = torch.zeros((n_experts * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xt[flat_t]
    buf = buf[:-1].reshape(n_experts, capacity, d)

    g = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    y = torch.bmm(F.silu(g) * u, params["w_down"]).reshape(n_experts * capacity, d)
    y = torch.cat([y, y.new_zeros(1, d)])

    # combine: gather back, weight, add per token in f32
    contrib = y[slot].float() * flat_w[:, None]
    contrib = torch.where(keep[:, None], contrib, 0.0)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, flat_t, contrib)
    out = out.to(x.dtype)
    if n_shared:
        out = out + swiglu(xt, params["shared_gate"], params["shared_up"],
                           params["shared_down"])
    return out.reshape(b, s, d), aux
