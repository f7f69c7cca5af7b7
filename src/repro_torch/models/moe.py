"""Mixture-of-Experts layer: a top-k router and a capacity-bounded
sort-gather dispatch, as the reference's ``models/moe.py``.

1. The router runs in float32: softmax over ``tokens @ router``, the top-k
   probabilities renormalised by their sum (floored at 1e-9).  Top-k breaks
   ties as ``jax.lax.top_k`` does, the lower expert index first (a stable
   descending sort; ``torch.topk`` promises no order among ties).
2. The flat (token, k) pairs are stable-sorted by expert id; each expert
   takes its first ``capacity`` pairs in token order and the rest drop
   (standard capacity-factor semantics: which tokens drop depends on the
   call's token count).
3. Per-expert products ``(E, C, d) @ (E, d, f)`` (``torch.bmm``; the
   reference's ``jnp.einsum`` runs outside any Pallas kernel too).
4. Combine: each token sums its kept experts' gated outputs in increasing
   expert order, starting from zero.  That is the order in which the
   reference's scatter-add into zeros meets them, and unlike
   ``index_add_`` on the card (atomics) it gives the same bits every run.

One dispatch group: the reference groups tokens by data-parallel shard
only under a mesh, which the port does not have yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.init import dense_init


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _expert_init(gen: torch.Generator, e: int, d_in: int, d_out: int,
                 device) -> torch.Tensor:
    return torch.stack([dense_init(gen, d_in, d_out, device)
                        for _ in range(e)])


def init_moe(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, act: str, device) -> dict:
    """Router (d, E) at std 0.02; ``w_up`` / ``w_gate`` (E, d, f) and
    ``w_down`` (E, f, d) fan-in initialised, a gate for the gated MLPs
    only."""
    p = {"router": dense_init(gen, d_model, num_experts, device, std=0.02),
         "w_up": _expert_init(gen, num_experts, d_model, d_ff, device),
         "w_down": _expert_init(gen, num_experts, d_ff, d_model, device)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = _expert_init(gen, num_experts, d_model, d_ff, device)
    return p


def capacity(num_tokens: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: ``ceil(N k / E) * factor``, rounded up to a
    multiple of 8 and at least 8.  The floor and the rounding are the
    reference's: they decide which tokens drop, so they are semantics."""
    c = _ceil_div(num_tokens * top_k, num_experts)
    c = int(c * capacity_factor)
    return max(8, _ceil_div(c, 8) * 8)


def route(router: torch.Tensor, tokens: torch.Tensor, top_k: int) -> tuple:
    """(probs (N, E), renormalised gates (N, k), expert ids (N, k)) in
    float32; ids of equal probabilities in increasing order."""
    logits = tokens.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :top_k], ids[:, :top_k]
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_ids


def load_balance_loss(probs: torch.Tensor, expert_ids: torch.Tensor,
                      top_k: int) -> torch.Tensor:
    """Switch-style ``E * sum_e mean(probs)_e * mean(one_hot(ids))_e / k``."""
    num_experts = probs.shape[-1]
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(F.one_hot(expert_ids, num_experts).to(
        torch.float32), dim=1), dim=0) / torch.full_like(me, top_k)
    return num_experts * torch.sum(me * ce)


def _dispatch_group(tokens: torch.Tensor, gate_vals: torch.Tensor,
                    expert_ids: torch.Tensor, num_experts: int, top_k: int,
                    cap: int) -> tuple:
    """Sort-gather dispatch of one token group.  Returns (xe (E, C, d),
    tok_idx (E, C), gates (E, C), slot (N, k)): the token of each slot (0
    where the slot is empty), its gate (0 there), and the slot
    ``e * C + c`` each (token, k) pair landed in (-1 where it dropped)."""
    n = tokens.shape[0]
    dev = tokens.device
    flat_expert = expert_ids.reshape(-1)
    flat_token = torch.arange(n, device=dev).repeat_interleave(top_k)
    flat_gate = gate_vals.reshape(-1)

    order = torch.argsort(flat_expert, stable=True)
    sorted_token = flat_token[order]
    sorted_gate = flat_gate[order]

    counts = torch.bincount(flat_expert, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(cap, device=dev)
    idx = starts[:, None] + slot[None, :]
    valid = slot[None, :] < torch.clamp_max(counts, cap)[:, None]
    idx = torch.clamp(idx, 0, n * top_k - 1)
    tok_idx = torch.where(valid, sorted_token[idx], 0)            # (E, C)
    gates = torch.where(valid, sorted_gate[idx],
                        torch.zeros((), dtype=sorted_gate.dtype, device=dev))
    xe = tokens[tok_idx.reshape(-1)].reshape(num_experts, cap, -1)

    # where each pair landed: its rank within its expert, kept below cap
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n * top_k, device=dev)
    within = rank - starts[flat_expert]
    pair_slot = torch.where(within < cap, flat_expert * cap + within,
                            torch.full_like(within, -1))
    return xe, tok_idx, gates, pair_slot.reshape(n, top_k)


def _combine(ye: torch.Tensor, expert_ids: torch.Tensor,
             pair_slot: torch.Tensor) -> torch.Tensor:
    """Each token's kept gated expert outputs summed in increasing expert
    order from zero: the reference's scatter-add order, deterministic."""
    d = ye.shape[-1]
    rows = ye.reshape(-1, d)
    order = torch.argsort(expert_ids, dim=-1, stable=True)
    slot = torch.gather(pair_slot, 1, order)
    kept = slot >= 0
    picked = rows[torch.clamp_min(slot, 0).reshape(-1)].reshape(
        *slot.shape, d)
    picked = torch.where(kept[..., None], picked,
                         torch.zeros((), dtype=ye.dtype, device=ye.device))
    out = torch.zeros((slot.shape[0], d), dtype=ye.dtype, device=ye.device)
    for j in range(slot.shape[1]):
        out = out + picked[:, j]
    return out


def apply_moe(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, act: str) -> tuple:
    """Returns (output (B, T, d) in ``x``'s dtype, the load-balance loss
    (a float32 scalar))."""
    b, t, d = x.shape
    n = b * t
    tokens = x.reshape(n, d)
    num_experts = params["router"].shape[-1]
    probs, gate_vals, expert_ids = route(params["router"], tokens, top_k)
    aux = load_balance_loss(probs, expert_ids, top_k)

    cap = capacity(n, top_k, num_experts, capacity_factor)
    xe, _, gates, pair_slot = _dispatch_group(tokens, gate_vals, expert_ids,
                                              num_experts, top_k, cap)
    if act in ("swiglu", "geglu"):
        g = torch.bmm(xe, params["w_gate"])
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * torch.bmm(xe, params["w_up"])
    else:
        h = F.gelu(torch.bmm(xe, params["w_up"]), approximate="tanh")
    ye = torch.bmm(h, params["w_down"])
    ye = ye * gates[..., None].to(ye.dtype)
    out = _combine(ye, expert_ids, pair_slot)
    return out.reshape(b, t, d).to(x.dtype), aux.to(torch.float32)
