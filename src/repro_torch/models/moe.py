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
   reference's ``jnp.einsum`` runs outside any Pallas kernel too), one
   call for each of EXPERT_SPLITS equal blocks of the E experts: the
   library picks its algorithm by batch count, and on the H100 a decode
   step's products over 64 experts are not the same bits as over 128
   (``launch/row_probe --batches``), so blocks of E / EXPERT_SPLITS give
   a rank holding E / m experts, m = 1, 2 or 4, one device's calls and
   bits.
4. Combine: each token sums its kept experts' gated outputs in increasing
   expert order, starting from zero.  That is the order in which the
   reference's scatter-add into zeros meets them, and unlike
   ``index_add_`` on the card (atomics) it gives the same bits every run.

Dispatch groups (the reference's ``_num_groups``): under a mesh the tokens
are cut into ``groups`` contiguous blocks, one a data-parallel shard, and
steps 2-3 run per block with the capacity of a block's token count
(:func:`num_groups`: the "data" axis size, halved until it divides the
token count).  So a "data" axis changes which tokens drop.

Expert parallelism (experts over "model"): the router, routing, dispatch
and capacity run identically on every rank; a rank's expert leaves hold
its contiguous block of E / m experts, and it computes only their slice of
the dispatched slots.  Each rank writes the gated rows of the (token, k)
pairs its experts took into an (N, k, d) tensor, zeros elsewhere; ``reduce``
(a sum over "model") then gives every rank every pair's row exactly (x + 0
+ ... + 0), and the combine runs as unsharded.  That collective is N k d
floats a layer, where gathering the experts' outputs would be E C d.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.init import dense_init

EXPERT_SPLITS = 4   # the experts' products: a torch.bmm a quarter of them


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


def num_groups(n: int, data: int) -> int:
    """Dispatch groups of an ``n``-token call under a mesh whose
    data-parallel axes hold ``data`` shards: ``data`` halved until it
    divides ``n`` (the reference's ``_num_groups``; 1 without a mesh)."""
    g = data
    while g > 1 and n % g != 0:
        g //= 2
    return max(g, 1)


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


def _pair_rows(ye: torch.Tensor, pair_slot: torch.Tensor,
               first: int = 0) -> torch.Tensor:
    """(N, k, d): each (token, k) pair's gated expert output, read from
    ``ye`` (the slots of experts ``first`` .. ``first + ye.shape[0] - 1``),
    zero for a dropped pair and for a pair whose expert is not in ``ye``."""
    d = ye.shape[-1]
    rows = ye.reshape(-1, d)
    local = pair_slot - first * ye.shape[1]
    kept = (pair_slot >= 0) & (local >= 0) & (local < rows.shape[0])
    picked = rows[torch.where(kept, local, 0).reshape(-1)].reshape(
        *pair_slot.shape, d)
    return torch.where(kept[..., None], picked,
                       torch.zeros((), dtype=ye.dtype, device=ye.device))


def _combine(rows: torch.Tensor, expert_ids: torch.Tensor) -> torch.Tensor:
    """Each token's pair rows (N, k, d) summed in increasing expert order
    from zero: the reference's scatter-add order, deterministic."""
    order = torch.argsort(expert_ids, dim=-1, stable=True)
    picked = torch.gather(rows, 1, order[..., None].expand_as(rows))
    out = torch.zeros((rows.shape[0], rows.shape[-1]), dtype=rows.dtype,
                      device=rows.device)
    for j in range(rows.shape[1]):
        out = out + picked[:, j]
    return out


def expert_bmm(x: torch.Tensor, w: torch.Tensor, block: int
               ) -> torch.Tensor:
    """x (E', C, a) @ w (E', a, b), one ``torch.bmm`` a ``block`` of
    experts."""
    if w.shape[0] <= block:
        return torch.bmm(x, w)
    return torch.cat([torch.bmm(x[i:i + block], w[i:i + block])
                      for i in range(0, w.shape[0], block)])


def expert_block(num_experts: int) -> int:
    """Experts a ``torch.bmm`` multiplies: E / EXPERT_SPLITS."""
    return max(1, num_experts // EXPERT_SPLITS)


def _experts(params: dict, xe: torch.Tensor, act: str, block: int
             ) -> torch.Tensor:
    """The per-expert FFN of the dispatched slots xe (E', C, d) through
    the leaves' E' experts, ``block`` experts a product."""
    if act in ("swiglu", "geglu"):
        g = expert_bmm(xe, params["w_gate"], block)
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * expert_bmm(xe, params["w_up"], block)
    else:
        h = F.gelu(expert_bmm(xe, params["w_up"], block), approximate="tanh")
    return expert_bmm(h, params["w_down"], block)


def apply_moe(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, act: str, groups: int = 1,
              first_expert: int = 0,
              reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> tuple:
    """Returns (output (B, T, d) in ``x``'s dtype, the load-balance loss
    (a float32 scalar)).  ``groups`` dispatch groups of contiguous tokens
    (it divides B T), each with its own capacity.  Expert leaves holding
    fewer experts than the router (a rank's block, from ``first_expert``)
    compute only their experts' slots, and ``reduce`` sums the zero-filled
    (N, k, d) pair rows over the ranks that hold the rest."""
    b, t, d = x.shape
    n = b * t
    tokens = x.reshape(n, d)
    num_experts = params["router"].shape[-1]
    probs, gate_vals, expert_ids = route(params["router"], tokens, top_k)
    aux = load_balance_loss(probs, expert_ids, top_k)

    if n % groups:
        raise ValueError(f"{groups} dispatch groups do not divide {n} "
                         f"tokens")
    ng = n // groups
    cap = capacity(ng, top_k, num_experts, capacity_factor)
    held = params["w_up"].shape[0]
    mine = slice(first_expert, first_expert + held)
    rows = []
    for g in range(groups):
        part = slice(g * ng, (g + 1) * ng)
        xe, _, gates, pair_slot = _dispatch_group(
            tokens[part], gate_vals[part], expert_ids[part], num_experts,
            top_k, cap)
        ye = _experts(params, xe[mine], act, expert_block(num_experts))
        ye = ye * gates[mine, :, None].to(ye.dtype)
        rows.append(_pair_rows(ye, pair_slot, first_expert))
    rows = rows[0] if groups == 1 else torch.cat(rows)
    if held < num_experts:
        if reduce is None:
            raise ValueError(f"the expert leaves hold {held} of "
                             f"{num_experts} experts: pass reduce, the sum "
                             f"over the ranks holding the rest")
        rows = reduce(rows)
    out = _combine(rows, expert_ids)
    return out.reshape(b, t, d).to(x.dtype), aux.to(torch.float32)
