"""Adam(W) on trees of tensors, with the reference's semantics
(``optim/adam.py``): global-norm clipping, float32 bias corrections from a
device step count, decay on matrices only and moments kept in
``state_dtype`` but updated in float32.

``torch.optim.AdamW`` is not used: it decays before the moment update and
decays every tensor.  The update is out of place: it returns new params
and state and leaves its inputs untouched, so a caller can drop a poisoned
step by keeping the old ones.  ``state_dtype='bfloat16'`` halves the
moments' memory."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import global_norm, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0           # 0 disables
    state_dtype: str = "float32"     # moments dtype


def adam_init(params, cfg: AdamConfig) -> dict:
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adam_update(params, grads, state: dict, cfg: AdamConfig,
                lr_scale=1.0, grad_norm=None) -> tuple:
    """One AdamW step.  Returns (new_params, new_state).  ``grad_norm``
    replaces ``global_norm(grads)`` in the clip: on a mesh the norm of the
    whole tree, where ``grads`` hold one rank's shards."""
    count = state["count"] + 1
    if cfg.grad_clip > 0:
        gn = global_norm(grads) if grad_norm is None else grad_norm
        # an IEEE quotient: ``float / tensor`` is a reciprocal multiply
        clip = torch.clamp_max(torch.full_like(gn, cfg.grad_clip)
                               / (gn + 1e-9), 1.0)
        grads = tree_map(lambda g: g.to(torch.float32) * clip, grads)
    else:
        grads = tree_map(lambda g: g.to(torch.float32), grads)

    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    bias1 = 1.0 - torch.pow(b1, c)
    bias2 = 1.0 - torch.pow(b2, c)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=c.device)
    sd = getattr(torch, cfg.state_dtype)

    def upd(p, g, m, v):
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g
        v32 = v.to(torch.float32) * b2 + (1 - b2) * torch.square(g)
        step = (m32 / bias1) / (torch.sqrt(v32 / bias2) + cfg.eps)
        if cfg.weight_decay > 0 and p.ndim >= 2:   # decay matrices only
            step = step + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * step
        return new_p.to(p.dtype), m32.to(sd), v32.to(sd)

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    return _pick(out, 0), {"mu": _pick(out, 1), "nu": _pick(out, 2),
                           "count": count}


def _pick(tree, i: int):
    """Entry ``i`` of every (param, mu, nu) leaf of a dict / list tree (a
    leaf is a tuple; griffin's layers are a list)."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
