"""The training step: microbatched gradient accumulation and the Adam
update (the reference's ``train/step.py``).

Gradients come from autograd through ``model.loss``; with
``cfg.microbatches = n > 1`` the batch splits into n equal parts along B,
their gradients sum in float32 and loss and gradients are divided by n, so
activation memory is one microbatch's.  The step issues no host sync: the
loop reads the loss."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.optim import AdamConfig, adam_init, adam_update
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.utils import global_norm, tree_map


@dataclasses.dataclass
class TrainState:
    """params, Adam state and the step count (a 0-d int32 tensor).  A
    checkpoint flattens the three fields by index (``0||…``, ``1||…``,
    ``2``), as the reference's registered pytree does."""
    params: dict
    opt: dict
    step: torch.Tensor


def init_train_state(model, seed: int, adam_cfg: AdamConfig) -> TrainState:
    params = model.init(seed)
    return TrainState(params=params, opt=adam_init(params, adam_cfg),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def _split_microbatches(batch: dict, n: int) -> list:
    """(B, ...) -> n batches of B // n rows, in order."""
    def split(x):
        x = torch.as_tensor(x)
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return x.reshape(n, b // n, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _value_and_grad(model, params: dict, batch: dict) -> tuple:
    """(loss, gradient tree) of ``model.loss`` at ``params``."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = model.loss(leaves, batch)
    loss.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), leaves)
    return loss.detach(), grads


def make_train_step(model, adam_cfg: AdamConfig, total_steps: int = 10000,
                    warmup: int = 100,
                    compress_grads: Optional[Callable] = None):
    """Returns train_step(state, batch) -> (state, metrics); ``metrics``
    holds ``loss``, ``lr_scale`` and ``grad_norm`` (before clipping) as
    0-d device tensors.  ``compress_grads(grads) -> grads`` is a hook
    applied before the update (the reference's int8 reduction over a mesh
    is not ported)."""
    n_micro = max(model.cfg.microbatches, 1)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        if n_micro == 1:
            loss, grads = _value_and_grad(model, params, batch)
        else:
            loss = grads = None
            for mb in _split_microbatches(batch, n_micro):
                l, g = _value_and_grad(model, params, mb)
                g = tree_map(lambda t: t.to(torch.float32), g)
                loss = l if loss is None else loss + l
                grads = g if grads is None else tree_map(torch.add, grads, g)
            loss = loss / n_micro
            grads = tree_map(lambda g: g / n_micro, grads)

        if compress_grads is not None:
            grads = compress_grads(grads)

        lr_scale = linear_warmup_cosine(state.step, warmup, total_steps)
        new_params, new_opt = adam_update(params, grads, state.opt, adam_cfg,
                                          lr_scale)
        metrics = {"loss": loss, "lr_scale": lr_scale,
                   "grad_norm": global_norm(grads)}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
