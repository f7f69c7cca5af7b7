"""Seeded random initialisation of the dense llama trunk.

Same shapes and scales as the reference (truncated-normal fan-in linears
cut at two standard deviations, normal(0.02) embeddings, unit norm
scales, zero qkv biases), drawn from an explicit ``torch.Generator``, so
the bits differ from the reference's.  Layer parameters are stacked with a
leading ``L`` axis; linear weights are (in, out) and apply as ``x @ w``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qtensor import QTensor


def dense_init(gen: torch.Generator, d_in: int, d_out: int, device,
               std: float | None = None) -> torch.Tensor:
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=gen)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, device
               ) -> torch.Tensor:
    return torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                       device=device) * 0.02


def init_block(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """One layer's parameters (no leading L axis)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    ones = lambda: {"scale": torch.ones((d,), device=device)}
    p = {"ln_attn": ones(),
         "wq": dense_init(gen, d, hq * hd, device),
         "wk": dense_init(gen, d, hkv * hd, device),
         "wv": dense_init(gen, d, hkv * hd, device),
         "wo": dense_init(gen, hq * hd, d, device),
         "ln_mlp": ones(),
         "mlp": {"w_up": dense_init(gen, d, cfg.d_ff, device),
                 "w_down": dense_init(gen, cfg.d_ff, d, device),
                 "w_gate": dense_init(gen, d, cfg.d_ff, device)}}
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros((width,), device=device)
    return p


def init_top(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Embedding, final norm and (untied) head."""
    top = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, device),
           "ln_f": {"scale": torch.ones((cfg.d_model,), device=device)}}
    if not cfg.tie_embeddings:
        top["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, device,
                                 std=0.02)
    return top


def stack_layers(blocks: list) -> dict:
    """Stack per-layer trees (tensors and QTensors) along a new L axis."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: stack_layers([b[k] for b in blocks]) for k in first}
    if isinstance(first, QTensor):
        return QTensor(torch.stack([b.packed for b in blocks]),
                       torch.stack([b.scale for b in blocks]),
                       torch.stack([b.zp for b in blocks]), first.bits,
                       first.group_size)
    return torch.stack(blocks)


def layer(tree, i):
    """Layer ``i`` of a stacked tree (views; QTensors index their three
    tensors)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_lm(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Float parameter tree with stacked layers."""
    params = init_top(cfg, gen, device)
    params["layers"] = stack_layers(
        [init_block(cfg, gen, device) for _ in range(cfg.num_layers)])
    return params
