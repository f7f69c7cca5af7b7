"""Seeded random initialisation of the OPT, llama and MoE trunks.

Same shapes and scales as the reference (truncated-normal fan-in linears
cut at two standard deviations, normal(0.02) embeddings, unit norm
scales, zero LayerNorm biases and qkv biases, a gate weight for the gated
MLPs only, a std-0.02 router and stacked (E, K, N) experts in place of the
MLP for MoE), drawn from an explicit ``torch.Generator``, so
the bits differ from the reference's.  Layer parameters are stacked with a
leading ``L`` axis; linear weights are (in, out) and apply as ``x @ w``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qtensor import QTensor
from repro_torch.models.layers import GATED


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


def init_norm(d: int, kind: str, device) -> dict:
    """Unit scale; a LayerNorm also has a zero bias."""
    p = {"scale": torch.ones((d,), device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), device=device)
    return p


def init_block(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """One layer's parameters (no leading L axis)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    p = {"ln_attn": init_norm(d, cfg.norm, device),
         "wq": dense_init(gen, d, hq * hd, device),
         "wk": dense_init(gen, d, hkv * hd, device),
         "wv": dense_init(gen, d, hkv * hd, device),
         "wo": dense_init(gen, hq * hd, d, device),
         "ln_mlp": init_norm(d, cfg.norm, device)}
    if cfg.num_experts:
        from repro_torch.models.moe import init_moe
        p["moe"] = init_moe(gen, d, cfg.d_ff, cfg.num_experts, cfg.act,
                            device)
    else:
        p["mlp"] = {"w_up": dense_init(gen, d, cfg.d_ff, device),
                    "w_down": dense_init(gen, cfg.d_ff, d, device)}
        if cfg.act in GATED:
            p["mlp"]["w_gate"] = dense_init(gen, d, cfg.d_ff, device)
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros((width,), device=device)
    return p


def init_top(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Embedding, final norm and (untied) head."""
    top = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, device),
           "ln_f": init_norm(cfg.d_model, cfg.norm, device)}
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


def _stack_into(blocks, n: int) -> dict:
    """Stack ``n`` float layer trees drawn one at a time from the iterator
    ``blocks`` into tensors allocated once, so only one layer's tree exists
    beside the stack (a float llama-7b is 26 GB: stacking a list of its
    layers would hold 53 GB at the peak)."""
    first = next(blocks)
    alloc = lambda t: (torch.empty((n, *t.shape), dtype=t.dtype,
                                   device=t.device)
                       if not isinstance(t, dict)
                       else {k: alloc(v) for k, v in t.items()})
    out = alloc(first)

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    put(out, first, 0)
    for i in range(1, n):
        put(out, next(blocks), i)
    return out


def init_lm(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Float parameter tree with stacked layers."""
    params = init_top(cfg, gen, device)
    params["layers"] = _stack_into(
        (init_block(cfg, gen, device) for _ in range(cfg.num_layers)),
        cfg.num_layers)
    return params
