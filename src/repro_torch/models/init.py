"""Seeded random initialisation of every family's tree.

Same shapes and scales as the reference (truncated-normal fan-in linears
cut at two standard deviations, normal(0.02) embeddings, unit norm
scales, zero LayerNorm biases and qkv biases, a gate weight for the gated
MLPs only, a std-0.02 router and stacked (E, K, N) experts in place of the
MLP for MoE; mamba2's normal(0.1) conv, A = -[1..16], unit D and dt biases
whose softplus lies in [1e-3, 1e-1]; the RG-LRU's normal(0.1) conv, zero
gates and a Lambda whose decay lies in [0.9, 0.999] at r = 0.5), drawn
from an explicit ``torch.Generator``, so the bits differ from the
reference's.  Layer parameters are stacked with a leading ``L`` axis,
except griffin's, whose layers differ in kind: a list of
``{"kind_attn": block}`` and ``{"kind_rec": {"rglru", "ln_mlp", "mlp"}}``
(an attention block every ``attn_every``-th layer), as the reference's.
Linear weights are (in, out) and apply as ``x @ w``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qtensor import QTensor
from repro_torch.models.griffin import RG_LRU_C
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
        p["mlp"] = init_mlp(cfg, gen, device)
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros((width,), device=device)
    return p


def init_mlp(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    mlp = {"w_up": dense_init(gen, cfg.d_model, cfg.d_ff, device),
           "w_down": dense_init(gen, cfg.d_ff, cfg.d_model, device)}
    if cfg.act in GATED:
        mlp["w_gate"] = dense_init(gen, cfg.d_model, cfg.d_ff, device)
    return mlp


def init_mamba2_block(cfg: ModelConfig, gen: torch.Generator, device
                      ) -> dict:
    d, d_in = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = d_in + 2 * g * n
    u = torch.rand((h,), generator=gen, device=device)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "norm": init_norm(d, cfg.norm, device),
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * g * n + h, device),
        "conv_w": 0.1 * torch.randn((cfg.conv_width, conv_dim),
                                    generator=gen, device=device),
        "conv_b": torch.zeros((conv_dim,), device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "d_skip": torch.ones((h,), device=device),
        "dt_bias": torch.log(torch.expm1(dt)),      # softplus(dt_bias) = dt
        "gate_norm": init_norm(d_in, "rmsnorm", device),
        "out_proj": dense_init(gen, d_in, d, device),
    }


def init_rglru_block(cfg: ModelConfig, gen: torch.Generator, device
                     ) -> dict:
    d, dr = cfg.d_model, cfg.rnn_dim
    lam = 0.9 + 0.099 * torch.rand((dr,), generator=gen, device=device)
    zeros = lambda: torch.zeros((dr,), device=device)
    return {
        "norm": init_norm(d, cfg.norm, device),
        "w_rec": dense_init(gen, d, dr, device),
        "w_gate": dense_init(gen, d, dr, device),
        "conv_w": 0.1 * torch.randn((cfg.conv_width, dr), generator=gen,
                                    device=device),
        "conv_b": zeros(),
        "gate_a_w": zeros(), "gate_a_b": zeros(),
        "gate_x_w": zeros(), "gate_x_b": zeros(),
        # decay a = lam at r = 0.5: softplus(lam_raw) = -log(lam) / (c / 2)
        "lam": torch.log(torch.expm1(-torch.log(lam) / (0.5 * RG_LRU_C))),
        "w_out": dense_init(gen, dr, d, device),
    }


def griffin_is_attn(cfg: ModelConfig, i: int) -> bool:
    """Layer ``i`` of a griffin stack is local attention (the last of each
    ``attn_every`` layers) rather than recurrent."""
    return cfg.attn_every > 0 and i % cfg.attn_every == cfg.attn_every - 1


def init_griffin_layer(cfg: ModelConfig, i: int, gen: torch.Generator,
                       device) -> dict:
    if griffin_is_attn(cfg, i):
        return {"kind_attn": init_block(cfg, gen, device)}
    return {"kind_rec": {"rglru": init_rglru_block(cfg, gen, device),
                         "ln_mlp": init_norm(cfg.d_model, cfg.norm, device),
                         "mlp": init_mlp(cfg, gen, device)}}


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
    """Float parameter tree of any family: stacked layers (a list of
    per-layer trees for griffin)."""
    params = init_top(cfg, gen, device)
    if cfg.family == "griffin":
        params["layers"] = [init_griffin_layer(cfg, i, gen, device)
                            for i in range(cfg.num_layers)]
        return params
    block = init_mamba2_block if cfg.family == "mamba2" else init_block
    params["layers"] = _stack_into(
        (block(cfg, gen, device) for _ in range(cfg.num_layers)),
        cfg.num_layers)
    return params
