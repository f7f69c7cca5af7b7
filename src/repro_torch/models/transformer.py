"""The float dense llama trunk: full-sequence block, forward and LM loss.

Layer parameters are stacked with a leading ``L`` axis (as
:func:`repro_torch.models.init.init_lm` builds them); biases are honoured
by presence (``bq``/``bk``/``bv``, a norm's ``bias``, ``b_gate``/``b_up``),
since merging a calibrated shifted transform introduces them.  No cache,
no prefix embeddings: serving goes through ``serve/quantized.py``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models.init import layer


def embed(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B, T, d); RoPE models add no positions here."""
    if not cfg.rope_theta:
        raise NotImplementedError("sinusoidal positions (OPT) are not ported "
                                  "yet (ROADMAP queue 1 item 7)")
    return params["embed"][tokens.long()]


def apply_block_full(p: dict, x: torch.Tensor, cfg,
                     positions: torch.Tensor) -> torch.Tensor:
    """One full-sequence block (causal attention + MLP, pre-norm)."""
    h = layers.apply_norm(p["ln_attn"], x, cfg.norm)
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    b, t = x.shape[0], x.shape[1]
    hd = cfg.resolved_head_dim
    q = q.reshape(b, t, cfg.num_heads, hd)
    k = k.reshape(b, t, cfg.num_kv_heads, hd)
    v = v.reshape(b, t, cfg.num_kv_heads, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = attn_lib.attention(q, k, v)
    x = x + out.reshape(b, t, -1) @ p["wo"]
    h2 = layers.apply_norm(p["ln_mlp"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h2, cfg.act)


def forward(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Logits (B, T, vocab) of the whole sequence."""
    x = embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.num_layers):
        x = apply_block_full(layer(params["layers"], i), x, cfg, positions)
    x = layers.apply_norm(params["ln_f"], x, cfg.norm)
    w = params.get("head")
    return x @ (w if w is not None else params["embed"].T)


def lm_loss(params: dict, cfg, batch: dict) -> torch.Tensor:
    """Next-token cross entropy."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens)
    return layers.cross_entropy(logits[:, :-1], tokens[:, 1:],
                                batch.get("mask"))
