"""The float dense trunk (OPT and llama): full-sequence block, forward and
LM loss, and the sinusoidal positions of the no-RoPE (OPT) family.

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


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding at explicit positions (...,) -> (..., d) float32:
    ``sin(p / 10000^(2i/d))`` for i < d/2, then the cosines (concatenated,
    not interleaved), as the reference's ``sinusoidal_at``.

    The float forward, calibration and the packed model's prefill chunks
    ((B, C) positions) and decode steps ((B,) positions) all call it, so the
    position scheme cannot drift between phases.  The angle is the
    reference's float32 quotient; its sine and cosine are taken in float64
    and rounded once, which gives every element the same bits whatever the
    tensor's shape (a float32 ``sin`` on the CPU takes a vector and a scalar
    path, which can differ in the last bit, and a chunked prefill would then
    see other positions than the whole prompt)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    expo = (2 * i) / torch.full_like(i, d)
    freq = torch.pow(torch.tensor(10000.0, dtype=torch.float64,
                                  device=i.device),
                     expo.to(torch.float64)).to(torch.float32)
    ang = positions[..., None].to(torch.float32) / freq
    ang = ang.to(torch.float64)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(
        torch.float32)


def _sinusoidal(t: int, d: int, device=None) -> torch.Tensor:
    """(t, d) positions 0..t-1."""
    return sinusoidal_at(torch.arange(t, device=device), d)


def embed(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B, T, d); a no-RoPE model (``rope_theta == 0``,
    OPT) adds its sinusoidal positions 0..T-1 here."""
    x = params["embed"][tokens.long()]
    if not cfg.rope_theta:
        x = x + _sinusoidal(x.shape[1], cfg.d_model, x.device).to(
            x.dtype)[None]
    return x


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
    if cfg.rope_theta > 0:
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
