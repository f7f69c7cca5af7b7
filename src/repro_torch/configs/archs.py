"""The paper's evaluation families: OPT and LLaMA.

Same shapes as the reference registry: OPT = ReLU MLP + LayerNorm + qkv
biases, its learned positions approximated by sinusoidal ones
(``rope_theta == 0``; Zhang et al., 2022); LLaMA = SwiGLU + RMSNorm +
RoPE (Touvron et al., 2023); both tied, float32.  ``opt-125m`` and
``llama-7b`` are the published widths; the ``-mini`` / ``-micro`` entries
are the CPU-sized miniatures the tests use.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def _opt(name, L, d, h, ff, vocab=50272) -> ModelConfig:
    return ModelConfig(
        name=name, num_layers=L, d_model=d, num_heads=h, num_kv_heads=h,
        d_ff=ff, vocab_size=vocab, act="relu", norm="layernorm",
        qkv_bias=True, rope_theta=0.0, tie_embeddings=True, dtype="float32")


def _llama(name, L, d, h, kv, ff, vocab=32000) -> ModelConfig:
    return ModelConfig(
        name=name, num_layers=L, d_model=d, num_heads=h,
        num_kv_heads=kv, d_ff=ff, vocab_size=vocab, act="swiglu",
        norm="rmsnorm", rope_theta=10000.0, tie_embeddings=True,
        dtype="float32")


PAPER_ARCHS: dict[str, ModelConfig] = {
    "opt-125m": _opt("opt-125m", 12, 768, 12, 3072),
    "opt-mini": _opt("opt-mini", 4, 256, 8, 1024, vocab=2048),
    "opt-micro": _opt("opt-micro", 2, 128, 4, 512, vocab=512),
    "llama-7b": _llama("llama-7b", 32, 4096, 32, 32, 11008),
    "llama-mini": _llama("llama-mini", 4, 256, 8, 8, 704, vocab=2048),
    "llama-micro": _llama("llama-micro", 2, 128, 4, 4, 384, vocab=512),
}
