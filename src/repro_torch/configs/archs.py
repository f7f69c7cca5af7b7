"""The llama entries of the paper's evaluation families.

Same shapes as the reference registry: LLaMA = SwiGLU + RMSNorm + RoPE,
tied embeddings, float32 (Touvron et al., 2023).  ``llama-7b`` is the
published LLaMA-7B width; ``llama-mini`` / ``llama-micro`` are the
CPU-sized miniatures the tests use.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def _llama(name, L, d, h, kv, ff, vocab=32000) -> ModelConfig:
    return ModelConfig(
        name=name, num_layers=L, d_model=d, num_heads=h,
        num_kv_heads=kv, d_ff=ff, vocab_size=vocab, act="swiglu",
        norm="rmsnorm", rope_theta=10000.0, tie_embeddings=True,
        dtype="float32")


PAPER_ARCHS: dict[str, ModelConfig] = {
    "llama-7b": _llama("llama-7b", 32, 4096, 32, 32, 11008),
    "llama-mini": _llama("llama-mini", 4, 256, 8, 8, 704, vocab=2048),
    "llama-micro": _llama("llama-micro", 2, 128, 4, 4, 384, vocab=512),
}
