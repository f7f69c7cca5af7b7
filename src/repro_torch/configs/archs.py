"""The paper's evaluation families, OPT and LLaMA (``PAPER_ARCHS``), and
the reference registry's other dense archs (``DENSE_ARCHS``).

Same shapes as the reference registry: OPT = ReLU MLP + LayerNorm + qkv
biases, its learned positions approximated by sinusoidal ones
(``rope_theta == 0``; Zhang et al., 2022); LLaMA = SwiGLU + RMSNorm +
RoPE (Touvron et al., 2023); both tied, float32, trained without remat
and in one microbatch.  ``opt-125m`` and
``llama-7b`` are the published widths; the ``-mini`` / ``-micro`` entries
are the CPU-sized miniatures the tests use.

``DENSE_ARCHS`` holds the reference registry's four dense entries at their
published shapes (the sources in brackets): GQA with G = 3, 5 and 4, MQA
(G = 8), qkv biases with RoPE at theta 1e6, LayerNorm with RoPE, head_dim
160 and 256, GeGLU, untied heads.  The reference keeps them in bfloat16;
the port computes them in float32, as it does every arch (its caches and
its kernels' float operands are float32).  Their training fields are the
reference's: remat on, and 4, 8, 8 and 2 microbatches.

``MOE_ARCHS`` holds the registry's two MoE entries, qwen3-moe-30b-a3b and
dbrx-132b, likewise, and ``OTHER_ARCHS`` its four other families: the
attention-free mamba2 (SSD), the recurrentgemma hybrid (RG-LRU blocks with
one sliding-window attention block in three), the paligemma VLM (a gemma
trunk behind 256 prefix-LM image slots) and the hubert encoder
(bidirectional, frame embeddings in, frame labels out).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def _opt(name, L, d, h, ff, vocab=50272) -> ModelConfig:
    return ModelConfig(
        name=name, num_layers=L, d_model=d, num_heads=h, num_kv_heads=h,
        d_ff=ff, vocab_size=vocab, act="relu", norm="layernorm",
        qkv_bias=True, rope_theta=0.0, tie_embeddings=True, dtype="float32",
        remat=False)


def _llama(name, L, d, h, kv, ff, vocab=32000) -> ModelConfig:
    return ModelConfig(
        name=name, num_layers=L, d_model=d, num_heads=h,
        num_kv_heads=kv, d_ff=ff, vocab_size=vocab, act="swiglu",
        norm="rmsnorm", rope_theta=10000.0, tie_embeddings=True,
        dtype="float32", remat=False)


PAPER_ARCHS: dict[str, ModelConfig] = {
    "opt-125m": _opt("opt-125m", 12, 768, 12, 3072),
    "opt-mini": _opt("opt-mini", 4, 256, 8, 1024, vocab=2048),
    "opt-micro": _opt("opt-micro", 2, 128, 4, 512, vocab=512),
    "llama-7b": _llama("llama-7b", 32, 4096, 32, 32, 11008),
    "llama-mini": _llama("llama-mini", 4, 256, 8, 8, 704, vocab=2048),
    "llama-micro": _llama("llama-micro", 2, 128, 4, 4, 384, vocab=512),
}


DENSE_ARCHS: dict[str, ModelConfig] = {
    # [arXiv:2412.08905; hf] 32L d 3072 24H (GQA kv 8) d_ff 8192, untied
    "phi4-mini-3.8b": ModelConfig(
        name="phi4-mini-3.8b", num_layers=32, d_model=3072, num_heads=24,
        num_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=200064,
        act="swiglu", norm="rmsnorm", rope_theta=10000.0, microbatches=4),
    # [hf:Qwen/Qwen2.5] 48L d 5120 40H (GQA kv 8) d_ff 13824, QKV bias
    "qwen2.5-14b": ModelConfig(
        name="qwen2.5-14b", num_layers=48, d_model=5120, num_heads=40,
        num_kv_heads=8, head_dim=128, d_ff=13824, vocab_size=152064,
        act="swiglu", norm="rmsnorm", qkv_bias=True, rope_theta=1000000.0,
        microbatches=8),
    # [hf:stabilityai/stablelm-2] 40L d 5120 32H (GQA kv 8) head_dim 160
    "stablelm-12b": ModelConfig(
        name="stablelm-12b", num_layers=40, d_model=5120, num_heads=32,
        num_kv_heads=8, head_dim=160, d_ff=13824, vocab_size=100352,
        act="swiglu", norm="layernorm", rope_theta=10000.0, microbatches=8),
    # [arXiv:2403.08295; hf] 18L d 2048 8H (MQA) head_dim 256, GeGLU, tied
    "gemma-2b": ModelConfig(
        name="gemma-2b", num_layers=18, d_model=2048, num_heads=8,
        num_kv_heads=1, head_dim=256, d_ff=16384, vocab_size=256000,
        act="geglu", norm="rmsnorm", rope_theta=10000.0,
        tie_embeddings=True, microbatches=2),
}


# The reference registry's two MoE entries at their published shapes
# (experts replace the MLP; the router is float).  float32 as every port
# arch; the training fields are the reference's.
MOE_ARCHS: dict[str, ModelConfig] = {
    # [hf:databricks/dbrx-base] 40L d 6144 48H (GQA kv 8) d_ff 10752,
    # LayerNorm, 16 experts top-4, untied
    "dbrx-132b": ModelConfig(
        name="dbrx-132b", family="moe", num_layers=40, d_model=6144,
        num_heads=48, num_kv_heads=8, head_dim=128, d_ff=10752,
        vocab_size=100352, act="swiglu", norm="layernorm",
        rope_theta=500000.0, num_experts=16, top_k=4, capacity_factor=1.25,
        microbatches=16, opt_state_dtype="bfloat16"),
    # [hf:Qwen/Qwen3-30B-A3B] 48L d 2048 32H (GQA kv 4) head_dim 128,
    # 128 experts top-8 of d_ff 768, untied
    "qwen3-moe-30b-a3b": ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", num_layers=48, d_model=2048,
        num_heads=32, num_kv_heads=4, head_dim=128, d_ff=768,
        vocab_size=151936, act="swiglu", norm="rmsnorm",
        rope_theta=1000000.0, num_experts=128, top_k=8,
        capacity_factor=1.25, microbatches=4),
}


# The registry's other families at their published shapes.  Their
# frontends are stubs, as in the reference: a VLM's image patches and an
# audio model's frames arrive as embeddings.
OTHER_ARCHS: dict[str, ModelConfig] = {
    # [arXiv:2405.21060] 48L d 2048 (attention-free) vocab 50280, SSD
    # state 128, 64 heads of 64, tied
    "mamba2-1.3b": ModelConfig(
        name="mamba2-1.3b", family="mamba2", num_layers=48, d_model=2048,
        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
        conv_width=4, ssm_chunk=256, tie_embeddings=True, microbatches=8),
    # [arXiv:2402.19427; hf] 26L d 2560 10H (MQA) head_dim 256 d_ff 7680,
    # RG-LRU + local attention 2:1, window 2048, GeGLU, tied
    "recurrentgemma-2b": ModelConfig(
        name="recurrentgemma-2b", family="griffin", num_layers=26,
        d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
        d_ff=7680, vocab_size=256000, act="geglu", norm="rmsnorm",
        rope_theta=10000.0, tie_embeddings=True, window=2048,
        attn_every=3, rnn_width=2560, conv_width=4, microbatches=4),
    # [arXiv:2407.07726; hf] SigLIP + gemma: 18L d 2048 8H (MQA) head_dim
    # 256 d_ff 16384 vocab 257216, 256 prefix slots, GeGLU, tied
    "paligemma-3b": ModelConfig(
        name="paligemma-3b", family="vlm", num_layers=18, d_model=2048,
        num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
        vocab_size=257216, act="geglu", norm="rmsnorm", rope_theta=10000.0,
        tie_embeddings=True, num_prefix=256, frontend_stub=True,
        microbatches=2),
    # [arXiv:2106.07447] encoder-only: 48L d 1280 16H head_dim 80 d_ff
    # 5120, 504 frame classes, GELU, LayerNorm, sinusoidal positions
    "hubert-xlarge": ModelConfig(
        name="hubert-xlarge", family="audio", num_layers=48, d_model=1280,
        num_heads=16, num_kv_heads=16, head_dim=80, d_ff=5120,
        vocab_size=504, act="gelu", norm="layernorm", rope_theta=0.0,
        causal=False, frontend_stub=True, microbatches=4),
}
