"""Model configuration: the fields the dense paths read, and the training
fields (``remat``, ``microbatches``, ``opt_state_dtype``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    family: str = "dense"            # the port has the dense family only
    act: str = "swiglu"              # swiglu | geglu | gelu | relu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0      # 0: sinusoidal absolute positions
    tie_embeddings: bool = False
    dtype: str = "float32"
    # training
    remat: bool = True               # recompute each block in backward
    microbatches: int = 1            # gradient-accumulation chunks per step
    opt_state_dtype: str = "float32"  # Adam moment dtype

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def param_count(self) -> int:
        """Analytic parameter count (embeddings once if tied)."""
        h, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * h * (1 if self.tie_embeddings else 2)
        attn = (h * (self.num_heads * hd) + 2 * h * (self.num_kv_heads * hd)
                + (self.num_heads * hd) * h)
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        mlp = (3 if self.act in ("swiglu", "geglu") else 2) * h * self.d_ff
        return n + self.num_layers * (attn + mlp + 2 * h)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny config of the same structure for CPU smoke runs (the
        dense part of the reference's ``reduced``)."""
        base = dict(
            name=self.name + "-smoke", family=self.family, num_layers=2,
            d_model=64, num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)), head_dim=16,
            d_ff=128, vocab_size=256, act=self.act, norm=self.norm,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            tie_embeddings=True, dtype="float32", remat=False)
        base.update(overrides)
        return ModelConfig(**base)
