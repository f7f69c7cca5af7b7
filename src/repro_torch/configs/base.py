"""Model configuration: the fields the dense and MoE paths read, and the
training fields (``remat``, ``microbatches``, ``opt_state_dtype``)."""
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
    family: str = "dense"            # dense | moe (the port's families)
    act: str = "swiglu"              # swiglu | geglu | gelu | relu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0      # 0: sinusoidal absolute positions
    tie_embeddings: bool = False
    dtype: str = "float32"
    # MoE: experts replace the MLP (num_experts == 0: dense)
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
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
        mlp = self._mlp_one()
        if self.num_experts:            # every expert and the router
            mlp = self.num_experts * mlp + h * self.num_experts
        return n + self.num_layers * (attn + mlp + 2 * h)

    def _mlp_one(self) -> int:
        """Weights of one MLP (one expert)."""
        return ((3 if self.act in ("swiglu", "geglu") else 2)
                * self.d_model * self.d_ff)

    def active_param_count(self) -> int:
        """Parameters one token runs through (MoE: ``top_k`` of the
        ``num_experts`` experts)."""
        if not self.num_experts:
            return self.param_count()
        return self.param_count() - self.num_layers * (
            self.num_experts - self.top_k) * self._mlp_one()

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny config of the same structure for CPU smoke runs (the
        dense and MoE part of the reference's ``reduced``)."""
        base = dict(
            name=self.name + "-smoke", family=self.family, num_layers=2,
            d_model=64, num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)), head_dim=16,
            d_ff=128, vocab_size=256, act=self.act, norm=self.norm,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            tie_embeddings=True, dtype="float32", remat=False,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0)
        base.update(overrides)
        return ModelConfig(**base)
