"""Model configuration: the fields the dense paths read."""
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

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))
