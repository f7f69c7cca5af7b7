"""Model configuration: the fields of the reference's six families (dense,
moe, mamba2, griffin, vlm, audio) that the port reads, and the training
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
    family: str = "dense"            # dense | moe | mamba2 | griffin | vlm
    #                                  | audio
    act: str = "swiglu"              # swiglu | geglu | gelu | relu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0      # 0: sinusoidal absolute positions
    tie_embeddings: bool = False
    causal: bool = True              # False: bidirectional encoder (audio)
    dtype: str = "float32"
    # MoE: experts replace the MLP (num_experts == 0: dense)
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256
    ssd_bf16_intra: bool = False     # intra-chunk products in the model dtype
    # griffin (recurrentgemma)
    window: int = 0                  # sliding-window size of local attention
    attn_every: int = 0              # 1 attention layer per attn_every layers
    rnn_width: int = 0               # RG-LRU width (0 -> d_model)
    # modality frontends (stubs: the inputs are embeddings)
    num_prefix: int = 0              # vlm: image patches prepended
    frontend_stub: bool = False      # audio / vlm: inputs are embeddings
    frame_stride: int = 1            # audio: seq_len // stride frames
    # training
    remat: bool = True               # recompute each block in backward
    microbatches: int = 1            # gradient-accumulation chunks per step
    opt_state_dtype: str = "float32"  # Adam moment dtype

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:        # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (embeddings once if tied), the
        reference's formula for every family (griffin's recurrent block
        counts its gate vectors approximately, as the reference does)."""
        h, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * h * (1 if self.tie_embeddings else 2)
        L = self.num_layers
        attn = (h * (self.num_heads * hd) + 2 * h * (self.num_kv_heads * hd)
                + (self.num_heads * hd) * h)
        if self.family == "mamba2":
            d_in, gn = self.d_inner, self.ssm_ngroups * self.ssm_state
            proj_in = h * (2 * d_in + 2 * gn + self.ssm_heads)
            return n + L * (proj_in + d_in * h + 2 * h + d_in
                            + self.conv_width * (d_in + 2 * gn))
        if self.family == "griffin":
            d_r = self.rnn_dim
            n_attn = L // max(self.attn_every, 1)
            rec = 2 * h * d_r + d_r * h + self.conv_width * d_r + 3 * d_r
            mlp = 3 * h * self.d_ff
            return n + n_attn * (attn + mlp + 2 * h) + (L - n_attn) * (
                rec + mlp + 2 * h)
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        mlp = self._mlp_one()
        if self.num_experts:            # every expert and the router
            mlp = self.num_experts * mlp + h * self.num_experts
        return n + L * (attn + mlp + 2 * h)

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
        """A tiny config of the same structure for CPU smoke runs, the
        reference's ``reduced``: griffin keeps one (rec, rec, attn) period
        of 3 layers and a window of 8, mamba2 an SSD chunk of 8, vlm at
        most 4 prefix slots."""
        base = dict(
            name=self.name + "-smoke", family=self.family,
            num_layers=3 if self.family == "griffin" else 2,
            d_model=64, num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)), head_dim=16,
            d_ff=128, vocab_size=256, act=self.act, norm=self.norm,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            tie_embeddings=True, causal=self.causal, dtype="float32",
            remat=False,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_expand=self.ssm_expand,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_ngroups=self.ssm_ngroups, conv_width=self.conv_width,
            ssm_chunk=8, window=min(self.window, 8) if self.window else 0,
            attn_every=self.attn_every,
            rnn_width=64 if self.rnn_width else 0,
            num_prefix=min(self.num_prefix, 4) if self.num_prefix else 0,
            frontend_stub=self.frontend_stub, frame_stride=self.frame_stride)
        base.update(overrides)
        return ModelConfig(**base)
