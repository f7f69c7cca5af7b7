"""Packed low-bit serving of a dense, MoE, VLM or audio model (the paper's
deployment).

Every linear of the trunk is a :class:`QTensor`.  At ``a_bits < 16`` each
matmul goes through ``ops.quant_matmul`` (per-token dynamic activation
codes, the ``w4a8_matmul`` kernel); at a16 through ``ops.dequant_matmul``.
3-bit weights are a storage format no kernel unpacks: ``ops`` sends them to
the plain versions on every device, as the reference sends them to its ref
math.  At ``kv_bits == 8`` K/V enter the cache as int8 codes with a float32
scale per (token, head); at ``kv_bits == 4`` as packed int4 nibbles with a
bf16 scale per 32 values; at ``kv_bits >= 16`` the cache is float.  The
cache, the prefill chunks and the decode steps are the float model's
(:class:`~repro_torch.models.transformer.ServingTrunk`); only the linear
product and the quantize-on-write differ.  Full-matrix transform sites keep
their activation factor (``attn_t`` / ``mlp_t`` = {"a_inv", optional
"shift"}) and merged biases (``bq``/``bk``/``bv``, ``b_gate``/``b_up``) are
honoured, as calibrated trees carry them.

A raw float tree is packed on the RTN grid by ``ops.quantize_pack``: the
``quantize_pack`` kernel for CUDA weights, one launch for each stacked
leaf (a (K, N) linear, its stack over layers, a layer's experts), and its
plain version (byte-equal to ``quantize_codes``) on the CPU.

An MoE block's experts are packed too (the router stays float), all of a
leaf's experts in one launch.  At serving time each expert leaf is dequantized
from its codes to float32 and the MoE half runs on the float activations
through the capacity dispatch, at every ``a_bits``: the reference's one
float-activation site (a quantized grouped-expert kernel is future work
there).

paligemma (vlm) and hubert (audio) serve as the causal token trunk, as the
reference's ``QuantizedModel`` serves them: token embeddings in (hubert's
plus sinusoidal positions), no image prefix, and causal attention even for
hubert, whose calibration and float forward are bidirectional.  Padded and
chunked prefill and the paged cache are the dense trunk's.

Quantization conserves poison: a non-finite K/V row (kv4: block) gives a
NaN scale.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantizer import (QuantConfig, effective_group_size,
                                        quantize_codes)
from repro_torch.core.sites import require_quantizable
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.quantize_pack import kv4_check_head_dim, kv4_quantize
from repro_torch.models.transformer import ServingTrunk

PACKED_WEIGHTS = ("wq", "wk", "wv", "wo")
PACKED_MLP = ("w_gate", "w_up", "w_down")


def rtn_pack(w: torch.Tensor, qcfg: QuantConfig) -> QTensor:
    """A float (K, N) weight, or one stacked over leading axes (layers,
    experts), on the RTN grid as a QTensor, through one
    ``ops.quantize_pack`` call for the whole stack (its leading axes
    flattened into the packer's batch).  A symmetric grid, which the packer
    has no input for, goes through ``quantize_codes``, as the reference
    packs every grid."""
    if qcfg.symmetric:
        return quantize_codes(w, qcfg)
    lead, (k, n) = w.shape[:-2], w.shape[-2:]
    g = effective_group_size(k, qcfg.group_size)
    flat = w.reshape(-1, k, n) if lead else w
    packed, scale, zp = ops.quantize_pack(
        flat.to(torch.float32).contiguous(), bits=qcfg.w_bits, group_size=g)
    if lead:
        packed, scale, zp = (t.reshape(*lead, *t.shape[1:])
                             for t in (packed, scale, zp))
    return QTensor(packed, scale, zp, qcfg.w_bits, g)


def quantize_layers(lp: dict, qcfg: QuantConfig) -> dict:
    """Packed form of a (stacked) layer tree: QTensor linears and experts
    on the RTN grid (:func:`rtn_pack`), norms, transforms, biases and the
    router kept."""
    out = {k: lp[k] for k in ("ln_attn", "ln_mlp", "attn_t", "mlp_t",
                              "bq", "bk", "bv") if k in lp}
    for k in PACKED_WEIGHTS:
        out[k] = rtn_pack(lp[k], qcfg)
    if "moe" in lp:
        mo = lp["moe"]
        out["moe"] = {"router": mo["router"]}
        out["moe"].update({k: rtn_pack(mo[k], qcfg) for k in PACKED_MLP
                           if k in mo})
        return out
    mlp = lp["mlp"]
    out["mlp"] = {k: rtn_pack(mlp[k], qcfg) for k in PACKED_MLP if k in mlp}
    out["mlp"].update({k: mlp[k] for k in ("b_gate", "b_up") if k in mlp})
    return out


def quantize_lm_packed(params: dict, cfg: ModelConfig, qcfg: QuantConfig
                       ) -> dict:
    """Raw float tree -> packed serving tree on the RTN grid; a tree that
    already holds QTensor linears passes through untouched."""
    require_quantizable(cfg)
    if isinstance(params["layers"]["wq"], QTensor):
        return params
    out = {k: params[k] for k in ("embed", "ln_f", "head") if k in params}
    out["layers"] = quantize_layers(params["layers"], qcfg)
    return out


def _kv_quantize(x: torch.Tensor, kv_bits: int):
    """Quantize-on-write.  kv8: symmetric per-(token, head) codes, x
    (..., H, D) -> (int8 codes (..., H, D), float32 scale (..., H)).  kv4:
    :func:`kv4_quantize`, x -> (nibbles (..., H, D // 2), bf16 scales
    (..., H, D // 32)).  ``amax`` propagates NaN, so a poisoned row keeps a
    NaN scale."""
    if kv_bits == 4:
        return kv4_quantize(x)
    xf = x.to(torch.float32)
    qmax = 2.0 ** (kv_bits - 1) - 1.0
    bound = torch.clamp_min(torch.amax(xf.abs(), dim=-1), 1e-8)
    scale = bound / torch.full_like(bound, qmax)     # IEEE quotient
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax - 1.0, qmax)
    return q.to(torch.int8), scale


@dataclasses.dataclass(frozen=True)
class QuantizedModel(ServingTrunk):
    """Serves a packed tree through :class:`ServingTrunk`: ``init_cache``
    / ``init_paged_cache`` / ``prefill`` / ``prefill_chunk`` /
    ``decode_step``.  ``mode="auto"`` runs the CUDA kernels on CUDA
    tensors, ``"plain"`` the plain versions.  ``block_kv`` sets the plain
    versions' tile over the linear cache, as the reference's
    ``flash_block_kv`` does."""
    cfg: ModelConfig
    qcfg: QuantConfig
    mode: str = "auto"
    device: str = "cuda"
    block_kv: Optional[int] = None
    # one rank's view of a serving mesh (the Engine sets it)
    tp: Optional[object] = dataclasses.field(default=None, compare=False,
                                             repr=False)

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        cfg, qcfg = self.cfg, self.qcfg
        if self.mode not in ops.MODES:
            raise ValueError(f"mode={self.mode!r}: use one of {ops.MODES}")
        require_quantizable(cfg)
        if qcfg.a_bits < 16 and not 2 <= qcfg.a_bits <= 8:
            raise ValueError(f"a_bits={qcfg.a_bits}: use 2..8 or >= 16")
        if qcfg.kv_bits < 16 and qcfg.kv_bits not in (4, 8):
            raise ValueError(f"kv_bits={qcfg.kv_bits}: use 4 (packed int4 + "
                             f"block-32 bf16 scales), 8 (int8 + per-(token, "
                             f"head) float32 scales) or >= 16 (float)")
        if qcfg.kv_bits == 4:
            kv4_check_head_dim(cfg.resolved_head_dim)

    @property
    def kv_bits(self) -> int:
        return self.qcfg.kv_bits

    def _mm(self, x: torch.Tensor, qt: QTensor) -> torch.Tensor:
        return ops.quant_matmul(x, qt, a_bits=self.qcfg.a_bits,
                                mode=self.mode)

    def _kv_values(self, k: torch.Tensor, v: torch.Tensor) -> tuple:
        """What enters the cache, in ``_kv_entries`` order: codes and
        scales (quantize-on-write) at kv8 / kv4, the values at kv16."""
        if not self.kv_quantized:
            return k, v
        (kq, k_s), (vq, v_s) = (_kv_quantize(t, self.qcfg.kv_bits)
                                for t in (k, v))
        return kq, vq, k_s, v_s

    # ---- sharding ------------------------------------------------------
    def param_logical_axes(self) -> dict:
        """Logical axes of the packed tree, the reference's table: one
        names tuple for a QTensor's codes, scale and zero points, whose K
        stays whole (weights resident, no gather a step); q/k/v and the
        MLP's up-projections split their outputs, wo and w_down keep K
        ("fsdp_embed", None when serving)."""
        cfg = self.cfg
        L = ("layers",)

        def norm_ax():
            ax = {"scale": L + (None,)}
            if cfg.norm == "layernorm":
                ax["bias"] = L + (None,)
            return ax

        def q_ax(out_name):
            names = L + (None, out_name)
            return {"packed": names, "scale": names, "zp": names}

        lx = {"ln_attn": norm_ax(), "ln_mlp": norm_ax(),
              "wq": q_ax("heads"), "wk": q_ax("kv_heads"),
              "wv": q_ax("kv_heads"), "wo": q_ax("fsdp_embed")}
        if cfg.qkv_bias:
            lx.update(bq=L + ("heads",), bk=L + ("kv_heads",),
                      bv=L + ("kv_heads",))
        if cfg.num_experts:
            names = L + ("expert", None, None)
            qe = {"packed": names, "scale": names, "zp": names}
            lx["moe"] = {"router": L + (None, None), "w_up": qe,
                         "w_down": qe}
            if cfg.act in ("swiglu", "geglu"):
                lx["moe"]["w_gate"] = qe
        else:
            lx["mlp"] = {"w_gate": q_ax("mlp"), "w_up": q_ax("mlp"),
                         "w_down": q_ax("fsdp_embed")}
            if cfg.act not in ("swiglu", "geglu"):
                lx["mlp"].pop("w_gate")
        axes = {"embed": ("vocab", None), "layers": lx,
                "ln_f": {"scale": (None,)}}
        if cfg.norm == "layernorm":
            axes["ln_f"]["bias"] = (None,)
        if not cfg.tie_embeddings:
            axes["head"] = (None, "vocab")
        return axes

    def cache_logical_axes(self, cache) -> dict:
        """The float model's cache axes, with kv8 / kv4 scales split over
        their KV heads like the codes (kv4's block axis stays whole)."""
        from repro_torch.models.model import Model
        from repro_torch.serve.kv_cache import (PagedKVCache,
                                                paged_cache_logical_axes)
        if isinstance(cache, PagedKVCache):
            return paged_cache_logical_axes(cache)
        axes = Model.cache_logical_axes(self, cache)
        if "k_scale" in cache:
            sc = ("layers", "batch", None, "cache_heads")
            if cache["k_scale"].ndim == 5:
                sc = sc + (None,)
            axes["k_scale"] = axes["v_scale"] = sc
        return axes

    def _moe_apply(self, mp: dict, h: torch.Tensor,
                   split: bool = False) -> torch.Tensor:
        """The MoE half on packed experts: each expert leaf dequantized
        from its (single-rounding) codes to float32, the float router and
        the float activations ``h`` (not activation-quantized, even at
        a4) through the capacity dispatch.  On a mesh the leaves hold this
        rank's block of the experts, so only those are dequantized."""
        experts = {k: (v.dequantize() if isinstance(v, QTensor) else v)
                   for k, v in mp.items()}
        return super()._moe_apply(experts, h, split)
