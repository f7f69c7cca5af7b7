"""Uniform affine weight quantization onto the RTN grid (paper Eq. 1).

Weights are ``(in_features, out_features)`` and multiply as ``y = x @ w``;
groups run along the input axis K per output column, ``group_size == 0``
meaning one group per column.  The op order (max/min, range, scale, zero
point, round-half-even, clip) follows the reference quantizer, so the codes,
scales and zero points are byte-equal to the ones it emits.  Learnable
weight clipping belongs to calibration, which the port does not have yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.packing import pack
from repro_torch.core.qtensor import QTensor


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """w_bits: weight bit-width (16 disables weight quantization).
    a_bits: activation bit-width (16 keeps activations in float).
    group_size: K-axis group length, 0 = per output channel.
    kv_bits: KV-cache bit-width (8 = int8 codes, 16 = fp).
    The grid is asymmetric min/max (the reference's ``symmetric=False``)."""
    w_bits: int = 4
    a_bits: int = 16
    group_size: int = 0
    kv_bits: int = 16

    def tag(self) -> str:
        g = f"g{self.group_size}" if self.group_size else ""
        return f"w{self.w_bits}a{self.a_bits}{g}kv{self.kv_bits}"


def effective_group_size(d_in: int, group_size: int) -> int:
    """Group length used along a K of ``d_in``: 0 and non-dividing group
    sizes fall back to one group spanning K."""
    g = group_size if group_size else d_in
    if d_in % g != 0:
        g = d_in
    return g


def weight_qparams(w: torch.Tensor, cfg: QuantConfig
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-group (scale, zp) of a (K, N) weight, each (groups, 1, N) f32;
    zp is not rounded yet."""
    d_in, d_out = w.shape
    g = effective_group_size(d_in, cfg.group_size)
    wg = w.to(torch.float32).reshape(d_in // g, g, d_out)
    wmax = torch.amax(wg, dim=1, keepdim=True)
    wmin = torch.amin(wg, dim=1, keepdim=True)
    rng = torch.clamp_min(wmax - wmin, 1e-8)
    scale = rng / torch.full_like(rng, 2 ** cfg.w_bits - 1)  # IEEE quotient
    zp = -wmin / scale
    return scale, zp


def quantize_weight_int(w: torch.Tensor, cfg: QuantConfig
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Codes uint8 (K, N) in [0, 2^bits - 1], scale and rounded zp (G, N)."""
    d_in, d_out = w.shape
    g = effective_group_size(d_in, cfg.group_size)
    wg = w.to(torch.float32).reshape(d_in // g, g, d_out)
    scale, zp = weight_qparams(w, cfg)
    zp = torch.round(zp)
    q = torch.clamp(torch.round(wg / scale) + zp, 0, 2 ** cfg.w_bits - 1)
    return q.reshape(d_in, d_out).to(torch.uint8), scale[:, 0], zp[:, 0]


def quantize_codes(w: torch.Tensor, cfg: QuantConfig) -> QTensor:
    """Quantize once onto the RTN grid and pack.  Leading dims (stacked
    layers) are quantized one matrix at a time, which bounds the float
    temporaries to one layer's weight."""
    if w.ndim > 2:
        flat = w.reshape(-1, *w.shape[-2:])
        parts = [quantize_codes(wi, cfg) for wi in flat]
        lead = w.shape[:-2]
        stack = lambda ts: torch.stack(ts).reshape(*lead, *ts[0].shape)
        return QTensor(stack([p.packed for p in parts]),
                       stack([p.scale for p in parts]),
                       stack([p.zp for p in parts]),
                       cfg.w_bits, parts[0].group_size)
    codes, scale, zp = quantize_weight_int(w, cfg)
    g = effective_group_size(w.shape[0], cfg.group_size)
    return QTensor(pack(codes, cfg.w_bits), scale, zp, cfg.w_bits, g)
