"""Uniform affine pseudo-quantization (paper Eq. 1) with learnable clipping.

    Q(w) = Delta * (clamp(round(w / Delta) + zp, 0, 2^n - 1) - zp)

Weights are ``(in_features, out_features)`` and multiply as ``y = x @ w``;
groups run along the input axis K per output column, ``group_size == 0``
meaning one group per column.  Learnable weight clipping (LWC, from
OmniQuant) shrinks each group's max / min by ``sigmoid(gamma)`` /
``sigmoid(beta)``; a straight-through estimator on the rounding lets the
calibration loss reach the clips and the affine transforms.

The op order (max/min, clip factors, range, scale, zero point,
round-half-even, clip) follows the reference quantizer, and a quotient that
feeds a rounding step divides by a tensor (PyTorch turns a division by a
Python number into a multiply by its reciprocal), so with the same clip
factors the codes, scales and zero points are byte-equal to the ones the
reference emits when called eagerly.  The clamps are ``maximum`` /
``minimum`` against tensors: at a tie both split the gradient in half, as
the reference's ``jnp.clip`` does (``torch.clamp`` passes all of it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.packing import pack
from repro_torch.core.qtensor import QTensor


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """w_bits: weight bit-width (16 disables weight quantization).
    a_bits: activation bit-width (16 keeps activations in float).
    group_size: K-axis group length, 0 = per output channel.
    symmetric: symmetric weight grid (zero point at the midpoint).
    lwc: learnable weight clipping during calibration.
    act_symmetric: symmetric per-token activation grid.
    kv_bits: KV-cache bit-width for serving (8 = int8 codes, 16 = fp)."""
    w_bits: int = 4
    a_bits: int = 16
    group_size: int = 0
    symmetric: bool = False
    lwc: bool = True
    act_symmetric: bool = True
    kv_bits: int = 16

    @property
    def quantize_weights(self) -> bool:
        return self.w_bits < 16

    @property
    def quantize_acts(self) -> bool:
        return self.a_bits < 16

    @property
    def levels(self) -> int:
        return 2 ** self.w_bits - 1

    def tag(self) -> str:
        g = f"g{self.group_size}" if self.group_size else ""
        return f"w{self.w_bits}a{self.a_bits}{g}kv{self.kv_bits}"


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """The IEEE quotient ``x / c`` (not a reciprocal multiply)."""
    return x / torch.full_like(x, c)


def effective_group_size(d_in: int, group_size: int) -> int:
    """Group length used along a K of ``d_in``: 0 and non-dividing group
    sizes fall back to one group spanning K."""
    g = group_size if group_size else d_in
    if d_in % g != 0:
        g = d_in
    return g


def _to_groups(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """(..., K, N) -> (..., K // g, g, N) float32."""
    *lead, d_in, d_out = w.shape
    g = effective_group_size(d_in, group_size)
    return w.to(torch.float32).reshape(*lead, d_in // g, g, d_out)


def init_lwc_params(w_shape: tuple, group_size: int, init_value: float = 4.0,
                    device=None) -> dict:
    """Per-group clip logits ``gamma`` / ``beta`` (..., groups, 1, d_out)
    for a (..., K, N) weight (stacked experts get one set each);
    ``sigmoid(4) ~= 0.982``: almost no clipping to start."""
    *lead, d_in, d_out = w_shape
    n_groups = d_in // effective_group_size(d_in, group_size)
    full = lambda: torch.full((*lead, n_groups, 1, d_out), init_value,
                              dtype=torch.float32, device=device)
    return {"gamma": full(), "beta": full()}


def weight_qparams(w: torch.Tensor, cfg: QuantConfig,
                   lwc: Optional[dict] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-group (scale, zp) of a (..., K, N) weight, each (..., groups, 1,
    N) f32, every (K, N) matrix on its own grid (the reference vmaps the
    quantizer over stacked experts; these are elementwise ops and
    reductions within one matrix, so the values are the same); zp is not
    rounded yet."""
    wg = _to_groups(w, cfg.group_size)
    wmax = torch.amax(wg, dim=-2, keepdim=True)
    wmin = torch.amin(wg, dim=-2, keepdim=True)
    if cfg.lwc and lwc is not None:
        wmax = torch.sigmoid(lwc["gamma"]) * wmax
        wmin = torch.sigmoid(lwc["beta"]) * wmin
    if cfg.symmetric:
        bound = torch.maximum(wmax.abs(), wmin.abs())
        wmax, wmin = bound, -bound
    rng = torch.clamp_min(wmax - wmin, 1e-8)
    scale = _div(rng, 2 ** cfg.w_bits - 1)
    zp = -wmin / scale
    return scale, zp


def fake_quant_weight(w: torch.Tensor, cfg: QuantConfig,
                      lwc: Optional[dict] = None) -> torch.Tensor:
    """Pseudo-quantize a (..., K, N) weight, differentiable through the
    STE; same shape and dtype as ``w``."""
    if not cfg.quantize_weights:
        return w
    wg = _to_groups(w, cfg.group_size)
    scale, zp = weight_qparams(w, cfg, lwc)
    zr = round_ste(zp)
    q = _clip(round_ste(wg / scale) + zr, 0.0, float(cfg.levels))
    return ((q - zr) * scale).reshape(w.shape).to(w.dtype)


def quantize_weight_int(w: torch.Tensor, cfg: QuantConfig,
                        lwc: Optional[dict] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Codes uint8 (K, N) in [0, 2^bits - 1], scale and rounded zp (G, N)."""
    wg = _to_groups(w, cfg.group_size)
    scale, zp = weight_qparams(w, cfg, lwc)
    zp = torch.round(zp)
    q = torch.clamp(torch.round(wg / scale) + zp, 0, cfg.levels)
    return q.reshape(w.shape).to(torch.uint8), scale[:, 0], zp[:, 0]


def quantize_codes(w: torch.Tensor, cfg: QuantConfig,
                   lwc: Optional[dict] = None) -> QTensor:
    """Quantize once onto the (clipped) grid and pack:
    ``quantize_codes(w, cfg, lwc).dequantize()`` equals
    ``fake_quant_weight(w, cfg, lwc)``.  Leading dims (stacked layers) are
    quantized one matrix at a time, which bounds the float temporaries to
    one layer's weight; ``lwc`` then carries the same leading dims."""
    if w.ndim > 2:
        flat = w.reshape(-1, *w.shape[-2:])
        lf = (None if lwc is None else
              {k: v.reshape(-1, *v.shape[-3:]) for k, v in lwc.items()})
        parts = [quantize_codes(wi, cfg, None if lf is None else
                                {k: v[i] for k, v in lf.items()})
                 for i, wi in enumerate(flat)]
        lead = w.shape[:-2]
        stack = lambda ts: torch.stack(ts).reshape(*lead, *ts[0].shape)
        return QTensor(stack([p.packed for p in parts]),
                       stack([p.scale for p in parts]),
                       stack([p.zp for p in parts]),
                       cfg.w_bits, parts[0].group_size)
    codes, scale, zp = quantize_weight_int(w, cfg, lwc)
    g = effective_group_size(w.shape[0], cfg.group_size)
    return QTensor(pack(codes, cfg.w_bits), scale, zp, cfg.w_bits, g)


def fake_quant_activation(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Per-token dynamic pseudo-quantization over the last axis,
    differentiable through the STE."""
    if not cfg.quantize_acts:
        return x
    xf = x.to(torch.float32)
    if cfg.act_symmetric:
        bound = torch.clamp_min(torch.amax(xf.abs(), dim=-1, keepdim=True),
                                1e-8)
        qmax = 2.0 ** (cfg.a_bits - 1) - 1.0
        scale = _div(bound, qmax)
        dq = _clip(round_ste(xf / scale), -qmax - 1.0, qmax) * scale
    else:
        xmax = torch.amax(xf, dim=-1, keepdim=True)
        xmin = torch.amin(xf, dim=-1, keepdim=True)
        scale = _div(torch.clamp_min(xmax - xmin, 1e-8), 2 ** cfg.a_bits - 1)
        zp = round_ste(-xmin / scale)
        q = _clip(round_ste(xf / scale) + zp, 0.0, float(2 ** cfg.a_bits - 1))
        dq = (q - zp) * scale
    return dq.to(x.dtype)
