"""The kv4 cache format: block-32 microscaling int4 codes.

K/V vectors are stored as two signed int4 codes per byte along D
(:func:`repro_torch.core.packing.pack_nibbles`) with one bfloat16 scale per
block of ``KV_BLOCK`` = 32 values.  :func:`kv4_quantize` is the
quantize-on-write step of the serving model; :func:`kv4_dequant` is the
dequantization the plain flash versions run per tile and the CUDA kernels
run per element (a code times its widened bf16 scale, exact in float32).
The per-group weight ``quantize_pack`` kernel of the reference is not
ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import pack_nibbles, unpack_nibbles

KV_BLOCK = 32     # values sharing one bf16 scale
KV4_QMAX = 7.0    # symmetric int4 grid: codes in [-8, 7]


def kv4_check_head_dim(d: int) -> None:
    """kv4 needs D % 32 == 0: one bf16 scale per 32-value block and two
    codes per byte."""
    if d % KV_BLOCK != 0:
        raise ValueError(
            f"kv_bits=4 requires head_dim % {KV_BLOCK} == 0 (one bf16 scale "
            f"per {KV_BLOCK}-value block, two int4 codes per byte); got "
            f"head_dim={d}")


def kv4_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) float -> (packed codes int8 (..., D // 2), scales bf16
    (..., D // 32)).  ``scale = bf16(max|block| / 7)``; codes are rounded
    against the bf16-rounded scale, so dequant -> requant is a fixed point.
    A non-finite block keeps a NaN scale."""
    d = x.shape[-1]
    kv4_check_head_dim(d)
    xf = x.to(torch.float32).reshape(*x.shape[:-1], d // KV_BLOCK, KV_BLOCK)
    bound = torch.clamp_min(torch.amax(xf.abs(), dim=-1), 1e-8)
    # IEEE quotient: dividing by a Python number would be a reciprocal
    # multiply in PyTorch
    scales = (bound / torch.full_like(bound, KV4_QMAX)).to(torch.bfloat16)
    q = torch.clamp(torch.round(xf / scales.to(torch.float32)[..., None]),
                    -KV4_QMAX - 1.0, KV4_QMAX)
    # a NaN block's codes are 0, as the reference's conversion gives (a
    # float -> int cast of NaN is undefined in C++)
    q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
    return pack_nibbles(q.reshape(*x.shape[:-1], d)), scales


def kv4_dequant(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(..., D // 2) int8 codes + (..., D // 32) bf16 scales -> (..., D)
    float32."""
    codes = unpack_nibbles(packed)
    block = torch.repeat_interleave(scales.to(torch.float32), KV_BLOCK,
                                    dim=-1)
    return codes.to(torch.float32) * block
