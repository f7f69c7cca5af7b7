"""Per-group weight quantize + pack, and the kv4 cache format.

:func:`quantize_pack_plain` is the reference's ``quantize_pack_ref``: per
(K group, column) asymmetric min/max RTN codes on the serving quantizer's
grid (``core.quantizer``, the same ops in the same order), packed
little-endian along K (:func:`repro_torch.core.packing.pack`).
:func:`quantize_pack` runs it for CPU tensors and launches
``csrc/quantize_pack.cu`` for CUDA tensors; a (B, K, N) stack of weights
(a layer's experts, a stack of layers) is one launch, and on the CPU the
plain version one matrix at a time (:func:`quantize_pack_plain_batch`).

K/V vectors are stored as two signed int4 codes per byte along D
(:func:`repro_torch.core.packing.pack_nibbles`) with one bfloat16 scale per
block of ``KV_BLOCK`` = 32 values.  :func:`kv4_quantize` is the
quantize-on-write step of the serving model; :func:`kv4_dequant` is the
dequantization the plain flash versions run per tile and the CUDA kernels
run per element (a code times its widened bf16 scale, exact in float32).
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import pack, pack_nibbles, unpack_nibbles
from repro_torch.core.quantizer import QuantConfig, quantize_weight_int
from repro_torch.kernels import _lib
from repro_torch.kernels.dequant_matmul import KERNEL_BITS

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


def check_group(k: int, group_size: int) -> int:
    """The reference's shape contract: the effective group divides K and
    is a multiple of 8 (one packing unit); returns it."""
    g = group_size or k
    if k % g or g % 8:
        raise ValueError(f"quantize_pack needs a group (g={g}) that divides "
                         f"K={k} and is a multiple of 8")
    return g


def quantize_pack_plain(w: torch.Tensor, bits: int, group_size: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """w (K, N) float -> (packed (K // 8 * bits, N) uint8, scale (K // g, N)
    float32, zp (K // g, N) float32); ``group_size`` 0 is one K-wide group.
    The grid is the serving quantizer's (``quantize_weight_int``, the
    reference's op order).  Weights are finite (a NaN's uint8 code is
    undefined in the reference too)."""
    check_group(w.shape[0], group_size)
    codes, scale, zp = quantize_weight_int(
        w, QuantConfig(w_bits=bits, group_size=group_size))
    return pack(codes, bits), scale, zp


def quantize_pack_plain_batch(w: torch.Tensor, bits: int, group_size: int
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """:func:`quantize_pack_plain` of a (K, N) weight, or of each matrix of
    a (B, K, N) stack, stacked: (B, K // 8 * bits, N) and (B, K // g, N)."""
    if w.ndim == 2:
        return quantize_pack_plain(w, bits, group_size)
    k, n = w.shape[1:]
    g = check_group(k, group_size)
    if w.shape[0] == 0:
        return (torch.empty((0, k // 8 * bits, n), dtype=torch.uint8),
                torch.empty((0, k // g, n)), torch.empty((0, k // g, n)))
    parts = [quantize_pack_plain(wi, bits, group_size) for wi in w]
    return tuple(torch.stack(p) for p in zip(*parts))


def quantize_pack(w: torch.Tensor, *, bits: int, group_size: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version for CPU tensors, the CUDA kernel for CUDA tensors.
    ``w`` is one (K, N) weight or a (B, K, N) stack; a stack's outputs
    carry its leading B."""
    if w.ndim not in (2, 3):
        raise ValueError(f"quantize_pack takes a (K, N) weight or a (B, K, "
                         f"N) stack, got {tuple(w.shape)}")
    if w.device.type == "cpu":
        return quantize_pack_plain_batch(w, bits, group_size)
    lead, (k, n) = w.shape[:-2], w.shape[-2:]
    g = check_group(k, group_size)
    if w.device.type != "cuda":
        raise ValueError(f"quantize_pack: no kernel for device {w.device}")
    if bits not in KERNEL_BITS:
        raise NotImplementedError(f"quantize_pack kernel: {bits}-bit codes "
                                  f"take the plain route (ops.quantize_pack)")
    if w.dtype != torch.float32:
        raise ValueError(f"quantize_pack kernel takes float32 w, got "
                         f"{w.dtype}")
    _lib.check_cuda("quantize_pack", w)
    dev = w.device
    packed = torch.empty((*lead, k // 8 * bits, n), dtype=torch.uint8,
                         device=dev)
    scale = torch.empty((*lead, k // g, n), dtype=torch.float32, device=dev)
    zp = torch.empty((*lead, k // g, n), dtype=torch.float32, device=dev)
    if w.numel() == 0:
        return packed, scale, zp
    _lib.launch("quantize_pack", w.data_ptr(), packed.data_ptr(),
                scale.data_ptr(), zp.data_ptr(), w.shape[0] if lead else 1,
                k, n, bits, g)
    return packed, scale, zp
