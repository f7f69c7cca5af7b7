"""Weight-activation packed matmul (the W4A4 / W4A8 serving path).

``quant_matmul_plain`` is the plain PyTorch version of the reference's
``quant_matmul_ref``: per-token dynamic symmetric ``a_bits`` activation
codes with one whole-row scale, weight codes centred by
``off = 2^(bits-1)``, an exact integer dot per K group (float64 products of
small integers, exact far past any group length here, since CUDA has no
int32 matmul), and the float32 epilogue in the reference's op order.
``w4a8_matmul`` runs it for CPU tensors and launches
``csrc/w4a8_matmul.cu`` for CUDA tensors.

Divisions here and in the quantizers divide by a tensor: PyTorch turns a
division by a Python number into a multiply by its reciprocal, which is
not the IEEE quotient the reference and the kernels compute.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import unpack
from repro_torch.kernels import _lib
from repro_torch.kernels.dequant_matmul import check_packed


def quant_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor, zp: torch.Tensor, *, bits: int,
                       group_size: int, a_bits: int) -> torch.Tensor:
    """x (M, K) float -> (M, N) in x.dtype."""
    m, k = x.shape
    n = packed.shape[-1]
    xf = x.to(torch.float32)
    qmax = 2.0 ** (a_bits - 1) - 1.0
    bound = torch.clamp_min(torch.amax(xf.abs(), dim=-1, keepdim=True), 1e-8)
    a_scale = bound / torch.full_like(bound, qmax)
    x_q = torch.clamp(torch.round(xf / a_scale), -qmax - 1.0, qmax)
    off = 2 ** (bits - 1)
    g = group_size or k
    groups = k // g
    c = unpack(packed, bits, k).to(torch.float64) - off           # (K, N)
    xg = x_q.to(torch.float64).reshape(m, groups, g)
    dot = torch.bmm(xg.transpose(0, 1), c.reshape(groups, g, n)
                    ).to(torch.float32)                            # (G, M, N)
    rsum = xg.sum(dim=-1).to(torch.float32)                        # (M, G)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for gi in range(groups):
        acc = acc + scale[gi][None, :] * (
            dot[gi] + rsum[:, gi:gi + 1] * (off - zp[gi])[None, :])
    return (acc * a_scale).to(x.dtype)


def w4a8_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                zp: torch.Tensor, *, bits: int, group_size: int,
                a_bits: int) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, packed, scale, zp, bits=bits,
                                  group_size=group_size, a_bits=a_bits)
    g = check_packed("w4a8_matmul", x, packed, scale, zp, bits, group_size)
    if not 2 <= a_bits <= 8:
        raise ValueError(f"a_bits={a_bits}: the kernel takes 2..8")
    m, k = x.shape
    n = packed.shape[-1]
    dev = x.device
    x_q = torch.empty((m, k), dtype=torch.int8, device=dev)
    a_scale = torch.empty((m,), dtype=torch.float32, device=dev)
    rsum = torch.empty((m, k // g), dtype=torch.int32, device=dev)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    _lib.launch("w4a8_matmul", x.data_ptr(), x_q.data_ptr(),
                a_scale.data_ptr(), rsum.data_ptr(), packed.data_ptr(),
                scale.data_ptr(), zp.data_ptr(), y.data_ptr(), m, k, n, bits,
                g, a_bits)
    return y
