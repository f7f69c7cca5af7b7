"""Weight-only packed matmul: ``y = x @ ((codes - zp) * scale)``.

``dequant_matmul_plain`` is the plain PyTorch version (the reference's
``dequant_matmul_ref`` op for op); ``dequant_matmul`` runs it for CPU
tensors and launches ``csrc/dequant_matmul.cu`` for CUDA tensors.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.packing import unpack
from repro_torch.kernels import _lib

KERNEL_BITS = (2, 4, 8)
# The kernel's K split (rows per fmaf chain) and its decode body's largest M
# (csrc/dequant_matmul.cu).
SPLIT = 512
DECODE_MMAX = 8
# csrc/dequant_matmul.cu's bodies, by the number aq_dequant_plan returns:
# decode (M <= 8), tile (M > 8, each block walks all of K) and tile_split
# (M > 8, K cut across blocks at split boundaries, the splits added by a
# second launch).  The wrapper counts launches of each body in
# _lib.LAUNCHES["dequant_matmul/<body>"].
BODIES = ("decode", "tile", "tile_split")


def dequant_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                         scale: torch.Tensor, zp: torch.Tensor, *, bits: int,
                         group_size: int) -> torch.Tensor:
    """x (M, K) float @ dequant(packed (K//8*bits, N)) -> (M, N) in x.dtype;
    scale/zp (K // group_size, N) float32, float32 accumulation."""
    m, k = x.shape
    n = packed.shape[-1]
    codes = unpack(packed, bits, k).to(torch.float32)
    g = group_size or k
    w = (codes.reshape(k // g, g, n) - zp[:, None, :]) * scale[:, None, :]
    return torch.matmul(x, w.reshape(k, n).to(x.dtype))


def check_packed(name, x, packed, scale, zp, bits: int, group_size: int
                 ) -> int:
    """Shared wrapper checks of the two packed-weight kernels; returns the
    effective group size."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    k, n = x.shape[1], packed.shape[-1]
    g = group_size or k
    if bits not in KERNEL_BITS:
        raise NotImplementedError(f"{name} kernel: {bits}-bit codes are not "
                                  f"ported yet (use 2, 4 or 8)")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} kernel takes float32 x, got {x.dtype}")
    if (packed.dtype != torch.uint8 or packed.shape[0] != k // 8 * bits
            or scale.shape != (k // g, n) or zp.shape != (k // g, n)
            or scale.dtype != torch.float32 or zp.dtype != torch.float32):
        raise ValueError(f"{name}: packed (K//8*bits, N) uint8 and scale/zp "
                         f"(K//g, N) float32 expected")
    if k % 8 or k % g or g % 8:
        raise ValueError(f"{name} kernel needs K % 8 == 0 and a group "
                         f"(g={g}) that divides K and is a multiple of 8")
    _lib.check_cuda(name, x, packed, scale, zp)
    return g


def dequant_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                   zp: torch.Tensor, *, bits: int,
                   group_size: int) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, packed, scale, zp, bits=bits,
                                    group_size=group_size)
    g = check_packed("dequant_matmul", x, packed, scale, zp, bits,
                     group_size)
    m, k = x.shape
    n = packed.shape[-1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    # the per-split partial sums of the decode body (M <= 8) or of a tile
    # body that cuts K across blocks
    nbytes = _workspace_bytes(m, k, n)
    part = (torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
            if nbytes else None)
    _lib.launch("dequant_matmul", x.data_ptr(), packed.data_ptr(),
                scale.data_ptr(), zp.data_ptr(), y.data_ptr(), _lib.ptr(part),
                m, k, n, bits, g)
    _lib.LAUNCHES["dequant_matmul/" + plan(m, k, n)["body"]] += 1
    return y


@functools.lru_cache(maxsize=None)
def _workspace_bytes(m: int, k: int, n: int) -> int:
    """The bytes of the kernel's float32 workspace, as its C entry lays it
    out (csrc/dequant_matmul.cu: workspace_floats)."""
    return _lib.lib().aq_dequant_workspace_bytes(m, k, n)


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int) -> dict:
    """The body ``dequant_matmul`` runs at (M, K, N) on the card: its name
    (:data:`BODIES`), the tile (bm x bn; 0 for decode) and the K chunks
    the tile body's grid cuts K into (csrc/dequant_matmul.cu:
    choose_tile, which reads the card's SM count)."""
    code = _lib.lib().aq_dequant_plan(m, k, n)
    return {"body": BODIES[code & 0xFF], "bm": (code >> 8) & 0xFF,
            "bn": (code >> 16) & 0xFF, "chunks": code >> 24}
