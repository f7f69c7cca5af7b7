"""Integer-activation matmuls: the packed W4A4 / W4A8 serving path and the
int8 x int8 pair (``int8_matmul``, ``w8a8_matmul``).

``quant_matmul_plain`` is the plain PyTorch version of the reference's
``quant_matmul_ref``: per-token dynamic symmetric ``a_bits`` activation
codes with one whole-row scale, weight codes centred by
``off = 2^(bits-1)``, an exact integer dot per K group (float64 products of
small integers, exact far past any group length here, since CUDA has no
int32 matmul), and the float32 epilogue in the reference's op order.
``w4a8_matmul`` runs it for CPU tensors and launches
``csrc/w4a8_matmul.cu`` for CUDA tensors, bit-equal to it in both of its
bodies (decode M <= 8, tensor-core tile M > 8), so a row of y is the same at
every M.

``int8_matmul_plain`` and ``w8a8_dynamic_plain`` are the reference's
``int8_matmul_ref`` and ``w8a8_dynamic_ref``: int8 codes times int8
per-channel weight codes, the int32 dot converted to float32 once (round
to nearest) and scaled as ``(f32(acc) * x_scale) * w_scale``; the dynamic
form first quantizes each row with one whole-row scale, as the reference
does (the TPU kernel's per-K-slab scale is a tiling artifact and is not
reproduced).  ``int8_matmul`` and ``w8a8_matmul`` launch
``csrc/int8_matmul.cu`` for CUDA tensors.

Divisions here and in the quantizers divide by a tensor: PyTorch turns a
division by a Python number into a multiply by its reciprocal, which is
not the IEEE quotient the reference and the kernels compute.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.packing import unpack
from repro_torch.kernels import _lib
from repro_torch.kernels.dequant_matmul import check_packed


def act_quant_plain(x: torch.Tensor, a_bits: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric ``a_bits`` codes of x (M, K) with one whole-row
    scale: (codes (M, K) as float32, a_scale (M, 1) float32).  A NaN row
    keeps a NaN scale and NaN codes (the kernels' codes of such a row
    differ, its output row is NaN all the same)."""
    xf = x.to(torch.float32)
    qmax = 2.0 ** (a_bits - 1) - 1.0
    bound = torch.clamp_min(torch.amax(xf.abs(), dim=-1, keepdim=True), 1e-8)
    a_scale = bound / torch.full_like(bound, qmax)        # IEEE quotient
    x_q = torch.clamp(torch.round(xf / a_scale), -qmax - 1.0, qmax)
    return x_q, a_scale


def quant_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor, zp: torch.Tensor, *, bits: int,
                       group_size: int, a_bits: int) -> torch.Tensor:
    """x (M, K) float -> (M, N) in x.dtype."""
    m, k = x.shape
    n = packed.shape[-1]
    x_q, a_scale = act_quant_plain(x, a_bits)
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
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    nbytes = _w4a8_workspace_bytes(m, k, n, g)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    _lib.launch("w4a8_matmul", x.data_ptr(), ws.data_ptr(), nbytes,
                packed.data_ptr(), scale.data_ptr(), zp.data_ptr(),
                y.data_ptr(), m, k, n, bits, g, a_bits)
    return y


@functools.lru_cache(maxsize=None)
def _w4a8_workspace_bytes(m: int, k: int, n: int, g: int) -> int:
    """The bytes of w4a8_matmul's workspace, as its C entry lays it out
    (csrc/w4a8_matmul.cu: carve)."""
    return _lib.lib().aq_w4a8_workspace_bytes(m, k, n, g)


def int8_matmul_plain(x_q: torch.Tensor, x_scale: torch.Tensor,
                      w_q: torch.Tensor, w_scale: torch.Tensor
                      ) -> torch.Tensor:
    """x_q (M, K) int8 codes (any dtype holding them), x_scale (M, 1),
    w_q (K, N) int8, w_scale (N,) -> (M, N) float32.  The dot is exact:
    |acc| <= K * 128 * 128, far inside float64's integers; float64 -> float32
    rounds to nearest, as int32 -> float32 does."""
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
    out = acc.to(torch.float32) * x_scale.to(torch.float32).reshape(-1, 1)
    return out * w_scale.to(torch.float32)[None, :]


def w8a8_dynamic_plain(x: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) float -> (M, N) in x.dtype: int8 codes of each row
    (:func:`act_quant_plain` at 8 bits), then :func:`int8_matmul_plain`."""
    x_q, x_scale = act_quant_plain(x, 8)
    return int8_matmul_plain(x_q, x_scale, w_q, w_scale).to(x.dtype)


def _check_int8(name, x, w_q, w_scale, *more) -> None:
    """Shared wrapper checks of the two int8-weight kernels (``more``: other
    inputs on the same device)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"{name}: x (M, K) and w_q (K, N) expected, got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    if (w_q.dtype != torch.int8 or w_scale.dtype != torch.float32
            or w_scale.shape != (w_q.shape[1],)):
        raise ValueError(f"{name}: w_q (K, N) int8 and w_scale (N,) float32 "
                         f"expected")
    _lib.check_cuda(name, x, w_q, w_scale, *more)


def int8_matmul(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for CUDA tensors.
    x_q (M, K) int8, x_scale (M, 1) float32 -> (M, N) float32."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, x_scale, w_q, w_scale)
    _check_int8("int8_matmul", x_q, w_q, w_scale, x_scale)
    m, k = x_q.shape
    n = w_q.shape[1]
    if (x_q.dtype != torch.int8 or x_scale.dtype != torch.float32
            or x_scale.shape != (m, 1)):
        raise ValueError("int8_matmul: x_q (M, K) int8 and x_scale (M, 1) "
                         "float32 expected")
    y = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if y.numel() == 0:
        return y
    _lib.launch("int8_matmul", x_q.data_ptr(), x_scale.data_ptr(),
                w_q.data_ptr(), w_scale.data_ptr(), y.data_ptr(), m, k, n)
    return y


def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel (whole-row activation
    pre-pass, then the int8 dot) for CUDA tensors.  x (M, K) float32."""
    if x.device.type == "cpu":
        return w8a8_dynamic_plain(x, w_q, w_scale)
    _check_int8("w8a8_matmul", x, w_q, w_scale)
    if x.dtype != torch.float32:
        raise ValueError(f"w8a8_matmul kernel takes float32 x, got {x.dtype}")
    m, k = x.shape
    n = w_q.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    nbytes = _w8a8_workspace_bytes(m, k)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    _lib.launch("w8a8_matmul", x.data_ptr(), ws.data_ptr(), nbytes,
                w_q.data_ptr(), w_scale.data_ptr(), y.data_ptr(), m, k, n)
    return y


@functools.lru_cache(maxsize=None)
def _w8a8_workspace_bytes(m: int, k: int) -> int:
    """The bytes of w8a8_matmul's workspace (the activation codes and
    scales), as its C entry lays it out (csrc/int8_matmul.cu)."""
    return _lib.lib().aq_w8a8_workspace_bytes(m, k)


# csrc/int8_matmul.cu's bodies, by the number aq_int8_body returns
BODIES = ("decode", "wgmma", "mma_sync")


def int8_body(x_q: torch.Tensor, w_q: torch.Tensor) -> str:
    """The body of csrc/int8_matmul.cu that ``int8_matmul(x_q, ., w_q, .)``
    runs: "decode" (M <= 8), "wgmma" (M > 8 and TMA-able: K and N multiples
    of 16, 16-byte aligned x_q and w_q) or "mma_sync" (M > 8, other
    shapes).  CUDA tensors only."""
    m, k = x_q.shape
    return BODIES[_lib.lib().aq_int8_body(m, k, w_q.shape[1], x_q.data_ptr(),
                                          w_q.data_ptr())]


def w8a8_body(x: torch.Tensor, w_q: torch.Tensor) -> str:
    """As :func:`int8_body` for ``w8a8_matmul(x, w_q, .)``, whose codes lie
    in its 256-byte aligned workspace."""
    m, k = x.shape
    return BODIES[_lib.lib().aq_int8_body(m, k, w_q.shape[1], 0,
                                          w_q.data_ptr())]
