"""The one quantized-weight representation: packed codes + per-group grid.

``w ~= (codes - zp) * scale`` with codes packed along K
(:mod:`repro_torch.core.packing`) and ``scale``/``zp`` per (group, column).
A stacked per-layer weight keeps a leading ``L`` axis on all three tensors;
``qt[l]`` is layer ``l``'s weight (views, no copy).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.packing import unpack


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Attributes:
      packed: (..., K // 8 * bits, N) uint8.
      scale:  (..., K // group_size, N) float32.
      zp:     (..., K // group_size, N) float32, integer-valued.
      bits:   bit-width of the codes.
      group_size: effective K-axis group length (nonzero, divides K).
    """
    packed: torch.Tensor
    scale: torch.Tensor
    zp: torch.Tensor
    bits: int
    group_size: int

    @property
    def d_in(self) -> int:
        return self.packed.shape[-2] * 8 // self.bits

    @property
    def d_out(self) -> int:
        return self.packed.shape[-1]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.packed, self.scale, self.zp))

    def __getitem__(self, i) -> "QTensor":
        return QTensor(self.packed[i], self.scale[i], self.zp[i], self.bits,
                       self.group_size)

    def codes(self) -> torch.Tensor:
        """Unpacked uint8 codes (..., K, N)."""
        return unpack(self.packed, self.bits, self.d_in)

    def dequantize(self) -> torch.Tensor:
        """(codes - zp) * scale in float32, subtract then scale."""
        k, n = self.d_in, self.d_out
        lead = self.packed.shape[:-2]
        g = self.group_size or k
        cg = self.codes().to(torch.float32).reshape(*lead, k // g, g, n)
        w = (cg - self.zp[..., None, :]) * self.scale[..., None, :]
        return w.reshape(*lead, k, n)
