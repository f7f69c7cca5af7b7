"""The float dense and MoE model of the port: ``init``, ``forward``,
``loss`` (with the MoE load-balance term), and
serving through the Engine (``init_cache`` / ``init_paged_cache`` /
``prefill`` / ``prefill_chunk`` / ``decode_step``, from
:class:`~repro_torch.models.transformer.ServingTrunk`).

The float linears are ``x @ w`` (``torch.matmul``), as the reference
computes them outside any Pallas kernel; the cache is float (kv16) and
attention reads it through the flash kernels on CUDA tensors at
``mode="auto"``, through their plain versions on the CPU or at
``mode="plain"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sites import require_ported
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.init import init_lm


@dataclasses.dataclass(frozen=True)
class Model(transformer.ServingTrunk):
    cfg: ModelConfig
    device: str = "cuda"
    mode: str = "auto"
    block_kv: Optional[int] = None

    kv_bits = 16

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.mode not in ops.MODES:
            raise ValueError(f"mode={self.mode!r}: use one of {ops.MODES}")
        require_ported(self.cfg)

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w

    def init(self, seed: int) -> dict:
        """Seeded random float parameters on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_lm(self.cfg, gen, self.device)

    def forward(self, params: dict, batch: dict) -> torch.Tensor:
        return transformer.forward(params, self.cfg,
                                   torch.as_tensor(batch["tokens"]
                                                   ).to(self.device))

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        return transformer.lm_loss(params, self.cfg,
                                   dict(batch, tokens=tokens))


def build_model(cfg: ModelConfig, device="cuda", mode: str = "auto") -> Model:
    return Model(cfg, device, mode)
