"""The float dense llama model of the port: ``init``, ``forward``, ``loss``.

Serving the float model through the Engine is not ported yet (ROADMAP
queue 1 item 7); the packed model is served by ``serve/quantized.py``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sites import require_dense
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.init import init_lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: str = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        require_dense(self.cfg)

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


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)
