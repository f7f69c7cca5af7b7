"""Architecture registry of the port: ``get_config(name)``."""
from __future__ import annotations

from repro_torch.configs.archs import PAPER_ARCHS
from repro_torch.configs.base import ModelConfig


def get_config(name: str) -> ModelConfig:
    if name not in PAPER_ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(PAPER_ARCHS)}")
    return PAPER_ARCHS[name]


__all__ = ["ModelConfig", "PAPER_ARCHS", "get_config"]
