"""Architecture registry of the port: ``get_config(name)``."""
from __future__ import annotations

from repro_torch.configs.archs import (DENSE_ARCHS, MOE_ARCHS, OTHER_ARCHS,
                                      PAPER_ARCHS)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {**PAPER_ARCHS, **DENSE_ARCHS, **MOE_ARCHS,
                                  **OTHER_ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "DENSE_ARCHS", "MOE_ARCHS", "ModelConfig",
           "OTHER_ARCHS", "PAPER_ARCHS", "get_config"]
