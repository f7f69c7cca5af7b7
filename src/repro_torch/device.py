"""The one device rule of the port: entry points run on the card unless the
caller asks for the CPU, and a CUDA request without CUDA raises."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The requested device; CUDA that is absent raises (no quiet CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: use 'cuda' or 'cpu'")
    return dev
