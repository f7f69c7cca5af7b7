"""Carry a parameter tree of the reference package into the port.

``from_jax_params`` takes the tree as numpy arrays (or anything
``numpy.asarray`` accepts) and returns the same tree of torch tensors on
``device``.  A packed weight is recognised by its ``packed``, ``scale``,
``zp``, ``bits`` and ``group_size`` attributes and becomes a
:class:`QTensor`, so both frameworks compute on identical codes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor

_QT_FIELDS = ("packed", "scale", "zp", "bits", "group_size")


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def from_jax_params(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if all(hasattr(tree, f) for f in _QT_FIELDS):
        return QTensor(_tensor(tree.packed, device),
                       _tensor(tree.scale, device), _tensor(tree.zp, device),
                       int(tree.bits), int(tree.group_size))
    return _tensor(tree, device)
