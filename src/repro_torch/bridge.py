"""Carry a parameter tree of the reference package into the port.

``from_jax_params`` takes the tree as numpy arrays (or anything
``numpy.asarray`` accepts) and returns the same tree of torch tensors on
``device``.  A packed weight is recognised by its ``packed``, ``scale``,
``zp``, ``bits`` and ``group_size`` attributes and becomes a
:class:`QTensor`, so both frameworks compute on identical codes.

Every leaf crosses byte for byte.  numpy has no bfloat16 of its own: the
reference's bf16 leaves (the default dtype of its full-size configs, and a
kv4 cache's scales) are ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses.  Such a leaf is recognised by its dtype's
name, viewed as ``uint16`` and reinterpreted as ``torch.bfloat16``, so the
port needs no ``ml_dtypes``; every other dtype goes through
``torch.from_numpy`` as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor

_QT_FIELDS = ("packed", "scale", "zp", "bits", "group_size")


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = np.array(a.view(np.uint16), copy=True)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_params(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if all(hasattr(tree, f) for f in _QT_FIELDS):
        return QTensor(_tensor(tree.packed, device),
                       _tensor(tree.scale, device), _tensor(tree.zp, device),
                       int(tree.bits), int(tree.group_size))
    return _tensor(tree, device)
