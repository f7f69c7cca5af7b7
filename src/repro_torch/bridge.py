"""Carry a parameter tree of the reference package into the port.

``from_jax_params`` takes the tree as numpy arrays (or anything
``numpy.asarray`` accepts) and returns the same tree of torch tensors on
``device``.  A packed weight is recognised by its ``packed``, ``scale``,
``zp``, ``bits`` and ``group_size`` attributes and becomes a
:class:`QTensor`, so both frameworks compute on identical codes.  Python
strings, ints, floats and bools pass through unchanged: a calibration
parameter tree describes its transform sites with them (``_sites``).

Every array leaf crosses byte for byte.  numpy has no bfloat16 of its own:
the reference's bf16 leaves (the default dtype of its full-size configs, and
a kv4 cache's scales) are ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses, and an npz file returns them as raw ``|V2``
bytes.  Such a leaf is recognised by its dtype's name (or the name its
checkpoint's manifest gives), viewed as ``uint16`` and reinterpreted as
``torch.bfloat16``, so the port needs no ``ml_dtypes``; every other dtype
goes through ``torch.from_numpy`` as it is.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor

_QT_FIELDS = ("packed", "scale", "zp", "bits", "group_size")
_PLAIN = (str, bool, int, float)


def tensor_from_numpy(a: np.ndarray, device,
                      dtype_name: Optional[str] = None) -> torch.Tensor:
    """``a`` as a torch tensor on ``device``, byte for byte; ``dtype_name``
    overrides ``a.dtype.name`` (a bf16 leaf read back from an npz)."""
    if (dtype_name or a.dtype.name) == "bfloat16":
        bits = np.array(a.view(np.uint16), copy=True)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_params(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    if isinstance(tree, _PLAIN):
        return tree
    if all(hasattr(tree, f) for f in _QT_FIELDS):
        return QTensor(from_jax_params(tree.packed, device),
                       from_jax_params(tree.scale, device),
                       from_jax_params(tree.zp, device),
                       int(tree.bits), int(tree.group_size))
    return tensor_from_numpy(np.asarray(tree), device)
