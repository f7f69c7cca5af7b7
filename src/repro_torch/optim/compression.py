"""Gradient compression for the data-parallel reduction (the reference's
``optim/compression.py``): an int8 per-leaf-scaled all-reduce.

Each rank quantizes every gradient leaf to int8 with a float32 scale of
its own (``max(max|g|, 1e-12) / 127``; codes ``clip(round(g / scale),
-127, 127)``, round half to even), the codes are summed over the
data-parallel axes as int32 and the scales are summed, and the leaf comes
back as ``total * (sum of scales / n) / n``: about the mean of the ranks'
gradients, the per-rank scales averaged.  The arithmetic is the
reference's, in its order; every quotient is an IEEE quotient by a tensor
(PyTorch turns a division by a Python number into a multiply by the
reciprocal on the card).

The wire carries int32 codes, 4 bytes a value, as the reference's ``psum``
of ``q.astype(int32)`` does: no fewer bytes than a float32 all-reduce.
What the hook changes is the result (a lossy, zero-mean rounding of each
rank's gradient), not the traffic.

It is the ``compress_grads`` hook of
:func:`repro_torch.train.step.make_train_step`: on a mesh it replaces the
float mean over the data-parallel axes.  Its input is each rank's own
gradient (its local batch's mean), each leaf laid out the same on every
rank of ``axes`` (a rank's "model" shard of the leaf, so its scale is the
shard's).  Under GSPMD the reference's ``shard_map`` over a replicated
``P()`` sees gradients XLA has already averaged over "data", so there its
effective result is the quantized mean; the port sums each rank's codes,
which is what the reference's docstring describes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.serve.tensor_parallel import all_reduce
from repro_torch.sharding import axis_sizes
from repro_torch.utils import tree_map


def int8_codes(g: torch.Tensor) -> tuple:
    """(int8 codes, float32 scale) of one rank's leaf: ``scale = max(max
    |g|, 1e-12) / 127``, ``q = clip(round(g / scale), -127, 127)``."""
    top = torch.clamp_min(torch.max(torch.abs(g)), 1e-12)
    scale = top / torch.full_like(top, 127.0)
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8), \
        scale


def make_int8_psum(mesh, axes: tuple = ("data",)):
    """Returns ``compress(grads)``: every leaf all-reduced over ``axes``
    through int8 codes.  ``axes`` keeps only the mesh's own axes, so
    ``("pod", "data")`` works on a mesh with or without a "pod" axis; the
    sums run over each axis in turn, in ``axes``' order."""
    sizes = axis_sizes(mesh)
    names = tuple(a for a in axes if a in sizes)
    groups = [mesh.get_group(a) for a in names if sizes[a] > 1]
    n = math.prod(sizes[a] for a in names)

    def reduce_leaf(g: torch.Tensor) -> torch.Tensor:
        q, s = int8_codes(g)
        total = q.to(torch.int32)
        for group in groups:
            total = all_reduce(total, group)
            s = all_reduce(s, group)
        count = torch.full_like(s, float(n))
        return total.to(torch.float32) * (s / count) / count

    def compress(grads):
        return tree_map(reduce_leaf, grads)

    return compress
