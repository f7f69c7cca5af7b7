"""One rank's view of a (data, model) serving mesh: its coordinates, the
two axes' process groups and the collectives the serving trunk calls.

The trunk runs on plain local tensors (``sharding.shard_tree`` cut them
once) and meets the other ranks only here:

* ``gather(x, "model")`` where a column-parallel output meets a consumer
  that needs all of it: the attention output before a whole-K ``wo``,
  ``act(gate) * up`` before a whole-K ``w_down``, the logits after a
  vocabulary-split head, and q / k / v when attention cannot split by
  heads;
* ``sum(x, "model")`` after a row-parallel product (the float model's
  ``wo`` / ``w_down``) and after the embedding's masked lookup in this
  rank's vocabulary slice (x + 0 + ... + 0: exact);
* ``gather(x, "data")`` of a step's newly written K/V, so every rank's
  replicated page pool stays whole, and of the hidden states before the
  head, so the head runs every row as the unsharded step does.

Heads split over "model" only where "model" divides the KV heads (and so
the query heads), the reference's rule; elsewhere attention runs whole on
every rank.  A step's rows split over "data" where "data" divides them;
whole-prompt admission, whose group size varies, runs on every data rank.

The other families' collectives are all ``sum(x, "model")``: an MoE
block's zero-filled (token, k) pair rows, each rank holding its block of
the experts (:meth:`span`); a mamba2 block's ``gate_norm`` sum of squares
and its row-split ``out_proj``, a rank holding its block of the SSD heads;
griffin's row-split ``w_out``, a rank holding its block of the rnn
channels (``rec``: the recurrent width is split).

A gloo group's collective on a CUDA tensor is staged through the host: the
copy to the host waits for this rank's own stream, so the collective sees
the rank's finished kernels.  NCCL takes CUDA tensors as they are.  The
plain collectives (:func:`all_gather`, :func:`all_reduce`) also carry
training on a mesh (:mod:`repro_torch.train.parallel` wraps them in
autograd functions).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.sharding import axis_sizes, mesh_coordinate


class TensorParallel:
    """``heads``: the cache's KV heads are split over "model" (resolution
    splits them where "model" divides them, and so the query heads: the
    reference's ``_tp_mesh`` rule).  ``batch``: the rules map "batch" onto
    "data", so steps split their rows where "data" divides them."""

    def __init__(self, mesh, cfg, *, heads: bool, batch: bool = True,
                 rec: bool = False):
        sizes = axis_sizes(mesh)
        coord = mesh_coordinate(mesh)
        self.m, self.d = sizes.get("model", 1), sizes.get("data", 1)
        self.mi, self.di = coord.get("model", 0), coord.get("data", 0)
        self.groups = {a: mesh.get_group(a) for a in ("model", "data")
                       if sizes.get(a, 1) > 1}
        if heads and (cfg.num_heads % self.m or cfg.num_kv_heads % self.m):
            raise ValueError(f"heads split over model={self.m} needs it to "
                             f"divide {cfg.num_heads} query and "
                             f"{cfg.num_kv_heads} KV heads")
        self.heads = heads and self.m > 1
        self.batch = batch and self.d > 1
        self.rec = rec and self.m > 1

    @property
    def size(self) -> int:
        return self.m * self.d

    # ---- shapes ----------------------------------------------------------
    def rows(self, b: int) -> Optional[slice]:
        """This rank's rows of a ``b``-row step, or None (whole) where
        "data" does not split it."""
        if not self.batch or b % self.d:
            return None
        n = b // self.d
        return slice(self.di * n, (self.di + 1) * n)

    def span(self, local: int, whole: int) -> slice:
        """This rank's block of a ``whole``-wide axis (its experts) cut over
        "model" into blocks of ``local``; all of it where it is not cut."""
        if local == whole:
            return slice(0, whole)
        return slice(self.mi * local, (self.mi + 1) * local)

    def cols(self, t: torch.Tensor, width: int) -> torch.Tensor:
        """``t``'s last dim cut to this rank's ``width`` columns when it is
        wider (a replicated bias beside a column-split weight)."""
        if t.shape[-1] == width:
            return t
        return t[..., self.mi * width:(self.mi + 1) * width]

    # ---- collectives -----------------------------------------------------
    def gather(self, x: torch.Tensor, axis: str, dim: int = -1
               ) -> torch.Tensor:
        """The pieces of ``x`` from every rank of ``axis``, concatenated
        along ``dim`` in rank order; ``x`` when the axis has one rank."""
        group = self.groups.get(axis)
        return x if group is None else all_gather(x, group, dim)

    def sum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The elementwise sum of ``x`` over the ranks of ``axis``."""
        group = self.groups.get(axis)
        return x if group is None else all_reduce(x, group)


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().cpu()
    return x.detach().contiguous()


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The pieces of ``x`` from every rank of ``group`` concatenated along
    ``dim`` in rank order, on ``x``'s device (outside autograd; 2-byte
    floats cross as int16: a gather moves bits only)."""
    xs = _staged(x, group)
    raw = xs.view(torch.int16) if xs.dtype in (torch.bfloat16,
                                                torch.float16) else xs
    parts = [torch.empty_like(raw) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, raw, group=group)
    out = torch.cat(parts, dim=dim)
    return (out.view(xs.dtype) if raw is not xs else out).to(x.device)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of ``x`` over the ranks of ``group``, on
    ``x``'s device (outside autograd; ``x`` itself is left as it was)."""
    xs = _staged(x, group)
    if xs.device == x.device:          # no host copy was made
        xs = xs.clone()
    dist.all_reduce(xs, op=dist.ReduceOp.SUM, group=group)
    return xs.to(x.device)
