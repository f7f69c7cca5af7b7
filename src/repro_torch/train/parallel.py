"""Training on a (data, model) mesh over ``torch.distributed``: FSDP over
"data", tensor parallelism over "model" and the batch rows over the
data-parallel axes, the layout the reference's ``sharding.make_rules()``
(FSDP on) gives a ``TrainState`` under GSPMD.

A rank holds its shard of every leaf (:class:`MeshTraining` cuts them by
``Model.param_logical_axes`` under the training rules): q/k/v and the
MLP's up-projections their output columns over "model", ``wo`` /
``w_down`` their input rows, the embedding and an untied head the
vocabulary, and every "fsdp_embed" dimension (the model width) over
"data"; Adam's moments follow their parameters, ``count`` and ``step``
are whole on every rank.  The step
(:func:`repro_torch.train.step.make_train_step` with ``mesh``):

1. gathers each FSDP-split leaf over "data", outside autograd, into fresh
   leaves that hold the rank's "model" shard (:meth:`MeshTraining.gather`);
2. runs the loss and backward on the rank's rows of the global batch, the
   forward meeting the other "model" ranks through :class:`TrainParallel`;
3. reduces every gradient over the data-parallel axes: a float mean, or
   the ``compress_grads`` hook (the reference's int8 reduction,
   :mod:`repro_torch.optim.compression`) in its place; with a ``mask`` each
   rank's loss and gradient are weighted by its share of the tokens;
4. takes the global norm of the whole tree (a "model"-split leaf's
   squares summed over "model", a replicated leaf counted once), so every
   rank clips by the same factor, and keeps the rank's FSDP slice;
5. runs Adam on the local shards.

The loss and the norm are the global batch's on every rank, so the loop's
NaN guard decides alike everywhere.  On a 1 x 1 mesh no collective runs
and the step is the unsharded step, bit for bit.

The forward's collectives over "model" are the conjugate pairs of tensor
parallelism, each an autograd function: ``copy`` (identity; backward: the
sum over "model") where a replicated activation enters column-parallel
products, ``sum`` (all-reduce; backward: identity) after a row-parallel
product or the embedding's masked lookup, ``gather`` (all-gather;
backward: this rank's slice) where a whole consumer follows (the logits
before the cross entropy; q / k / v where "model" does not divide the KV
heads) and ``cols`` (this rank's columns; backward: all-gather) where a
replicated tensor meets this rank's block (the whole attention output
before a row-split ``wo``, a replicated bias).  Without ``copy`` the
gradients of the replicated leaves (norm scales, the embedding's rows)
would be partial and differ by rank, and the replicas would drift apart.
They wrap the serving trunk's plain collectives
(:mod:`repro_torch.serve.tensor_parallel`), which stage a gloo group's
CUDA tensors through the host.

Only the dense trunk trains on a mesh larger than 1 x 1 (ROADMAP queue 1,
item 6d has MoE, mamba2 / griffin, vlm and audio).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.models.init import init_lm
from repro_torch.serve.tensor_parallel import all_gather, all_reduce
from repro_torch.sharding import (axis_sizes, local_shard, make_rules,
                                  mesh_coordinate, shard_tree,
                                  tree_shardings)
from repro_torch.train.step import TrainState
from repro_torch.utils import tree_leaves, tree_map

NOT_DENSE = ("training on a mesh larger than 1 x 1 covers the dense trunk "
             "only: the {family} family on a training mesh is ROADMAP "
             "queue 1, item 6d")


# ---------------------------------------------------------------------------
# the conjugate pairs over "model" (autograd functions)
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.width = index, x.shape[-1]
        return all_gather(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None, None


class _Cols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, width):
        ctx.group = group
        lo = index * width
        return x[..., lo:lo + width].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, -1), None, None, None


class TrainParallel:
    """One rank's collectives over "model" for the training forward
    (``models/transformer.py`` takes it as ``tp``).  ``heads``: "model"
    divides the query and KV heads, so attention runs on this rank's heads
    (the reference's rule); else on q / k / v gathered whole."""

    def __init__(self, mesh, cfg):
        self.m = axis_sizes(mesh).get("model", 1)
        self.mi = mesh_coordinate(mesh).get("model", 0)
        self.group = mesh.get_group("model")
        self.heads = (cfg.num_heads % self.m == 0
                      and cfg.num_kv_heads % self.m == 0)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; the gradient is summed over "model"."""
        return _Copy.apply(x, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over "model"; the gradient passes unchanged."""
        return _Sum.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The last dim's pieces from every "model" rank, concatenated; the
        gradient is this rank's slice."""
        return _Gather.apply(x, self.group, self.mi)

    def cols(self, t: torch.Tensor, width: int) -> torch.Tensor:
        """``t``'s last dim cut to this rank's ``width`` columns when it is
        wider; the gradient is gathered over "model"."""
        if t.shape[-1] == width:
            return t
        return _Cols.apply(t, self.group, self.mi, width)


# ---------------------------------------------------------------------------
# the layout of a TrainState and the step's data-parallel collectives
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _walk(fn: Callable, tree, specs):
    """``fn(leaf, spec)`` over a tensor tree and its spec tree (specs are
    tuples, so they cannot go through ``utils.tree_map``)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def _pairs(tree, specs) -> list:
    """(leaf, spec) in ``utils.tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _pairs(tree[k], specs[k])]
    if isinstance(tree, list):
        return [p for v, s in zip(tree, specs) for p in _pairs(v, s)]
    return [(tree, specs)]


def state_bytes(state) -> dict:
    """Bytes of this rank's parameters and Adam moments."""
    count = lambda tree: sum(t.numel() * t.element_size()
                             for t in tree_leaves(tree))
    return {"params": count(state.params),
            "moments": count(state.opt["mu"]) + count(state.opt["nu"])}


class MeshTraining:
    """A model's ``TrainState`` on ``mesh`` under the reference's training
    rules (``make_rules()`` with FSDP on; with a "pod" axis the multipod
    ones): the leaves' specs, the rank's rows of a
    batch, the FSDP gather and slice, the reductions over the
    data-parallel axes, the global norm, and whole states for checkpoints
    (:meth:`unshard` gathers, :meth:`shard` cuts, so a state saved on one
    mesh restores on any other)."""

    def __init__(self, model, mesh):
        cfg = model.cfg
        self.sizes = axis_sizes(mesh)
        self.world = math.prod(self.sizes.values())
        if cfg.family != "dense" and self.world > 1:
            raise NotImplementedError(NOT_DENSE.format(family=cfg.family))
        self.mesh, self.device = mesh, model.device
        self.coord = mesh_coordinate(mesh)
        self.rules = make_rules(multi_pod="pod" in self.sizes)
        self.shapes = init_lm(cfg, torch.Generator().manual_seed(0), "meta")
        self.specs = tree_shardings(model.param_logical_axes(), self.shapes,
                                    mesh, self.rules)
        self.dp = tuple(a for a in _axes(self.rules.get("batch"))
                        if a in self.sizes)
        self.data = math.prod(self.sizes[a] for a in self.dp)
        self.groups = {a: mesh.get_group(a) for a, n in self.sizes.items()
                       if n > 1}
        self.m = self.sizes.get("model", 1)
        self.tp = TrainParallel(mesh, cfg) if self.m > 1 else None
        self.writer = dist.get_rank() == 0 if self.world > 1 else True

    # ---- rows ------------------------------------------------------------
    def rows(self, batch: dict) -> dict:
        """This rank's rows of the global batch: contiguous blocks over the
        data-parallel axes (row-major, as ``sharding.local_shard``)."""
        if self.data == 1:
            return batch
        block = 0
        for a in self.dp:
            block = block * self.sizes[a] + self.coord[a]
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            if v.shape[0] % self.data:
                raise ValueError(f"batch of {v.shape[0]} rows does not "
                                 f"split over {self.data} data-parallel "
                                 f"ranks")
            n = v.shape[0] // self.data
            out[k] = v[block * n:(block + 1) * n]
        return out

    # ---- FSDP ------------------------------------------------------------
    def _gather_leaf(self, t: torch.Tensor, spec: tuple,
                     keep_model: bool) -> torch.Tensor:
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            if keep_model and "model" in axes:
                if len(axes) > 1:
                    raise ValueError(f"spec {spec}: dim {dim} mixes "
                                     f"\"model\" with other axes")
                continue
            for a in reversed(axes):       # the inner axis first
                if self.sizes[a] > 1:
                    t = all_gather(t, self.groups[a], dim)
        return t

    def gather(self, params: dict) -> dict:
        """Each leaf whole over every axis but "model" (the rank's "model"
        shard), outside autograd; the leaves themselves on a mesh without
        data-parallel ranks."""
        if self.world == self.m:
            return params
        with torch.no_grad():
            return _walk(lambda t, s: self._gather_leaf(t, s, True), params,
                         self.specs)

    def keep_local(self, tree: dict) -> dict:
        """A tree of "model" shards (whole over "data") cut to this rank's
        FSDP slices."""
        if self.world == self.m:
            return tree

        def cut(t, spec):
            spec = tuple(None if "model" in _axes(e) else e for e in spec)
            return local_shard(t, spec, self.mesh, self.coord)
        return _walk(cut, tree, self.specs)

    # ---- reductions over the data-parallel axes ----------------------------
    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        for a in self.dp:
            if self.sizes[a] > 1:
                x = all_reduce(x, self.groups[a])
        return x

    def dp_mean(self, x: torch.Tensor) -> torch.Tensor:
        if self.data == 1:
            return x
        return self.dp_sum(x) / torch.tensor(float(self.data),
                                             device=x.device)

    def reduce(self, loss: torch.Tensor, grads: dict, batch: dict,
               compress: Optional[Callable] = None) -> tuple:
        """(the global batch's loss, each gradient reduced over the
        data-parallel axes): the float mean, or ``compress(grads)`` (each
        rank's local-mean gradient in, the reduced tree out).  With a
        ``mask`` a rank's loss and gradient weigh by its share of the
        tokens."""
        mask = batch.get("mask")
        if mask is not None and self.data > 1:
            n = torch.sum(torch.as_tensor(mask).to(torch.float32)).to(
                loss.device)
            total = torch.clamp_min(self.dp_sum(n), 1.0)
            loss = self.dp_sum(loss * n) / total
            w = float(self.data) * n / total
            grads = tree_map(lambda g: g * w, grads)
        else:
            loss = self.dp_mean(loss)
        if compress is not None:
            return loss, compress(grads)
        return loss, tree_map(self.dp_mean, grads)

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The norm of the whole gradient tree from this rank's "model"
        shards (whole over "data", identical on every data rank): a
        "model"-split leaf's sum of squares is summed over "model", a
        replicated one counted once, and the leaves' sums are added in
        ``utils.global_norm``'s order."""
        pairs = _pairs(grads, self.specs)
        sums = [torch.sum(torch.square(g.to(torch.float32)))
                for g, _ in pairs]
        split = [i for i, (_, spec) in enumerate(pairs)
                 if any("model" in _axes(e) for e in spec)]
        if split and self.m > 1:
            v = all_reduce(torch.stack([sums[i] for i in split]),
                           self.groups["model"])
            for j, i in enumerate(split):
                sums[i] = v[j]
        total = None
        for s in sums:
            total = s if total is None else total + s
        return torch.sqrt(total)

    def slowest(self, seconds: float) -> float:
        """The largest of every rank's ``seconds`` (the straggler
        monitor's step time, alike on every rank)."""
        if self.world == 1:
            return seconds
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.tensor([seconds], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    # ---- whole states (checkpoints) ----------------------------------------
    def shard_params(self, params: dict) -> dict:
        """Whole parameters (on any device) cut to this rank's shards on
        the model's device."""
        return shard_tree(params, self.specs, self.mesh, device=self.device)

    def shard(self, state):
        """A whole ``TrainState`` cut to this rank's shards."""
        opt = {k: (self.shard_params(v) if isinstance(v, dict)
                   else v.to(self.device)) for k, v in state.opt.items()}
        return TrainState(self.shard_params(state.params), opt,
                          state.step.to(self.device))

    def unshard(self, state):
        """The whole ``TrainState`` on the host, gathered from every rank
        (every rank must call it)."""
        whole = lambda tree: _walk(
            lambda t, s: self._gather_leaf(t, s, False).cpu(), tree,
            self.specs)
        with torch.no_grad():
            opt = {k: (whole(v) if isinstance(v, dict) else v.cpu())
                   for k, v in state.opt.items()}
            return TrainState(whole(state.params), opt, state.step.cpu())

    def like(self, state):
        """Empty host tensors of the whole state's shapes and this state's
        dtypes: the like tree a checkpoint restores into."""
        empty = lambda tree: _walk(
            lambda t, s: torch.empty(s.shape, dtype=t.dtype), tree,
            self.shapes)
        opt = {k: (empty(v) if isinstance(v, dict) else v.cpu())
               for k, v in state.opt.items()}
        return TrainState(empty(state.params), opt, state.step.cpu())
