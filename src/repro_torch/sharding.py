"""Logical-axis sharding: rule tables and divisibility-safe resolution.

Models and caches name their tensors' dimensions with *logical* axes
("batch", "heads", "mlp", "vocab", "cache_heads", ...).  A rule table maps
each logical name to a mesh axis ("data", "model", "pod"), a tuple of them,
or None.  Resolution is divisibility-safe: a mesh axis that does not divide
the tensor dimension is dropped (from the tail of a tuple rule) and the
dimension stays whole, and no mesh axis is used twice in one spec.

A *spec* is a plain tuple with the entries of a ``PartitionSpec`` (None, an
axis name, or a tuple of names), trailing Nones dropped, so ``()`` means
replicated.  Resolution reads only the mesh's axis names and sizes, so it
takes a ``torch.distributed`` ``DeviceMesh``, any object with an
``axis_names`` tuple and a ``shape`` mapping, or a ``(names, sizes)`` pair,
and needs no process group.

Placement is explicit: the port's kernels are custom launches with no
sharding-propagation rules, so a sharded tensor is this rank's local slice
of the whole (:func:`local_shard`, :func:`shard_tree`), cut once, and the
serving trunk calls its collectives itself
(:mod:`repro_torch.serve.tensor_parallel`).

Concatenated leaves.  A contiguous cut of a dimension that concatenates
several components would give one rank whole components and another none,
so a model can override the cut of such a leaf's last dimension with
:class:`Segments`: each component cut into equal contiguous blocks over a
mesh axis, or whole on every rank, and the rank's pieces concatenated in
the same order (:func:`cut_segments`).  mamba2's leaves are the case (its
``Model.param_cuts`` / ``cache_cuts``), with H SSD heads of P channels, G
state groups of N and "model" of size m dividing H:

* ``in_proj`` (L, d, [z | x | B | C | dt]) -> [z_r | x_r | B | C | dt_r]:
  z and x (H P each) by heads, H P / m a rank (heads ``r H / m`` on),
  dt (H) by heads; B and C (G N each) whole while m does not divide G,
  else by groups;
* ``conv_w`` (L, W, [x | B | C]), ``conv_b`` (L, [x | B | C]) and the conv
  state (L, B, W - 1, [x | B | C]): the same components as ``in_proj``'s;
* ``a_log``, ``d_skip``, ``dt_bias`` (L, H) and ``gate_norm``'s scale
  (L, H P): by heads.

The specs stay the reference's (``in_proj`` ("fsdp_embed", "inner"),
``a_log`` replicated, ...); only the cut differs.  Where m does not
divide H, every component stays whole on every rank.  A rank's pieces
from every rank, component by component, reassemble the whole leaf.

Usage::

    specs = tree_shardings(model.param_logical_axes(), params, mesh, rules)
    local = shard_tree(params, specs, mesh)
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Optional, Sequence, Union

import torch

from repro_torch.core.qtensor import QTensor

logger = logging.getLogger(__name__)

Axis = Union[None, str, tuple]

_state = threading.local()


def _ctx():
    if not hasattr(_state, "mesh"):
        _state.mesh = None
        _state.rules = {}
    return _state


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Bind a mesh and logical rules for the enclosed region
    (thread-local)."""
    ctx = _ctx()
    prev = (ctx.mesh, ctx.rules)
    ctx.mesh, ctx.rules = mesh, dict(rules or {})
    try:
        yield
    finally:
        ctx.mesh, ctx.rules = prev


def current_mesh():
    return _ctx().mesh


def current_rules() -> dict:
    return _ctx().rules


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, of an object with
    ``axis_names`` and a ``shape`` mapping, or of a ``(names, sizes)``
    pair."""
    if isinstance(mesh, tuple):
        names, sizes = mesh
        return dict(zip(names, sizes))
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                          # a DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.axis_names, mesh.shape))


def _axis_size(sizes: dict, axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return sizes[axis]
    n = 1
    for a in axis:
        n *= sizes[a]
    return n


def _resolve(names, dims_of, mesh, rules, what: str) -> tuple:
    """The shared walk of :func:`resolve_spec` and
    :func:`resolve_joint_spec`: ``dims_of(i)`` lists the sizes dimension
    ``i`` must be divisible in (empty: no shape known)."""
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules if rules is not None else current_rules()
    sizes = axis_sizes(mesh) if mesh is not None else None
    out: list = []
    used: set = set()
    for i, name in enumerate(names):
        axis = rules.get(name) if name else None
        if axis is None:
            out.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        axes = tuple(a for a in axes if a not in used)
        if sizes is not None:
            dims = dims_of(i)
            while axes and any(d % _axis_size(sizes, axes) for d in dims):
                logger.debug("sharding: drop axis %s from %s dim %d (%s: "
                             "%s)", axes[-1], what, i, name, dims)
                axes = axes[:-1]
        if not axes:
            out.append(None)
        else:
            used.update(axes)
            out.append(axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def resolve_spec(names: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None, mesh=None,
                 rules: Optional[dict] = None) -> tuple:
    """Logical names -> spec, dropping mesh axes that do not divide the
    dimension (a tuple rule such as batch -> ("pod", "data") drops from
    its tail until the rest divides)."""
    return _resolve(names, lambda i: () if shape is None else (shape[i],),
                    mesh, rules, "tensor")


def resolve_joint_spec(names: Sequence[Optional[str]],
                       shapes: Sequence[Sequence[int]], mesh=None,
                       rules: Optional[dict] = None) -> tuple:
    """ONE spec that divides EVERY shape in ``shapes``: tensors that must
    stay co-sharded but differ in size (a QTensor's packed codes, ``K * bits
    / 8`` wide, and its ``K / group_size`` grid) keep an axis only where it
    divides the dimension in all of them."""
    ranks = {len(s) for s in shapes}
    if len(ranks) != 1 or len(names) not in ranks:
        raise ValueError(f"joint resolution needs same-rank shapes matching "
                         f"the {len(names)} logical names; got {shapes}")
    return _resolve(names, lambda i: tuple(s[i] for s in shapes), mesh,
                    rules, "joint")


def _padded(spec: tuple, rank: int) -> tuple:
    return tuple(spec) + (None,) * (rank - len(spec))


def qtensor_spec(axes, qt: QTensor, mesh=None,
                 rules: Optional[dict] = None) -> tuple:
    """The one spec shared by a QTensor's codes, scale and zero points.

    ``axes`` is a logical-name tuple for the (..., K, N) weight, or the
    legacy ``{"packed", "scale", "zp"}`` dict, whose entries must agree.
    Resolution is joint over the logical (K, N), the packed bytes (``K *
    bits / 8``) and the group grid (``K / group_size``), and the result is
    checked against each leaf again."""
    if not isinstance(qt, QTensor):
        raise TypeError(f"qtensor_spec needs a QTensor; got {type(qt)}")
    if isinstance(axes, dict):
        name_sets = {tuple(axes[k]) for k in ("packed", "scale", "zp")}
        if len(name_sets) != 1:
            raise ValueError(
                f"QTensor leaves must share one logical-axes tuple; got "
                f"{axes} — per-leaf divergence would shard codes and grid "
                f"differently")
        names = next(iter(name_sets))
    else:
        names = tuple(axes)
    leaves = (qt.packed, qt.scale, qt.zp)
    logical = tuple(qt.packed.shape[:-2]) + (qt.d_in, qt.d_out)
    spec = resolve_joint_spec(names, [logical] + [tuple(t.shape)
                                                  for t in leaves],
                              mesh, rules)
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is not None:
        sizes = axis_sizes(mesh)
        for leaf in leaves:
            for i, ax in enumerate(_padded(spec, len(names))):
                assert ax is None or \
                    leaf.shape[i] % _axis_size(sizes, ax) == 0, (
                        f"resolved spec {spec} does not partition QTensor "
                        f"leaf shape {tuple(leaf.shape)} at dim {i}")
    return spec


def _is_names(x) -> bool:
    return x is None or (isinstance(x, tuple)
                         and all(a is None or isinstance(a, str) for a in x))


def tree_shardings(axes_tree, tree, mesh, rules: dict):
    """Zip a logical-axes tree with a tensor tree -> a spec tree of the
    same structure.  A subtree with no declared axes replicates (``()`` for
    each tensor): calibration by-products such as merged q/k/v biases and
    activation-transform factors.  A QTensor node gets one spec for its
    codes, scale and zero points (:func:`qtensor_spec`), returned as a
    QTensor of specs; a PagedKVCache is keyed by field.  Leaves need only
    ``.shape``."""
    from repro_torch.serve.kv_cache import PagedKVCache

    def replicate(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: replicate(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(replicate(v) for v in node)
        if isinstance(node, QTensor):
            return QTensor((), (), (), node.bits, node.group_size)
        if isinstance(node, PagedKVCache):
            return walk({}, node)
        if hasattr(node, "shape"):
            return ()
        return node                   # a plain value (an int, a string)

    def walk(axes, node):
        if node is None:
            return None
        if axes is None:
            return replicate(node)
        if isinstance(node, QTensor):
            spec = qtensor_spec(axes, node, mesh, rules)
            return QTensor(spec, spec, spec, node.bits, node.group_size)
        if isinstance(node, PagedKVCache):
            fields = {f.name: walk(axes.get(f.name), getattr(node, f.name))
                      for f in dataclasses.fields(node)
                      if f.name != "page_size"}
            return PagedKVCache(page_size=node.page_size, **fields)
        if _is_names(axes):
            return resolve_spec(axes, tuple(node.shape), mesh, rules)
        if isinstance(axes, dict):
            return {k: walk(axes.get(k), v) for k, v in node.items()}
        if isinstance(axes, list):
            return [walk(a, s) for a, s in zip(axes, node)]
        raise TypeError(f"unexpected axes node {type(axes)}")
    return walk(axes_tree, tree)


def batch_shards(mesh=None, rules: Optional[dict] = None) -> int:
    """The data-parallel shard count of ``mesh`` (default: the bound one):
    the product of the sizes of the mesh axes the "batch" rule names, 1
    without a mesh (the reference's MoE dispatch groups)."""
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules if rules is not None else current_rules()
    axis = rules.get("batch")
    if mesh is None or axis is None:
        return 1
    sizes = axis_sizes(mesh)
    g = 1
    for a in ((axis,) if isinstance(axis, str) else axis):
        g *= sizes.get(a, 1)
    return g


@dataclasses.dataclass(frozen=True)
class Segments:
    """The last dimension of a leaf as concatenated components: ``parts``
    is a tuple of (width, mesh axis or None), a component cut into equal
    contiguous blocks over that axis, or whole on every rank (None)."""
    parts: tuple

    @property
    def width(self) -> int:
        return sum(w for w, _ in self.parts)


def cut_segments(t: torch.Tensor, seg: Segments, mesh,
                 coord: Optional[dict] = None) -> torch.Tensor:
    """This rank's pieces of ``t``'s last dimension under ``seg``,
    concatenated in component order."""
    if t.shape[-1] != seg.width:
        raise ValueError(f"segments of width {seg.width} do not cover the "
                         f"last dimension of {tuple(t.shape)}")
    sizes = axis_sizes(mesh)
    coord = coord if coord is not None else mesh_coordinate(mesh)
    pieces, start = [], 0
    for width, axis in seg.parts:
        if axis is None or sizes[axis] == 1:
            pieces.append(t[..., start:start + width])
        else:
            n = width // sizes[axis]
            if n * sizes[axis] != width:
                raise ValueError(f"mesh axis {axis} of size {sizes[axis]} "
                                 f"does not divide a component of width "
                                 f"{width}")
            lo = start + coord[axis] * n
            pieces.append(t[..., lo:lo + n])
        start += width
    return torch.cat(pieces, dim=-1).contiguous()


def mesh_coordinate(mesh) -> dict:
    """{axis name: this rank's index along it} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def local_shard(t: torch.Tensor, spec: tuple, mesh,
                coord: Optional[dict] = None) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` under ``spec``: each
    sharded dimension cut into equal contiguous blocks, the block index the
    rank's mesh coordinate (row-major over a tuple of axes)."""
    if not spec:
        return t
    sizes = axis_sizes(mesh)
    coord = coord if coord is not None else mesh_coordinate(mesh)
    index = []
    for dim, ax in enumerate(spec):
        if ax is None:
            index.append(slice(None))
            continue
        axes = (ax,) if isinstance(ax, str) else ax
        block = 0
        for a in axes:
            block = block * sizes[a] + coord[a]
        n = t.shape[dim] // _axis_size(sizes, ax)
        index.append(slice(block * n, (block + 1) * n))
    return t[tuple(index)].contiguous()


def shard_tree(tree, specs, mesh, device=None, cuts=None):
    """Every tensor of ``tree`` cut to this rank's local shard under the
    matching entry of ``specs`` (:func:`tree_shardings`), and moved to
    ``device`` when one is given: the whole tree may sit on the CPU and
    only the shards reach the card.  ``cuts``, a partial tree of
    :class:`Segments`, overrides the cut of those leaves' last dimension
    (their other dimensions follow the spec)."""
    from repro_torch.serve.kv_cache import PagedKVCache
    coord = mesh_coordinate(mesh)

    def cut(t, spec, seg=None):
        if seg is not None:
            spec = _padded(spec, t.ndim)[:-1]
            out = cut_segments(local_shard(t, spec, mesh, coord), seg, mesh,
                               coord)
        else:
            out = local_shard(t, spec, mesh, coord)
        return out if device is None else out.to(device)

    def walk(node, spec, seg):
        if node is None:
            return None
        if isinstance(node, QTensor):
            return QTensor(cut(node.packed, spec.packed),
                           cut(node.scale, spec.scale),
                           cut(node.zp, spec.zp), node.bits, node.group_size)
        if isinstance(node, PagedKVCache):
            fields = {f.name: walk(getattr(node, f.name),
                                   getattr(spec, f.name), None)
                      for f in dataclasses.fields(node)
                      if f.name != "page_size"}
            return PagedKVCache(page_size=node.page_size, **fields)
        if isinstance(node, dict):
            seg = seg if isinstance(seg, dict) else {}
            return {k: walk(v, spec[k], seg.get(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            seg = seg if isinstance(seg, (list, tuple)) else [None] * len(node)
            return type(node)(walk(v, s, c)
                              for v, s, c in zip(node, spec, seg))
        if isinstance(node, torch.Tensor):
            return cut(node, spec, seg)
        return node
    return walk(tree, specs, cuts)


def shard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """This rank's local shard of the whole tensor ``x`` under the bound
    mesh and rules; ``x`` itself when no mesh is bound."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or not rules:
        return x
    return local_shard(x, resolve_spec(names, tuple(x.shape), mesh, rules),
                       mesh)


# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------

def make_rules(*, multi_pod: bool = False, fsdp: bool = True,
               seq_sharding: bool = False) -> dict:
    """Default logical -> mesh mapping for the production meshes:
    data-parallel over ("pod", "data"), tensor / expert parallel over
    "model", FSDP over "data" for the params' input-feature axis."""
    dp: Axis = ("pod", "data") if multi_pod else "data"
    return {
        # activations
        "batch": dp,
        "seq": dp if seq_sharding else None,
        "embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_mlp": "model",
        "act_expert": "model",
        "act_seq_tp": "model",
        "expert_cap": dp,
        "act_vocab": "model",
        "act_rnn": "model",
        "act_inner": "model",
        # params: the tensor-parallel axis
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "rnn": "model",
        "inner": "model",
        # params: FSDP (input-feature / stacked-layer dims)
        "fsdp_embed": "data" if fsdp else None,
        "layers": None,
        # serving: decode caches split their KV-head dim over "model";
        # pages and positions stay whole on every rank.  "kv_seq" and
        # "kv_pages" are the superseded placements, kept for tables that
        # still name them.
        "cache_heads": "model",
        "kv_seq": "model",
        "kv_pages": "model",
        "ssm_heads": "model",
        # never sharded
        "head_dim": None,
        "state": None,
        "conv": None,
        "group": None,
        "mlp_local": None,
        "qgroups": None,
    }


def make_serving_rules() -> dict:
    """Logical -> mesh mapping for mesh-native serving: column-parallel
    wq / wk / wv / w_gate / w_up and the vocabulary over "model", cache
    pools over their KV-head dim, the batch over "data", and FSDP off —
    weights stay resident, and wo / w_down keep their whole K, so each
    sublayer's one collective is on activations, not weights."""
    return make_rules(fsdp=False)
