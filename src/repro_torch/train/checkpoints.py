"""Atomic npz checkpoints in the reference's layout, both directions.

Layout (the reference's ``train/checkpoints.py``)::

    <dir>/step_<N:08d>/manifest.json   {step, leaves: {path: shape, dtype}}
    <dir>/step_<N:08d>/arrays.npz      one entry per leaf path

A leaf's path joins its dict keys, sorted, with ``||``; a :class:`QTensor`
contributes ``.packed``, ``.scale`` and ``.zp`` (the reference's dataclass
field keys), so ``layers||wq||.packed`` is the stacked packed codes of
``wq``.  A step is written to ``step_<N>.tmp`` and renamed, and only after
that are the oldest steps beyond ``keep`` removed.

A QTensor's ``bits`` and ``group_size`` are not stored (they are pytree
aux data in the reference).  :func:`load_tree` recovers them from the
model config and the leaf shapes: ``K`` is the linear's input width, the
packed codes have ``K * bits / 8`` rows and the scales ``K / group_size``.
bf16 leaves are stored as raw 2-byte records (``|V2``, as numpy saves an
``ml_dtypes.bfloat16`` array) with ``bfloat16`` in the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.bridge import tensor_from_numpy
from repro_torch.core.qtensor import QTensor
from repro_torch.device import resolve_device

SEP = "||"
_QT_KEYS = (".packed", ".scale", ".zp")


def _leaf(x) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2"), "bfloat16"
        a = x.numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def flatten(tree) -> dict:
    """{path: (array, dtype name)} in the reference's key order."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif isinstance(node, QTensor):
            for k in _QT_KEYS:
                walk(getattr(node, k[1:]), path + (k,))
        else:
            out[SEP.join(path)] = _leaf(node)

    walk(tree, ())
    return out


def save(ckpt_dir, step: int, tree, keep: int = 3,
         extra: Optional[dict] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = flatten(tree)
    np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in leaves.items()})
    manifest = {"step": step,
                "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                           for k, (a, dt) in leaves.items()},
                "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    for old in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{old:08d}", ignore_errors=True)
    return final


def _steps(ckpt_dir: Path) -> list:
    return sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                  if p.is_dir() and not p.name.endswith(".tmp"))


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    steps = _steps(ckpt_dir) if ckpt_dir.exists() else []
    return steps[-1] if steps else None


def _d_in(cfg, name: str) -> int:
    """Input width K of a packed linear, by its leaf name."""
    widths = {"wq": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
              "w_gate": cfg.d_model, "w_up": cfg.d_model,
              "wo": cfg.num_heads * cfg.resolved_head_dim,
              "w_down": cfg.d_ff}
    if name not in widths:
        raise ValueError(f"packed leaf {name!r}: not a linear of the dense "
                         f"llama block")
    return widths[name]


def _qtensor(node: dict, path: str, cfg, qcfg) -> QTensor:
    packed, scale, zp = (node[k] for k in _QT_KEYS)
    k = _d_in(cfg, path.split(SEP)[-1])
    rows, srows = packed.shape[-2], scale.shape[-2]
    if rows * 8 != qcfg.w_bits * k:
        raise ValueError(f"{path}: {rows} packed rows for K={k} are not "
                         f"{qcfg.w_bits}-bit codes")
    if k % srows:
        raise ValueError(f"{path}: {srows} scale rows do not divide K={k}")
    return QTensor(packed, scale, zp, qcfg.w_bits, k // srows)


def _build(node: dict, path: str, cfg, qcfg):
    if set(node) == set(_QT_KEYS):
        return _qtensor(node, path, cfg, qcfg)
    return {k: (_build(v, f"{path}{SEP}{k}" if path else k, cfg, qcfg)
                if isinstance(v, dict) else v) for k, v in node.items()}


def load_tree(ckpt_dir, cfg, qcfg, step: Optional[int] = None,
              device="cuda") -> dict:
    """The nested tree of a checkpoint as torch tensors on ``device``, with
    QTensor leaves rebuilt (``qcfg.w_bits`` must match the stored codes).
    Index path parts (a list, or a reference ``TrainState``'s fields) stay
    string keys."""
    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    src = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    tree: dict = {}
    with np.load(src / "arrays.npz") as data:
        for key, meta in manifest["leaves"].items():
            node = tree
            *parents, last = key.split(SEP)
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = tensor_from_numpy(data[key], device, meta["dtype"])
    return _build(tree, "", cfg, qcfg)
