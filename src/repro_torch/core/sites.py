"""Transform-site placement (paper §3.3 / §4.1) for the dense family.

* ``ln_attn``: after the attention norm, feeding q/k/v.  Full in
  weight-only mode; diagonal when activations are quantized, so it merges
  into the norm.
* ``vo``: between v_proj and out_proj, one head_dim^2 matrix per KV head
  (shared by its query group: the only tying that merges on both sides).
* ``ln_mlp``: after the MLP norm, feeding the gate and up projections;
  fc1 -> fc2 is excluded (the nonlinearity breaks the equivalence).
* shifts ride on the two norm sites when activations are quantized.
"""
from __future__ import annotations

from repro_torch.core.affine import AffineSpec

_OTHER_FAMILIES = ("the MoE, mamba2 and griffin families' transform sites "
                   "are not ported yet (ROADMAP queue 1 item 11)")


def require_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family={cfg.family!r}: {_OTHER_FAMILIES}")


def block_sites(cfg, weight_only: bool) -> list:
    """Transform sites of one dense block."""
    require_dense(cfg)
    ln_kind = "full" if weight_only else "diagonal"
    shift = not weight_only
    return [AffineSpec("ln_attn", ln_kind, cfg.d_model, with_shift=shift),
            AffineSpec("vo", "headwise", cfg.resolved_head_dim,
                       num_heads=cfg.num_kv_heads),
            AffineSpec("ln_mlp", ln_kind, cfg.d_model, with_shift=shift)]


def quantized_weights(cfg) -> list:
    """The weight matrices of one block that calibration quantizes (each
    gets LWC parameters), as ``/``-joined paths."""
    require_dense(cfg)
    ws = ["wq", "wk", "wv", "wo", "mlp/w_up", "mlp/w_down"]
    if cfg.act in ("swiglu", "geglu"):
        ws.append("mlp/w_gate")
    return ws
