"""Transform-site placement (paper §3.3 / §4.1) for the dense, MoE, VLM and
audio families (the VLM's and audio's blocks are the dense block's).

* ``ln_attn``: after the attention norm, feeding q/k/v.  Full in
  weight-only mode; diagonal when activations are quantized, so it merges
  into the norm.
* ``vo``: between v_proj and out_proj, one head_dim^2 matrix per KV head
  (shared by its query group: the only tying that merges on both sides).
* ``ln_mlp``: after the MLP norm, feeding the gate and up projections
  (the up projection alone in OPT's ReLU MLP); fc1 -> fc2 is excluded (the
  nonlinearity breaks the equivalence).  In an MoE block the router and
  every expert's gate and up projections share it (they read the same
  activations), the experts' down projections stay untransformed, and it
  has no shift (the reference's choice: no per-expert bias plumbing).
* shifts ride on the two norm sites when activations are quantized; a
  diagonal site merges its shift into the norm's bias (a LayerNorm's
  existing one, or a new one after an RMSNorm), and the shift corrects the
  consumers' biases (``bq``/``bk``/``bv``, ``b_gate``/``b_up``).
"""
from __future__ import annotations

from repro_torch.core.affine import AffineSpec
from repro_torch.models.layers import GATED

QUANTIZED_FAMILIES = ("dense", "moe", "vlm", "audio")
NO_QUANTIZED_PATH = ("the reference has no quantized path for the mamba2 "
                     "and griffin families (its calibration and packed "
                     "serving read the transformer block's ln_attn and wq, "
                     "which their blocks do not have); the port serves and "
                     "trains them through the float Model")


def require_quantizable(cfg) -> None:
    """Refuse a family that calibration, the baselines and
    ``QuantizedModel`` do not take: mamba2 and griffin, which the reference
    cannot quantize either."""
    if cfg.family not in QUANTIZED_FAMILIES:
        raise NotImplementedError(f"family={cfg.family!r}: "
                                  f"{NO_QUANTIZED_PATH}")


def block_sites(cfg, weight_only: bool) -> list:
    """Transform sites of one transformer block (dense, MoE, VLM, audio)."""
    require_quantizable(cfg)
    ln_kind = "full" if weight_only else "diagonal"
    shift = not weight_only
    return [AffineSpec("ln_attn", ln_kind, cfg.d_model, with_shift=shift),
            AffineSpec("vo", "headwise", cfg.resolved_head_dim,
                       num_heads=cfg.num_kv_heads),
            AffineSpec("ln_mlp", ln_kind, cfg.d_model,
                       with_shift=shift and not cfg.num_experts)]


def quantized_weights(cfg) -> list:
    """The weight matrices of one block that calibration quantizes (each
    gets LWC parameters), as ``/``-joined paths: an MoE block's are its
    stacked (E, K, N) experts, its router stays float."""
    require_quantizable(cfg)
    prefix = "moe" if cfg.num_experts else "mlp"
    ws = ["wq", "wk", "wv", "wo", f"{prefix}/w_up", f"{prefix}/w_down"]
    if cfg.act in GATED:
        ws.append(f"{prefix}/w_gate")
    return ws
