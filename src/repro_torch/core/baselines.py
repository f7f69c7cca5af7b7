"""PTQ baselines the paper compares against: RTN, AWQ, GPTQ, SmoothQuant.

All baselines consume the same calibration stream as AffineQuant and emit
fake-quant effective weights into the same dense-block parameter
structure, so every method is evaluated by the same model code, as in the
paper's tables.  Each function is the reference's (``core/baselines.py``)
with its op order:

* RTN: the round-to-nearest min/max grid, no calibration.
* AWQ: a per-input-channel scale ``s = act_max ** alpha``, alpha chosen
  from an 11-point grid against the layer-output MSE (Lin et al., 2023,
  the scale search without the clip search).  The first alpha whose error
  is strictly lower wins, and alpha 0 is RTN.
* GPTQ: column-by-column quantization with Cholesky-factored inverse-
  Hessian error compensation (Frantar et al., 2022), in float64 on the
  weights' device.  Each column's group grid is read from the weights as
  they stand before the current block of columns writes its compensation
  back, as in the reference.
* SmoothQuant: fixed alpha 0.5 activation-to-weight difficulty migration
  (Xiao et al., 2023), the weight-activation baseline.

A quotient that feeds a rounding step divides by a tensor (PyTorch turns a
division by a Python number into a multiply by its reciprocal).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import torch

from repro_torch.core.calibration import _copy_tree, _get, _set_path
from repro_torch.core.quantizer import QuantConfig, _div, fake_quant_weight
from repro_torch.core.sites import require_quantizable
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, transformer
from repro_torch.models.init import layer, stack_layers

logger = logging.getLogger(__name__)

METHODS = ("rtn", "awq", "gptq")
# dense-block linears: (weight key, input kind); input kinds: "ln_attn"
# (after the attention norm), "attn_out", "ln_mlp", "mlp_inner"
DENSE_LINEARS = [
    ("wq", "ln_attn"), ("wk", "ln_attn"), ("wv", "ln_attn"),
    ("wo", "attn_out"),
    ("mlp/w_gate", "ln_mlp"), ("mlp/w_up", "ln_mlp"),
    ("mlp/w_down", "mlp_inner"),
]


@torch.no_grad()
def block_linear_inputs(block_params: dict, x: torch.Tensor, cfg,
                        positions: torch.Tensor) -> dict:
    """Run one float block and capture the input activation of every
    linear, by input kind."""
    caps: dict = {}
    h = layers.apply_norm(block_params["ln_attn"], x, cfg.norm)
    caps["ln_attn"] = h
    q, k, v = (h @ block_params[n] for n in ("wq", "wk", "wv"))
    if "bq" in block_params:
        q, k, v = (q + block_params["bq"], k + block_params["bk"],
                   v + block_params["bv"])
    b, t = x.shape[0], x.shape[1]
    hd = cfg.resolved_head_dim
    q = q.reshape(b, t, cfg.num_heads, hd)
    k = k.reshape(b, t, cfg.num_kv_heads, hd)
    v = v.reshape(b, t, cfg.num_kv_heads, hd)
    if cfg.rope_theta > 0:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    attn = attn_lib.attention(q, k, v, causal=cfg.causal,
                              window=cfg.window).reshape(b, t, -1)
    caps["attn_out"] = attn
    x = x + attn @ block_params["wo"]
    h2 = layers.apply_norm(block_params["ln_mlp"], x, cfg.norm)
    caps["ln_mlp"] = h2
    mlp = block_params["mlp"]
    caps["mlp_inner"] = layers.mlp_hidden(lambda w, _b: h2 @ mlp[w], cfg.act)
    return caps


# ---------------------------------------------------------------------------
# RTN
# ---------------------------------------------------------------------------

def rtn_quantize_weight(w: torch.Tensor, qcfg: QuantConfig) -> torch.Tensor:
    """The RTN fake-quant weight (no clipping); a 3-D weight is quantized
    one matrix at a time."""
    cfg0 = dataclasses.replace(qcfg, lwc=False)
    if w.ndim == 3:
        return torch.stack([fake_quant_weight(wi, cfg0) for wi in w])
    return fake_quant_weight(w, cfg0)


# ---------------------------------------------------------------------------
# AWQ (scale search)
# ---------------------------------------------------------------------------

@torch.no_grad()
def awq_search(w: torch.Tensor, x: torch.Tensor, qcfg: QuantConfig,
               grid: int = 11) -> tuple[float, torch.Tensor]:
    """Search ``s = act_max ** alpha`` over alpha in [0, 1]; returns the
    chosen alpha (the first whose float32 output error is strictly lower)
    and the fused fake-quant effective weight ``diag(1/s) Q(diag(s) W)``."""
    cfg0 = dataclasses.replace(qcfg, lwc=False)
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    act_max = torch.clamp_min(torch.amax(xf.abs(), dim=0), 1e-5)
    wf = w.to(torch.float32)
    y_ref = xf @ wf
    best_err, best = float("inf"), (float("nan"), wf)
    for i in range(grid):
        alpha = i / (grid - 1)
        s = torch.clamp(act_max ** alpha, 1e-4, 1e4)
        w_eff = (torch.ones_like(s) / s)[:, None] \
            * fake_quant_weight(s[:, None] * wf, cfg0)
        err = float(torch.mean(torch.square(xf @ w_eff - y_ref)))
        if err < best_err:
            best_err, best = err, (alpha, w_eff)
    return best[0], best[1].to(w.dtype)


def awq_quantize_weight(w: torch.Tensor, x: torch.Tensor, qcfg: QuantConfig,
                        grid: int = 11) -> torch.Tensor:
    """The AWQ effective weight (:func:`awq_search`)."""
    return awq_search(w, x, qcfg, grid)[1]


# ---------------------------------------------------------------------------
# GPTQ
# ---------------------------------------------------------------------------

@torch.no_grad()
def gptq_quantize_weight(w: torch.Tensor, x: torch.Tensor, qcfg: QuantConfig,
                         block_size: int = 64,
                         percdamp: float = 0.01) -> torch.Tensor:
    """GPTQ with Cholesky error compensation; ``w`` (d_in, d_out), ``x``
    (..., d_in) calibration inputs.  Solves in float64 on ``w``'s device
    (the reference solves in numpy float64 on the host)."""
    f64 = torch.float64
    wf = w.to(f64).clone()
    xf = x.to(f64).reshape(-1, w.shape[0])
    d_in = wf.shape[0]
    h = 2.0 * (xf.T @ xf)
    del xf
    dead = torch.diagonal(h) == 0
    idx = torch.nonzero(dead)[:, 0]
    h[idx, idx] = 1.0
    wf[dead, :] = 0.0
    damp = percdamp * torch.mean(torch.diagonal(h))
    torch.diagonal(h).add_(damp)
    hinv = torch.linalg.cholesky(torch.linalg.inv(h), upper=True)
    del h

    levels = 2 ** qcfg.w_bits - 1
    g = qcfg.group_size or d_in
    q_out = torch.zeros_like(wf)
    for b0 in range(0, d_in, block_size):
        b1 = min(b0 + block_size, d_in)
        w_blk = wf[b0:b1].clone()
        err_blk = torch.zeros_like(w_blk)
        # the grid of a group reads wf, which changes only when a block of
        # columns writes back: one grid per group within the block
        grids: dict = {}
        for i in range(b1 - b0):
            gi = b0 + i
            g0 = (gi // g) * g
            if g0 not in grids:
                seg = wf[g0:min(g0 + g, d_in)]
                wmin = torch.amin(seg, dim=0)
                scale = _div(torch.clamp_min(torch.amax(seg, dim=0) - wmin,
                                             1e-8), levels)
                grids[g0] = (scale, torch.round(-wmin / scale))
            scale, zp = grids[g0]
            qv = torch.clamp(torch.round(w_blk[i] / scale) + zp, 0, levels)
            dq = (qv - zp) * scale
            q_out[gi] = dq
            err = (w_blk[i] - dq) / hinv[gi, gi]
            if i + 1 < b1 - b0:
                w_blk[i + 1:] -= torch.outer(hinv[gi, gi + 1:b1], err)
            err_blk[i] = err
        wf[b0:b1] = w_blk
        if b1 < d_in:
            wf[b1:] -= hinv[b0:b1, b1:].T @ err_blk
    return q_out.to(w.dtype)


# ---------------------------------------------------------------------------
# SmoothQuant (weight-activation)
# ---------------------------------------------------------------------------

def smoothquant_transform(w: torch.Tensor, act_max: torch.Tensor,
                          alpha: float = 0.5
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (scaled weight s * W, activation divisor s)."""
    wf = w.to(torch.float32)
    w_max = torch.clamp_min(torch.amax(wf.abs(), dim=1), 1e-5)
    s = torch.clamp(act_max ** alpha / w_max ** (1 - alpha), 1e-4, 1e4)
    return (s[:, None] * wf).to(w.dtype), s


# ---------------------------------------------------------------------------
# whole-model pipeline (dense family)
# ---------------------------------------------------------------------------

def output_mse(w_q: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> float:
    """Layer-output MSE of ``w_q`` against ``w`` on inputs ``x``."""
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    return float(torch.mean(torch.square(xf @ w_q.to(torch.float32)
                                         - xf @ w.to(torch.float32))))


@torch.no_grad()
def quantize_model_baseline(params: dict, cfg, qcfg: QuantConfig,
                            calib_tokens, method: str, log: bool = False,
                            info: Optional[dict] = None) -> dict:
    """Apply a weight-only baseline (rtn | awq | gptq) to a dense LM; the
    calibration stream runs forward through each quantized block.

    ``info`` (a dict), when given, receives ``block_seconds`` (each block's
    quantization, on the host clock after a device sync) and, for awq and
    gptq, ``linear_mse``: per block, ``{weight key: (method's MSE, RTN's
    MSE)}`` of the layer output on the linear's calibration inputs."""
    if method not in METHODS:
        raise ValueError(f"method={method!r}: use one of {METHODS}")
    require_quantizable(cfg)
    if cfg.num_experts:
        raise NotImplementedError(
            "the baselines are dense-only, as the reference's whole-model "
            "drivers are: on an MoE block its RTN leaves the experts float "
            "and its AWQ / GPTQ read block['mlp'] (KeyError); ROADMAP "
            "queue 3 records the difference")
    blocks = [layer(params["layers"], i) for i in range(cfg.num_layers)]
    device = params["embed"].device
    tokens = torch.as_tensor(calib_tokens).to(device)
    x = transformer.embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=device)[None, :]
    if info is not None:
        info.update(block_seconds=[], linear_mse=[])
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    new_blocks = []
    for li, bp in enumerate(blocks):
        sync()
        t0 = time.perf_counter()
        caps = (block_linear_inputs(bp, x, cfg, positions)
                if method in ("awq", "gptq") else None)
        nbp = _copy_tree(bp)
        for wkey, in_kind in DENSE_LINEARS:
            try:
                w = _get(bp, wkey)
            except KeyError:
                continue
            if method == "rtn":
                wq = rtn_quantize_weight(w, qcfg)
            elif method == "awq":
                wq = awq_quantize_weight(w, caps[in_kind], qcfg)
            else:
                wq = gptq_quantize_weight(w, caps[in_kind], qcfg)
            _set_path(nbp, wkey, wq)
        sync()
        seconds = time.perf_counter() - t0
        if info is not None:
            info["block_seconds"].append(seconds)
            if caps is not None:
                info["linear_mse"].append({
                    wkey: (output_mse(_get(nbp, wkey), _get(bp, wkey),
                                      caps[kind]),
                           output_mse(rtn_quantize_weight(_get(bp, wkey),
                                                          qcfg),
                                      _get(bp, wkey), caps[kind]))
                    for wkey, kind in DENSE_LINEARS
                    if wkey != "mlp/w_gate" or "w_gate" in bp["mlp"]})
        del caps
        new_blocks.append(nbp)
        x = transformer.apply_block_full(nbp, x, cfg, positions)[0]
        if log:
            logger.info("%s block %d/%d done in %.2f s", method, li + 1,
                        len(blocks), seconds)
    return dict(params, layers=stack_layers(new_blocks))
