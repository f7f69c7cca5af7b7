"""Block-wise AffineQuant calibration (paper Eq. 4 + §3.2 Gradual Mask).

Per transformer block, in order, with two streams (OmniQuant-style)::

    fp_out    = block_fp(fp_in)                      # target
    quant_out = block_q(quant_in; A, delta, lwc)     # optimized
    loss      = || fp_out - quant_out ||_F^2 / numel
    ... Adam over (A, delta, lwc) for `epochs`, the GM band growing per epoch
    quant_in  <- block_q(quant_in) ; fp_in <- block_fp(fp_in)

The quantized block computes its effective weights every step::

    Wq_eff    = Q( A1 @ Wq )                          (ln_attn consumers)
    Wv_eff    = Q( A1 @ Wv @ blockdiag(inv(A2)) )     (vo producer side)
    Wo_eff    = Q( blockdiag(A2) @ Wo )               (vo consumer side)
    Wg/Wu_eff = Q( A3 @ Wg/Wu ) ;  W_down_eff = Q(W_down)
    router    = A3 @ router                           (MoE: float, every
                                                       expert's Wg/Wu too)

and transformed activations ``h_t = (h - delta) @ inv(A1)`` after each norm
(per-token fake-quantized when activations are quantized).  Everything is
differentiable (the STE through Q, autograd through the solve), and the
optimizer is the reference's hand-rolled Adam with per-path learning rates.

The dense (OPT and llama), MoE, VLM and audio families.  The VLM and audio
trunks calibrate as the reference calibrates them: on token embeddings
(never image prefixes or frames), under the config's mask (causal for
paligemma, bidirectional for hubert: ``cfg.causal``) and window.  An MoE
block's experts are
stacked (E, K, N) leaves: each expert gets its own LWC logits and its own
grid, the ``ln_mlp`` transform reaches the router and every expert's gate
and up projections, and the quantized block runs its activation-quantized
MoE input through ``moe.apply_moe`` (so at a4 calibration quantizes the MoE
input where packed serving does not: the reference's difference, kept).
A no-RoPE model (OPT, hubert) gets its sinusoidal positions at the
embedding (``transformer.embed``).
The reference runs each step under ``jax.jit``, where XLA turns a division
by a constant into a multiply by its reciprocal; the port divides wherever
the reference's eager code does, so its step matches the reference called
eagerly.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Optional

import torch

from repro_torch.core import affine as af
from repro_torch.core import equivalence as eq
from repro_torch.core import gradual_mask as gm
from repro_torch.core.quantizer import (QuantConfig, fake_quant_activation,
                                        fake_quant_weight, init_lwc_params,
                                        quantize_codes)
from repro_torch.core.sites import (block_sites, quantized_weights,
                                    require_quantizable)
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, moe, transformer
from repro_torch.models.init import layer, stack_layers

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CalibConfig:
    """Calibration hyper-parameters (the reference's defaults)."""
    epochs: int = 20
    lr_affine: float = 5e-3
    lr_shift: float = 1e-3
    lr_lwc: float = 1e-2
    alpha: float = 1.0            # GM stability factor (paper Table 5)
    use_affine: bool = True       # False -> OmniQuant-diag (alpha -> 0 limit)
    batch_size: int = 8           # calibration samples per step


# ---------------------------------------------------------------------------
# parameter initialization for one block
# ---------------------------------------------------------------------------

def init_block_quant_params(block_params: dict, cfg, qcfg: QuantConfig,
                            ccfg: CalibConfig,
                            act_stats: Optional[dict] = None) -> dict:
    """Learnable tree: affine matrices, shifts, LWC clip logits, and the
    sites' descriptions (``_sites``: strings, ints and bools)."""
    weight_only = not qcfg.quantize_acts
    sites = {s.name: s for s in block_sites(cfg, weight_only)}
    device = block_params["wq"].device
    params: dict = {"affine": {}, "lwc": {}}

    def diag_init(site_name: str, w_key: str) -> torch.Tensor:
        if act_stats and site_name in act_stats:
            w = _get(block_params, w_key).abs()
            # stacked experts (E, d_in, d_out): the max over all of them
            w_absmax = torch.amax(w, dim=(0, 2) if w.ndim == 3 else 1)
            return af.smoothquant_diag(act_stats[site_name], w_absmax)
        return torch.ones((sites[site_name].dim,), dtype=torch.float32,
                          device=device)

    if not ccfg.use_affine:
        # OmniQuant-diag: every non-headwise site diagonal
        sites = {n: (dataclasses.replace(s, kind="diagonal")
                     if s.kind == "full" else s) for n, s in sites.items()}

    used: dict = {}
    for name, spec in sites.items():
        if spec.kind == "headwise" and not ccfg.use_affine:
            continue                      # OmniQuant has no headwise transform
        init = None
        if name == "ln_attn":
            init = diag_init(name, "wq")
        elif name == "ln_mlp":
            init = diag_init(name, f"{_mlp_key(cfg)}/w_up")
        params["affine"][name] = af.init_params(spec, init, device=device)
        used[name] = spec
    params["_sites"] = {n: dataclasses.asdict(s) for n, s in used.items()}

    if qcfg.lwc:
        for wname in quantized_weights(cfg):
            w = _get(block_params, wname)
            params["lwc"][wname] = init_lwc_params(tuple(w.shape),
                                                   qcfg.group_size,
                                                   device=device)
    return params


def _mlp_key(cfg) -> str:
    return "moe" if cfg.num_experts else "mlp"


def _get(tree: dict, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _set_path(tree: dict, path: str, val) -> None:
    *parents, last = path.split("/")
    node = tree
    for p in parents:
        node = node[p]
    node[last] = val


def _copy_tree(tree):
    """New nested dicts over the same tensors."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def _specs_from(params: dict) -> dict:
    return {n: af.AffineSpec(**d) for n, d in params["_sites"].items()}


# ---------------------------------------------------------------------------
# effective (transformed + fake-quantized) weights
# ---------------------------------------------------------------------------

def _masks(specs: dict, epoch: int, ccfg: CalibConfig, device=None) -> dict:
    """GM matrices per site for ``epoch`` (paper Eq. 6).  A headwise site
    gets one (head_dim, head_dim) band broadcast over its heads, as the
    reference builds it (``gradual_mask``, not ``gradual_mask_headwise``)."""
    return {name: (None if spec.kind == "diagonal" else
                   gm.gradual_mask(spec.dim, epoch, ccfg.epochs, ccfg.alpha,
                                   device=device))
            for name, spec in specs.items()}


def site_matrices(qp: dict, name: str, masks: dict) -> tuple:
    """(spec, A*, inv(A*)) of one site."""
    spec = _specs_from(qp)[name]
    a_eff = af.effective_matrix(spec, qp["affine"][name], masks.get(name))
    return spec, a_eff, af.invert(spec, a_eff)


def eq_headwise_left(a2: torch.Tensor, wo: torch.Tensor, cfg) -> torch.Tensor:
    """blockdiag(A2) @ Wo with GQA group tying (A2 per KV head)."""
    hd = a2.shape[-1]
    group = cfg.num_heads // cfg.num_kv_heads
    wo_h = wo.reshape(cfg.num_kv_heads, group, hd, -1)
    return torch.einsum("khe,kgeo->kgho", a2.to(wo.dtype), wo_h
                        ).reshape(wo.shape)


def transformed_weights(block_params: dict, qp: dict, cfg,
                        masks: dict) -> dict:
    """Every transformed (not yet quantized) weight and bias of the block:
    the float tensors both the calibration forward and the packed
    deployment put on the quantizer grid, so the two share one rounding."""
    specs = _specs_from(qp)
    out: dict = {}

    def a_of(name):
        spec = specs[name]
        return spec, af.effective_matrix(spec, qp["affine"][name],
                                         masks.get(name))

    if "ln_attn" in specs:
        spec1, a1 = a_of("ln_attn")
        wq, wk, wv = (af.transform_weight(spec1, a1, block_params[n])
                      for n in ("wq", "wk", "wv"))
        if "vo" in specs:
            spec2, a2 = a_of("vo")
            a2_inv = af.invert(spec2, a2).to(wv.dtype)
            wv_h = wv.reshape(wv.shape[0], cfg.num_kv_heads, spec2.dim)
            wv = torch.einsum("dkh,khe->dke", wv_h, a2_inv).reshape(wv.shape)
            wo = eq_headwise_left(a2, block_params["wo"], cfg)
        else:
            wo = block_params["wo"]
        out["wq"], out["wk"], out["wv"], out["wo"] = wq, wk, wv, wo
        # shift-corrected biases b + delta @ W, on the pre-transform weight
        # (exact: delta @ W == (delta A^-1) @ (A W))
        shift1 = qp["affine"]["ln_attn"].get("shift")
        for wname, bname in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
            b = block_params.get(bname)
            if shift1 is not None:
                b = af.shift_bias_correction(shift1, block_params[wname], b)
            if b is not None:
                out[bname] = b

    mlp_site = "ln_mlp" if "ln_mlp" in specs else None
    prefix = _mlp_key(cfg)
    for sub in (("w_gate", "w_up", "w_down") if cfg.act in layers.GATED
                else ("w_up", "w_down")):
        w = block_params[prefix][sub]
        if mlp_site and sub in ("w_gate", "w_up"):
            spec3, a3 = a_of(mlp_site)
            # (E, d, f) experts: A3 @ each (broadcast over E)
            w = af.transform_weight(spec3, a3, w)
        out[f"{prefix}/{sub}"] = w
    if cfg.num_experts:
        out["moe/router"] = block_params["moe"]["router"]
        if mlp_site:
            spec3, a3 = a_of(mlp_site)
            out["moe/router"] = af.transform_weight(spec3, a3,
                                                    out["moe/router"])
    elif mlp_site:
        shift3 = qp["affine"][mlp_site].get("shift")
        if shift3 is not None:
            for wn, bn in (("w_gate", "b_gate"), ("w_up", "b_up")):
                if wn in block_params["mlp"]:
                    out[f"mlp/{bn}"] = af.shift_bias_correction(
                        shift3, block_params["mlp"][wn], None)
    return out


def effective_weights(block_params: dict, qp: dict, cfg, qcfg: QuantConfig,
                      masks: dict) -> dict:
    """Every transformed and pseudo-quantized weight of the block."""
    tw = transformed_weights(block_params, qp, cfg, masks)
    qnames = set(quantized_weights(cfg))
    return {name: (fake_quant_weight(w, qcfg, qp["lwc"].get(name))
                   if name in qnames else w) for name, w in tw.items()}


# ---------------------------------------------------------------------------
# the quantized block forward
# ---------------------------------------------------------------------------

def quant_block_forward(block_params: dict, qp: dict, x: torch.Tensor, cfg,
                        qcfg: QuantConfig, masks: dict,
                        positions: torch.Tensor) -> torch.Tensor:
    """One block with transformed and quantized weights (Eq. 4's right
    side)."""
    specs = _specs_from(qp)
    ws = effective_weights(block_params, qp, cfg, qcfg, masks)

    def aq(t):
        return fake_quant_activation(t, qcfg)

    def act_transform(h, site):
        if site not in specs:
            return h
        spec, _, a_inv = site_matrices(qp, site, masks)
        return af.transform_activation(spec, a_inv, h,
                                       qp["affine"][site].get("shift"))

    h = aq(act_transform(
        layers.apply_norm(block_params["ln_attn"], x, cfg.norm), "ln_attn"))
    q, k, v = h @ ws["wq"], h @ ws["wk"], h @ ws["wv"]
    bias = {n: ws[n] if n in ws else block_params.get(n)
            for n in ("bq", "bk", "bv")}
    if bias["bq"] is not None:
        q, k, v = q + bias["bq"], k + bias["bk"], v + bias["bv"]
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
    x = x + aq(attn) @ ws["wo"]

    h2 = aq(act_transform(
        layers.apply_norm(block_params["ln_mlp"], x, cfg.norm), "ln_mlp"))
    if cfg.num_experts:
        y, _ = moe.apply_moe({k.split("/")[1]: w for k, w in ws.items()
                              if k.startswith("moe/")}, h2, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor, act=cfg.act)
        return x + y

    def mlin(wn, bn):
        y = h2 @ ws[f"mlp/{wn}"]
        return y + ws[f"mlp/{bn}"] if f"mlp/{bn}" in ws else y

    return x + aq(layers.mlp_hidden(mlin, cfg.act)) @ ws["mlp/w_down"]


def fp_block_forward(block_params: dict, x: torch.Tensor, cfg,
                     positions: torch.Tensor) -> torch.Tensor:
    return transformer.apply_block_full(block_params, x, cfg, positions,
                                        window=cfg.window)[0]


# ---------------------------------------------------------------------------
# the per-block optimization loop
# ---------------------------------------------------------------------------

def _learnable(qp: dict) -> list:
    """[(key path, tensor)] of the affine and LWC leaves, keys sorted."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            out.append((path, node))

    walk({"affine": qp["affine"], "lwc": qp["lwc"]}, ())
    return out


def calibrate_block(block_params: dict, fp_in: torch.Tensor,
                    quant_in: torch.Tensor, cfg, qcfg: QuantConfig,
                    ccfg: CalibConfig, act_stats: Optional[dict] = None,
                    step_seconds: Optional[list] = None
                    ) -> tuple[dict, list]:
    """Optimize one block's (A, delta, lwc).  Returns (quant_params,
    per-epoch mean losses).  The remainder batch is dropped, as in the
    reference; a non-finite epoch loss stops the loop.  ``step_seconds``
    collects each step's wall time (the step ends in a host read of its
    loss, so on the card it includes the device work)."""
    device = fp_in.device
    positions = torch.arange(fp_in.shape[1], device=device)[None, :]
    qp = init_block_quant_params(block_params, cfg, qcfg, ccfg, act_stats)
    specs = _specs_from(qp)
    with torch.no_grad():
        fp_out = fp_block_forward(block_params, fp_in, cfg, positions)

    leaves = _learnable(qp)
    params = [p.requires_grad_(True) for _, p in leaves]

    def lr_of(path: tuple) -> float:
        if "shift" in path:
            return ccfg.lr_shift
        if path[0] == "lwc":
            return ccfg.lr_lwc
        return ccfg.lr_affine

    lrs = [lr_of(path) for path, _ in leaves]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    f32 = dict(dtype=torch.float32, device=device)
    b1_t, b2_t = torch.tensor(b1, **f32), torch.tensor(b2, **f32)

    count = 0
    n = fp_in.shape[0]
    bs = min(ccfg.batch_size, n)
    losses = []
    for epoch in range(ccfg.epochs):
        masks = _masks(specs, epoch + 1, ccfg, device)
        epoch_loss, nb = 0.0, 0
        for i in range(0, n - bs + 1, bs):
            t0 = time.perf_counter()
            out = quant_block_forward(block_params, qp, quant_in[i:i + bs],
                                      cfg, qcfg, masks, positions)
            loss = torch.mean(torch.square(out.to(torch.float32)
                                           - fp_out[i:i + bs].to(torch.float32)))
            grads = torch.autograd.grad(loss, params)
            count += 1
            with torch.no_grad():
                bias1 = 1 - b1_t ** count       # float32, as the reference
                bias2 = 1 - b2_t ** count
                for j, (p, g) in enumerate(zip(params, grads)):
                    m[j] = b1 * m[j] + (1 - b1) * g
                    v[j] = b2 * v[j] + (1 - b2) * torch.square(g)
                    upd = (m[j] / bias1) / (torch.sqrt(v[j] / bias2) + eps)
                    p.sub_(lrs[j] * upd)
            epoch_loss += loss.item()
            nb += 1
            if step_seconds is not None:
                step_seconds.append(time.perf_counter() - t0)
        losses.append(epoch_loss / max(nb, 1))
        if not math.isfinite(losses[-1]):
            logger.warning("  calibration diverged (non-finite loss) at "
                           "epoch %d", epoch)
            break
    for p in params:
        p.requires_grad_(False)
    return {"affine": qp["affine"], "lwc": qp["lwc"],
            "_sites": qp["_sites"]}, losses


# ---------------------------------------------------------------------------
# whole-model pipeline
# ---------------------------------------------------------------------------

def quantize_dense_model(params: dict, cfg, qcfg: QuantConfig,
                         ccfg: CalibConfig, calib_tokens: torch.Tensor,
                         log: bool = True,
                         deploy: str = "fake") -> tuple[dict, dict]:
    """Sequential block-wise PTQ of a dense LM (stacked layers).

    ``deploy="fake"`` merges fake-quant effective weights back into the
    float structure (served by the float forward); ``deploy="packed"``
    emits QTensor leaves for every quantized linear, served by
    ``QuantizedModel`` with no re-quantization.  Returns (new_params, info)
    with ``block_losses``, ``final_losses``, ``block_qps`` and every step's
    wall time in ``step_seconds``."""
    require_quantizable(cfg)
    blocks = _unstack_layers(params, cfg)
    device = params["embed"].device
    calib_tokens = torch.as_tensor(calib_tokens).to(device)
    with torch.no_grad():
        x = transformer.embed(params, cfg, calib_tokens)
    positions = torch.arange(calib_tokens.shape[1], device=device)[None, :]
    fp_in = quant_in = x
    info = {"block_losses": [], "final_losses": [], "block_qps": [],
            "step_seconds": []}
    new_blocks = []
    for li, bp in enumerate(blocks):
        with torch.no_grad():
            # per-site activation stats for the SmoothQuant diagonal init
            h1 = layers.apply_norm(bp["ln_attn"], quant_in, cfg.norm)
            stats = {"ln_attn": torch.amax(h1.reshape(-1, cfg.d_model).abs(),
                                           dim=0)}
            xa = fp_block_forward(bp, quant_in, cfg, positions)
            h2 = layers.apply_norm(bp["ln_mlp"], xa, cfg.norm)
            stats["ln_mlp"] = torch.amax(h2.reshape(-1, cfg.d_model).abs(),
                                         dim=0)
            del h1, xa, h2
        qp, losses = calibrate_block(bp, fp_in, quant_in, cfg, qcfg, ccfg,
                                     act_stats=stats,
                                     step_seconds=info["step_seconds"])
        info["block_qps"].append(qp)
        info["block_losses"].append(losses)
        info["final_losses"].append(losses[-1] if losses else float("nan"))
        if log:
            logger.info("block %d/%d: loss %.6f -> %.6f", li + 1, len(blocks),
                        losses[0] if losses else float("nan"),
                        losses[-1] if losses else float("nan"))
        new_blocks.append(finalize_block(bp, qp, cfg, qcfg, ccfg,
                                         deploy=deploy))
        with torch.no_grad():       # advance the two streams
            masks = _masks(_specs_from(qp), ccfg.epochs, ccfg, device)
            quant_in = quant_block_forward(bp, qp, quant_in, cfg, qcfg, masks,
                                           positions)
            fp_in = fp_block_forward(bp, fp_in, cfg, positions)
    return _stack_layers(params, new_blocks), info


def _unstack_layers(params: dict, cfg) -> list:
    return [layer(params["layers"], i) for i in range(cfg.num_layers)]


def _stack_layers(params: dict, blocks: list) -> dict:
    return dict(params, layers=stack_layers(blocks))


@torch.no_grad()
def finalize_model(params: dict, block_qps: list, cfg, qcfg: QuantConfig,
                   ccfg: CalibConfig, deploy: str = "fake") -> dict:
    """Re-finalize calibrated parameters (``info["block_qps"]``) under
    another deployment without re-running calibration; ``ccfg`` must be the
    config calibration ran with (the GM epoch enters the transform)."""
    require_quantizable(cfg)
    return _stack_layers(params, [
        finalize_block(bp, qp, cfg, qcfg, ccfg, deploy=deploy)
        for bp, qp in zip(_unstack_layers(params, cfg), block_qps)])


@torch.no_grad()
def finalize_block(block_params: dict, qp: dict, cfg, qcfg: QuantConfig,
                   ccfg: CalibConfig, deploy: str = "fake") -> dict:
    """Merge the transforms away (paper §3.3).

    ``deploy="fake"``: diagonal sites merge into the norm, full sites give
    the fused effective weight inv(A) @ Q(A W), the vo transform merges
    into wv/wo; the block then evaluates like the calibrated quantized block
    through the float forward.

    ``deploy="packed"``: every quantized linear becomes a QTensor of the
    same single rounding the calibration loss optimized (LWC clips kept).
    Diagonal sites still merge into the norm; full sites keep their
    activation factor explicit as ``attn_t`` / ``mlp_t`` = {"a_inv",
    optional "shift"}; the vo transform is absorbed into wv/wo before
    quantization."""
    if deploy not in ("fake", "packed"):
        raise ValueError(f"deploy must be 'fake' or 'packed', got {deploy!r}")
    specs = _specs_from(qp)
    masks = _masks(specs, ccfg.epochs, ccfg, block_params["wq"].device)
    if deploy == "packed":
        return _finalize_block_packed(block_params, qp, cfg, qcfg, specs,
                                      masks)
    ws = effective_weights(block_params, qp, cfg, qcfg, masks)
    new_bp = _copy_tree(block_params)

    if "ln_attn" in specs:
        spec1, a1, a1_inv = site_matrices(qp, "ln_attn", masks)
        shift1 = qp["affine"]["ln_attn"].get("shift")
        if spec1.kind == "diagonal":
            _merge_norm(new_bp, "ln_attn", block_params, a1, shift1)
            for wn in ("wq", "wk", "wv"):
                new_bp[wn] = ws[wn]
            for bn in ("bq", "bk", "bv"):
                if bn in ws:
                    new_bp[bn] = ws[bn]
        else:
            for wn in ("wq", "wk", "wv"):
                new_bp[wn] = eq.fuse_effective_weight(
                    ws[wn], a1_inv.to(torch.float32))
            if shift1 is not None:
                for wn, bn in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
                    new_bp[bn] = af.shift_bias_correction(
                        shift1, block_params[wn], block_params.get(bn))
        new_bp["wo"] = ws["wo"]

    if "ln_mlp" in specs:
        spec3, a3, a3_inv = site_matrices(qp, "ln_mlp", masks)
        shift3 = qp["affine"]["ln_mlp"].get("shift")
        prefix = _mlp_key(cfg)
        if spec3.kind == "diagonal":
            _merge_norm(new_bp, "ln_mlp", block_params, a3, shift3)
            for sub in ("w_gate", "w_up", "b_gate", "b_up", "router"):
                if f"{prefix}/{sub}" in ws:
                    new_bp[prefix][sub] = ws[f"{prefix}/{sub}"]
        else:
            # inv(A3) @ Q(A3 W) per expert; the router inv(A3) @ (A3 R)
            for sub in ("w_gate", "w_up", "router"):
                if f"{prefix}/{sub}" in ws:
                    new_bp[prefix][sub] = eq.fuse_effective_weight(
                        ws[f"{prefix}/{sub}"], a3_inv.to(torch.float32))
        new_bp[prefix]["w_down"] = ws[f"{prefix}/w_down"]
    return new_bp


def _merge_norm(new_bp: dict, norm: str, block_params: dict,
                a_diag: torch.Tensor, shift: Optional[torch.Tensor]) -> None:
    g, beta = eq.merge_diag_into_norm(block_params[norm]["scale"],
                                      block_params[norm].get("bias"),
                                      a_diag, shift)
    new_bp[norm] = {"scale": g} if beta is None else {"scale": g,
                                                      "bias": beta}


def _finalize_block_packed(block_params: dict, qp: dict, cfg,
                           qcfg: QuantConfig, specs: dict, masks: dict) -> dict:
    """Packed deployment of one calibrated block (see finalize_block)."""
    tw = transformed_weights(block_params, qp, cfg, masks)
    qnames = set(quantized_weights(cfg))
    new_bp = _copy_tree(block_params)
    # one quantization per linear, on the LWC grid the loss saw; biases pass
    # through transformed but float
    for name, w in tw.items():
        _set_path(new_bp, name, quantize_codes(w, qcfg, qp["lwc"].get(name))
                  if name in qnames else w)
    for site, norm, key in (("ln_attn", "ln_attn", "attn_t"),
                            ("ln_mlp", "ln_mlp", "mlp_t")):
        if site not in specs:
            continue
        spec, a, a_inv = site_matrices(qp, site, masks)
        shift = qp["affine"][site].get("shift")
        if spec.kind == "diagonal":
            _merge_norm(new_bp, norm, block_params, a, shift)
        else:
            new_bp[key] = {"a_inv": a_inv.to(torch.float32)}
            if shift is not None:
                new_bp[key]["shift"] = shift.to(torch.float32)
    return new_bp
