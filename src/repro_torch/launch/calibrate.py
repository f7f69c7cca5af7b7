"""PTQ calibration launcher: AffineQuant, OmniQuant-diag and the weight-only
baselines (RTN, AWQ, GPTQ) on the port.

    PYTHONPATH=src python -m repro_torch.launch.calibrate --arch llama-micro \
        --device cpu --method affine --wbits 4 --abits 4 --group 32 --epochs 2

Float weights come from ``--ckpt`` (a float tree in the npz layout of
``train/checkpoints.py``, written by either package) or from a seeded
random init on the device; ``--layers`` cuts depth.  Calibration tokens are
``--calib-samples`` x ``--calib-seq`` of the Markov corpus (seed 777), the
held-out tokens 16 x ``--calib-seq`` (seed 999).  Writes, under ``--out``:

    <arch>-<method>-<tag>/         the fake-quant tree (step 0)
    <arch>-<method>-<tag>-packed/  the packed QTensor tree (step 0), which
                                   ``launch/serve.py --load-packed`` serves
    <arch>-<method>-<tag>.json     fp and quant perplexity, per-block losses
                                   (affine, omniquant) or seconds (baselines)

The baselines run without clipping (``lwc=False``), as the reference's
launcher does.  RTN's packed tree is the float tree on the RTN grid through
``quantize_lm_packed`` (the ``quantize_pack`` kernel on the card); AWQ and
GPTQ write no packed tree, and the report says why: AWQ's per-linear
``diag(1/s)`` puts the rows of one group on different grids, and GPTQ's
grid moves column by column.  ``--device`` defaults to ``cuda`` and raises
when no CUDA device exists; ``--reduced`` takes the arch's smoke config
(2 layers, d 64), for the CPU.

``--arch paligemma-3b`` and ``hubert-xlarge`` calibrate as the reference's
``quantize_dense_model`` does: on the calibration tokens' embeddings (no
image prefix, no frames), paligemma causally, hubert bidirectionally.  An
audio model has no next-token loss: its perplexities are of its frame
cross entropy on the held-out tokens' embeddings, labelled with the tokens
themselves (the reference's launcher stops there on a ``KeyError``, its
loss reading frame embeddings).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.core.baselines import METHODS, quantize_model_baseline
from repro_torch.core.calibration import (CalibConfig, finalize_model,
                                          quantize_dense_model)
from repro_torch.core.quantizer import QuantConfig
from repro_torch.core.sites import require_quantizable
from repro_torch.data import MarkovCorpus
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.quantized import quantize_lm_packed
from repro_torch.train import checkpoints

NOT_PACKED = {
    "awq": "not packed: AWQ's effective weight diag(1/s) Q(diag(s) W) "
           "scales each input row by its own 1/s, so a group's rows are on "
           "no one grid",
    "gptq": "not packed: GPTQ's grid moves column by column with the "
            "compensated weights (the fake-quant tree runs through the "
            "float forward)"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama-mini")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut depth to this many layers (0 = all)")
    ap.add_argument("--reduced", action="store_true",
                    help="calibrate the reduced smoke config of --arch")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir of a float tree (optional)")
    ap.add_argument("--method", default="affine",
                    choices=["affine", "omniquant", "rtn", "awq", "gptq"])
    ap.add_argument("--wbits", type=int, default=4)
    ap.add_argument("--abits", type=int, default=16)
    ap.add_argument("--group", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--calib-samples", type=int, default=16)
    ap.add_argument("--calib-seq", type=int, default=128)
    ap.add_argument("--out", default="quantized")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def load_float_params(ckpt: str, cfg, qcfg: QuantConfig, device) -> dict:
    """A float tree from a checkpoint; a reference ``TrainState`` (params,
    opt, step) flattens to the indices 0, 1, 2 and gives its params.  A
    griffin tree's layers, stored by index, become its list again."""
    tree = checkpoints.load_tree(ckpt, cfg, qcfg, device=device)
    tree = tree["0"] if "embed" not in tree and "0" in tree else tree
    if cfg.family == "griffin":
        tree["layers"] = [tree["layers"][str(i)]
                          for i in range(len(tree["layers"]))]
    return tree


@torch.no_grad()
def eval_ppl(model, params: dict, tokens) -> float:
    """exp of the next-token loss; audio's frame loss on the tokens'
    embeddings, each labelled with its own token."""
    if model.cfg.family == "audio":
        tokens = torch.as_tensor(tokens).to(model.device)
        batch = {"embeds": params["embed"][tokens.long()], "labels": tokens}
    else:
        batch = {"tokens": tokens}
    return math.exp(float(model.loss(params, batch)))


def calibrate(args: argparse.Namespace, params=None) -> dict:
    """Quantize once; returns the float, fake-quant and packed trees (the
    packed tree is None for awq and gptq), the configs, the calibration
    info (``block_qps``, losses and step seconds; a baseline's
    ``block_seconds``) and the report.  ``params`` reuses a float tree of
    the same arch and depth."""
    device = resolve_device(args.device)
    # float32 stays float32 on the card: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    require_quantizable(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    baseline = args.method in METHODS
    qcfg = QuantConfig(w_bits=args.wbits, a_bits=args.abits,
                       group_size=args.group, lwc=not baseline)
    model = build_model(cfg, device)
    if params is None:
        params = (load_float_params(args.ckpt, cfg, qcfg, device)
                  if args.ckpt else model.init(args.seed))
    corpus = MarkovCorpus(vocab=cfg.vocab_size, seed=args.seed)
    calib = torch.from_numpy(corpus.sample(args.calib_samples,
                                           args.calib_seq, seed=777))
    test = torch.from_numpy(corpus.sample(16, args.calib_seq, seed=999))
    report = {"method": args.method, "config": qcfg.tag(),
              "fp_ppl": eval_ppl(model, params, test)}
    ccfg = None
    if baseline:
        info: dict = {}
        fake = quantize_model_baseline(params, cfg, qcfg, calib, args.method,
                                       info=info)
        report["block_seconds"] = info["block_seconds"]
        packed = (quantize_lm_packed(params, cfg, qcfg)
                  if args.method == "rtn" else None)
        if packed is None:
            report["packed"] = NOT_PACKED[args.method]
    else:
        ccfg = CalibConfig(epochs=args.epochs, alpha=args.alpha,
                           use_affine=args.method == "affine")
        fake, info = quantize_dense_model(params, cfg, qcfg, ccfg, calib)
        report["block_final_losses"] = info["final_losses"]
        packed = finalize_model(params, info["block_qps"], cfg, qcfg, ccfg,
                                deploy="packed")
    report["quant_ppl"] = eval_ppl(model, fake, test)
    return {"cfg": cfg, "qcfg": qcfg, "ccfg": ccfg, "model": model,
            "params": params, "fake": fake, "packed": packed, "info": info,
            "report": report}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="[calibrate] %(message)s")
    args = build_parser().parse_args(argv)
    out = calibrate(args)
    r = out["report"]
    print(f"[calibrate] {args.method} {out['qcfg'].tag()} "
          f"{out['cfg'].name} x{out['cfg'].num_layers} on "
          f"{out['model'].device}: fp ppl {r['fp_ppl']:.4f} -> quant ppl "
          f"{r['quant_ppl']:.4f}")
    root = Path(args.out)
    root.mkdir(parents=True, exist_ok=True)
    name = f"{args.arch}-{args.method}-{out['qcfg'].tag()}"
    checkpoints.save(root / name, 0, out["fake"])
    wrote = [str(root / name)]
    if out["packed"] is not None:
        wrote.append(str(checkpoints.save(root / f"{name}-packed", 0,
                                          out["packed"]).parent))
    else:
        print(f"[calibrate] {r['packed']}")
    (root / f"{name}.json").write_text(json.dumps(r, indent=2))
    print(f"[calibrate] wrote {', '.join(wrote)} and {root / name}.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
