"""PTQ calibration launcher: AffineQuant (or OmniQuant-diag) on the port.

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

The baselines (rtn, awq, gptq) are not ported yet.  ``--device`` defaults to
``cuda`` and raises when no CUDA device exists.
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
from repro_torch.core.calibration import (CalibConfig, finalize_model,
                                          quantize_dense_model)
from repro_torch.core.quantizer import QuantConfig
from repro_torch.data import MarkovCorpus
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.train import checkpoints


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama-mini")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut depth to this many layers (0 = all)")
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
    opt, step) flattens to the indices 0, 1, 2 and gives its params."""
    tree = checkpoints.load_tree(ckpt, cfg, qcfg, device=device)
    return tree["0"] if "embed" not in tree and "0" in tree else tree


@torch.no_grad()
def eval_ppl(model, params: dict, tokens) -> float:
    return math.exp(float(model.loss(params, {"tokens": tokens})))


def calibrate(args: argparse.Namespace, params=None) -> dict:
    """Calibrate once; returns the float, fake-quant and packed trees, the
    configs, the calibration info (``block_qps``, losses, step seconds) and
    the report.  ``params`` reuses a float tree of the same arch and
    depth."""
    device = resolve_device(args.device)
    # float32 stays float32 on the card: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.method not in ("affine", "omniquant"):
        raise NotImplementedError(
            f"--method {args.method}: the rtn/awq/gptq baselines "
            f"(core/baselines.py) are not ported yet (ROADMAP queue 1 item 9)")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    qcfg = QuantConfig(w_bits=args.wbits, a_bits=args.abits,
                       group_size=args.group)
    model = build_model(cfg, device)
    if params is None:
        params = (load_float_params(args.ckpt, cfg, qcfg, device)
                  if args.ckpt else model.init(args.seed))
    corpus = MarkovCorpus(vocab=cfg.vocab_size, seed=args.seed)
    calib = torch.from_numpy(corpus.sample(args.calib_samples,
                                           args.calib_seq, seed=777))
    test = torch.from_numpy(corpus.sample(16, args.calib_seq, seed=999))
    ccfg = CalibConfig(epochs=args.epochs, alpha=args.alpha,
                       use_affine=args.method == "affine")
    report = {"method": args.method, "config": qcfg.tag(),
              "fp_ppl": eval_ppl(model, params, test)}
    fake, info = quantize_dense_model(params, cfg, qcfg, ccfg, calib)
    report["block_final_losses"] = info["final_losses"]
    report["quant_ppl"] = eval_ppl(model, fake, test)
    packed = finalize_model(params, info["block_qps"], cfg, qcfg, ccfg,
                            deploy="packed")
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
    packed_dir = checkpoints.save(root / f"{name}-packed", 0, out["packed"])
    (root / f"{name}.json").write_text(json.dumps(r, indent=2))
    print(f"[calibrate] wrote {root / name}, {packed_dir.parent} and "
          f"{root / name}.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
