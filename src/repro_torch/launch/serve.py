"""Serve a packed llama model from seeded random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-7b \
        --wbits 4 --group 128 --abits 4 --kvbits 8 --requests 4 \
        --prompt-len 128 --max-new 32 --max-batch 4 --max-len 512

Weights come from a seeded random init, quantized layer by layer onto the
RTN grid (so only one layer's float weights exist at a time), packed into
QTensors and served by ``QuantizedModel`` through the ``Engine``.  Prints
generated tokens per second (prefill included), the first step's time
(admission, prefill and one decode), the median decode step, weight bytes,
KV-cache bytes and the number of preemptions.  ``--layers`` cuts depth;
widths stay the architecture's.  ``--kvbits`` takes 4, 8 or 16;
``--paged`` serves from a page pool (``--page-size``, ``--num-pages``,
0 = as many pages as the linear cache holds) and ``--prefill-chunk N``
admits prompts in chunks of N tokens.  ``--device`` defaults to
``cuda`` and raises when no CUDA device exists; ``--device cpu`` runs the
plain versions of the kernels.

Other weights: ``--ckpt DIR`` reads a float tree (npz layout of
``train/checkpoints.py``) and packs it on the RTN grid; ``--calibrate``
calibrates the float weights in process (AffineQuant, ``CalibConfig(epochs
=5)``, 16 Markov samples of the prompt length) and serves the packed result,
then prints the greedy agreement of the packed tree with the calibrated
fake-quant simulation, teacher-forced on the served streams;
``--load-packed DIR`` serves a packed tree written earlier (by
``launch/calibrate.py`` or ``checkpoints.save``).
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.calibration import (CalibConfig, finalize_model,
                                          quantize_dense_model)
from repro_torch.core.quantizer import QuantConfig
from repro_torch.data import MarkovCorpus
from repro_torch.device import resolve_device
from repro_torch.launch.calibrate import load_float_params
from repro_torch.models import transformer
from repro_torch.models.init import init_block, init_lm, init_top, stack_layers
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.quantized import (QuantizedModel, quantize_layers,
                                         quantize_lm_packed)
from repro_torch.train import checkpoints


def random_packed_lm(cfg, qcfg: QuantConfig, seed: int, device) -> dict:
    """Seeded random float weights, RTN-quantized and packed one layer at
    a time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_top(cfg, gen, device)
    params["layers"] = stack_layers(
        [quantize_layers(init_block(cfg, gen, device), qcfg)
         for _ in range(cfg.num_layers)])
    return params


def calibrated_lm(float_params: dict, cfg, qcfg: QuantConfig, args
                  ) -> tuple[dict, dict]:
    """(packed tree, fake-quant simulation tree) of an in-process
    AffineQuant calibration on 16 Markov samples of the prompt length."""
    ccfg = CalibConfig(epochs=5)
    calib = MarkovCorpus(vocab=cfg.vocab_size, seed=args.seed).sample(
        16, args.prompt_len, seed=777)
    fake, info = quantize_dense_model(float_params, cfg, qcfg, ccfg,
                                      torch.from_numpy(calib), log=False)
    packed = finalize_model(float_params, info["block_qps"], cfg, qcfg, ccfg,
                            deploy="packed")
    return packed, fake


def load_params(args, cfg, qcfg: QuantConfig, device
                ) -> tuple[dict, Optional[dict]]:
    """(packed tree, fake-quant tree or None) as the flags ask."""
    if args.load_packed and args.ckpt:
        raise ValueError("--load-packed serves a packed tree; --ckpt names "
                         "a float one: pass one of them")
    if args.load_packed:
        return checkpoints.load_tree(args.load_packed, cfg, qcfg,
                                     device=device), None
    if not (args.ckpt or args.calibrate):
        return random_packed_lm(cfg, qcfg, args.seed, device), None
    if args.ckpt:
        float_params = load_float_params(args.ckpt, cfg, qcfg, device)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        float_params = init_lm(cfg, gen, device)
    if args.calibrate:
        return calibrated_lm(float_params, cfg, qcfg, args)
    return quantize_lm_packed(float_params, cfg, qcfg), None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama-mini")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut depth to this many layers (0 = all)")
    ap.add_argument("--wbits", type=int, default=4)
    ap.add_argument("--group", type=int, default=128)
    ap.add_argument("--abits", type=int, default=4)
    ap.add_argument("--kvbits", type=int, default=8,
                    help="4 (int4 + bf16 block-32 scales), 8 or 16")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--paged", action="store_true",
                    help="page-pool KV cache with admission control and "
                         "preemption")
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="pool pages (0 = max_batch * ceil(max_len / "
                         "page_size))")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="> 0: chunked admission, one chunk per step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--load-packed", default=None, metavar="DIR",
                     help="serve a packed checkpoint")
    src.add_argument("--calibrate", action="store_true",
                     help="calibrate the float weights (random, or --ckpt) "
                          "in process and serve the packed result")
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="float checkpoint: packed on the RTN grid, or "
                         "calibrated with --calibrate")
    return ap


def build_model(args: argparse.Namespace, params: Optional[dict] = None):
    """(cfg, qcfg, packed params, QuantizedModel, fake-quant tree or None)
    from the parsed flags; ``params`` reuses a packed tree built for the
    same arch, depth, weight bits, group and seed (the KV format and
    activation bits may differ)."""
    device = resolve_device(args.device)
    # float32 matmuls left to PyTorch (vocab head, activation transforms)
    # stay full float32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    qcfg = QuantConfig(w_bits=args.wbits, a_bits=args.abits,
                       group_size=args.group, kv_bits=args.kvbits)
    fake = None
    if params is None:
        params, fake = load_params(args, cfg, qcfg, device)
    return cfg, qcfg, params, QuantizedModel(cfg, qcfg, device=device), fake


def serve(args: argparse.Namespace, params: Optional[dict] = None) -> dict:
    """Build, run and time one serving session; returns the engine, its
    requests and the measurements.  ``params``: as in :func:`build_model`."""
    cfg, qcfg, params, model, fake = build_model(args, params)
    engine = Engine(model, params, ServeConfig(
        max_batch=args.max_batch, max_len=args.max_len,
        max_new=args.max_new, paged=args.paged, page_size=args.page_size,
        num_pages=args.num_pages, prefill_chunk=args.prefill_chunk))
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len)
               for _ in range(args.requests)]
    for p in prompts:
        engine.submit(p)
    # each step ends in a host readback of the sampled tokens, so the host
    # clock around a step measures the step's device work too
    step_s = []
    t0 = t = time.perf_counter()
    while engine.step():
        now = time.perf_counter()
        step_s.append(now - t)
        t = now
    seconds = t - t0
    reqs = engine.run()          # nothing left: returns the requests
    generated = sum(len(r.out_tokens) for r in reqs)
    return {"cfg": cfg, "qcfg": qcfg, "model": model, "params": params,
            "fake": fake, "engine": engine, "requests": reqs,
            "prompts": prompts,
            "seconds": seconds, "generated": generated,
            "tokens_per_s": generated / seconds, "step_seconds": step_s,
            "preemptions": engine.preemptions, **engine.memory_report()}


@torch.no_grad()
def teacher_forced(model: QuantizedModel, params: dict, prompts: torch.Tensor,
                   gen: torch.Tensor, steps: int, max_len: int
                   ) -> torch.Tensor:
    """Logits (B, 1 + steps, vocab) of the packed tree: the prefill's last
    position, then ``steps`` decode steps fed ``gen[:, i]``."""
    lg, cache = model.prefill(params, {"tokens": prompts}, max_len=max_len)
    seq = [lg]
    for i in range(steps):
        lg, cache = model.decode_step(params, gen[:, i:i + 1], cache)
        seq.append(lg)
    return torch.cat(seq, 1)


@torch.no_grad()
def packed_and_fake_logits(model: QuantizedModel, params: dict, fake: dict,
                           prompts: list, streams: list
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Logits (B, n, vocab) of the packed tree, teacher-forced on the
    served tokens, and of the fake-quant tree through the float forward, at
    the positions that predicted the ``n`` served tokens."""
    n = min(len(s) for s in streams)
    p = torch.as_tensor(np.stack(prompts), dtype=torch.int32)
    gen = torch.as_tensor([s[:n] for s in streams], dtype=torch.int32)
    packed = teacher_forced(model, params, p, gen, n - 1, p.shape[1] + n)
    tokens = torch.cat([p, gen[:, :n - 1]], 1).to(model.device)
    sim = transformer.forward(fake, model.cfg, tokens)[:, p.shape[1] - 1:]
    return packed, sim


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    out = serve(args)
    print(f"[serve] {out['cfg'].name} x{out['cfg'].num_layers} layers "
          f"{out['qcfg'].tag()} on {out['model'].device}: "
          f"{out['generated']} tokens in {out['seconds']:.3f} s = "
          f"{out['tokens_per_s']:.1f} tok/s (prefill included)")
    steps = out["step_seconds"]
    print(f"[serve] first step (admission + prefill + one decode) "
          f"{steps[0]:.4f} s; decode step median "
          f"{statistics.median(steps[1:] or steps) * 1e3:.2f} ms over "
          f"{len(steps) - 1} steps")
    print(f"[serve] weight bytes {out['weight_bytes']}, KV bytes "
          f"{out['kv_bytes']}, preemptions {out['preemptions']}")
    if out["fake"] is not None:
        packed, sim = packed_and_fake_logits(
            out["model"], out["params"], out["fake"], out["prompts"],
            [r.out_tokens for r in out["requests"]])
        agree = (packed.argmax(-1) == sim.argmax(-1)).float().mean().item()
        print(f"[serve] calibrated packed vs fake-quant simulation, "
              f"teacher-forced on the served streams: greedy agreement "
              f"{agree:.4f} over {sim.shape[0] * sim.shape[1]} tokens")
    return out


if __name__ == "__main__":
    main()
