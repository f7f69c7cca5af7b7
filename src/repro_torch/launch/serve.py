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
from repro_torch.core.quantizer import QuantConfig
from repro_torch.models.init import init_block, init_top, stack_layers
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.quantized import (QuantizedModel, quantize_layers,
                                         resolve_device)


def random_packed_lm(cfg, qcfg: QuantConfig, seed: int, device) -> dict:
    """Seeded random float weights, RTN-quantized and packed one layer at
    a time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_top(cfg, gen, device)
    params["layers"] = stack_layers(
        [quantize_layers(init_block(cfg, gen, device), qcfg)
         for _ in range(cfg.num_layers)])
    return params


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
    return ap


def build_model(args: argparse.Namespace, params: Optional[dict] = None):
    """(cfg, qcfg, packed params, QuantizedModel) from the parsed flags;
    ``params`` reuses a packed tree built for the same arch, depth, weight
    bits, group and seed (the KV format and activation bits may differ)."""
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
    if params is None:
        params = random_packed_lm(cfg, qcfg, args.seed, device)
    return cfg, qcfg, params, QuantizedModel(cfg, qcfg, device=device)


def serve(args: argparse.Namespace, params: Optional[dict] = None) -> dict:
    """Build, run and time one serving session; returns the engine, its
    requests and the measurements.  ``params``: as in :func:`build_model`."""
    cfg, qcfg, params, model = build_model(args, params)
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
            "engine": engine, "requests": reqs, "prompts": prompts,
            "seconds": seconds, "generated": generated,
            "tokens_per_s": generated / seconds, "step_seconds": step_s,
            "preemptions": engine.preemptions, **engine.memory_report()}


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
    return out


if __name__ == "__main__":
    main()
