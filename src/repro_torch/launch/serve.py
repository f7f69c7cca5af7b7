"""Serve a packed (or float) dense model from seeded random weights.

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
plain versions of the kernels.  ``--ttl-s`` gives every request a
wall-clock deadline and ``--max-queue`` bounds the admission queue (a
submit past it is rejected, not queued); the last line reports the
requests' terminal statuses beside the preemptions.

``--prefix-cache`` (needs ``--paged``; chunks default to ``--page-size``)
then serves the same prompts twice, a cold wave and a replay wave, on one
engine with refcounted prefix-page sharing and a pool sized to the whole
trace (or ``--num-pages``), and prints the prefix statistics and each
wave's greedy agreement with the paged run.

Other weights: ``--ckpt DIR`` reads a float tree (npz layout of
``train/checkpoints.py``) and packs it on the RTN grid; ``--calibrate``
calibrates the float weights in process (AffineQuant, ``CalibConfig(epochs
=5)``, 16 Markov samples of the prompt length) and serves the packed result,
then prints the greedy agreement of the packed tree with the calibrated
fake-quant simulation, teacher-forced on the served streams;
``--load-packed DIR`` serves a packed tree written earlier (by
``launch/calibrate.py`` or ``checkpoints.save``).

The float model: ``--fp`` serves the float tree itself (the seeded init,
which draws the floats ``random_packed_lm`` packs, or ``--ckpt``) through
``Model``: float32 linears, a float cache, the same Engine.
``--compare-fp`` serves that float tree first and then the packed tree made
from it, and prints the reference's greedy-agreement lines: fp vs packed,
and with ``--calibrate`` also the fake-quant tree served through ``Model``
(fp vs quant, quant vs packed).  Both hold the whole float tree in memory.

``--arch paligemma-3b`` and ``hubert-xlarge`` serve packed (and
calibrated, ``--calibrate``) as the causal token trunk, as the reference's
``QuantizedModel`` serves them: text prompts, no image prefix, causal
attention for hubert too.  ``paligemma-3b`` also serves through ``--fp``
(text prompts); ``hubert-xlarge`` is an encoder and its float ``Model`` has
no decode path, so ``--fp`` and ``--compare-fp`` refuse it.  The recurrent
families serve through ``--fp`` only: ``--arch mamba2-1.3b`` and
``recurrentgemma-2b`` (prompts prefilled at their exact lengths, the
recurrent states and griffin's attention ring buffer in the linear cache);
the packed path refuses them (``core/sites.py``).  ``--reduced`` serves
the arch's tiny smoke config (2 layers, d 64), for the CPU.

Mesh-native serving: ``--mesh-data D --mesh-model M`` (D x M > 1) starts
D x M ranks itself (``torch.multiprocessing``, one process each, joined over
``tcp://localhost``), each serving the same requests through
``Engine(mesh=...)`` on its shards (column-parallel weights over "model",
the batch over "data"); rank 0 prints the report with each rank's resident
weight and KV bytes.  Every family serves so: the dense trunk, the MoE
family packed and with ``--fp`` (``--arch qwen3-moe-30b-a3b`` /
``dbrx-132b``: a rank holds its E / M experts), ``mamba2-1.3b`` and
``recurrentgemma-2b`` with ``--fp`` (a rank holds its SSD heads / rnn
channels and their states) and ``paligemma-3b`` packed or with ``--fp``.
A float tree (``--ckpt``) and a packed one (``--load-packed``) load to
the CPU on a mesh, so only each rank's shards reach the card.  On the
card each rank needs a card of its own (NCCL) unless ``--share-cards``
puts several on one card (gloo, collectives staged through the host);
``--device cpu`` runs the ranks on gloo.  A 1 x 1 mesh serves in process,
as without the flags.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.calibration import (CalibConfig, finalize_model,
                                          quantize_dense_model)
from repro_torch.core.quantizer import QuantConfig
from repro_torch.core.sites import require_quantizable
from repro_torch.data import MarkovCorpus
from repro_torch.device import resolve_device
from repro_torch.kernels import _lib
from repro_torch.launch.calibrate import load_float_params
from repro_torch.launch.mesh import (backend_for, free_port, init_world,
                                     make_serving_mesh)
from repro_torch.models.init import init_block, init_lm, init_top, stack_layers
from repro_torch.models.model import ENCODER_ONLY, Model
from repro_torch.serve.engine import Engine, QueueFull, ServeConfig
from repro_torch.serve.kv_cache import pages_for
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


def on_mesh(args) -> bool:
    return args.mesh_data * args.mesh_model > 1


def float_lm(args, cfg, qcfg: QuantConfig, device) -> dict:
    """The float tree: ``--ckpt``, or the seeded init (the floats that
    ``random_packed_lm`` packs, drawn in the same order).  On a mesh a
    checkpoint loads to the CPU: each rank's Engine moves only its shards
    to the card (the seeded init is drawn on ``device``, whose generator
    draws the floats an unsharded run serves)."""
    if args.ckpt:
        return load_float_params(args.ckpt, cfg, qcfg,
                                 "cpu" if on_mesh(args) else device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return init_lm(cfg, gen, device)


def load_params(args, cfg, qcfg: QuantConfig, device,
                float_params: Optional[dict] = None
                ) -> tuple[dict, Optional[dict]]:
    """(served tree, fake-quant tree or None) as the flags ask: the float
    tree with ``--fp``, else the packed one (from ``float_params`` when
    given)."""
    if args.load_packed and (args.ckpt or args.fp):
        raise ValueError("--load-packed serves a packed tree; --ckpt and "
                         "--fp name a float one: pass one of them")
    if args.load_packed:
        # on a mesh the whole tree stays on the CPU: each rank's Engine
        # moves only its shards to the card
        return checkpoints.load_tree(args.load_packed, cfg, qcfg,
                                     device="cpu" if on_mesh(args)
                                     else device), None
    if args.fp:
        return float_params or float_lm(args, cfg, qcfg, device), None
    if not (args.ckpt or args.calibrate or float_params):
        return random_packed_lm(cfg, qcfg, args.seed, device), None
    float_params = float_params or float_lm(args, cfg, qcfg, device)
    if args.calibrate:
        return calibrated_lm(float_params, cfg, qcfg, args)
    return quantize_lm_packed(float_params, cfg, qcfg), None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama-mini")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut depth to this many layers (0 = all)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced smoke config of --arch")
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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="then serve the prompts twice (cold, replay) on "
                         "one engine sharing prompt-prefix pages by "
                         "refcount (needs --paged; chunks default to "
                         "--page-size)")
    ap.add_argument("--ttl-s", type=float, default=0.0,
                    help="per-request wall-clock deadline in seconds "
                         "(0 = none): expired requests end FAILED_DEADLINE")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound on pending requests (0 = unbounded); a "
                         "submit past it ends REJECTED_QUEUE_FULL")
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
    fp = ap.add_mutually_exclusive_group()
    fp.add_argument("--fp", action="store_true",
                    help="serve the float tree (seeded, or --ckpt) through "
                         "the float Model; the bit flags are ignored")
    fp.add_argument("--compare-fp", action="store_true",
                    help="serve the float tree, then the packed tree made "
                         "from it, and print their greedy agreement")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel mesh axis: each step's batch rows "
                         "split across it")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="tensor-parallel mesh axis: column-parallel "
                         "weights and the KV cache's heads split across it")
    ap.add_argument("--share-cards", action="store_true",
                    help="let a mesh larger than the visible cards put "
                         "several ranks on a card (gloo)")
    return ap


def arch_config(args: argparse.Namespace):
    """The arch's config (``--reduced``: its smoke config), depth cut to
    ``--layers``; an encoder through the float ``Model`` (``--fp``), which
    has no decode path, and without ``--fp`` a family the packed path does
    not take, are refused.  Also turns TF32 off: the float32 products left
    to PyTorch (every float linear, the vocab head, activation transforms)
    stay full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.fp and cfg.family == "audio":
        raise ValueError(f"--arch {args.arch}: {ENCODER_ONLY}")
    if not args.fp:
        require_quantizable(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def quant_config(args: argparse.Namespace) -> QuantConfig:
    return QuantConfig(w_bits=args.wbits, a_bits=args.abits,
                       group_size=args.group, kv_bits=args.kvbits)


def build_model(args: argparse.Namespace, params: Optional[dict] = None):
    """(cfg, qcfg, params, model, fake-quant tree or None) from the parsed
    flags: a ``QuantizedModel`` over a packed tree, or with ``--fp`` a
    ``Model`` over the float tree; ``params`` reuses a tree built for the
    same arch, depth and seed (packed: and weight bits and group; the KV
    format and activation bits may differ)."""
    device = resolve_device(args.device)
    cfg, qcfg = arch_config(args), quant_config(args)
    fake = None
    if params is None:
        params, fake = load_params(args, cfg, qcfg, device)
    model = (Model(cfg, device) if args.fp
             else QuantizedModel(cfg, qcfg, device=device))
    return cfg, qcfg, params, model, fake


def serve_config(args: argparse.Namespace) -> ServeConfig:
    return ServeConfig(
        max_batch=args.max_batch, max_len=args.max_len,
        max_new=args.max_new, paged=args.paged, page_size=args.page_size,
        num_pages=args.num_pages, prefill_chunk=args.prefill_chunk,
        default_ttl_s=args.ttl_s, max_queue=args.max_queue)


def submit_all(engine: Engine, prompts: list) -> list:
    """Submit every prompt; a QueueFull rejection is no error (the request
    is terminal, REJECTED_QUEUE_FULL, and counted in the statuses)."""
    reqs = []
    for p in prompts:
        try:
            reqs.append(engine.submit(p))
        except QueueFull as e:
            reqs.append(e.request)
    return reqs


def serve(args: argparse.Namespace, params: Optional[dict] = None,
          mesh=None) -> dict:
    """Build, run and time one serving session (on ``mesh``: this rank's
    part of it); returns the engine, its requests and the measurements.
    ``params``: as in :func:`build_model`."""
    if args.prefix_cache and not args.paged:
        raise ValueError("--prefix-cache shares pages of the paged KV "
                         "cache: add --paged")
    cfg, qcfg, params, model, fake = build_model(args, params)
    engine = Engine(model, params, serve_config(args), mesh=mesh)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len)
               for _ in range(args.requests)]
    submit_all(engine, prompts)
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
            "mesh": mesh, "tag": "fp" if args.fp else qcfg.tag(),
            "fake": fake, "engine": engine, "requests": reqs,
            "prompts": prompts,
            "seconds": seconds, "generated": generated,
            "tokens_per_s": generated / seconds, "step_seconds": step_s,
            "preemptions": engine.preemptions,
            "statuses": engine.status_counts(), **engine.memory_report()}


def serve_prefix(args: argparse.Namespace, out: dict) -> dict:
    """``--prefix-cache``: the prompts of ``out`` (a paged run) served as a
    cold and a replay wave on one prefix-sharing engine whose pool holds
    the whole trace, so the replay adopts the pages the cold wave left.
    Returns each wave's requests and seconds, the prefix statistics and the
    engine."""
    num_pages = args.num_pages or args.requests * pages_for(
        args.prompt_len + args.max_new + 1, args.page_size)
    scfg = dataclasses.replace(
        serve_config(args), prefix_cache=True, num_pages=num_pages,
        prefill_chunk=args.prefill_chunk or args.page_size)
    engine = Engine(out["model"], out["params"], scfg, mesh=out["mesh"])
    waves = {}
    for wave in ("cold", "replay"):
        t0 = time.perf_counter()
        reqs = submit_all(engine, out["prompts"])
        engine.run()
        waves[wave] = (reqs, time.perf_counter() - t0)
    return {"waves": waves, "stats": dict(engine.prefix_stats),
            "engine": engine}


def agreement(a: list, b: list) -> float:
    """Share of equal tokens over the common length of paired streams."""
    pairs = [(x, y) for x, y in zip(a, b) if x and y]
    if not pairs:
        return float("nan")
    return float(np.mean([np.mean(np.array(x[:len(y)]) == np.array(y[:len(x)]))
                          for x, y in pairs]))


@torch.no_grad()
def teacher_forced(model, params: dict, prompts: torch.Tensor,
                   gen: torch.Tensor, steps: int, max_len: int,
                   chunk: int = 0) -> torch.Tensor:
    """Logits (B, 1 + steps, vocab) of ``model`` (float or packed): the
    prompt's last position, then ``steps`` decode steps fed ``gen[:, i]``.
    The prompt is prefilled whole, or with ``chunk`` in chunks of that many
    tokens, as chunked admission and a preempted resume prefill it."""
    if chunk:
        b, t = prompts.shape
        cache = model.init_cache(b, max_len)
        for c0 in range(0, t, chunk):
            lg, cache = model.prefill_chunk(
                params, {"tokens": prompts[:, c0:c0 + chunk]}, cache,
                torch.full((b,), c0, dtype=torch.int32), last_only=True)
    else:
        lg, cache = model.prefill(params, {"tokens": prompts},
                                  max_len=max_len)
    seq = [lg]
    for i in range(steps):
        lg, cache = model.decode_step(params, gen[:, i:i + 1], cache)
        seq.append(lg)
    return torch.cat(seq, 1)


def near_greedy(logits: torch.Tensor, tokens: torch.Tensor,
                tol: float) -> float:
    """Share of served ``tokens`` (B, n) whose logit in ``logits`` (B, n,
    vocab), the teacher-forced logits that predicted them, lies within
    ``tol`` of the largest logit magnitude below the row's maximum: 1.0 when
    every token is the greedy choice or ties it to within ``tol``."""
    lg = logits.to(torch.float32)
    idx = tokens.long().to(lg.device)[..., None]
    picked = torch.gather(lg, -1, idx)[..., 0]
    gap = lg.amax(-1) - picked
    return (gap <= tol * lg.abs().max()).float().mean().item()


@torch.no_grad()
def packed_and_fake_logits(model: QuantizedModel, params: dict, fake: dict,
                           prompts: list, streams: list
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Logits (B, n, vocab) of the packed tree and of the fake-quant tree
    through the float model, both teacher-forced on the served tokens by the
    same calls (the prompt's prefill, then decode steps), at the positions
    that predicted the ``n`` served tokens.  The same calls give an MoE the
    same token counts, so its per-call expert capacity drops the same
    tokens in both."""
    n = min(len(s) for s in streams)
    p = torch.as_tensor(np.stack(prompts), dtype=torch.int32)
    gen = torch.as_tensor([s[:n] for s in streams], dtype=torch.int32)
    packed = teacher_forced(model, params, p, gen, n - 1, p.shape[1] + n)
    sim = teacher_forced(Model(model.cfg, model.device), fake, p, gen, n - 1,
                         p.shape[1] + n)
    return packed, sim


def report(args: argparse.Namespace, out: dict, echo: bool = True) -> dict:
    """Print one serving run's lines (and serve the prefix waves when
    ``--prefix-cache`` asks); returns ``out``.  ``echo`` False computes
    without printing (the ranks of a mesh other than 0)."""
    print = _printer(echo)
    print(f"[serve] {out['cfg'].name} x{out['cfg'].num_layers} layers "
          f"{out['tag']} on {out['model'].device}: "
          f"{out['generated']} tokens in {out['seconds']:.3f} s = "
          f"{out['tokens_per_s']:.1f} tok/s (prefill included)")
    steps = out["step_seconds"]
    print(f"[serve] first step (admission + prefill + one decode) "
          f"{steps[0]:.4f} s; decode step median "
          f"{statistics.median(steps[1:] or steps) * 1e3:.2f} ms over "
          f"{len(steps) - 1} steps")
    if out["fake"] is not None and out["cfg"].family == "audio":
        print(f"[serve] the fake-quant simulation runs through the float "
              f"Model, which has no decode path for an encoder: not "
              f"compared")
    elif out["fake"] is not None:
        packed, sim = packed_and_fake_logits(
            out["model"], out["params"], out["fake"], out["prompts"],
            [r.out_tokens for r in out["requests"]])
        agree = (packed.argmax(-1) == sim.argmax(-1)).float().mean().item()
        print(f"[serve] calibrated packed vs fake-quant simulation, "
              f"teacher-forced on the served streams: greedy agreement "
              f"{agree:.4f} over {sim.shape[0] * sim.shape[1]} tokens")
    if args.prefix_cache:
        px = serve_prefix(args, out)
        base = [r.out_tokens for r in out["requests"]]
        for wave, (reqs, secs) in px["waves"].items():
            n = sum(len(r.out_tokens) for r in reqs)
            print(f"[serve-prefix] {wave} wave: {n} tokens in {secs:.3f} s "
                  f"= {n / secs:.1f} tok/s; greedy agreement with the paged "
                  f"run {agreement(base, [r.out_tokens for r in reqs]):.4f}")
        st = px["stats"]
        print(f"[serve-prefix] {st['hits']}/{st['lookups']} lookups hit, "
              f"{st['matched_tokens']} prompt tokens adopted from resident "
              f"pages, {st['prefilled_tokens']} prefilled")
        out["prefix"] = px
    if out["mesh"] is not None:
        print(f"[serve] per-device resident memory: weights "
              f"{out['weight_bytes'] / 2**20:.2f} MiB, kv cache "
              f"{out['kv_bytes'] / 2**20:.2f} MiB (x{out['device_count']} "
              f"devices)")
    print(f"[serve] weight bytes {out['weight_bytes']}, KV bytes "
          f"{out['kv_bytes']}, preemptions {out['preemptions']}, statuses "
          f"{out['statuses']}")
    return out


def _printer(echo: bool):
    return print if echo else (lambda *a, **k: None)


def compare_fp(args: argparse.Namespace, mesh=None, echo: bool = True
               ) -> dict:
    """``--compare-fp``: the float tree served through ``Model``, then the
    packed tree made from it (RTN, or ``--calibrate``), and with
    ``--calibrate`` the fake-quant tree through ``Model``; prints the
    greedy agreement of each pair of runs, as the reference's serve CLI
    does.  Returns the packed run with the others under "fp" and
    "quant"."""
    if args.load_packed:
        raise ValueError("--compare-fp needs the float tree the packed one "
                         "is made from: drop --load-packed")
    device = resolve_device(args.device)
    fp_args = argparse.Namespace(**{**vars(args), "fp": True,
                                    "compare_fp": False})
    # both runs' refusals (an encoder has no float decode path) come
    # before any float weight is made
    arch_config(fp_args)
    cfg = arch_config(args)
    qcfg = quant_config(args)
    float_params = float_lm(args, cfg, qcfg, device)
    fp = report(fp_args, serve(fp_args, float_params, mesh), echo)
    packed, fake = load_params(args, cfg, qcfg, device, float_params)
    out = serve(args, packed, mesh)
    out["fake"] = fake
    report(args, out, echo)
    print = _printer(echo)
    streams = lambda o: [r.out_tokens for r in o["requests"]]
    print(f"[serve] greedy-token agreement fp vs packed-{out['tag']}: "
          f"{agreement(streams(fp), streams(out)):.4f}")
    if fake is not None:
        quant = report(fp_args, serve(fp_args, fake, mesh), echo)
        print(f"[serve] greedy-token agreement fp vs quant: "
              f"{agreement(streams(fp), streams(quant)):.4f}; quant vs "
              f"packed-{out['tag']}: "
              f"{agreement(streams(quant), streams(out)):.4f}")
        out["quant"] = quant
    print(f"[serve] weight bytes: fp {fp['weight_bytes']} -> packed "
          f"{out['weight_bytes']} "
          f"({fp['weight_bytes'] / out['weight_bytes']:.2f}x)")
    out["fp"] = fp
    return out


def run(args: argparse.Namespace, mesh=None, echo: bool = True) -> dict:
    """The session the flags ask for (on ``mesh``: this rank's part)."""
    if args.compare_fp:
        return compare_fp(args, mesh, echo)
    return report(args, serve(args, mesh=mesh), echo)


def rank_summary(out: dict) -> dict:
    """What a rank of a mesh reports: its streams, statuses, preemptions,
    resident bytes, kernel launches and step times."""
    return {"streams": [list(r.out_tokens) for r in out["requests"]],
            "statuses": [r.status.name for r in out["requests"]],
            "preemptions": out["preemptions"],
            "memory": out["engine"].memory_report(),
            "launches": dict(_lib.LAUNCHES),
            "step_seconds": out["step_seconds"], "seconds": out["seconds"],
            "generated": out["generated"]}


def _rank_main(rank: int, args: argparse.Namespace, world: int, port: int,
               out_dir: str) -> None:
    """One rank of :func:`serve_on_mesh`: join the group, serve, write the
    rank's summary as JSON into ``out_dir``."""
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    backend = init_world(rank, world, port, args.device)
    try:
        mesh = make_serving_mesh(args.mesh_data, args.mesh_model,
                                 device=args.device)
        if rank == 0:
            cards = (torch.cuda.device_count()
                     if torch.device(args.device).type == "cuda" else 0)
            print(f"[serve] mesh (data={args.mesh_data}, model="
                  f"{args.mesh_model}): {world} ranks, backend {backend}"
                  + (f", on {min(cards, world)} card(s)" if cards else
                     " on the CPU"))
        out = run(args, mesh, echo=rank == 0)
        summary = dict(rank_summary(out), rank=rank, backend=backend,
                       coordinate=list(mesh.get_coordinate()))
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(summary))
        # no rank tears its connections down while another still serves
        dist.barrier()
    finally:
        dist.destroy_process_group()


def serve_on_mesh(args: argparse.Namespace) -> dict:
    """Start ``--mesh-data x --mesh-model`` ranks, each serving its part of
    the session, and return their summaries (``ranks``, in rank order) with
    rank 0's beside them.  A rank that fails fails the call."""
    import torch.multiprocessing as mp
    world = args.mesh_data * args.mesh_model
    if args.mesh_data < 1 or args.mesh_model < 1:
        raise ValueError(f"mesh axes must be positive; got data="
                         f"{args.mesh_data}, model={args.mesh_model}")
    device = resolve_device(args.device)
    if device.type == "cuda" and torch.cuda.device_count() < world \
            and not args.share_cards:
        raise ValueError(
            f"mesh (data={args.mesh_data}, model={args.mesh_model}) needs "
            f"{world} cards but {torch.cuda.device_count()} are visible: "
            f"shrink --mesh-data / --mesh-model, or pass --share-cards to "
            f"put several ranks on a card (gloo)")
    backend_for(device, world)          # refuses what no backend serves
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_rank_main, args=(args, world, free_port(), out_dir),
                 nprocs=world, join=True)
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(world)]
    return dict(ranks[0], ranks=ranks)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if on_mesh(args):
        return serve_on_mesh(args)
    return run(args)


if __name__ == "__main__":
    main()
