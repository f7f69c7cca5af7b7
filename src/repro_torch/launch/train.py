"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-mini \
        --steps 300 --global-batch 32 --seq 128 --ckpt-dir checkpoints/opt-mini

Trains any registered arch (``--reduced`` its tiny smoke config) on the
Markov corpus, float32 without TF32, with the loop's checkpoint/restart,
NaN skip and straggler flagging: kill the command and launch it again
unchanged, and it resumes from the latest checkpoint.  The checkpoint is a
``TrainState`` in the reference's npz layout: ``launch/calibrate.py --ckpt``
and ``launch/serve.py --ckpt`` read its params, and so does the reference's
``repro.train.checkpoints.restore``.  ``--device`` defaults to ``cuda`` and
raises when no CUDA device exists; ``--device cpu`` trains on the CPU.
``--mesh host`` (one device) is the only mesh: sharded training is ROADMAP
queue 1, item 6.  Every family with a token stream trains (mamba2 and
griffin through their own blocks, a VLM on its text alone, each block
under remat where the config asks); audio is refused, as the reference's
launcher refuses it in effect: its batches hold tokens, and an audio loss
reads frame embeddings and labels.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import math

import torch

from repro_torch.configs import get_config
from repro_torch.data import MarkovCorpus, make_batch_fn
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.optim import AdamConfig
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.utils import human_count, logger


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="opt-mini")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced smoke config of --arch")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (widths stay)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/train",
                    help="'' trains without checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "production", "multipod"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def train(args: argparse.Namespace) -> dict:
    """Train to ``args.steps`` (resuming from ``--ckpt-dir``); returns the
    config, model, corpus and final state, every applied step's ``(step,
    loss, grad_norm, seconds)`` in ``history`` and the final loss."""
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training is not ported (ROADMAP "
            f"queue 1, item 6); the port trains on one device (--mesh host)")
    device = resolve_device(args.device)
    # float32 stays float32 on the card: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if cfg.family == "audio":
        raise NotImplementedError(
            f"--arch {args.arch}: the launcher's batches are token streams "
            f"(the reference's too), and an audio model's loss reads frame "
            f"embeddings and frame labels; train it through Model.loss")
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if cfg.microbatches > 1 and args.global_batch % cfg.microbatches:
        cfg = dataclasses.replace(cfg, microbatches=1)
    model = build_model(cfg, device)

    corpus = MarkovCorpus(vocab=cfg.vocab_size, seed=args.seed)
    batch_fn_np = make_batch_fn(corpus, args.global_batch, args.seq)

    def batch_fn(step: int) -> dict:
        return {"tokens": torch.from_numpy(
            batch_fn_np(step)["tokens"]).to(device)}

    adam = AdamConfig(lr=args.lr, state_dtype=cfg.opt_state_dtype)
    state = init_train_state(model, args.seed, adam)
    logger.info("arch=%s params=%s device=%s", cfg.name,
                human_count(cfg.param_count()), device)
    step_fn = make_train_step(model, adam, total_steps=args.steps,
                              warmup=max(args.steps // 20, 5))
    history = []

    def on_metrics(step, metrics, seconds):
        history.append((step, float(metrics["loss"]),
                        float(metrics["grad_norm"]), seconds))

    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir)
    state = train_loop(state, step_fn, batch_fn, loop_cfg, on_metrics)
    final_loss = float(step_fn(state, batch_fn(args.steps))[1]["loss"])
    return {"cfg": cfg, "model": model, "corpus": corpus, "state": state,
            "history": history, "final_loss": final_loss}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="[train] %(message)s")
    out = train(build_parser().parse_args(argv))
    loss = out["final_loss"]
    print(f"[train] done: final loss {loss:.4f} (ppl {math.exp(loss):.2f}); "
          f"corpus entropy floor {out['corpus'].entropy_floor():.4f} nats",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
