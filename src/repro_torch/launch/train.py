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
Every family with a token stream trains (mamba2 and
griffin through their own blocks, a VLM on its text alone, each block
under remat where the config asks); audio is refused, as the reference's
launcher refuses it in effect: its batches hold tokens, and an audio loss
reads frame embeddings and labels.

``--mesh`` takes the reference's three meshes, under its training rules
(FSDP over "data", tensor parallelism over "model":
:mod:`repro_torch.train.parallel`).  ``host`` is every rank of the
process group this launcher joins as a (1, world) mesh: the world
``torch.distributed.run`` describes in the environment, or, without one,
a world of one, which trains unsharded as before.  ``production`` (16 x
16) and ``multipod`` (2 x 16 x 16) refuse a world of another size.  Two
ranks on one card (gloo, every collective staged through the host)::

    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch opt-125m --mesh host

Each rank builds the global batch and trains its rows; only rank 0 logs
the final line and writes the (whole) checkpoints.  Meshes with "data"
larger than 1 are reached through the API (``launch.mesh.make_mesh(d,
m)``, ``init_train_state`` / ``make_train_step`` with ``mesh``), as the
reference reaches them.  The non-dense families refuse a mesh larger than
1 x 1 (ROADMAP queue 1, item 6d).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import math

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data import MarkovCorpus, make_batch_fn
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (init_from_env, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.model import build_model
from repro_torch.optim import AdamConfig
from repro_torch.sharding import batch_shards, make_rules
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.parallel import MeshTraining
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.utils import human_count, logger

MESH_RANKS = {"production": 256, "multipod": 512}


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


def training_mesh(args: argparse.Namespace, device):
    """The ``--mesh`` of the launcher: None for a world of one on
    ``host`` (the unsharded step)."""
    world = init_from_env(device)
    if args.mesh == "host":
        return make_host_mesh(device=device) if world > 1 else None
    need = MESH_RANKS[args.mesh]
    if world != need:
        raise ValueError(
            f"--mesh {args.mesh} needs {need} ranks; the process group "
            f"holds {world} (start them with python -m "
            f"torch.distributed.run, or train on --mesh host)")
    return make_production_mesh(multi_pod=args.mesh == "multipod",
                                device=device)


def train(args: argparse.Namespace) -> dict:
    """Train to ``args.steps`` (resuming from ``--ckpt-dir``); returns the
    config, model, corpus and final state (this rank's shards on a mesh,
    with the ``sharding`` that holds their layout), every applied step's
    ``(step, loss, grad_norm, seconds)`` in ``history`` and the final
    loss."""
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
    mesh = training_mesh(args, device)
    rank = dist.get_rank() if mesh is not None else 0
    if rank:
        logger.setLevel(logging.WARNING)
    data = batch_shards(mesh, make_rules(multi_pod=args.mesh == "multipod")) \
        if mesh is not None else 1
    if args.global_batch % data:
        raise ValueError(f"--global-batch {args.global_batch} does not "
                         f"split over {data} data-parallel ranks")
    # microbatches split each rank's own rows
    if cfg.microbatches > 1 and (args.global_batch // data) % cfg.microbatches:
        cfg = dataclasses.replace(cfg, microbatches=1)
    model = build_model(cfg, device)
    sharding = MeshTraining(model, mesh) if mesh is not None else None

    corpus = MarkovCorpus(vocab=cfg.vocab_size, seed=args.seed)
    batch_fn_np = make_batch_fn(corpus, args.global_batch, args.seq)

    def batch_fn(step: int) -> dict:
        return {"tokens": torch.from_numpy(
            batch_fn_np(step)["tokens"]).to(device)}

    adam = AdamConfig(lr=args.lr, state_dtype=cfg.opt_state_dtype)
    state = init_train_state(model, args.seed, adam, mesh=mesh)
    logger.info("arch=%s params=%s device=%s mesh=%s", cfg.name,
                human_count(cfg.param_count()), device,
                None if sharding is None else sharding.sizes)
    step_fn = make_train_step(model, adam, total_steps=args.steps,
                              warmup=max(args.steps // 20, 5), mesh=mesh)
    history = []

    def on_metrics(step, metrics, seconds):
        history.append((step, float(metrics["loss"]),
                        float(metrics["grad_norm"]), seconds))

    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir)
    state = train_loop(state, step_fn, batch_fn, loop_cfg, on_metrics,
                       sharding=sharding)
    final_loss = float(step_fn(state, batch_fn(args.steps))[1]["loss"])
    return {"cfg": cfg, "model": model, "corpus": corpus, "state": state,
            "history": history, "final_loss": final_loss, "rank": rank,
            "sharding": sharding}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="[train] %(message)s")
    started = not dist.is_initialized()
    try:
        out = train(build_parser().parse_args(argv))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    if out["rank"]:
        return 0
    loss = out["final_loss"]
    print(f"[train] done: final loss {loss:.4f} (ppl {math.exp(loss):.2f}); "
          f"corpus entropy floor {out['corpus'].entropy_floor():.4f} nats",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
