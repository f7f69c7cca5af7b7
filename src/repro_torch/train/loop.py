"""The training loop: checkpoint/restart, NaN guards, straggler monitoring
(the reference's ``train/loop.py``).

* **checkpoint/restart**: step-tagged atomic checkpoints every
  ``ckpt_every`` steps and at the end; on start the loop restores the
  latest checkpoint beyond the state's step, and the step-addressable data
  pipeline resumes exactly (an empty ``ckpt_dir``: no checkpoints);
* **poisoned steps**: a non-finite loss or gradient norm keeps the old
  state (the update is out of place, so nothing was written) and counts;
  ``max_bad_steps`` in a row abort with ``RuntimeError``;
* **stragglers**: per-step wall times feed a median-based detector
  (``StepTimer``); a flagged step is logged and counted into the
  checkpoint's ``extra``.

On a mesh (``sharding``, a :class:`~repro_torch.train.parallel.
MeshTraining`) the state holds this rank's shards, and checkpoints hold
whole arrays, as the reference's: every rank gathers the whole state and
rank 0 writes it in the reference's npz layout; on start every rank
restores the whole state and cuts its shards (the reference's
``sharding_fn`` role), so a checkpoint written on one mesh resumes on any
other, one device included.  The loss and grad norm the step returns are
the global batch's, and the straggler monitor times the slowest rank, so
every rank skips, aborts and flags alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

from repro_torch.train import checkpoints
from repro_torch.train.step import TrainState
from repro_torch.utils import StepTimer, logger


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"    # "" (or None): no checkpoints
    keep: int = 3
    log_every: int = 10
    max_bad_steps: int = 10
    straggler_factor: float = 2.5


def train_loop(state: TrainState, train_step: Callable, batch_fn: Callable,
               cfg: LoopConfig, on_metrics: Optional[Callable] = None,
               sharding=None) -> TrainState:
    """Run to ``total_steps`` with restart semantics; returns the final
    state.  ``on_metrics(step, metrics, seconds)`` sees every applied
    step.  ``sharding``: the state's layout on a mesh (every rank runs the
    loop)."""
    start = int(state.step)
    latest = checkpoints.latest_step(cfg.ckpt_dir) if cfg.ckpt_dir else None
    if latest is not None and latest > start:
        if sharding is None:
            state, start = checkpoints.restore(cfg.ckpt_dir, state)
        else:
            whole, start = checkpoints.restore(cfg.ckpt_dir,
                                               sharding.like(state))
            state = sharding.shard(whole)
        logger.info("restored checkpoint at step %d", start)

    timer = StepTimer()
    bad_streak = 0
    stragglers = 0
    for step in range(start, cfg.total_steps):
        batch = batch_fn(step)
        timer.start()
        new_state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        dt = timer.stop()
        if sharding is not None:
            dt = timer.samples[-1] = sharding.slowest(dt)

        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            bad_streak += 1
            logger.warning("step %d poisoned (loss=%s gnorm=%s) — skipped "
                           "(%d/%d)", step, loss, gnorm, bad_streak,
                           cfg.max_bad_steps)
            if bad_streak >= cfg.max_bad_steps:
                logger.error("too many poisoned steps; aborting to the last "
                             "checkpoint")
                raise RuntimeError("training diverged")
            continue   # keep the old state: the update is skipped entirely
        bad_streak = 0
        state = new_state

        if timer.is_straggler(dt, cfg.straggler_factor):
            stragglers += 1
            logger.warning("step %d straggler: %.3fs (median %.3fs)", step,
                           dt, timer.percentile(50))

        if (step + 1) % cfg.log_every == 0:
            logger.info("step %d loss %.4f gnorm %.3f %.3fs/step", step + 1,
                        loss, gnorm, dt)
        if on_metrics is not None:
            on_metrics(step, metrics, dt)
        if cfg.ckpt_dir and ((step + 1) % cfg.ckpt_every == 0
                             or step + 1 == cfg.total_steps):
            whole = state if sharding is None else sharding.unshard(state)
            if sharding is None or sharding.writer:
                checkpoints.save(cfg.ckpt_dir, step + 1, whole,
                                 keep=cfg.keep,
                                 extra={"stragglers": stragglers})
    return state
