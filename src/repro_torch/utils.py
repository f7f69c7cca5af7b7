"""Small helpers of the training path: the global norm of a tensor tree,
the step timer behind the straggler monitor, a count formatter and the
port's logger (the reference's ``utils.py``, the parts training uses)."""
from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np
import torch

logger = logging.getLogger("repro_torch")


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list tree in the reference's leaf
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf (a 0-d tensor);
    the leaves' sums are added in leaf order, as the reference's ``sum``."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def human_count(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000.0:
            return f"{n:.2f}{unit}"
        n /= 1000.0
    return f"{n:.2f}Q"


class StepTimer:
    """Wall-clock timer with percentile stats — used by the straggler
    monitor.  ``clock`` is injectable (a fake clock in the tests)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.samples: list[float] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = self._clock()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        dt = self._clock() - self._t0
        self.samples.append(dt)
        self._t0 = None
        return dt

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), q))

    def is_straggler(self, dt: float, factor: float = 2.0,
                     min_samples: int = 8) -> bool:
        """A step is a straggler if it exceeds ``factor`` x the median of
        the history."""
        if len(self.samples) < min_samples:
            return False
        return dt > factor * self.percentile(50.0)
