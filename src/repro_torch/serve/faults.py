"""Deterministic fault injection for the serving engine.

The failure paths of the Engine (NaN quarantine, pool starvation, deadline
expiry, a raising streaming callback, a corrupted page table) cannot be
reached from well-formed inputs.  A :class:`FaultPlan` reaches them: it
holds :class:`Fault` triggers keyed by named injection points that the
allocator, the cache stores and the Engine's step loop probe with
``plan.fires(point, ...)``.  With no plan installed a probe costs a
``None`` check.

Injection points (and the component that honours each):

``ALLOC_FAIL``       ``PageAllocator.allocate`` returns None (pool "dry")
                     although pages are free.
``SPLICE_CORRUPT``   ``PagedCache.splice`` misdirects one device page-table
                     entry after the scatter.
``NAN_LOGITS``       the Engine adds a NaN to the victim row's final logits
                     (a poison vector added to the float32 logits; 0.0 when
                     inactive).
``CALLBACK_RAISE``   the Engine fails the victim's ``on_token`` dispatch in
                     place of the user callback.
``DEADLINE``         the Engine treats the victim's TTL as expired at the
                     next step boundary, whatever the wall clock says.

Determinism: trigger selection uses only the plan's own counters and a
seeded ``numpy`` Generator (for ``prob < 1`` triggers), never the wall
clock or device state, so a (plan, trace) pair fires at the same calls in
every run.  The point names, the counters and the Generator are those of
the JAX package's ``serve/faults.py``, so one plan fires at the same calls
in both engines.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

ALLOC_FAIL = "alloc_no_pages"      # PageAllocator.allocate -> None
SPLICE_CORRUPT = "splice_corrupt"  # PagedCache.splice misdirects a pt entry
NAN_LOGITS = "nan_logits"          # Engine poisons one row's final logits
CALLBACK_RAISE = "callback_raise"  # Engine's on_token dispatch raises
DEADLINE = "deadline"              # Engine expires the victim's TTL now

POINTS = (ALLOC_FAIL, SPLICE_CORRUPT, NAN_LOGITS, CALLBACK_RAISE, DEADLINE)


class InjectedFault(RuntimeError):
    """Raised by injection sites that model an exception (CALLBACK_RAISE)."""


@dataclasses.dataclass
class Fault:
    """One trigger: fire at ``point`` when every set filter matches.

    ``step``        fire only on this engine step (None = any step)
    ``after_step``  fire only at step >= this (default 0 = immediately)
    ``rid``         fire only for this request id (None = any request)
    ``count``       total firings before the trigger drains (<= 0 = never
                    drains); ``fired`` counts the firings so far
    ``prob``        per-eligible-check firing probability (seeded RNG)
    """
    point: str
    step: Optional[int] = None
    after_step: int = 0
    rid: Optional[int] = None
    count: int = 1
    prob: float = 1.0
    fired: int = 0

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown injection point {self.point!r}; "
                             f"known points: {', '.join(POINTS)}")

    @property
    def drained(self) -> bool:
        return 0 < self.count <= self.fired


class FaultPlan:
    """A seeded, replayable schedule of :class:`Fault` triggers.

    The Engine calls :meth:`begin_step` once per step; injection sites call
    :meth:`fires` with their point name and whatever context they have
    (``rid=``, ``slot=`` ...).  Every firing is appended to :attr:`log` as
    ``(step, point, ctx)``.
    """

    def __init__(self, *faults: Fault, seed: int = 0):
        self.faults = list(faults)
        self.log: list[tuple[int, str, dict]] = []
        self._rng = np.random.default_rng(seed)
        self._step = -1   # begin_step(0) is the first engine step

    def begin_step(self, step: int) -> None:
        self._step = step

    def fires(self, point: str, **ctx) -> bool:
        """True (and one firing consumed) if an un-drained fault matches
        ``point`` and the step / rid filters.  At most one fault fires per
        call."""
        for f in self.faults:
            if f.point != point or f.drained:
                continue
            if f.step is not None and f.step != self._step:
                continue
            if self._step < f.after_step:
                continue
            if f.rid is not None and ctx.get("rid") != f.rid:
                continue
            if f.prob < 1.0 and self._rng.random() >= f.prob:
                continue
            f.fired += 1
            self.log.append((self._step, point, dict(ctx)))
            return True
        return False

    def fired(self, point: Optional[str] = None) -> int:
        """Total firings so far (optionally of one point)."""
        if point is None:
            return sum(f.fired for f in self.faults)
        return sum(f.fired for f in self.faults if f.point == point)

    @property
    def drained(self) -> bool:
        """True when every bounded fault has used up its count."""
        return all(f.drained for f in self.faults if f.count > 0)
