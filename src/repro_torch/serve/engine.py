"""Continuous-batching serving engine over the linear cache.

The engine owns a slot table of ``max_batch`` sequences sharing one cache
and a FIFO queue of pending requests.  Each ``step``

  1. admits: pops a FIFO run of pending requests whose prompts pad to the
     same bucket (``prefill_bucket`` multiples), prefills them in one
     batched whole-prompt call (end padding is exact for the causal trunk)
     and splices each row into its slot;
  2. decodes one token for every slot in one batched ``decode_step`` and
     samples greedily (ties go to the first index);
  3. retires a request at EOS, at ``max_new`` tokens, or when its slot is
     one token short of the cache capacity.

Scheduling state is host-side; each admission and each decode step reads
back only the sampled tokens.  Not ported yet, and refused with
``NotImplementedError``: sampling at a temperature, chunked admission, the
paged cache (and with it preemption and prefix sharing), and the failure
model (deadlines, NaN quarantine, backpressure).
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.serve.kv_cache import LinearCache


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    max_new: int = 64
    eos_token: int = -1          # -1: never terminates early
    prefill_bucket: int = 32     # prompt-length bucket granularity
    temperature: float = 0.0     # only greedy (0) is ported
    prefill_chunk: int = 0       # only whole-prompt admission (0) is ported
    paged: bool = False          # only the linear cache is ported


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"      # EOS / max_new / capacity


@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int32
    out_tokens: list = dataclasses.field(default_factory=list)
    status: RequestStatus = RequestStatus.QUEUED

    @property
    def done(self) -> bool:
        return self.status is RequestStatus.COMPLETED


def _next_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def tree_bytes(tree) -> int:
    """Bytes held by the tensors of a (nested dict) tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, QTensor):
        return tree.nbytes
    return tree.numel() * tree.element_size()


class Engine:
    def __init__(self, model, params: dict, cfg: ServeConfig):
        missing = [name for name, on in (
            ("sampling at a temperature", cfg.temperature > 0),
            ("chunked admission", cfg.prefill_chunk > 0),
            ("the paged cache", cfg.paged)) if on]
        if missing:
            raise NotImplementedError("not ported yet: " + ", ".join(missing))
        if cfg.max_new < 1:
            raise ValueError(f"max_new={cfg.max_new}: a request must be "
                             f"allowed at least one generated token")
        self.model = model
        self.params = params
        self.cfg = cfg
        self._kv = LinearCache(model, cfg.max_batch, cfg.max_len)
        self._pending: deque[Request] = deque()
        self._all: list[Request] = []
        self._slots: list[Optional[Request]] = [None] * cfg.max_batch
        self._seq_len = [0] * cfg.max_batch          # host-side cache lens
        self._next_rid = 0
        self._last_tok = torch.zeros((cfg.max_batch, 1), dtype=torch.int32,
                                     device=model.device)

    # ---- submission ------------------------------------------------------
    def submit(self, prompt) -> Request:
        """Queue a request.  Raises ValueError, before any state changes,
        for a prompt the engine can never serve (empty, or longer than the
        cache can hold with one generated token)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array; "
                             f"got shape {prompt.shape}")
        if prompt.size + 1 > self._kv.capacity:
            raise ValueError(f"prompt length {prompt.size} unservable: needs "
                             f"{prompt.size + 1} cache tokens but max_len is "
                             f"{self._kv.capacity} — raise --max-len")
        req = Request(rid=self._next_rid, prompt=prompt)
        self._next_rid += 1
        self._pending.append(req)
        self._all.append(req)
        return req

    def memory_report(self) -> dict:
        return {"weight_bytes": tree_bytes(self.params),
                "kv_bytes": tree_bytes(self._kv.cache)}

    # ---- admission: bucketed batch prefill ---------------------------------
    def _bucket(self, n: int) -> int:
        return min(_next_multiple(n, self.cfg.prefill_bucket),
                   self._kv.capacity)

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self._slots) if s is None]
        while free and self._pending:
            bucket = self._bucket(len(self._pending[0].prompt))
            group: list[Request] = []
            while (self._pending and len(group) < len(free)
                   and self._bucket(len(self._pending[0].prompt)) == bucket):
                group.append(self._pending.popleft())
            # requests the store cannot hold go back to the queue head
            fitted = 0
            while (fitted < len(group)
                   and self._kv.reserve(free[fitted], len(group[fitted].prompt))):
                fitted += 1
            self._pending.extendleft(reversed(group[fitted:]))
            group = group[:fitted]
            if not group:
                return
            slots, free = free[:len(group)], free[len(group):]
            tokens = np.zeros((len(group), bucket), np.int32)
            lengths = np.asarray([len(r.prompt) for r in group], np.int32)
            for row, req in enumerate(group):
                tokens[row, :len(req.prompt)] = req.prompt
            logits, cache1 = self.model.prefill(
                self.params, {"tokens": torch.from_numpy(tokens),
                              "lengths": torch.from_numpy(lengths)},
                max_len=bucket)
            toks = torch.argmax(logits[:, -1, :], dim=-1).tolist()
            for row, (slot, req) in enumerate(zip(slots, group)):
                self._kv.splice(slot, cache1, row, int(lengths[row]))
                self._slots[slot] = req
                self._seq_len[slot] = int(lengths[row])
                req.status = RequestStatus.RUNNING
                req.out_tokens.append(toks[row])
                self._last_tok[slot, 0] = toks[row]
                self._maybe_finish(slot, toks[row])
            # a request can retire straight from prefill: refill its slot
            free.extend(s for s in slots if self._slots[s] is None)

    # ---- the loop ------------------------------------------------------------
    def _maybe_finish(self, slot: int, tok: int) -> None:
        req = self._slots[slot]
        cache_full = self._seq_len[slot] >= self._kv.capacity - 1
        if (tok == self.cfg.eos_token
                or len(req.out_tokens) >= self.cfg.max_new or cache_full):
            self._slots[slot] = None
            self._seq_len[slot] = 0
            self._kv.free(slot)
            req.status = RequestStatus.COMPLETED

    def step(self) -> int:
        """Admit, then one batched decode step over every slot (idle slots
        compute a discarded token).  Returns the sequences advanced."""
        self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return 0
        logits, cache = self.model.decode_step(self.params, self._last_tok,
                                               self._kv.cache)
        self._kv.cache = cache
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        self._last_tok = nxt[:, None]
        host = nxt.tolist()
        for i in active:
            self._slots[i].out_tokens.append(host[i])
            self._seq_len[i] += 1
            self._maybe_finish(i, host[i])
        return len(active)

    def run(self, max_steps: int = 0) -> list[Request]:
        """Drain the queue; returns every submitted request in submission
        order.  ``max_steps > 0`` bounds the loop (raises past it)."""
        steps = 0
        while any(not r.done for r in self._all):
            n = self.step()
            steps += 1
            if max_steps and steps >= max_steps:
                raise RuntimeError(f"run() exceeded max_steps={max_steps}")
            if n == 0 and not self._pending:
                break
        return self._all
