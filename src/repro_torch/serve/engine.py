"""Continuous-batching serving engine over the linear or the paged cache.

The engine owns a slot table of ``max_batch`` sequences sharing one cache
and a FIFO queue of pending requests.  Each ``step``

  1. admits, in one of two ways:
     * whole-prompt: pops a FIFO run of pending requests whose prompts pad
       to the same bucket (``prefill_bucket`` multiples), prefills them in
       one batched call (end padding is exact for the causal trunk) and
       splices each row into its slot (into its pages when paged);
     * chunked (``prefill_chunk > 0``): assigns pending requests to free
       slots (FIFO) and feeds the oldest mid-prefill prompt through
       ``prefill_chunk`` in chunks of at most ``prefill_chunk`` tokens, one
       chunk per step, interleaved with decode;
     paged admission reserves each prompt's ``ceil(len / page_size)``
     pages up front, and a request that does not fit waits at the queue
     head;
  2. ensures capacity (paged): a sequence crossing a page boundary gets one
     page; when the pool is dry the engine preempts the sequence holding
     the most pages (mid-prefill ones included), frees them and requeues it
     at the head.  A request resumes by prefilling its prompt plus the
     tokens it generated, whose next-token logits continue its stream.  A
     request evicted more than ``max_preemptions`` times, or
     ``stall_preemptions`` times in a row without growing, ends
     ``FAILED_POOL``, as does a queued request the idle pool can never
     hold;
  3. decodes one token for every slot in one batched ``decode_step`` and
     samples greedily (ties go to the first index);
  4. retires a request at EOS, at ``max_new`` tokens, or when its slot is
     one token short of the cache capacity; its pages return to the pool.

Scheduling state is host-side; each admission and each decode step reads
back only the sampled tokens.  Not ported yet, and refused with
``NotImplementedError``: sampling at a temperature, prefix caching, and the
rest of the failure model (deadlines, NaN quarantine, backpressure, the
watchdog, fault injection).
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.serve.kv_cache import LinearCache, PagedCache


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    max_new: int = 64
    eos_token: int = -1          # -1: never terminates early
    prefill_bucket: int = 32     # prompt-length bucket granularity
    temperature: float = 0.0     # only greedy (0) is ported
    prefill_chunk: int = 0       # > 0: chunked admission, one chunk a step
    paged: bool = False          # page-table KV cache + admission control
    page_size: int = 64
    num_pages: int = 0           # 0 = max_batch * max_pages_per_seq
    max_pages_per_seq: int = 0   # 0 = ceil(max_len / page_size)
    prefix_cache: bool = False   # not ported yet
    max_preemptions: int = 64    # evictions per request before FAILED_POOL
    stall_preemptions: int = 16  # consecutive no-growth evictions before it


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"      # EOS / max_new / capacity
    FAILED_POOL = "failed_pool"  # the pool can or will never serve it

    @property
    def terminal(self) -> bool:
        return self not in (RequestStatus.QUEUED, RequestStatus.RUNNING)


@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int32
    out_tokens: list = dataclasses.field(default_factory=list)
    status: RequestStatus = RequestStatus.QUEUED
    error: Optional[str] = None  # the cause of a FAILED_* status
    preemptions: int = 0
    stalls: int = 0              # consecutive evictions without growth
    last_evict_len: int = -1     # resume_len at the previous eviction

    @property
    def done(self) -> bool:
        return self.status.terminal

    @property
    def resume_len(self) -> int:
        """Length of :meth:`resume_tokens` without building it."""
        return len(self.prompt) + len(self.out_tokens)

    def resume_tokens(self) -> np.ndarray:
        """The prompt to (re-)admit: the original prompt and every token
        generated so far."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.out_tokens, np.int32)])


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
            ("prefix caching", cfg.prefix_cache)) if on]
        if missing:
            raise NotImplementedError("not ported yet: " + ", ".join(missing))
        if cfg.max_new < 1:
            raise ValueError(f"max_new={cfg.max_new}: a request must be "
                             f"allowed at least one generated token")
        self.model = model
        self.params = params
        self.cfg = cfg
        if cfg.paged:
            self._kv = PagedCache(model, cfg.max_batch, cfg.max_len,
                                  cfg.page_size, num_pages=cfg.num_pages,
                                  max_pages_per_seq=cfg.max_pages_per_seq)
        else:
            self._kv = LinearCache(model, cfg.max_batch, cfg.max_len)
        self._pending: deque[Request] = deque()
        self._all: list[Request] = []
        self._slots: list[Optional[Request]] = [None] * cfg.max_batch
        self._seq_len = [0] * cfg.max_batch          # host-side cache lens
        # chunked admission: (request, resume tokens) of a slot mid-prefill
        self._prefill_prog: list[Optional[tuple]] = [None] * cfg.max_batch
        self._next_rid = 0
        self._last_tok = torch.zeros((cfg.max_batch, 1), dtype=torch.int32,
                                     device=model.device)

    # ---- submission ------------------------------------------------------
    def submit(self, prompt) -> Request:
        """Queue a request.  Raises ValueError, before any state changes,
        for a prompt the engine can never serve (empty, or longer than an
        idle cache can hold with one generated token)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array; "
                             f"got shape {prompt.shape}")
        if not self._kv.fits_idle(int(prompt.size) + 1):
            raise ValueError(f"prompt length {prompt.size} unservable: "
                             + self._kv.unservable_reason(int(prompt.size)
                                                          + 1))
        req = Request(rid=self._next_rid, prompt=prompt)
        self._next_rid += 1
        self._pending.append(req)
        self._all.append(req)
        return req

    def memory_report(self) -> dict:
        return {"weight_bytes": tree_bytes(self.params),
                "kv_bytes": self._kv.cache_bytes()}

    @property
    def preemptions(self) -> int:
        return sum(r.preemptions for r in self._all)

    # ---- termination ---------------------------------------------------------
    def _retire_slot(self, slot: int, status: RequestStatus,
                     error: Optional[str] = None) -> None:
        req = self._slots[slot]
        self._slots[slot] = None
        self._seq_len[slot] = 0
        self._prefill_prog[slot] = None
        self._kv.free(slot)
        req.status, req.error = status, error

    def _maybe_finish(self, slot: int, tok: int) -> None:
        req = self._slots[slot]
        cache_full = self._seq_len[slot] >= self._kv.capacity - 1
        if (tok == self.cfg.eos_token
                or len(req.out_tokens) >= self.cfg.max_new or cache_full):
            self._retire_slot(slot, RequestStatus.COMPLETED)

    def _shed_unservable(self) -> None:
        """Fail the queued requests whose resume can never fit an idle
        cache (grown past it through evictions): waiting cannot help."""
        kept: deque[Request] = deque()
        for req in self._pending:
            if self._kv.fits_idle(req.resume_len + 1):
                kept.append(req)
            else:
                req.status = RequestStatus.FAILED_POOL
                req.error = (f"resume length {req.resume_len} unservable: "
                             + self._kv.unservable_reason(req.resume_len + 1))
        self._pending = kept

    # ---- admission: bucketed batch prefill ---------------------------------
    def _bucket(self, n: int) -> int:
        return min(_next_multiple(n, self.cfg.prefill_bucket),
                   self._kv.capacity)

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _start(self, slot: int, tok: int) -> None:
        """A slot's first sampled token: record it and hand it to decode."""
        req = self._slots[slot]
        req.out_tokens.append(tok)
        self._last_tok[slot, 0] = tok
        self._maybe_finish(slot, tok)

    def _admit(self) -> None:
        self._shed_unservable()
        free = self._free_slots()
        while free and self._pending:
            bucket = self._bucket(self._pending[0].resume_len)
            group: list[Request] = []
            while (self._pending and len(group) < len(free)
                   and self._bucket(self._pending[0].resume_len) == bucket):
                group.append(self._pending.popleft())
            # requests the store cannot hold go back to the queue head
            fitted = 0
            while (fitted < len(group)
                   and self._kv.reserve(free[fitted],
                                        group[fitted].resume_len)):
                fitted += 1
            self._pending.extendleft(reversed(group[fitted:]))
            group = group[:fitted]
            if not group:
                return
            slots, free = free[:len(group)], free[len(group):]
            tokens = np.zeros((len(group), bucket), np.int32)
            lengths = np.asarray([r.resume_len for r in group], np.int32)
            for row, req in enumerate(group):
                tokens[row, :req.resume_len] = req.resume_tokens()
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
                self._start(slot, toks[row])
            # a request can retire straight from prefill: refill its slot
            free.extend(s for s in slots if self._slots[s] is None)

    # ---- admission: chunked ------------------------------------------------
    def _admit_chunked(self) -> None:
        """Assign pending requests to free slots (FIFO), reserving their
        pages up front; the prefill itself runs in :meth:`_advance_prefill`,
        one chunk per step."""
        self._shed_unservable()
        for slot in self._free_slots():
            if not self._pending:
                return
            req = self._pending[0]
            if not self._kv.reserve(slot, req.resume_len):
                return                   # pool dry: wait for completions
            self._pending.popleft()
            self._slots[slot] = req
            self._seq_len[slot] = 0
            req.status = RequestStatus.RUNNING
            self._prefill_prog[slot] = (req, req.resume_tokens())

    def _advance_prefill(self) -> bool:
        """Advance the oldest mid-prefill slot by one chunk of up to
        ``prefill_chunk`` tokens; on its final chunk, sample the first
        token from the last valid row and hand the slot to decode."""
        slots = [i for i, p in enumerate(self._prefill_prog) if p is not None]
        if not slots:
            return False
        slot = min(slots, key=lambda i: self._prefill_prog[i][0].rid)
        req, toks = self._prefill_prog[slot]
        done = self._seq_len[slot]
        c = self.cfg.prefill_chunk
        n = min(c, len(toks) - done)
        tokens = np.zeros((self.cfg.max_batch, c), np.int32)
        tokens[slot, :n] = toks[done:done + n]
        chunk_len = np.zeros((self.cfg.max_batch,), np.int32)
        chunk_len[slot] = n
        # every row passes its host-known length: rows with chunk_len 0
        # neither write nor attend, and the call resets their device len
        # (a decode step writes a droppable token ahead of a mid-prefill
        # slot, which the next chunk overwrites before it is attended)
        offsets = np.asarray(self._seq_len, np.int32)
        logits, self._kv.cache = self.model.prefill_chunk(
            self.params, {"tokens": torch.from_numpy(tokens),
                          "chunk_len": torch.from_numpy(chunk_len)},
            self._kv.cache, torch.from_numpy(offsets), last_only=True)
        self._seq_len[slot] = done + n
        if done + n < len(toks):
            return True
        self._prefill_prog[slot] = None
        self._start(slot, int(torch.argmax(logits[slot, -1]).item()))
        return True

    # ---- preemption ----------------------------------------------------------
    def _preempt(self, slot: int) -> None:
        """Evict a slot and requeue it at the head, unless it is storming
        (more than ``max_preemptions`` evictions, or ``stall_preemptions``
        in a row without growing): then it ends FAILED_POOL."""
        req = self._slots[slot]
        grew = req.resume_len > req.last_evict_len
        req.stalls = 0 if grew else req.stalls + 1
        req.last_evict_len = req.resume_len
        req.preemptions += 1
        if (req.preemptions > self.cfg.max_preemptions
                or req.stalls >= self.cfg.stall_preemptions):
            self._retire_slot(
                slot, RequestStatus.FAILED_POOL,
                error=f"preemption storm: evicted {req.preemptions}x "
                      f"({req.stalls} consecutive without progress) — the "
                      f"pool is too small for the working set")
            return
        self._retire_slot(slot, RequestStatus.QUEUED)
        self._pending.appendleft(req)    # resumes first when pages free up

    def _ensure_capacity(self, active: list[int]) -> list[int]:
        """Back every active slot's next token write by a page; when the
        pool is dry, evict the slot whose eviction frees the most pages
        (then the longest, then the lowest index)."""
        for slot in active:
            if self._slots[slot] is None:
                continue
            while not self._kv.ensure_append(slot, self._seq_len[slot]):
                live = [i for i, s in enumerate(self._slots) if s is not None]
                victim = max(live, key=lambda i: (
                    self._kv.reclaimable_pages(i), self._seq_len[i], -i))
                self._preempt(victim)
                if victim == slot:
                    break
        return [i for i in active if self._slots[i] is not None]

    # ---- the loop ------------------------------------------------------------
    def step(self) -> int:
        """Admit (or advance one prefill chunk), ensure pages, then one
        batched decode step over every slot (idle and mid-prefill slots
        compute a discarded token).  Returns the sequences advanced, plus
        one for a prefill chunk."""
        if self.cfg.prefill_chunk:
            self._admit_chunked()
            did_chunk = self._advance_prefill()
        else:
            self._admit()
            did_chunk = False
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and self._prefill_prog[i] is None]
        if self.cfg.paged:
            active = self._ensure_capacity(active)
        if not active:
            return int(did_chunk)
        logits, self._kv.cache = self.model.decode_step(
            self.params, self._last_tok, self._kv.cache)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        self._last_tok = nxt[:, None]
        host = nxt.tolist()
        for i in active:
            self._slots[i].out_tokens.append(host[i])
            self._seq_len[i] += 1
            self._maybe_finish(i, host[i])
        return len(active) + int(did_chunk)

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
