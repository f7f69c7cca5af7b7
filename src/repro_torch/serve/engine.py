"""Continuous-batching serving engine over the linear or the paged cache.

It serves the float :class:`~repro_torch.models.model.Model` and the packed
:class:`~repro_torch.serve.quantized.QuantizedModel` alike: both expose
``device``, ``init_cache`` / ``init_paged_cache`` / ``prefill`` /
``prefill_chunk`` / ``decode_step`` over the same cache layouts, so the
engine never asks which it holds.

The engine owns a slot table of ``max_batch`` sequences sharing one cache
and a FIFO queue of pending requests.  Each ``step``

  1. retires requests whose deadline passed (queued or slotted);
  2. admits, in one of two ways:
     * whole-prompt: pops a FIFO run of pending requests whose prompts pad
       to the same bucket (``prefill_bucket`` multiples), prefills them in
       one batched call (end padding is exact for the causal trunk) and
       splices each row into its slot (into its pages when paged); a
       model without ``supports_padded_prefill`` (the recurrent families)
       groups prompts of one exact length and prefills them without
       ``lengths``;
     * chunked (``prefill_chunk > 0``, a model with
       ``supports_chunked_prefill``): assigns pending requests to free
       slots (FIFO) and feeds the oldest mid-prefill prompt through
       ``prefill_chunk`` in chunks of at most ``prefill_chunk`` tokens, one
       chunk per step, interleaved with decode;
     paged admission reserves each prompt's ``ceil(len / page_size)``
     pages up front, and a request that does not fit waits at the queue
     head;
  3. ensures capacity (paged): a sequence crossing a page boundary gets one
     page; when the pool is dry the engine preempts the sequence whose
     eviction frees the most pages (mid-prefill ones included), frees them
     and requeues it at the head.  A request resumes by prefilling its
     prompt plus the tokens it generated, whose next-token logits continue
     its stream;
  4. decodes one token for every slot in one batched ``decode_step`` and
     samples: greedy (``argmax``, ties to the first index) at
     ``temperature == 0``, else temperature / top-k sampling from a
     ``torch.Generator`` seeded by (``seed``, rid, tokens generated so far),
     so a sampled stream depends neither on slot placement, nor on batch
     composition, nor on preemption;
  5. retires a request at EOS, at ``max_new`` tokens, or when its slot is
     one token short of the cache capacity; its pages return to the pool.

Scheduling state is host-side.  Each decode step, and each admission's
final prefill, reads back one tensor: the sampled tokens with a per-row
finiteness flag of the final logits beside them.

Failure model: every request ends in exactly one terminal
:class:`RequestStatus`, reported through ``on_done``.  A row whose logits
are not finite is quarantined alone (``FAILED_NAN``: its exclusive pages
zeroed, then freed), so the other rows stream on unchanged.  Pool pressure
degrades instead of livelocking: a queued request whose resume can never
fit the idle pool ends ``FAILED_POOL``, so does one evicted more than
``max_preemptions`` times (or ``stall_preemptions`` times in a row without
growing), and a no-progress watchdog (``watchdog_steps``) fails the
largest page owner when the whole engine stops moving.  ``max_queue``
bounds the pending deque (``submit`` raises :class:`QueueFull`); deadlines
(``ttl_s``) are wall-clock, checked host-side at step boundaries;
``cancel(rid)`` reclaims a request's pages wherever it is.  A raising
``on_token`` fails its own request (``FAILED_CALLBACK``); a raising
``on_done`` is logged and detached.  A :class:`~repro_torch.serve.faults.
FaultPlan` drives each of these paths deterministically.

Prefix caching (``prefix_cache``, paged and chunked): admission passes the
resume tokens to ``reserve``, which adopts the longest resident full-page
prefix (refcounted shares) and reports the matched token count; prefill
starts there.  A ``FAILED_NAN`` retirement fails the co-readers of the
slot's shared pages too, rather than let them attend to suspect K/V.
``prefix_stats`` counts lookups, hits, matched and prefilled tokens.

Mesh-native serving (``mesh``, a (data, model) ``DeviceMesh`` from
:func:`repro_torch.launch.mesh.make_serving_mesh`; one Engine per rank):
the weights and the cache are cut once, at construction, to this rank's
shards under ``rules`` (default :func:`repro_torch.sharding.
make_serving_rules`): QTensor linears column-parallel over "model" with
codes, scale and zero points cut alike, ``wo`` / ``w_down`` whole, the
vocabulary split, the cache over its KV heads (a linear cache's batch
over "data"); an MoE block's experts over "model", mamba2's SSD heads and
griffin's rnn channels over "model" with their states (mamba2's
concatenated leaves cut component by component, its ``param_cuts`` /
``cache_cuts``).  The model runs them through its ``tp``
(:class:`~repro_torch.serve.tensor_parallel.TensorParallel`).  The
scheduler is unchanged and runs the same on every rank: page tables,
lens, last tokens, sampling seeds and fault probes are replicated host
state, and every rank samples the same logits, so admission, eviction,
preemption, quarantine and prefix sharing decide the same everywhere and
the streams equal the unsharded engine's wherever every rank's shard of a
product is the same bits as that part of the whole (the packed dense and
MoE trunks on the CPU); a row-split float product summed over "model",
or a card's ``torch.bmm`` over fewer experts, holds them to logits.
"""
from __future__ import annotations

import dataclasses
import enum
import logging
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.serve import faults as flt
from repro_torch.serve.kv_cache import LinearCache, PagedCache
from repro_torch.serve.tensor_parallel import TensorParallel
from repro_torch.sharding import (make_serving_rules, shard_tree,
                                  tree_shardings)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    max_new: int = 64
    eos_token: int = -1          # -1: never terminates early
    temperature: float = 0.0     # 0 = greedy
    top_k: int = 0               # 0 = full categorical (when sampling)
    seed: int = 0                # sampling seed
    prefill_bucket: int = 32     # prompt-length bucket granularity
    prefill_chunk: int = 0       # > 0: chunked admission, one chunk a step
    paged: bool = False          # page-table KV cache + admission control
    page_size: int = 64
    num_pages: int = 0           # 0 = max_batch * max_pages_per_seq
    max_pages_per_seq: int = 0   # 0 = ceil(max_len / page_size)
    prefix_cache: bool = False   # refcounted prefix-page sharing; needs
    #                              paged=True and prefill_chunk > 0
    max_queue: int = 0           # > 0: bound the pending deque (QueueFull)
    default_ttl_s: float = 0.0   # > 0: TTL of a submit without ttl_s
    max_preemptions: int = 64    # evictions per request before FAILED_POOL
    stall_preemptions: int = 16  # consecutive no-growth evictions before it
    watchdog_steps: int = 16     # no-progress steps before degrading
    integrity_checks: bool = False   # check the device page table on free


class RequestStatus(enum.Enum):
    """Lifecycle of a request; exactly one terminal state per request."""
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"                      # EOS / max_new / capacity
    FAILED_NAN = "failed_nan"                    # non-finite logits
    FAILED_DEADLINE = "failed_deadline"          # wall-clock TTL expired
    FAILED_POOL = "failed_pool"                  # pool can/will never serve
    FAILED_CALLBACK = "failed_callback"          # on_token raised
    REJECTED_QUEUE_FULL = "rejected_queue_full"  # backpressure at submit
    CANCELLED = "cancelled"                      # cancel(rid)

    @property
    def terminal(self) -> bool:
        return self not in (RequestStatus.QUEUED, RequestStatus.RUNNING)


class QueueFull(RuntimeError):
    """``submit`` backpressure: the queue holds ``max_queue`` requests.
    ``.request`` is the rejected request (``REJECTED_QUEUE_FULL``)."""

    def __init__(self, msg: str, request: "Request" = None):
        super().__init__(msg)
        self.request = request


@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int32
    out_tokens: list = dataclasses.field(default_factory=list)
    status: RequestStatus = RequestStatus.QUEUED
    error: Optional[str] = None  # the cause of a FAILED_* status
    deadline: Optional[float] = None   # absolute time.monotonic() TTL
    preemptions: int = 0
    stalls: int = 0              # consecutive evictions without growth
    last_evict_len: int = -1     # resume_len at the previous eviction
    on_token: Optional[Callable[["Request", int], None]] = None
    on_done: Optional[Callable[["Request"], None]] = None

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
    """Bytes held by the tensors of a nested dict / list tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, QTensor):
        return tree.nbytes
    return tree.numel() * tree.element_size()


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sampling_logits(lg: torch.Tensor, temperature: float,
                    top_k: int) -> torch.Tensor:
    """The logits a sample is drawn from: float32 ``lg`` (N, V) over the
    temperature, every logit strictly below the row's ``top_k``-th largest
    set to ``-inf`` (ties at the k-th stay), as the reference masks."""
    lg = lg.to(torch.float32) / temperature
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    return lg


def row_seed(seed: int, rid: int, position: int) -> int:
    """The 64-bit generator seed of request ``rid``'s token ``position``."""
    return int(np.random.SeedSequence([seed, rid, position])
               .generate_state(1, np.uint64)[0])


def sample(lg: torch.Tensor, temperature: float, top_k: int,
           seeds: list) -> torch.Tensor:
    """lg (N, V) -> (N,) int64 tokens.  Greedy at ``temperature <= 0``
    (ties to the first index).  Else each row with a seed draws from
    ``softmax(sampling_logits)`` by the Gumbel-max rule, its exponential
    noise taken from a ``torch.Generator`` on ``lg``'s device seeded with
    it alone, so the draw depends on the row's logits and seed and on
    nothing else in the batch; rows whose seed is None (idle slots) take
    the argmax of their sampling logits."""
    if temperature <= 0:
        return torch.argmax(lg, dim=-1)
    lg = sampling_logits(lg, temperature, top_k)
    expo = torch.ones_like(lg)
    for row, s in enumerate(seeds):
        if s is not None:
            gen = torch.Generator(device=lg.device)
            gen.manual_seed(s)
            expo[row].exponential_(generator=gen)
    # argmax(lg - log E) with E ~ Exp(1) draws from softmax(lg); masked
    # (-inf) logits stay -inf even where log E is -inf
    score = torch.where(lg == float("-inf"), lg, lg - expo.log())
    return torch.argmax(score, dim=-1)


class Engine:
    def __init__(self, model, params: dict, cfg: ServeConfig,
                 faults: Optional[flt.FaultPlan] = None, *, mesh=None,
                 rules: Optional[dict] = None):
        if cfg.max_new < 1:
            raise ValueError(f"max_new={cfg.max_new}: a request must be "
                             f"allowed at least one generated token")
        if cfg.max_queue < 0:
            raise ValueError(f"max_queue={cfg.max_queue} unsupported: use 0 "
                             f"(unbounded) or a positive queue bound")
        if cfg.prefix_cache and not (cfg.paged and cfg.prefill_chunk > 0):
            raise ValueError(
                "prefix_cache=True needs paged=True and prefill_chunk > 0: "
                "prefix reuse shares whole pool pages and resumes chunked "
                "prefill at the first novel token")
        if cfg.prefill_chunk and not getattr(model, "supports_chunked_prefill",
                                             False):
            raise ValueError(
                f"chunked admission (prefill_chunk={cfg.prefill_chunk}) "
                f"needs model.prefill_chunk; {type(model).__name__} does "
                f"not support it")
        self.cfg = cfg
        self._faults = faults
        # end-padded prompts are exact only for the causal trunk: the
        # recurrent families prefill at exact lengths, without ``lengths``
        self._supports_padded = bool(getattr(model, "supports_padded_prefill",
                                             False))
        if cfg.paged:
            self._kv = PagedCache(model, cfg.max_batch, cfg.max_len,
                                  cfg.page_size, num_pages=cfg.num_pages,
                                  max_pages_per_seq=cfg.max_pages_per_seq,
                                  faults=faults,
                                  integrity_checks=cfg.integrity_checks,
                                  prefix_cache=cfg.prefix_cache)
        else:
            self._kv = LinearCache(model, cfg.max_batch, cfg.max_len)
        self.mesh = mesh
        self.rules = None
        if mesh is not None:
            self.rules = (dict(rules) if rules is not None
                          else make_serving_rules())
            model, params = self._place(model, params)
        self.model = model
        self.params = params
        self._pending: deque[Request] = deque()
        self._all: list[Request] = []
        self._slots: list[Optional[Request]] = [None] * cfg.max_batch
        self._seq_len = [0] * cfg.max_batch          # host-side cache lens
        # chunked admission: (request, resume tokens) of a slot mid-prefill
        self._prefill_prog: list[Optional[tuple]] = [None] * cfg.max_batch
        self._next_rid = 0
        self._last_tok = torch.zeros((cfg.max_batch, 1), dtype=torch.int32,
                                     device=model.device)
        self._step_idx = 0
        self._watchdog = 0       # consecutive steps without progress
        self._progress = 0       # tokens streamed + chunks + retirements
        self.prefix_stats = {"lookups": 0, "hits": 0,
                             "matched_tokens": 0, "prefilled_tokens": 0}

    def _place(self, model, params: dict) -> tuple:
        """Shard once, at rest: the store's cache through
        ``cache_logical_axes``, which decides the split (attention heads
        from the KV entries, the recurrent width from the ``ssm`` / ``rnn``
        states, rows from ``len``), then the weights through
        ``model.param_logical_axes()`` (moved to the model's device as they
        are cut, so a whole tree on the CPU never reaches the card), with a
        model's component cuts (mamba2's concatenated leaves); returns the
        model bound to this rank (``tp``) and its shards."""
        mesh, rules = self.mesh, self.rules
        cache = self._kv.cache
        cspecs = tree_shardings(model.cache_logical_axes(cache), cache, mesh,
                                rules)

        def axis(spec, dim: int):
            spec = tuple(spec) + (None,) * (dim + 1 - len(spec))
            return spec[dim]

        if self.cfg.paged:
            heads, rec, lens = axis(cspecs.k, 3) == "model", False, None
        else:
            heads = "k" in cspecs and axis(cspecs["k"], 3) == "model"
            state = cspecs.get("ssm", cspecs.get("rnn"))
            rec = state is not None and axis(state, 2) == "model"
            lens = axis(cspecs["len"], 0)
        batch = rules.get("batch")
        tp = TensorParallel(mesh, model.cfg, heads=heads, rec=rec,
                            batch="data" in ((batch,) if isinstance(batch, str)
                                             else tuple(batch or ())))
        local = shard_tree(cache, cspecs, mesh, cuts=model.cache_cuts(tp))
        rows = None if self.cfg.paged else tp.rows(self.cfg.max_batch)
        if not self.cfg.paged and (rows is not None) != (lens == "data"
                                                         and tp.d > 1):
            raise ValueError(f"the linear cache's batch spec {lens!r} "
                             f"disagrees with the step's row split {rows}")
        if rows is not None:
            self._kv.hold_rows(local, rows)
        else:
            self._kv.cache = local
        specs = tree_shardings(model.param_logical_axes(), params, mesh, rules)
        params = shard_tree(params, specs, mesh, device=model.device,
                            cuts=model.param_cuts(tp))
        return dataclasses.replace(model, tp=tp), params

    # ---- submission / cancellation ---------------------------------------
    def submit(self, prompt, on_token=None, on_done=None,
               ttl_s: Optional[float] = None) -> Request:
        """Queue a request.  Raises ValueError, before any state changes,
        for a prompt the engine can never serve (empty, or longer than an
        idle cache can hold with one generated token), and
        :class:`QueueFull` past ``max_queue``.  ``ttl_s`` overrides
        ``default_ttl_s`` (0 = no deadline)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array; "
                             f"got shape {prompt.shape}")
        if not self._kv.fits_idle(int(prompt.size) + 1):
            raise ValueError(f"prompt length {prompt.size} unservable: "
                             + self._kv.unservable_reason(int(prompt.size)
                                                          + 1))
        req = Request(rid=self._next_rid, prompt=prompt, on_token=on_token,
                      on_done=on_done)
        self._next_rid += 1
        ttl = self.cfg.default_ttl_s if ttl_s is None else ttl_s
        if ttl and ttl > 0:
            req.deadline = time.monotonic() + ttl
        if self.cfg.max_queue and len(self._pending) >= self.cfg.max_queue:
            self._all.append(req)
            self._finish_request(
                req, RequestStatus.REJECTED_QUEUE_FULL,
                error=f"admission queue full ({self.cfg.max_queue} "
                      f"pending): backpressure — retry later")
            raise QueueFull(req.error, request=req)
        self._pending.append(req)
        self._all.append(req)
        return req

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it is (queued, mid-prefill or
        decoding), reclaiming its pages.  False if ``rid`` is unknown or
        already terminal."""
        for req in self._pending:
            if req.rid == rid:
                self._pending.remove(req)
                self._finish_request(req, RequestStatus.CANCELLED)
                return True
        for slot, req in enumerate(self._slots):
            if req is not None and req.rid == rid:
                self._retire_slot(slot, RequestStatus.CANCELLED)
                return True
        return False

    def status_counts(self) -> dict:
        """Status histogram over every request this engine saw."""
        counts: dict = {}
        for r in self._all:
            counts[r.status.name] = counts.get(r.status.name, 0) + 1
        return counts

    def memory_report(self) -> dict:
        """This rank's resident weight and KV bytes, and the number of
        ranks that hold the model (1 without a mesh)."""
        tp = self.model.tp
        return {"device_count": 1 if tp is None else tp.size,
                "weight_bytes": tree_bytes(self.params),
                "kv_bytes": self._kv.cache_bytes()}

    @property
    def preemptions(self) -> int:
        return sum(r.preemptions for r in self._all)

    # ---- termination (the only places a request goes terminal) -----------
    def _finish_request(self, req: Request, status: RequestStatus,
                        error: Optional[str] = None) -> None:
        req.status, req.error = status, error
        if error is not None:
            logger.debug("rid=%d -> %s: %s", req.rid, status.name, error)
        self._progress += 1
        self._dispatch_done(req)

    def _free_slot(self, slot: int) -> Request:
        """Clear a slot's scheduling state and return its pages."""
        req = self._slots[slot]
        self._slots[slot] = None
        self._seq_len[slot] = 0
        self._prefill_prog[slot] = None
        self._kv.free(slot)
        return req

    def _retire_slot(self, slot: int, status: RequestStatus,
                     error: Optional[str] = None) -> None:
        """Terminal path of an occupied slot: quarantine (FAILED_NAN), free,
        then fire on_done.  A FAILED_NAN slot's exclusive pages are zeroed
        before the free list recycles them; its shared pages cannot be (other
        readers attend to them), so ``quarantine`` unmaps them and names the
        co-readers, and each is failed FAILED_NAN in turn (recursively)."""
        co_readers: list[int] = []
        if status is RequestStatus.FAILED_NAN:
            co_readers = self._kv.quarantine(slot)
        req = self._free_slot(slot)
        self._finish_request(req, status, error)
        for other in co_readers:
            if self._slots[other] is not None:
                self._retire_slot(
                    other, RequestStatus.FAILED_NAN,
                    error=f"shared prefix page(s) poisoned by rid="
                          f"{req.rid} (FAILED_NAN quarantine)")

    def _dispatch_token(self, req: Request, tok: int) -> bool:
        """Record and stream one token; False when the callback raised (or
        a CALLBACK_RAISE fault fired): the request then fails."""
        req.out_tokens.append(tok)
        self._progress += 1
        if self._faults is not None and self._faults.fires(
                flt.CALLBACK_RAISE, rid=req.rid):
            return False
        if req.on_token is None:
            return True
        try:
            req.on_token(req, tok)
            return True
        except Exception:
            logger.exception("on_token callback for rid=%d raised — "
                             "failing the request", req.rid)
            return False

    def _dispatch_done(self, req: Request) -> None:
        """Fire on_done exactly once; a raising callback is logged and
        detached (the request is already terminal)."""
        cb, req.on_done = req.on_done, None
        if cb is None:
            return
        try:
            cb(req)
        except Exception:
            logger.exception("on_done callback for rid=%d raised — "
                             "detached (request already terminal)", req.rid)

    # ---- deadlines and fail-fast admission -------------------------------
    def _expired(self, req: Request, now: float) -> bool:
        if req.deadline is not None and now > req.deadline:
            return True
        return (self._faults is not None
                and self._faults.fires(flt.DEADLINE, rid=req.rid))

    def _check_deadlines(self) -> None:
        """Retire TTL-expired requests (queued or slotted) at the step
        boundary: host clock, no device work."""
        now = time.monotonic()
        for slot, req in enumerate(self._slots):
            if req is not None and self._expired(req, now):
                self._retire_slot(slot, RequestStatus.FAILED_DEADLINE,
                                  error=f"deadline exceeded after "
                                        f"{len(req.out_tokens)} tokens")
        if not self._pending:
            return
        kept: deque[Request] = deque()
        while self._pending:
            req = self._pending.popleft()
            if self._expired(req, now):
                self._finish_request(req, RequestStatus.FAILED_DEADLINE,
                                     error="deadline exceeded while queued")
            else:
                kept.append(req)
        self._pending = kept

    def _shed_unservable(self) -> None:
        """Fail the queued requests whose resume can never fit an idle
        cache (grown past it through evictions): waiting cannot help."""
        kept: deque[Request] = deque()
        while self._pending:
            req = self._pending.popleft()
            if self._kv.fits_idle(req.resume_len + 1):
                kept.append(req)
            else:
                self._finish_request(
                    req, RequestStatus.FAILED_POOL,
                    error=f"resume length {req.resume_len} unservable: "
                          + self._kv.unservable_reason(req.resume_len + 1))
        self._pending = kept

    # ---- sampling ---------------------------------------------------------
    def _seeds(self, reqs: list) -> list:
        """Per-row generator seeds (None for idle rows, and for every row
        when greedy): (seed, rid, tokens generated so far)."""
        if self.cfg.temperature <= 0:
            return [None] * len(reqs)
        return [None if r is None
                else row_seed(self.cfg.seed, r.rid, len(r.out_tokens))
                for r in reqs]

    def _sample_rows(self, lg: torch.Tensor, reqs: list,
                     poison: Optional[list] = None):
        """Sample each row of the final logits ``lg`` (N, V) and flag
        whether it is finite, in ONE device-to-host transfer.  Returns
        (``[(token, finite), ...]``, the tokens on the device).  ``poison``
        (N floats, NAN_LOGITS) is added to the logits first."""
        if poison is not None:
            lg = lg + torch.tensor(poison, dtype=lg.dtype,
                                   device=lg.device)[:, None]
        tok = sample(lg, self.cfg.temperature, self.cfg.top_k,
                     self._seeds(reqs))
        ok = torch.isfinite(lg).all(dim=-1)
        host = torch.stack((tok, ok.to(tok.dtype))).tolist()
        return [(t, bool(f)) for t, f in zip(*host)], tok

    def _poison(self, n: int, rows: list) -> Optional[list]:
        """The NAN_LOGITS vector of an ``n``-row batch, or None when no
        fault fires: ``rows`` holds (row, probe context) pairs."""
        if self._faults is None:
            return None
        vec = None
        for row, ctx in rows:
            if self._faults.fires(flt.NAN_LOGITS, **ctx):
                if vec is None:
                    vec = [0.0] * n
                vec[row] = float("nan")
        return vec

    # ---- admission: bucketed batch prefill --------------------------------
    def _bucket(self, n: int) -> int:
        """The prompt's padded length: a ``prefill_bucket`` multiple, or
        ``n`` itself for a model that cannot take end padding."""
        if not self._supports_padded:
            return n
        return min(_next_multiple(n, self.cfg.prefill_bucket),
                   self._kv.capacity)

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _start(self, slot: int, tok: int) -> None:
        """A slot's first sampled token: stream it and hand it to decode."""
        req = self._slots[slot]
        if not self._dispatch_token(req, tok):
            self._retire_slot(slot, RequestStatus.FAILED_CALLBACK,
                              error="on_token callback raised")
            return
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
                # pool (transiently) dry: wait for completions; a queue
                # that can never drain trips the watchdog
                return
            slots, free = free[:len(group)], free[len(group):]
            tokens = np.zeros((len(group), bucket), np.int32)
            lengths = np.asarray([r.resume_len for r in group], np.int32)
            for row, req in enumerate(group):
                tokens[row, :req.resume_len] = req.resume_tokens()
            batch = {"tokens": torch.from_numpy(tokens)}
            if self._supports_padded:
                batch["lengths"] = torch.from_numpy(lengths)
            logits, cache1 = self.model.prefill(self.params, batch,
                                                max_len=bucket)
            poison = self._poison(len(group), [
                (row, {"rid": req.rid}) for row, req in enumerate(group)])
            drawn, _ = self._sample_rows(logits[:, -1, :], group, poison)
            for row, (slot, req) in enumerate(zip(slots, group)):
                self._kv.splice(slot, cache1, row, int(lengths[row]))
                self._slots[slot] = req
                self._seq_len[slot] = int(lengths[row])
                req.status = RequestStatus.RUNNING
                tok, finite = drawn[row]
                if not finite:
                    self._retire_slot(slot, RequestStatus.FAILED_NAN,
                                      error="non-finite logits at prefill")
                    continue
                self._start(slot, tok)
            # a request can retire straight from prefill: refill its slot
            free.extend(s for s in slots if self._slots[s] is None)

    # ---- admission: chunked -----------------------------------------------
    def _admit_chunked(self) -> None:
        """Assign pending requests to free slots (FIFO), reserving their
        pages up front (adopting a resident prefix when ``prefix_cache``);
        the prefill itself runs in :meth:`_advance_prefill`, one chunk per
        step, from the matched length on."""
        self._shed_unservable()
        for slot in self._free_slots():
            if not self._pending:
                return
            req = self._pending[0]
            toks = req.resume_tokens()
            if not self._kv.reserve(slot, req.resume_len, tokens=toks):
                return                   # pool dry: wait for completions
            self._pending.popleft()
            self._slots[slot] = req
            # matched is a page multiple, so the slot's writes only ever
            # touch its own fresh pages
            matched = self._kv.matched_tokens(slot)
            self._seq_len[slot] = matched
            req.status = RequestStatus.RUNNING
            self._prefill_prog[slot] = (req, toks)
            if self.cfg.prefix_cache:
                st = self.prefix_stats
                st["lookups"] += 1
                st["hits"] += int(matched > 0)
                st["matched_tokens"] += matched

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
        self._progress += 1
        self.prefix_stats["prefilled_tokens"] += n
        if done + n < len(toks):
            return True
        self._prefill_prog[slot] = None
        poison = self._poison(1, [(0, {"rid": req.rid, "slot": slot})])
        ((tok, finite),), _ = self._sample_rows(logits[slot], [req], poison)
        if not finite:
            self._retire_slot(slot, RequestStatus.FAILED_NAN,
                              error="non-finite logits at prefill")
            return True
        # finite final logits certify every attended K/V row finite: only
        # now may the sequence's full pages enter the prefix map
        self._kv.register_prefix(slot, toks)
        self._start(slot, tok)
        return True

    # ---- preemption --------------------------------------------------------
    def _preempt(self, slot: int) -> None:
        """Evict a slot and requeue it at the head, unless it is storming
        (more than ``max_preemptions`` evictions, or ``stall_preemptions``
        in a row without growing): then it ends FAILED_POOL.  The slot is
        freed directly, never through :meth:`_retire_slot`: an eviction is
        not an end (no on_done) and never quarantines."""
        req = self._slots[slot]
        grew = req.resume_len > req.last_evict_len
        req.stalls = 0 if grew else req.stalls + 1
        req.last_evict_len = req.resume_len
        req.preemptions += 1
        self._free_slot(slot)
        if (req.preemptions > self.cfg.max_preemptions
                or req.stalls >= self.cfg.stall_preemptions):
            self._finish_request(
                req, RequestStatus.FAILED_POOL,
                error=f"preemption storm: evicted {req.preemptions}x "
                      f"({req.stalls} consecutive without progress) — the "
                      f"pool is too small for the working set")
            return
        req.status = RequestStatus.QUEUED
        self._pending.appendleft(req)    # resumes first when pages free up

    def _victim(self, live: list[int]) -> int:
        """The slot whose eviction frees the most pages (shared pages stay
        live for their other readers), then the longest, then the lowest
        index."""
        return max(live, key=lambda i: (self._kv.reclaimable_pages(i),
                                        self._seq_len[i], -i))

    def _ensure_capacity(self, active: list[int]) -> list[int]:
        """Back every active slot's next token write by a page, evicting
        :meth:`_victim` while the pool is dry."""
        for slot in active:
            if self._slots[slot] is None:
                continue
            while not self._kv.ensure_append(slot, self._seq_len[slot]):
                victim = self._victim(
                    [i for i, s in enumerate(self._slots) if s is not None])
                self._preempt(victim)
                if victim == slot:
                    break
        return [i for i in active if self._slots[i] is not None]

    # ---- the loop ------------------------------------------------------------
    def _maybe_finish(self, slot: int, tok: int) -> None:
        req = self._slots[slot]
        cache_full = self._seq_len[slot] >= self._kv.capacity - 1
        if (tok == self.cfg.eos_token
                or len(req.out_tokens) >= self.cfg.max_new or cache_full):
            self._retire_slot(slot, RequestStatus.COMPLETED)

    def _degrade(self) -> None:
        """Watchdog action after ``watchdog_steps`` steps without progress:
        fail ONE request with FAILED_POOL (the largest page owner, or the
        queue head when no slot is live) so the rest can move."""
        live = [i for i, s in enumerate(self._slots) if s is not None]
        if live:
            self._retire_slot(
                self._victim(live), RequestStatus.FAILED_POOL,
                error=f"watchdog: no engine progress for "
                      f"{self.cfg.watchdog_steps} steps — failing the "
                      f"largest page owner to unwedge the pool")
        elif self._pending:
            self._finish_request(
                self._pending.popleft(), RequestStatus.FAILED_POOL,
                error=f"watchdog: admission starved for "
                      f"{self.cfg.watchdog_steps} steps — the pool never "
                      f"freed enough pages to admit this request")
        self._watchdog = 0

    def step(self) -> int:
        """Deadlines, admission (or one prefill chunk), pages, then one
        batched decode step over every slot (idle and mid-prefill slots
        compute a discarded token).  Returns the sequences advanced, plus
        one for a prefill chunk."""
        progress0 = self._progress
        if self._faults is not None:
            self._faults.begin_step(self._step_idx)
        self._check_deadlines()
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
        advanced = 0
        if active:
            logits, self._kv.cache = self.model.decode_step(
                self.params, self._last_tok, self._kv.cache)
            on = set(active)
            reqs = [self._slots[i] if i in on else None
                    for i in range(self.cfg.max_batch)]
            poison = self._poison(self.cfg.max_batch, [
                (i, {"rid": self._slots[i].rid, "slot": i}) for i in active])
            drawn, nxt = self._sample_rows(logits[:, -1, :], reqs, poison)
            self._last_tok = nxt.to(torch.int32)[:, None]
            for i in active:
                req = self._slots[i]
                if req is None:
                    # failed mid-loop as a co-reader of a poisoned shared
                    # page: its sampled token is void
                    continue
                tok, finite = drawn[i]
                if not finite:
                    self._retire_slot(i, RequestStatus.FAILED_NAN,
                                      error=f"non-finite logits at decode "
                                            f"step {len(req.out_tokens)}")
                    continue
                if not self._dispatch_token(req, tok):
                    self._retire_slot(i, RequestStatus.FAILED_CALLBACK,
                                      error="on_token callback raised")
                    continue
                self._seq_len[i] += 1
                self._maybe_finish(i, tok)
            advanced = len(active)
        self._step_idx += 1
        if self._progress == progress0 and (
                self._pending or any(s is not None for s in self._slots)):
            self._watchdog += 1
            if self._watchdog > self.cfg.watchdog_steps:
                self._degrade()
        else:
            self._watchdog = 0
        return advanced + int(did_chunk)

    def run(self, max_steps: int = 0) -> list[Request]:
        """Drain the queue; returns every submitted request in submission
        order.  ``max_steps > 0`` bounds the loop (raises past it)."""
        steps = 0
        while any(not r.done for r in self._all):
            n = self.step()
            steps += 1
            if max_steps and steps >= max_steps:
                live = [r.rid for r in self._all if not r.done]
                raise RuntimeError(
                    f"run() exceeded max_steps={max_steps} with requests "
                    f"{live} still live — engine wedged?")
            if n == 0 and not self._pending:
                break
        return self._all
