"""KV cache layouts, write destinations, the page allocator and the
Engine's two cache stores.

Linear cache: ``{"k", "v": (L, B, S, Hkv, Dk), "k_scale", "v_scale":
(L, B, S, Hkv[, D // 32]) (kv8 / kv4), "len": (B,) int32}`` — the sequence
axis at position 2, as in the reference, so splice and write helpers touch
only leading dims.

Paged cache (:class:`PagedKVCache`): pools ``k``/``v`` (L, num_pages,
page_size, Hkv, Dk) with scale pools (L, num_pages, page_size, Hkv[,
D // 32]), per-sequence page tables (B, max_pages_per_seq) int32 (-1 marks
an unallocated logical page) and ``lens`` (B,) int32.  A sequence of length
``n`` holds ``ceil(n / page_size)`` pages, so pool memory tracks live
tokens, not ``max_batch * max_len``.  Dk is D, or D // 2 for kv4 nibbles.

Allocation is host-side bookkeeping: :class:`PageAllocator` owns the free
list and per-page owner sets; :class:`PagedCache` and :class:`LinearCache`
pair a device cache with reserve / append / splice / free, so the Engine
never touches cache ranks.  The port updates cache tensors in place.

Writes: the reference's scatters drop out-of-bounds destinations
silently, while PyTorch indexing wraps -1 and raises past the end.  So the
port computes the reference's destinations and writes only the valid
entries: a chunk's in-bounds rows are found with one host sync per chunk
(shared by every layer); a decode token write needs none (see
:func:`token_write_index`).  Prefix caching (``adopt``, page hashing) is not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.quantize_pack import KV_BLOCK, kv4_check_head_dim

SEQ_KEYS = ("k", "v", "k_scale", "v_scale")   # entries with a sequence axis


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# ---------------------------------------------------------------------------
# linear cache writes
# ---------------------------------------------------------------------------

def linear_chunk_write_dest(offset: torch.Tensor, chunk_len: torch.Tensor,
                            chunk: int, max_len: int) -> torch.Tensor:
    """Sequence-axis indices (B, chunk) where a C-token chunk lands.

    Token ``i`` of sequence ``b`` goes to ``offset[b] + i``; pad rows
    (``i >= chunk_len[b]``) and past-capacity positions resolve to
    ``max_len``, out of bounds.  The reference's scatter drops such writes
    silently; PyTorch indexing raises on them, so callers write only the
    in-bounds entries (see :func:`chunk_write_index`)."""
    rows = torch.arange(chunk, device=offset.device)[None, :]
    pos = offset[:, None] + rows
    valid = (rows < chunk_len[:, None]) & (pos < max_len)
    return torch.where(valid, pos, max_len)


def chunk_write_index(offset: torch.Tensor, chunk_len: torch.Tensor,
                      chunk: int, max_len: int):
    """(batch rows, chunk rows, cache positions) of the in-bounds writes of
    a chunk: the dropped writes of :func:`linear_chunk_write_dest` made
    explicit.  One host sync per chunk call, shared by every layer."""
    dest = linear_chunk_write_dest(offset, chunk_len, chunk, max_len)
    b_idx, c_idx = torch.nonzero(dest < max_len, as_tuple=True)
    return b_idx, c_idx, dest[b_idx, c_idx]


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedKVCache:
    """Device-side paged cache state (see the module docstring)."""
    k: torch.Tensor
    v: torch.Tensor
    page_table: torch.Tensor
    lens: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    page_size: int

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def max_pages_per_seq(self) -> int:
        return self.page_table.shape[1]

    @property
    def capacity(self) -> int:
        """Max logical tokens one sequence can hold."""
        return self.max_pages_per_seq * self.page_size

    @property
    def pool_bytes(self) -> int:
        return _nbytes((self.k, self.v, self.k_scale, self.v_scale))

    @property
    def nbytes(self) -> int:
        return self.pool_bytes + _nbytes((self.page_table, self.lens))


def chunk_write_dest(page_table: torch.Tensor, offset: torch.Tensor,
                     chunk_len: torch.Tensor, chunk: int, page_size: int,
                     num_pages: int) -> torch.Tensor:
    """Flat pool rows (B, chunk) (into a ``(num_pages * page_size, ...)``
    view) where a C-token chunk's tokens land.  Token ``i`` of sequence
    ``b`` goes to position ``offset[b] + i``; pad rows, unallocated logical
    pages and at-capacity positions resolve to ``num_pages * page_size``,
    out of bounds.  The reference's one destination formula for chunks and
    (as its C == 1 column) decode tokens."""
    b, mpps = page_table.shape
    rows = torch.arange(chunk, device=offset.device)[None, :]
    pos = offset[:, None] + rows
    page_idx = torch.clamp_max(pos // page_size, mpps - 1)
    page = torch.gather(page_table, 1, page_idx.long())
    valid = (page >= 0) & (pos < mpps * page_size) \
        & (rows < chunk_len[:, None])
    return torch.where(valid, page * page_size + pos % page_size,
                       num_pages * page_size)


def token_write_dest(page_table: torch.Tensor, lens: torch.Tensor,
                     page_size: int, num_pages: int) -> torch.Tensor:
    """Flat pool row (B,) of each sequence's next token, out of bounds
    (``num_pages * page_size``) where the page is unallocated or the
    sequence is at capacity: the C == 1 column of
    :func:`chunk_write_dest`."""
    return chunk_write_dest(page_table, lens, torch.ones_like(lens), 1,
                            page_size, num_pages)[:, 0]


def paged_chunk_write_index(dest: torch.Tensor, rows: int):
    """(batch rows, chunk rows, pool rows) of the in-bounds entries of
    ``dest`` (B, C) for a pool of ``rows`` flat rows.  One host sync per
    chunk, shared by every layer."""
    b_idx, c_idx = torch.nonzero(dest < rows, as_tuple=True)
    return b_idx, c_idx, dest[b_idx, c_idx]


def paged_chunk_write(pool: torch.Tensor, val: torch.Tensor, index) -> None:
    """Write chunk values ``val`` (B, C, ...) into ``pool`` (num_pages,
    page_size, ...) at the in-bounds entries of
    :func:`paged_chunk_write_index` (in place)."""
    b_idx, c_idx, dest = index
    flat = pool.view(-1, *pool.shape[2:])
    flat[dest.long()] = val[b_idx, c_idx].to(pool.dtype)


def token_write_index(dest: torch.Tensor, rows: int):
    """A one-token-per-sequence write into ``rows`` flat pool rows that
    drops the out-of-bounds entries of ``dest`` (B,) with no host sync:
    (target rows, source rows, any kept).  A dropped sequence rewrites the
    first kept sequence's target with that sequence's value, so duplicate
    targets carry equal values; with none kept, every sequence rewrites
    row 0 with its old value."""
    keep = dest < rows
    first = torch.argmax(keep.to(torch.int32))
    src = torch.where(keep, torch.arange(dest.shape[0], device=dest.device),
                      first)
    anyk = keep.any()
    tgt = torch.where(anyk, torch.where(keep, dest, dest[first]), 0)
    return tgt.long(), src, anyk


def paged_token_write(pool: torch.Tensor, val: torch.Tensor, index) -> None:
    """Write one token per sequence, ``val`` (B, ...), into ``pool`` at
    :func:`token_write_index`'s targets (in place)."""
    tgt, src, anyk = index
    flat = pool.view(-1, *pool.shape[2:])
    flat[tgt] = torch.where(anyk, val.to(pool.dtype)[src], flat[tgt])


def pages_for(length: int, page_size: int) -> int:
    return max(0, -(-length // page_size))


def make_paged_cache(*, num_layers: int, num_kv_heads: int, head_dim: int,
                     batch: int, num_pages: int, page_size: int,
                     max_pages_per_seq: int, dtype, kv_bits: int,
                     device) -> PagedKVCache:
    """Code pages and scale pages at kv8 (int8 + float32) and kv4 (packed
    nibbles + bf16 block-32 scales), ``dtype`` pages at kv16."""
    shape = (num_layers, num_pages, page_size, num_kv_heads, head_dim)
    ks = vs = None
    if kv_bits == 4:
        kv4_check_head_dim(head_dim)
        shape = shape[:-1] + (head_dim // 2,)
        sshape = shape[:-1] + (head_dim // KV_BLOCK,)
        kdt = torch.int8
        ks, vs = (torch.zeros(sshape, dtype=torch.bfloat16, device=device)
                  for _ in range(2))
    elif kv_bits == 8:
        kdt = torch.int8
        ks, vs = (torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                  for _ in range(2))
    else:
        kdt = dtype
    return PagedKVCache(
        k=torch.zeros(shape, dtype=kdt, device=device),
        v=torch.zeros(shape, dtype=kdt, device=device),
        page_table=torch.full((batch, max_pages_per_seq), -1,
                              dtype=torch.int32, device=device),
        lens=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scale=ks, v_scale=vs, page_size=page_size)


class PageIntegrityError(RuntimeError):
    """Page-pool bookkeeping corruption: a page double-freed, freed while
    another slot still references it, or a device page-table row that
    diverged from the host allocator.  A silently corrupted page table
    serves one sequence's KV to another, so these raise."""


class PageAllocator:
    """Host-side refcounted free list over the page pool.

    ``owned[slot]`` lists the pool pages backing a slot in logical order;
    ``owners[page]`` is the inverse map (the set of slots referencing a
    page: its refcount) and ``in_free[page]`` mirrors free-list membership,
    so every integrity check is O(1) per page.  The free list is a LIFO
    stack: recently freed pages are reused first."""

    def __init__(self, num_pages: int, max_pages_per_seq: int,
                 max_batch: int):
        self.num_pages = num_pages
        self.max_pages_per_seq = max_pages_per_seq
        self.free_list: list[int] = list(range(num_pages - 1, -1, -1))
        self.owned: list[list[int]] = [[] for _ in range(max_batch)]
        self.owners: list[set[int]] = [set() for _ in range(num_pages)]
        self.in_free: list[bool] = [True] * num_pages
        self.peak_in_use = 0

    @property
    def num_free(self) -> int:
        return len(self.free_list)

    @property
    def num_in_use(self) -> int:
        return self.num_pages - len(self.free_list)

    def allocate(self, slot: int, n: int) -> Optional[list[int]]:
        """Grow ``slot`` by ``n`` fresh pages; None (state unchanged) if the
        pool or the slot's page table cannot hold them."""
        if n > len(self.free_list):
            return None
        if len(self.owned[slot]) + n > self.max_pages_per_seq:
            return None
        pages = [self.free_list.pop() for _ in range(n)]
        for p in pages:
            self.in_free[p] = False
            self.owners[p].add(slot)
        self.owned[slot].extend(pages)
        self.peak_in_use = max(self.peak_in_use, self.num_in_use)
        return pages

    def exclusive_pages(self, slot: int) -> int:
        """Pages only ``slot`` references: what ``free(slot)`` returns."""
        return sum(1 for p in self.owned[slot] if self.owners[p] == {slot})

    def free(self, slot: int) -> int:
        """Drop ``slot``'s reference on every page it owns; pages reaching
        refcount 0 return to the free list.  Raises
        :class:`PageIntegrityError` on a double free (an owned page already
        on the free list) or a page whose refcounts do not credit
        ``slot``."""
        pages = self.owned[slot]
        dup = sorted({p for p in pages if self.in_free[p]})
        if dup:
            raise PageIntegrityError(
                f"double-free: slot {slot} owns page(s) {dup} that are "
                f"already on the free list")
        orphan = sorted({p for p in pages if slot not in self.owners[p]})
        if orphan:
            others = sorted({o for p in orphan for o in self.owners[p]})
            raise PageIntegrityError(
                f"freeing slot {slot}: page(s) {orphan} are missing from "
                f"slot {slot}'s refcounts — also owned by live slot(s) "
                f"{others}: corrupted handoff")
        dying = []
        for p in pages:
            self.owners[p].discard(slot)
            if not self.owners[p]:
                self.in_free[p] = True
                dying.append(p)
        self.free_list.extend(reversed(dying))
        self.owned[slot] = []
        return len(pages)


# ---------------------------------------------------------------------------
# engine-facing cache stores
# ---------------------------------------------------------------------------

class LinearCache:
    """The contiguous ``max_batch x max_len`` slot table behind the Engine."""

    def __init__(self, model, max_batch: int, max_len: int):
        self.cache = model.init_cache(max_batch, max_len)
        self.max_len = max_len

    @property
    def capacity(self) -> int:
        return self.max_len

    def fits_idle(self, length: int) -> bool:
        """Could an idle engine ever hold ``length`` tokens for one
        sequence?"""
        return length <= self.max_len

    def unservable_reason(self, length: int) -> str:
        return (f"needs {length} cache tokens but max_len is "
                f"{self.max_len} — raise --max-len")

    def reserve(self, slot: int, length: int) -> bool:
        """Linear slots are preallocated; only the capacity check applies."""
        return length <= self.max_len

    def ensure_append(self, slot: int, length: int) -> bool:
        """Capacity for writing token ``length`` exists up front (a write
        past ``max_len`` drops)."""
        return True

    def reclaimable_pages(self, slot: int) -> int:
        return 0

    def splice(self, slot: int, seq_cache: dict, row: int,
               length: int) -> None:
        """Copy row ``row`` of a prefilled cache (often a prompt-bucket
        long) into ``slot`` as a prefix along the sequence axis."""
        for key in SEQ_KEYS:
            if key not in seq_cache:
                continue
            dst, src = self.cache[key], seq_cache[key]
            t = min(src.shape[2], dst.shape[2])
            dst[:, slot, :t] = src[:, row, :t].to(dst.dtype)
        self.cache["len"][slot] = length

    def free(self, slot: int) -> int:
        """Retire a slot: stale K/V stay (masked by len); len resets."""
        self.cache["len"][slot] = 0
        return 0

    def verify(self) -> None:
        """Linear slots have no shared bookkeeping to corrupt."""

    def cache_bytes(self) -> int:
        return _nbytes(self.cache.values())


class PagedCache:
    """Page-table cache store: a device :class:`PagedKVCache` and a host
    :class:`PageAllocator`.  The engine admits with :meth:`reserve` (the
    prompt's pages), grows with :meth:`ensure_append` (one page at a page
    boundary) and reclaims with :meth:`free`.  Length accounting is
    host-side; the device ``lens`` is set by splice, the chunk call and the
    decode step."""

    def __init__(self, model, max_batch: int, max_len: int, page_size: int,
                 num_pages: int = 0, max_pages_per_seq: int = 0):
        mpps = max_pages_per_seq or pages_for(max_len, page_size)
        pool = num_pages or max_batch * mpps   # default: linear-equivalent
        self.cache: PagedKVCache = model.init_paged_cache(
            max_batch, pool, page_size, mpps)
        self.page_size = page_size
        self.max_len = min(max_len, mpps * page_size)
        self._cfg_max_len = max_len
        self.allocator = PageAllocator(pool, mpps, max_batch)

    @property
    def capacity(self) -> int:
        return self.max_len

    def fits_idle(self, length: int) -> bool:
        """Could an idle engine ever hold ``length`` tokens for one
        sequence?  False means no amount of waiting or preemption helps."""
        al = self.allocator
        return (length <= self.max_len
                and pages_for(length, self.page_size)
                <= min(al.num_pages, al.max_pages_per_seq))

    def unservable_reason(self, length: int) -> str:
        """The binding constraint, each with its own remedy."""
        al = self.allocator
        n = pages_for(length, self.page_size)
        if length > self._cfg_max_len:
            return (f"needs {length} cache tokens but max_len is "
                    f"{self._cfg_max_len} — raise --max-len")
        if n > al.max_pages_per_seq:
            return (f"needs {n} pages of {self.page_size} for {length} "
                    f"cache tokens but one sequence may hold at most "
                    f"{al.max_pages_per_seq} (max_pages_per_seq caps "
                    f"usable max_len at {al.max_pages_per_seq * self.page_size}"
                    f") — raise max_pages_per_seq")
        return (f"needs {n} pages of {self.page_size} for {length} cache "
                f"tokens but the idle pool holds {al.num_pages} — size "
                f"num_pages up")

    def _publish(self, slot: int, start: int, pages: list[int]) -> None:
        self.cache.page_table[slot, start:start + len(pages)] = torch.tensor(
            pages, dtype=torch.int32)

    def reserve(self, slot: int, length: int) -> bool:
        """Allocate the prompt's ``ceil(length / page_size)`` pages and
        publish them to the slot's device page-table row."""
        if self.allocator.owned[slot]:
            raise PageIntegrityError(f"reserve on occupied slot {slot}")
        pages = self.allocator.allocate(slot,
                                        pages_for(length, self.page_size))
        if pages is None:
            return False
        self._publish(slot, 0, pages)
        return True

    def ensure_append(self, slot: int, length: int) -> bool:
        """Back the write of token index ``length`` (0-based) by a page;
        allocates at page boundaries, False when the pool is dry."""
        idx = len(self.allocator.owned[slot])
        if length < idx * self.page_size:
            return True
        pages = self.allocator.allocate(slot, 1)
        if pages is None:
            return False
        self._publish(slot, idx, pages)
        return True

    def owned_pages(self, slot: int) -> int:
        return len(self.allocator.owned[slot])

    def reclaimable_pages(self, slot: int) -> int:
        """Pages an eviction of ``slot`` would return to the pool."""
        return self.allocator.exclusive_pages(slot)

    def splice(self, slot: int, seq_cache: dict, row: int,
               length: int) -> None:
        """Scatter row ``row`` of a prefilled linear cache (L, B, T, ...)
        into the slot's pages: T is padded or cut to whole pages and
        written page by page.  Tail positions past ``length`` carry garbage
        and are never attended."""
        pages = self.allocator.owned[slot]
        n, ps = len(pages), self.page_size
        if n != pages_for(length, ps):
            raise PageIntegrityError(
                f"splice of {length} tokens into slot {slot} holding {n} "
                f"pages of {ps}")
        if n:
            pidx = torch.tensor(pages, dtype=torch.long,
                                device=self.cache.k.device)
            want = n * ps
            for key in SEQ_KEYS:
                pool = getattr(self.cache, key)
                if pool is None:
                    continue
                src = seq_cache[key][:, row, :want]      # (L, T, ...)
                if src.shape[1] < want:
                    pad = src.new_zeros((src.shape[0], want - src.shape[1],
                                         *src.shape[2:]))
                    src = torch.cat([src, pad], dim=1)
                pool[:, pidx] = src.reshape(src.shape[0], n, ps,
                                            *src.shape[2:]).to(pool.dtype)
        self.cache.lens[slot] = length

    def free(self, slot: int) -> int:
        """Drop the slot's pages (stale pool contents stay: every read is
        gated by the page table and lens) and clear its device row."""
        n = self.allocator.free(slot)
        self.cache.page_table[slot] = -1
        self.cache.lens[slot] = 0
        return n

    def verify(self) -> None:
        """Full pool audit: every page is either free (refcount 0, once on
        the free list) or referenced by exactly its refcount's worth of
        owned lists, and the device page tables mirror the allocator.
        Raises :class:`PageIntegrityError`."""
        al = self.allocator
        if len(al.free_list) != len(set(al.free_list)):
            raise PageIntegrityError(
                f"free list holds duplicates: {sorted(al.free_list)}")
        refs = [0] * al.num_pages
        for slot, owned in enumerate(al.owned):
            for p in owned:
                refs[p] += 1
                if slot not in al.owners[p]:
                    raise PageIntegrityError(
                        f"slot {slot} owns page {p} but owners[{p}] = "
                        f"{sorted(al.owners[p])} does not credit it")
        free = set(al.free_list)
        for p in range(al.num_pages):
            rc = len(al.owners[p])
            if refs[p] != rc:
                raise PageIntegrityError(
                    f"page {p}: refcount {rc} but appears in {refs[p]} "
                    f"owned list(s)")
            if al.in_free[p] != (p in free):
                raise PageIntegrityError(
                    f"page {p}: in_free={al.in_free[p]} but free-list "
                    f"membership is {p in free}")
            if (rc == 0) != (p in free):
                raise PageIntegrityError(
                    f"page {p}: refcount {rc} but "
                    f"{'on' if p in free else 'not on'} the free list")
        pt = self.cache.page_table.cpu().numpy()
        for slot, owned in enumerate(al.owned):
            row, n = pt[slot], len(owned)
            if list(row[:n]) != owned or not (row[n:] == -1).all():
                raise PageIntegrityError(
                    f"slot {slot}: device page-table row {row.tolist()} "
                    f"!= allocator owned {owned}")

    def cache_bytes(self) -> int:
        return self.cache.nbytes

