"""The linear KV cache: write destinations and the Engine's slot store.

Layout: ``{"k", "v": (L, B, S, Hkv, D), "k_scale", "v_scale": (L, B, S, Hkv)
(kv8 only), "len": (B,) int32}`` — the sequence axis at position 2, as in
the reference, so splice and write helpers touch only leading dims.  The
port updates cache tensors in place.
"""
from __future__ import annotations

import torch

SEQ_KEYS = ("k", "v", "k_scale", "v_scale")   # entries with a sequence axis


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


class LinearCache:
    """The contiguous ``max_batch x max_len`` slot table behind the Engine."""

    def __init__(self, model, max_batch: int, max_len: int):
        self.cache = model.init_cache(max_batch, max_len)
        self.max_len = max_len

    @property
    def capacity(self) -> int:
        return self.max_len

    def reserve(self, slot: int, length: int) -> bool:
        """Linear slots are preallocated; only the capacity check applies."""
        return length <= self.max_len

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

    def free(self, slot: int) -> None:
        """Retire a slot: stale K/V stay (masked by len); len resets."""
        self.cache["len"][slot] = 0
