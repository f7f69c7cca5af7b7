"""Packed low-bit serving of a dense OPT or llama model (the paper's
deployment).

Every linear of the trunk is a :class:`QTensor`.  At ``a_bits < 16`` each
matmul goes through ``ops.quant_matmul`` (per-token dynamic activation
codes, the ``w4a8_matmul`` kernel); at a16 through ``ops.dequant_matmul``.
At ``kv_bits == 8`` K/V enter the cache as int8 codes with a float32 scale
per (token, head); at ``kv_bits == 4`` as packed int4 nibbles with a bf16
scale per 32 values; at ``kv_bits >= 16`` the cache is float.  Attention
reads the cache as stored through ``ops.flash_prefill`` /
``ops.flash_decode``.  The cache is linear (a dict, ``init_cache``) or
paged (a :class:`PagedKVCache`, ``init_paged_cache``); ``prefill_chunk``
and ``decode_step`` take either, whole-prompt ``prefill`` fills a linear
one.  Full-matrix transform sites keep their activation factor
(``attn_t`` / ``mlp_t`` = {"a_inv", optional "shift"}) and merged biases
(``bq``/``bk``/``bv``, ``b_gate``/``b_up``) are honoured, as calibrated
trees carry them.  OPT layers (LayerNorm, the ReLU MLP, qkv biases) run
the same code; a no-RoPE model adds ``sinusoidal_at`` of each row's
positions to its embeddings in prefill chunks and decode steps alike.

A raw float tree is packed on the RTN grid by ``ops.quantize_pack``: the
``quantize_pack`` kernel for CUDA weights, one (K, N) matrix at a time,
and its plain version (byte-equal to ``quantize_codes``) on the CPU.

Cache capacity: a write past ``max_len`` (or into an unallocated page) is
dropped (slot ``max_len - 1`` keeps its token) and ``len`` saturates at
capacity.  Quantization conserves poison: a non-finite K/V row (kv4: block)
gives a NaN scale.

The port updates the cache in place: ``prefill_chunk`` and ``decode_step``
write into the cache they are given and return it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantizer import QuantConfig, effective_group_size
from repro_torch.core.sites import require_dense
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.dequant_matmul import KERNEL_BITS
from repro_torch.kernels.quantize_pack import (KV_BLOCK, kv4_check_head_dim,
                                               kv4_quantize)
from repro_torch.models import layers
from repro_torch.models.init import layer, stack_layers
from repro_torch.models.transformer import sinusoidal_at
from repro_torch.serve import kv_cache
from repro_torch.serve.kv_cache import PagedKVCache, chunk_write_index

PACKED_WEIGHTS = ("wq", "wk", "wv", "wo")
PACKED_MLP = ("w_gate", "w_up", "w_down")


def rtn_pack(w: torch.Tensor, qcfg: QuantConfig) -> QTensor:
    """A float (K, N) or layer-stacked (L, K, N) weight on the RTN grid as
    a QTensor, through ``ops.quantize_pack`` one (K, N) matrix at a time.
    A symmetric grid, which the packer has no input for, is refused."""
    if qcfg.symmetric:
        raise NotImplementedError(
            "RTN packing is asymmetric min/max only (quantize_pack has no "
            "symmetric grid)")
    if w.ndim == 3:
        return stack_layers([rtn_pack(wi, qcfg) for wi in w])
    g = effective_group_size(w.shape[0], qcfg.group_size)
    packed, scale, zp = ops.quantize_pack(
        w.to(torch.float32).contiguous(), bits=qcfg.w_bits, group_size=g)
    return QTensor(packed, scale, zp, qcfg.w_bits, g)


def quantize_layers(lp: dict, qcfg: QuantConfig) -> dict:
    """Packed form of a (stacked) layer tree: QTensor linears on the RTN
    grid (:func:`rtn_pack`), norms, transforms and biases kept."""
    out = {k: lp[k] for k in ("ln_attn", "ln_mlp", "attn_t", "mlp_t",
                              "bq", "bk", "bv") if k in lp}
    for k in PACKED_WEIGHTS:
        out[k] = rtn_pack(lp[k], qcfg)
    mlp = lp["mlp"]
    out["mlp"] = {k: rtn_pack(mlp[k], qcfg) for k in PACKED_MLP if k in mlp}
    out["mlp"].update({k: mlp[k] for k in ("b_gate", "b_up") if k in mlp})
    return out


def quantize_lm_packed(params: dict, cfg: ModelConfig, qcfg: QuantConfig
                       ) -> dict:
    """Raw float tree -> packed serving tree on the RTN grid; a tree that
    already holds QTensor linears passes through untouched."""
    if isinstance(params["layers"]["wq"], QTensor):
        return params
    out = {k: params[k] for k in ("embed", "ln_f", "head") if k in params}
    out["layers"] = quantize_layers(params["layers"], qcfg)
    return out


def _act_transform(t: Optional[dict], h: torch.Tensor) -> torch.Tensor:
    """h_t = (h - shift) @ a_inv."""
    if t is None:
        return h
    if "shift" in t:
        h = h - t["shift"].to(h.dtype)
    return h @ t["a_inv"].to(h.dtype)


def _kv_quantize(x: torch.Tensor, kv_bits: int):
    """Quantize-on-write.  kv8: symmetric per-(token, head) codes, x
    (..., H, D) -> (int8 codes (..., H, D), float32 scale (..., H)).  kv4:
    :func:`kv4_quantize`, x -> (nibbles (..., H, D // 2), bf16 scales
    (..., H, D // 32)).  ``amax`` propagates NaN, so a poisoned row keeps a
    NaN scale."""
    if kv_bits == 4:
        return kv4_quantize(x)
    xf = x.to(torch.float32)
    qmax = 2.0 ** (kv_bits - 1) - 1.0
    bound = torch.clamp_min(torch.amax(xf.abs(), dim=-1), 1e-8)
    scale = bound / torch.full_like(bound, qmax)     # IEEE quotient
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax - 1.0, qmax)
    return q.to(torch.int8), scale


@dataclasses.dataclass(frozen=True)
class QuantizedModel:
    """Serves a packed tree: ``init_cache`` / ``init_paged_cache`` /
    ``prefill`` / ``prefill_chunk`` / ``decode_step``.  ``mode="auto"`` runs
    the CUDA kernels on CUDA tensors, ``"plain"`` the plain versions.
    ``block_kv`` sets the plain versions' tile over the linear cache (the
    paged ones take one page per tile), as the reference's
    ``flash_block_kv`` does."""
    cfg: ModelConfig
    qcfg: QuantConfig
    mode: str = "auto"
    device: str = "cuda"
    block_kv: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        cfg, qcfg = self.cfg, self.qcfg
        if self.mode not in ops.MODES:
            raise ValueError(f"mode={self.mode!r}: use one of {ops.MODES}")
        require_dense(cfg)
        if qcfg.w_bits not in KERNEL_BITS:
            raise NotImplementedError(f"not ported yet: {qcfg.w_bits}-bit "
                                      f"weights (ROADMAP queue 1 item 8)")
        if qcfg.a_bits < 16 and not 2 <= qcfg.a_bits <= 8:
            raise ValueError(f"a_bits={qcfg.a_bits}: use 2..8 or >= 16")
        if qcfg.kv_bits < 16 and qcfg.kv_bits not in (4, 8):
            raise ValueError(f"kv_bits={qcfg.kv_bits}: use 4 (packed int4 + "
                             f"block-32 bf16 scales), 8 (int8 + per-(token, "
                             f"head) float32 scales) or >= 16 (float)")
        if qcfg.kv_bits == 4:
            kv4_check_head_dim(cfg.resolved_head_dim)

    @property
    def kv_quantized(self) -> bool:
        return self.qcfg.kv_bits < 16

    def _mm(self, x: torch.Tensor, qt: QTensor) -> torch.Tensor:
        return ops.quant_matmul(x, qt, a_bits=self.qcfg.a_bits,
                                mode=self.mode)

    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg, dev = self.cfg, self.device
        d = cfg.resolved_head_dim
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, d)
        if not self.kv_quantized:
            dt = getattr(torch, cfg.dtype)
            cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
                     "v": torch.zeros(shape, dtype=dt, device=dev)}
        else:
            sshape, sdt = shape[:-1], torch.float32
            if self.qcfg.kv_bits == 4:
                shape = shape[:-1] + (d // 2,)
                sshape, sdt = shape[:-1] + (d // KV_BLOCK,), torch.bfloat16
            cache = {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                     "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                     "k_scale": torch.zeros(sshape, dtype=sdt, device=dev),
                     "v_scale": torch.zeros(sshape, dtype=sdt, device=dev)}
        cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
        return cache

    def init_paged_cache(self, batch: int, num_pages: int, page_size: int,
                         max_pages_per_seq: int) -> PagedKVCache:
        """Page pools in the linear cache's per-token layout."""
        cfg = self.cfg
        return kv_cache.make_paged_cache(
            num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, batch=batch,
            num_pages=num_pages, page_size=page_size,
            max_pages_per_seq=max_pages_per_seq,
            dtype=getattr(torch, cfg.dtype),
            kv_bits=min(self.qcfg.kv_bits, 16), device=self.device)

    def _kv_entries(self, cache, i: int) -> tuple:
        """Layer ``i``'s cache entries (linear dict or paged pools)."""
        keys = ("k", "v", "k_scale", "v_scale") if self.kv_quantized \
            else ("k", "v")
        if isinstance(cache, PagedKVCache):
            return tuple(getattr(cache, k)[i] for k in keys)
        return tuple(cache[k][i] for k in keys)

    def _kv_values(self, k: torch.Tensor, v: torch.Tensor) -> tuple:
        """What enters the cache, in ``_kv_entries`` order: codes and
        scales (quantize-on-write) at kv8 / kv4, the values at kv16."""
        if not self.kv_quantized:
            return k, v
        (kq, k_s), (vq, v_s) = (_kv_quantize(t, self.qcfg.kv_bits)
                                for t in (k, v))
        return kq, vq, k_s, v_s

    def _embed(self, params: dict, tokens: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
        """Token embeddings; a no-RoPE model adds the sinusoidal
        embedding of ``pos`` (tokens' shape)."""
        x = params["embed"][tokens.long()]
        if not self.cfg.rope_theta:
            x = x + sinusoidal_at(pos, self.cfg.d_model).to(x.dtype)
        return x

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = layers.apply_norm(params["ln_f"], x, self.cfg.norm)
        head = params.get("head")
        return x @ (head if head is not None else params["embed"].T)

    def _ints(self, x, fill: int, n: int) -> torch.Tensor:
        if x is None:
            return torch.full((n,), fill, dtype=torch.int32,
                              device=self.device)
        return torch.as_tensor(x, dtype=torch.int32).to(self.device)

    # ---- prefill -------------------------------------------------------
    def prefill(self, params: dict, batch: dict, max_len: int):
        """Whole-prompt prefill: one chunk at offset 0 into a fresh cache of
        ``max(max_len, T)`` positions.  ``batch["lengths"]`` (B,) marks the
        valid length of end-padded prompts.  Returns (logits (B, 1, vocab)
        at each last valid token, cache)."""
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        bsz, t = tokens.shape
        lengths = self._ints(batch.get("lengths"), t, bsz)
        cache = self.init_cache(bsz, max(max_len, t))
        x = self._forward_chunk(params, tokens, lengths, cache,
                                torch.zeros_like(lengths))
        x = x[torch.arange(bsz, device=self.device), lengths.long() - 1]
        return self._head(params, x[:, None]), cache

    def prefill_chunk(self, params: dict, batch: dict, cache, offset,
                      *, last_only: bool = False):
        """One C-token chunk written into (and attending) ``cache`` (linear
        or paged) at ``offset`` (B,).  ``batch["chunk_len"]`` (B,) counts
        valid rows (0 for idle rows).  Returns (logits (B, C, vocab) — or
        (B, 1, vocab) at the last valid row when ``last_only`` — , cache)
        with ``len`` (``lens`` when paged) advanced to ``offset +
        chunk_len`` (saturating)."""
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        bsz, c = tokens.shape
        chunk_len = self._ints(batch.get("chunk_len"), c, bsz)
        offset = self._ints(offset, 0, bsz)
        x = self._forward_chunk(params, tokens, chunk_len, cache, offset)
        if last_only:
            rows = torch.clamp_min(chunk_len.long() - 1, 0)
            x = x[torch.arange(bsz, device=self.device), rows][:, None]
        return self._head(params, x), cache

    def _forward_chunk(self, params, tokens, chunk_len, cache, offset):
        """Embed -> blocks (cache write + as-stored attention); returns the
        pre-norm hidden states (B, C, d) and updates ``cache`` in place."""
        bsz, c = tokens.shape
        pos = offset[:, None] + torch.arange(c, device=self.device)[None, :]
        x = self._embed(params, tokens, pos)
        page_table = None
        if isinstance(cache, PagedKVCache):
            page_table, cap = cache.page_table, cache.capacity
            rows = cache.num_pages * cache.page_size
            write = kv_cache.paged_chunk_write_index(kv_cache.chunk_write_dest(
                page_table, offset, chunk_len, c, cache.page_size,
                cache.num_pages), rows)
        else:
            cap = cache["k"].shape[2]
            write = chunk_write_index(offset, chunk_len, c, cap)
        for i in range(self.cfg.num_layers):
            x = self._block_prefill_chunk(
                layer(params["layers"], i), x, self._kv_entries(cache, i),
                pos, offset, chunk_len, write, page_table)
        lens = torch.clamp_max(offset + chunk_len, cap).to(torch.int32)
        if page_table is None:
            cache["len"] = lens
        else:
            cache.lens = lens
        return x

    def _qkv(self, p, x, pos):
        """norm -> activation transform -> packed q/k/v (+ biases) ->
        RoPE (RoPE models)."""
        cfg = self.cfg
        b, t = x.shape[0], x.shape[1]
        h = layers.apply_norm(p["ln_attn"], x, cfg.norm)
        h = _act_transform(p.get("attn_t"), h)
        q, k, v = (self._mm(h, p[w]) for w in ("wq", "wk", "wv"))
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        hd = cfg.resolved_head_dim
        q = q.reshape(b, t, cfg.num_heads, hd)
        k = k.reshape(b, t, cfg.num_kv_heads, hd)
        if cfg.rope_theta > 0:
            q = layers.apply_rope(q, pos, cfg.rope_theta)
            k = layers.apply_rope(k, pos, cfg.rope_theta)
        return q, k, v.reshape(b, t, cfg.num_kv_heads, hd)

    def _block_prefill_chunk(self, p, x, kv, pos, offset, chunk_len, write,
                             page_table=None):
        b, c = x.shape[0], x.shape[1]
        q, k, v = self._qkv(p, x, pos)
        b_idx, c_idx, dest = write
        for ct, val in zip(kv, self._kv_values(k, v)):
            if page_table is None:
                ct[b_idx, dest] = val[b_idx, c_idx].to(ct.dtype)
            else:
                kv_cache.paged_chunk_write(ct, val, write)
        out = ops.flash_prefill(q, kv, offset, chunk_len,
                                block_kv=self.block_kv,
                                page_table=page_table, mode=self.mode)
        x = x + self._mm(out.reshape(b, c, -1), p["wo"])
        return x + self._mlp(p, x)

    # ---- decode --------------------------------------------------------
    def decode_step(self, params: dict, token, cache):
        """token (B, 1) -> (logits (B, 1, vocab), cache), writing each
        row's K/V at position ``len`` (dropped when the row is full, or its
        page unallocated) and advancing ``len`` (saturating at capacity)."""
        token = torch.as_tensor(token).to(self.device)
        paged = isinstance(cache, PagedKVCache)
        cur_len = cache.lens if paged else cache["len"]
        x = self._embed(params, token, cur_len[:, None])
        if paged:
            return self._decode_step_paged(params, x, cache)
        s = cache["k"].shape[2]
        for i in range(self.cfg.num_layers):
            x = self._block_decode(layer(params["layers"], i), x,
                                   self._kv_entries(cache, i), cur_len)
        logits = self._head(params, x)
        cache["len"] = torch.clamp_max(cur_len + 1, s).to(torch.int32)
        return logits, cache

    def _block_decode(self, p, x, kv, cur_len):
        b = x.shape[0]
        s = kv[0].shape[1]
        q, k, v = self._qkv(p, x, cur_len[:, None])
        # a full row's write is dropped: write the old value back at the
        # clamped index (one index per row, so no duplicate scatter)
        idx = torch.clamp_max(cur_len, s - 1).long()
        rows = torch.arange(b, device=self.device)
        keep = (cur_len >= s)
        for ct, val in zip(kv, self._kv_values(k[:, 0], v[:, 0])):
            old = ct[rows, idx]
            mask = keep.reshape(-1, *([1] * (old.ndim - 1)))
            ct[rows, idx] = torch.where(mask, old, val.to(ct.dtype))
        out = ops.flash_decode(q, kv, torch.clamp_max(cur_len + 1, s),
                               block_kv=self.block_kv, mode=self.mode)
        x = x + self._mm(out.reshape(b, 1, -1), p["wo"])
        return x + self._mlp(p, x)

    def _decode_step_paged(self, params: dict, x, cache: PagedKVCache):
        """The decode step over page pools: the token's K/V land in the
        sequence's current page through the page table, attention walks only
        the allocated pages.  Same math as the linear step."""
        cur_len, cap = cache.lens, cache.capacity
        rows = cache.num_pages * cache.page_size
        write = kv_cache.token_write_index(kv_cache.token_write_dest(
            cache.page_table, cur_len, cache.page_size, cache.num_pages), rows)
        for i in range(self.cfg.num_layers):
            x = self._block_decode_paged(layer(params["layers"], i), x,
                                         self._kv_entries(cache, i), cur_len,
                                         cache.page_table, write, cap)
        logits = self._head(params, x)
        cache.lens = torch.clamp_max(cur_len + 1, cap).to(torch.int32)
        return logits, cache

    def _block_decode_paged(self, p, x, kv, cur_len, page_table, write, cap):
        b = x.shape[0]
        q, k, v = self._qkv(p, x, cur_len[:, None])
        for ct, val in zip(kv, self._kv_values(k[:, 0], v[:, 0])):
            kv_cache.paged_token_write(ct, val, write)
        out = ops.flash_decode(q, kv, torch.clamp_max(cur_len + 1, cap),
                               page_table=page_table, mode=self.mode)
        x = x + self._mm(out.reshape(b, 1, -1), p["wo"])
        return x + self._mlp(p, x)

    # ---- mlp -----------------------------------------------------------
    def _mlp(self, p, x):
        h = layers.apply_norm(p["ln_mlp"], x, self.cfg.norm)
        h = _act_transform(p.get("mlp_t"), h)
        mp = p["mlp"]

        def lin(wn, bn):
            y = self._mm(h, mp[wn])
            return y + mp[bn] if bn in mp else y

        return self._mm(layers.mlp_hidden(lin, self.cfg.act), mp["w_down"])
