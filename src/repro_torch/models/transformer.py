"""The transformer trunk of the dense, MoE, VLM and audio families and
griffin's attention blocks: full-sequence block, forward and LM loss (with
the MoE load-balance term and audio's frame cross entropy), the sinusoidal
positions of the no-RoPE families (OPT, hubert), and the serving half: the
decode cache, prefill chunks and decode steps over the linear or the paged
cache (:class:`ServingTrunk`).

Layer parameters are stacked with a leading ``L`` axis (as
:func:`repro_torch.models.init.init_lm` builds them); biases are honoured
by presence (``bq``/``bk``/``bv``, a norm's ``bias``, ``b_gate``/``b_up``),
since merging a calibrated shifted transform introduces them.  An MoE
block (``cfg.num_experts``) holds ``moe`` (router and stacked experts,
:mod:`repro_torch.models.moe`) where a dense block holds ``mlp``.

The masks are the reference's: causal, or bidirectional for audio
(``causal=False``); a VLM's prefix embeddings precede its text tokens and
every position attends the whole prefix (prefix-LM); a sliding
``window`` (griffin's local attention) keeps the last ``window``
positions, and its decode cache is a ring buffer of ``min(max_len,
window)`` slots.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.quantize_pack import KV_BLOCK
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, moe
from repro_torch.models.init import layer
from repro_torch.serve import kv_cache
from repro_torch.serve.kv_cache import PagedKVCache, chunk_write_index
from repro_torch.sharding import batch_shards


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding at explicit positions (...,) -> (..., d) float32:
    ``sin(p / 10000^(2i/d))`` for i < d/2, then the cosines (concatenated,
    not interleaved), as the reference's ``sinusoidal_at``.

    The float forward, calibration and the packed model's prefill chunks
    ((B, C) positions) and decode steps ((B,) positions) all call it, so the
    position scheme cannot drift between phases.  The angle is the
    reference's float32 quotient; its sine and cosine are taken in float64
    and rounded once, which gives every element the same bits whatever the
    tensor's shape (a float32 ``sin`` on the CPU takes a vector and a scalar
    path, which can differ in the last bit, and a chunked prefill would then
    see other positions than the whole prompt)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    expo = (2 * i) / torch.full_like(i, d)
    freq = torch.pow(torch.tensor(10000.0, dtype=torch.float64,
                                  device=i.device),
                     expo.to(torch.float64)).to(torch.float32)
    ang = positions[..., None].to(torch.float32) / freq
    ang = ang.to(torch.float64)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(
        torch.float32)


def _sinusoidal(t: int, d: int, device=None) -> torch.Tensor:
    """(t, d) positions 0..t-1."""
    return sinusoidal_at(torch.arange(t, device=device), d)


def embed(params: dict, cfg, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Token embeddings (B, T, d); a no-RoPE model (``rope_theta == 0``,
    OPT) adds its sinusoidal positions 0..T-1 here.  On a training mesh
    (``tp``) a rank holding a slice of the vocabulary looks up the tokens
    it holds, zeros elsewhere, and the ranks' rows are summed."""
    emb = params["embed"]
    if tp is not None and emb.shape[0] < cfg.vocab_size:
        n = emb.shape[0]
        idx = tokens.long() - tp.mi * n
        mine = ((idx >= 0) & (idx < n))[..., None]
        x = tp.sum(torch.where(mine, emb[idx.clamp(0, n - 1)],
                               emb.new_zeros(())))
    else:
        x = emb[tokens.long()]
    if not cfg.rope_theta:
        x = x + _sinusoidal(x.shape[1], cfg.d_model, x.device).to(
            x.dtype)[None]
    return x


def embed_inputs(params: dict, cfg, tokens=None, prefix_embeds=None,
                 embed_fn=None) -> tuple:
    """(x (B, T, d), positions (1, T), prefix_len), the reference's
    ``_embed_inputs``: audio's inputs are its frame embeddings (B, T, d)
    plus sinusoidal positions; a VLM's ``prefix_embeds`` (B, P, d) precede
    its token embeddings, and the prefix-LM mask then opens the first P
    positions to every query.  ``embed_fn(tokens)`` looks the tokens up
    (default :func:`embed`; the serving trunk's on a mesh, whose rank holds
    a slice of the vocabulary)."""
    prefix_len = 0
    if cfg.family == "audio":
        x = prefix_embeds + _sinusoidal(
            prefix_embeds.shape[1], cfg.d_model,
            prefix_embeds.device).to(prefix_embeds.dtype)[None]
    else:
        x = (embed_fn or (lambda t: embed(params, cfg, t)))(tokens)
        if cfg.family == "vlm" and prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
            prefix_len = prefix_embeds.shape[1]
    return x, torch.arange(x.shape[1], device=x.device)[None, :], prefix_len


def apply_block_full(p: dict, x: torch.Tensor, cfg,
                     positions: torch.Tensor, prefix_len: int = 0,
                     window: int = 0, tp=None) -> tuple:
    """One full-sequence block (attention under the config's mask + MLP or
    MoE, pre-norm).  Returns (x, aux): the MoE load-balance loss, 0 for a
    dense block.

    On a training mesh (``tp``, a :class:`~repro_torch.train.parallel.
    TrainParallel`) the block runs this rank's shards: q/k/v and the MLP's
    up-projections hold this rank's output columns (their input enters
    through ``tp.copy``), attention runs on this rank's heads where "model"
    divides the KV heads (else on q/k/v gathered whole), and a row-split
    ``wo`` / ``w_down`` sums its partial products over "model"."""
    h = layers.apply_norm(p["ln_attn"], x, cfg.norm)
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    lin = _column(tp, h)
    q, k, v = lin(p["wq"], hq * hd), lin(p["wk"], hkv * hd), \
        lin(p["wv"], hkv * hd)
    if "bq" in p:
        q, k, v = q + _cut(tp, p["bq"], q), k + _cut(tp, p["bk"], k), \
            v + _cut(tp, p["bv"], v)
    if tp is not None and tp.heads:
        hq, hkv = hq // tp.m, hkv // tp.m
    elif tp is not None:
        q, k, v = _whole(tp, q, hq * hd), _whole(tp, k, hkv * hd), \
            _whole(tp, v, hkv * hd)
    b, t = x.shape[0], x.shape[1]
    q = q.reshape(b, t, hq, hd)
    k = k.reshape(b, t, hkv, hd)
    v = v.reshape(b, t, hkv, hd)
    if cfg.rope_theta > 0:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = attn_lib.attention(q, k, v, causal=cfg.causal, window=window,
                             prefix_len=prefix_len)
    x = x + _row(tp, out.reshape(b, t, -1), p["wo"], cfg.num_heads * hd)
    h2 = layers.apply_norm(p["ln_mlp"], x, cfg.norm)
    if cfg.num_experts:
        y, aux = moe.apply_moe(p["moe"], h2, top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               act=cfg.act)
        return x + y, aux
    return (x + _mlp(tp, p["mlp"], h2, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _column(tp, h: torch.Tensor):
    """``lin(w, full)``, the product ``h @ w`` for a weight of ``full``
    output features: where ``w`` holds only this rank's columns, ``h``
    enters through ``tp.copy`` (one for all of them; its backward, the
    sum over "model", runs only where a split weight used it)."""
    if tp is None:
        return lambda w, full: h @ w
    entered = tp.copy(h)
    return lambda w, full: (h if w.shape[-1] == full else entered) @ w


def _cut(tp, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A bias for ``y``: a whole bias beside a column-split weight cut to
    this rank's columns."""
    return b if tp is None else tp.cols(b, y.shape[-1])


def _whole(tp, y: torch.Tensor, full: int) -> torch.Tensor:
    """A column-split output gathered over "model"."""
    return tp.gather(y) if y.shape[-1] < full else y


def _row(tp, h: torch.Tensor, w: torch.Tensor, full: int) -> torch.Tensor:
    """``h @ w`` for ``wo`` / ``w_down`` (``full`` input features): a
    whole-K ``w`` takes ``h`` whole; a row-split one takes this rank's
    features of ``h`` and its partial products are summed over
    "model"."""
    if tp is None:
        return h @ w
    k = w.shape[-2]
    if k == full:
        return _whole(tp, h, full) @ w
    return tp.sum(tp.cols(h, k) @ w)


def _mlp(tp, mp: dict, h: torch.Tensor, cfg) -> torch.Tensor:
    """The dense MLP; on a training mesh over this rank's columns of the
    hidden layer."""
    if tp is None:
        return layers.apply_mlp(mp, h, cfg.act)
    col = _column(tp, h)

    def lin(wn, bn):
        y = col(mp[wn], cfg.d_ff)
        return y + _cut(tp, mp[bn], y) if bn in mp else y

    return _row(tp, layers.mlp_hidden(lin, cfg.act), mp["w_down"], cfg.d_ff)


def call_block(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` and autograd on, ``fn`` keeps only its
    inputs for backward and runs again there (the reference's
    ``jax.checkpoint`` around a block): the same values and gradients for
    less activation memory."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def head(params: dict, cfg, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Final norm and the (tied or untied) vocabulary head; on a training
    mesh a vocabulary-split head's logits are gathered over "model"."""
    x = layers.apply_norm(params["ln_f"], x, cfg.norm)
    w = params.get("head")
    w = w if w is not None else params["embed"].T
    if tp is None:
        return x @ w
    return _whole(tp, _column(tp, x)(w, cfg.vocab_size), cfg.vocab_size)


def forward_with_aux(params: dict, cfg, tokens: Optional[torch.Tensor] = None,
                     prefix_embeds: Optional[torch.Tensor] = None,
                     tp=None) -> tuple:
    """(logits (B, T, vocab) of the whole sequence — a VLM's prefix
    positions included —, the load-balance loss summed over layers), each
    block through :func:`call_block` (``cfg.remat``; on a mesh the
    recomputation runs the block's collectives again); ``tp``: one rank's
    shards on a training mesh."""
    x, positions, prefix_len = embed_inputs(
        params, cfg, tokens, prefix_embeds,
        embed_fn=None if tp is None else (lambda t: embed(params, cfg, t,
                                                          tp)))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, aux_l = call_block(cfg.remat, apply_block_full,
                              layer(params["layers"], i), x, cfg, positions,
                              prefix_len, cfg.window, tp)
        aux = aux + aux_l
    return head(params, cfg, x, tp), aux


def forward(params: dict, cfg, tokens: Optional[torch.Tensor] = None,
            prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits (B, T, vocab) of the whole sequence."""
    return forward_with_aux(params, cfg, tokens, prefix_embeds)[0]


def lm_loss(params: dict, cfg, batch: dict, tp=None) -> torch.Tensor:
    """Next-token cross entropy over the text (a VLM's prefix positions
    excluded), or audio's frame cross entropy against ``labels``, plus
    ``0.01 *`` the load-balance loss (0 for a dense model), as the
    reference.  ``tp``: one rank's shards on a training mesh (the logits
    are whole on every rank of "model")."""
    if cfg.family == "audio":
        logits, aux = forward_with_aux(params, cfg,
                                       prefix_embeds=batch["embeds"], tp=tp)
        return layers.cross_entropy(logits, batch["labels"],
                                    batch.get("mask")) + 0.01 * aux
    tokens, prefix = batch["tokens"], batch.get("prefix_embeds")
    logits, aux = forward_with_aux(params, cfg, tokens, prefix, tp)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    return layers.cross_entropy(logits[:, :-1], tokens[:, 1:],
                                batch.get("mask")) + 0.01 * aux


# ---------------------------------------------------------------------------
# serving: the decode cache, prefill chunks and decode steps
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, *, kv_bits: int = 16,
               device="cpu", num_kv_heads: Optional[int] = None) -> dict:
    """Linear decode cache: ``k``/``v`` (L, B, S, Hkv, D) in ``cfg.dtype``
    and ``len`` (B,) int32.  kv8 stores int8 codes at that shape with
    float32 ``k_scale``/``v_scale`` (L, B, S, Hkv); kv4 packed int4 nibbles
    (L, B, S, Hkv, D // 2) with bf16 block-32 scales (L, B, S, Hkv,
    D // 32).  Only the trailing dims differ, so the cache helpers that
    touch the leading (L, B, S) dims serve every format.
    ``num_kv_heads`` overrides the config's (a rank's head slice)."""
    d = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, max_len,
             num_kv_heads or cfg.num_kv_heads, d)
    if kv_bits >= 16:
        dt = getattr(torch, cfg.dtype)
        cache = {"k": torch.zeros(shape, dtype=dt, device=device),
                 "v": torch.zeros(shape, dtype=dt, device=device)}
    else:
        sshape, sdt = shape[:-1], torch.float32
        if kv_bits == 4:
            shape = shape[:-1] + (d // 2,)
            sshape, sdt = shape[:-1] + (d // KV_BLOCK,), torch.bfloat16
        cache = {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "k_scale": torch.zeros(sshape, dtype=sdt, device=device),
                 "v_scale": torch.zeros(sshape, dtype=sdt, device=device)}
    cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def act_transform(t: Optional[dict], h: torch.Tensor) -> torch.Tensor:
    """A full-matrix transform site's activation factor: h_t = (h - shift)
    @ a_inv (``t`` None: h)."""
    if t is None:
        return h
    if "shift" in t:
        h = h - t["shift"].to(h.dtype)
    return h @ t["a_inv"].to(h.dtype)


class ServingTrunk:
    """The serving half of the dense trunk, shared by the float
    :class:`~repro_torch.models.model.Model` and the packed
    :class:`~repro_torch.serve.quantized.QuantizedModel`:
    ``init_cache`` / ``init_paged_cache`` / ``prefill`` / ``prefill_chunk``
    / ``decode_step``, the reference's ``apply_block_prefill_chunk``,
    ``apply_block_decode`` and ``apply_block_decode_paged`` as the
    ``_block_*`` methods.

    A subclass is a dataclass with ``cfg``, ``device``, ``mode`` and
    ``block_kv`` and gives ``kv_bits``, ``_mm(x, w)`` (the product of the
    activations with one weight of its tree) and, below kv16,
    ``_kv_values`` (quantize-on-write).  Attention reads the cache as
    stored through ``ops.flash_prefill`` / ``ops.flash_decode``: the
    kernels on CUDA tensors at ``mode="auto"``, their plain versions on
    the CPU or at ``mode="plain"``.  ``block_kv`` sets the plain versions'
    tile over the linear cache (the paged ones take one page per tile), as
    the reference's ``flash_block_kv`` does.

    The trunk embeds tokens (a no-RoPE model adds its sinusoidal
    positions) and attends causally for every family, as the reference's
    ``QuantizedModel`` serves its vlm and audio trees: packed hubert is a
    causal token trunk although its float forward is bidirectional over
    frames.  The float ``Model`` refuses what the reference's refuses
    (audio decode) and adds the VLM's prefix.

    The cache is updated in place: ``prefill_chunk`` and ``decode_step``
    write into the cache they are given and return it.  A write past
    ``max_len`` (or into an unallocated page) is dropped (slot ``max_len -
    1`` keeps its token) and ``len`` saturates at capacity.

    On a mesh (``tp``, a :class:`~repro_torch.serve.tensor_parallel.
    TensorParallel` the Engine sets) the trunk runs one rank's local
    shards: q/k/v and the MLP's up-projections hold this rank's output
    columns, a whole-K ``wo`` / ``w_down`` takes its input gathered over
    "model" (a row-split one sums its partial products), the embedding
    and head hold this rank's vocabulary slice, and attention runs on this
    rank's heads where "model" divides the KV heads (else whole, on
    gathered q/k/v).  Decode and chunk steps take this rank's rows where
    "data" divides the batch: a linear cache holds only those rows, a
    page pool all of them (each step's new K/V gathered over "data"), and
    the hidden states are gathered before the head.  An MoE block
    dispatches in the reference's groups (one a "data" shard: a step's rows
    where "data" split them, else :func:`~repro_torch.models.moe.
    num_groups` of the call's tokens) and runs this rank's block of the
    experts, its zero-filled pair rows summed over "model"."""

    supports_padded_prefill = True     # causal dense trunk: end padding
    supports_chunked_prefill = True    # is exact, chunks read the cache
    tp = None                          # a TensorParallel on a mesh

    @property
    def kv_quantized(self) -> bool:
        return self.kv_bits < 16

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.cfg, batch, max_len, kv_bits=self.kv_bits,
                          device=self.device,
                          num_kv_heads=self._heads()[1])

    def init_paged_cache(self, batch: int, num_pages: int, page_size: int,
                         max_pages_per_seq: int) -> PagedKVCache:
        """Page pools in the linear cache's per-token layout."""
        cfg = self.cfg
        return kv_cache.make_paged_cache(
            num_layers=cfg.num_layers, num_kv_heads=self._heads()[1],
            head_dim=cfg.resolved_head_dim, batch=batch,
            num_pages=num_pages, page_size=page_size,
            max_pages_per_seq=max_pages_per_seq,
            dtype=getattr(torch, cfg.dtype),
            kv_bits=min(self.kv_bits, 16), device=self.device)

    def _kv_entries(self, cache, i) -> tuple:
        """Layer ``i``'s cache entries (linear dict or paged pools)."""
        keys = ("k", "v", "k_scale", "v_scale") if self.kv_quantized \
            else ("k", "v")
        if isinstance(cache, PagedKVCache):
            return tuple(getattr(cache, k)[i] for k in keys)
        return tuple(cache[k][i] for k in keys)

    def _kv_values(self, k: torch.Tensor, v: torch.Tensor) -> tuple:
        """What enters the cache, in ``_kv_entries`` order: the values at
        kv16."""
        return k, v

    # ---- mesh helpers (identities without ``tp``) ------------------------
    def param_cuts(self, tp) -> Optional[dict]:
        """Leaves whose last dimension a mesh cuts component by component
        (:class:`~repro_torch.sharding.Segments`); None: every leaf
        follows its spec."""
        return None

    def cache_cuts(self, tp) -> Optional[dict]:
        """The cache's component cuts (as :meth:`param_cuts`)."""
        return None

    def _heads(self) -> tuple:
        """(query heads, KV heads) this rank attends."""
        cfg, tp = self.cfg, self.tp
        if tp is None or not tp.heads:
            return cfg.num_heads, cfg.num_kv_heads
        return cfg.num_heads // tp.m, cfg.num_kv_heads // tp.m

    def _rows(self, b: int) -> Optional[slice]:
        return None if self.tp is None else self.tp.rows(b)

    def _gather_rows(self, x: torch.Tensor, rows) -> torch.Tensor:
        return x if rows is None else self.tp.gather(x, "data", dim=0)

    def _whole(self, y: torch.Tensor, full: int) -> torch.Tensor:
        """A column-split output gathered over "model"."""
        return self.tp.gather(y, "model") if y.shape[-1] < full else y

    def _bias(self, y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """y + b, a replicated bias cut to y's columns."""
        return y + (b if self.tp is None else self.tp.cols(b, y.shape[-1]))

    def _out(self, h: torch.Tensor, w, full: int) -> torch.Tensor:
        """``h @ w`` for wo / w_down (``full`` input features): a whole-K
        ``w`` takes ``h`` gathered over "model"; a row-split one takes this
        rank's features and its partial products are summed."""
        tp = self.tp
        if tp is None:
            return self._mm(h, w)
        k = w.d_in if hasattr(w, "d_in") else w.shape[-2]
        if k == full:
            return self._mm(self._whole(h, full), w)
        return tp.sum(self._mm(tp.cols(h, k), w), "model")

    def _embed(self, params: dict, tokens: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
        """Token embeddings; a no-RoPE model adds the sinusoidal
        embedding of ``pos`` (tokens' shape).  A rank holding a slice of
        the vocabulary looks up the tokens it holds, zeros elsewhere, and
        the ranks' rows are summed."""
        emb, tp = params["embed"], self.tp
        if tp is not None and emb.shape[0] < self.cfg.vocab_size:
            n = emb.shape[0]
            idx = tokens.long() - tp.mi * n
            mine = ((idx >= 0) & (idx < n))[..., None]
            x = tp.sum(torch.where(mine, emb[idx.clamp(0, n - 1)],
                                   emb.new_zeros(())), "model")
        else:
            x = emb[tokens.long()]
        if not self.cfg.rope_theta:
            x = x + sinusoidal_at(pos, self.cfg.d_model).to(x.dtype)
        return x

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Final norm and head; a vocabulary-split head's logits gathered
        over "model"."""
        logits = head(params, self.cfg, x)
        if self.tp is not None:
            logits = self._whole(logits, self.cfg.vocab_size)
        return logits

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
        x, _ = self._forward_chunk(params, tokens, lengths, cache,
                                   torch.zeros_like(lengths), split=False)
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
        x, rows = self._forward_chunk(params, tokens, chunk_len, cache,
                                      offset, split=True)
        if last_only:
            if rows is not None:
                chunk_len = chunk_len[rows]
            last = torch.clamp_min(chunk_len.long() - 1, 0)
            x = x[torch.arange(x.shape[0], device=self.device), last][:, None]
        return self._head(params, self._gather_rows(x, rows)), cache

    def _forward_chunk(self, params, tokens, chunk_len, cache, offset,
                       split: bool):
        """Embed -> blocks (cache write + as-stored attention); returns the
        pre-norm hidden states (B, C, d) — this rank's rows where ``split``
        and "data" divides B — and the rows' slice (None: all), and
        updates ``cache`` in place."""
        bsz, c = tokens.shape
        rows = self._rows(bsz) if split else None
        pos = offset[:, None] + torch.arange(c, device=self.device)[None, :]
        page_table = None
        if isinstance(cache, PagedKVCache):
            page_table, cap = cache.page_table, cache.capacity
            write = kv_cache.paged_chunk_write_index(kv_cache.chunk_write_dest(
                page_table, offset, chunk_len, c, cache.page_size,
                cache.num_pages), cache.num_pages * cache.page_size)
            cache.lens = torch.clamp_max(offset + chunk_len, cap).to(
                torch.int32)
        if rows is not None:
            # this rank's rows; a page pool still takes every row's writes
            tokens, pos, offset, chunk_len = (t[rows] for t in (
                tokens, pos, offset, chunk_len))
            if page_table is not None:
                page_table = page_table[rows]
        if page_table is None:
            cap = cache["k"].shape[2]
            write = chunk_write_index(offset, chunk_len, c, cap)
        x = self._embed(params, tokens, pos)
        for i in range(self.cfg.num_layers):
            x = self._block_prefill_chunk(
                layer(params["layers"], i), x, self._kv_entries(cache, i),
                pos, offset, chunk_len, write, page_table, rows)
        if page_table is None:
            cache["len"] = torch.clamp_max(offset + chunk_len, cap).to(
                torch.int32)
        return x, rows

    def _qkv(self, p, x, pos):
        """norm -> activation transform -> q/k/v (+ biases) -> RoPE (RoPE
        models)."""
        cfg = self.cfg
        b, t = x.shape[0], x.shape[1]
        h = layers.apply_norm(p["ln_attn"], x, cfg.norm)
        h = act_transform(p.get("attn_t"), h)
        q, k, v = (self._mm(h, p[w]) for w in ("wq", "wk", "wv"))
        if "bq" in p:
            q, k, v = (self._bias(y, p[n]) for y, n in
                       ((q, "bq"), (k, "bk"), (v, "bv")))
        hd = cfg.resolved_head_dim
        if self.tp is not None and not self.tp.heads:
            # attention whole on every rank: q/k/v gathered over "model"
            q = self._whole(q, cfg.num_heads * hd)
            k, v = (self._whole(y, cfg.num_kv_heads * hd) for y in (k, v))
        hq, hkv = self._heads()
        q = q.reshape(b, t, hq, hd)
        k = k.reshape(b, t, hkv, hd)
        if cfg.rope_theta > 0:
            q = layers.apply_rope(q, pos, cfg.rope_theta)
            k = layers.apply_rope(k, pos, cfg.rope_theta)
        return q, k, v.reshape(b, t, hkv, hd)

    def _wo(self, p, out: torch.Tensor) -> torch.Tensor:
        """The attention output (B, T, heads here x D) through ``wo``."""
        return self._out(out.reshape(*out.shape[:2], -1), p["wo"],
                         self.cfg.num_heads * self.cfg.resolved_head_dim)

    def _new_kv(self, k, v, rows) -> tuple:
        """Every row's new K/V for a page pool: this rank's rows gathered
        over "data" where the step split them."""
        if rows is None:
            return k, v
        kv = self.tp.gather(torch.stack((k, v)), "data", dim=1)
        return kv[0], kv[1]

    def _block_prefill_chunk(self, p, x, kv, pos, offset, chunk_len, write,
                             page_table=None, rows=None):
        q, k, v = self._qkv(p, x, pos)
        if page_table is not None:
            k, v = self._new_kv(k, v, rows)
        b_idx, c_idx, dest = write
        for ct, val in zip(kv, self._kv_values(k, v)):
            if page_table is None:
                ct[b_idx, dest] = val[b_idx, c_idx].to(ct.dtype)
            else:
                kv_cache.paged_chunk_write(ct, val, write)
        out = ops.flash_prefill(q, kv, offset, chunk_len,
                                block_kv=self.block_kv,
                                page_table=page_table, mode=self.mode)
        x = x + self._wo(p, out)
        return x + self._mlp(p, x, rows)

    def _block_full_kv(self, p, x, pos, *, window: int = 0,
                       prefix_len: int = 0) -> tuple:
        """One whole-sequence block that also returns its K/V (B, T, Hkv,
        D): a prefill whose cache is not the linear one (griffin's ring
        buffer, a VLM's prefix).  Where the mask is plainly causal (no
        prefix, and no window or one that does not bind at T) attention is
        ``ops.flash_prefill`` over the block's own K/V; else the plain
        masked attention, as the reference's (the TPU kernel has neither a
        window nor a prefix mask)."""
        b, t = x.shape[0], x.shape[1]
        q, k, v = self._qkv(p, x, pos)
        if self.cfg.causal and not prefix_len and (not window or t <= window):
            zero = torch.zeros((b,), dtype=torch.int32, device=self.device)
            out = ops.flash_prefill(q, (k, v), zero, zero + t,
                                    block_kv=self.block_kv, mode=self.mode)
        else:
            out = attn_lib.attention(q, k, v, causal=self.cfg.causal,
                                     window=window, prefix_len=prefix_len)
        x = x + self._wo(p, out)
        return x + self._mlp(p, x), k, v

    # ---- decode --------------------------------------------------------
    def decode_step(self, params: dict, token, cache):
        """token (B, 1) -> (logits (B, 1, vocab), cache), writing each
        row's K/V at position ``len`` (dropped when the row is full, or its
        page unallocated) and advancing ``len`` (saturating at capacity)."""
        token = torch.as_tensor(token).to(self.device)
        if isinstance(cache, PagedKVCache):
            return self._decode_step_paged(params, token, cache)
        rows = self._rows(token.shape[0])
        if rows is not None:
            token = token[rows]          # the cache holds only these rows
        cur_len = cache["len"]
        x = self._embed(params, token, cur_len[:, None])
        s = cache["k"].shape[2]
        for i in range(self.cfg.num_layers):
            x = self._block_decode(layer(params["layers"], i), x,
                                   self._kv_entries(cache, i), cur_len, rows)
        logits = self._head(params, self._gather_rows(x, rows))
        cache["len"] = torch.clamp_max(cur_len + 1, s).to(torch.int32)
        return logits, cache

    def _block_decode(self, p, x, kv, cur_len, rows=None):
        b = x.shape[0]
        s = kv[0].shape[1]
        q, k, v = self._qkv(p, x, cur_len[:, None])
        rows = torch.arange(b, device=self.device)
        if self.cfg.window:
            # ring buffer: position len lives in slot len % s, RoPE'd at
            # its absolute position when written, so the min(len + 1, s)
            # written slots are exactly the positions the window admits
            # (attention sums them in slot order)
            idx = (cur_len % s).long()
            for ct, val in zip(kv, self._kv_values(k[:, 0], v[:, 0])):
                ct[rows, idx] = val.to(ct.dtype)
        else:
            # a full row's write is dropped: write the old value back at
            # the clamped index (one index per row, so no duplicate
            # scatter)
            idx = torch.clamp_max(cur_len, s - 1).long()
            keep = (cur_len >= s)
            for ct, val in zip(kv, self._kv_values(k[:, 0], v[:, 0])):
                old = ct[rows, idx]
                mask = keep.reshape(-1, *([1] * (old.ndim - 1)))
                ct[rows, idx] = torch.where(mask, old, val.to(ct.dtype))
        out = ops.flash_decode(q, kv, torch.clamp_max(cur_len + 1, s),
                               block_kv=self.block_kv, mode=self.mode)
        x = x + self._wo(p, out)
        return x + self._mlp(p, x, rows)

    def _decode_step_paged(self, params: dict, token, cache: PagedKVCache):
        """The decode step over page pools: the token's K/V land in the
        sequence's current page through the page table, attention walks only
        the allocated pages.  Same math as the linear step."""
        cur_len, cap = cache.lens, cache.capacity
        write = kv_cache.token_write_index(kv_cache.token_write_dest(
            cache.page_table, cur_len, cache.page_size, cache.num_pages),
            cache.num_pages * cache.page_size)
        rows = self._rows(token.shape[0])
        mine, page_table = cur_len, cache.page_table
        if rows is not None:
            token, mine, page_table = token[rows], mine[rows], \
                page_table[rows]
        x = self._embed(params, token, mine[:, None])
        for i in range(self.cfg.num_layers):
            x = self._block_decode_paged(layer(params["layers"], i), x,
                                         self._kv_entries(cache, i), mine,
                                         page_table, write, cap, rows)
        logits = self._head(params, self._gather_rows(x, rows))
        cache.lens = torch.clamp_max(cur_len + 1, cap).to(torch.int32)
        return logits, cache

    def _block_decode_paged(self, p, x, kv, cur_len, page_table, write, cap,
                            rows=None):
        q, k, v = self._qkv(p, x, cur_len[:, None])
        k, v = self._new_kv(k, v, rows)
        for ct, val in zip(kv, self._kv_values(k[:, 0], v[:, 0])):
            kv_cache.paged_token_write(ct, val, write)
        out = ops.flash_decode(q, kv, torch.clamp_max(cur_len + 1, cap),
                               page_table=page_table, mode=self.mode)
        x = x + self._wo(p, out)
        return x + self._mlp(p, x, rows)

    # ---- mlp -----------------------------------------------------------
    def _mlp(self, p, x, rows=None):
        """The MLP (or MoE) half of a block on ``x``: this rank's rows when
        ``rows`` is not None."""
        h = layers.apply_norm(p["ln_mlp"], x, self.cfg.norm)
        h = act_transform(p.get("mlp_t"), h)
        if self.cfg.num_experts:
            return self._moe_apply(p["moe"], h, split=rows is not None)
        mp = p["mlp"]

        def lin(wn, bn):
            y = self._mm(h, mp[wn])
            return self._bias(y, mp[bn]) if bn in mp else y

        return self._out(layers.mlp_hidden(lin, self.cfg.act), mp["w_down"],
                         self.cfg.d_ff)

    def _moe_apply(self, mp: dict, h: torch.Tensor,
                   split: bool = False) -> torch.Tensor:
        """The MoE half on float experts.  Capacity is per dispatch group,
        so which tokens drop depends on the call's token count: padded
        prefill rows and idle decode rows route too (the reference's
        approximation for padded and chunked prefill).  The groups are the
        reference's: one a data-parallel shard of the mesh (``split``: the
        step's rows are this rank's shard, one group), else
        :func:`~repro_torch.models.moe.num_groups` of the call's tokens
        over the "data" axis (this rank's, or a mesh bound by
        :func:`repro_torch.sharding.use_mesh`).  Expert leaves cut over
        "model" hold this rank's block of the experts."""
        cfg, tp = self.cfg, self.tp
        if tp is not None:
            data = tp.d if tp.batch else 1
        else:
            data = batch_shards()
        groups = 1 if split else moe.num_groups(h.shape[0] * h.shape[1],
                                                data)
        held = mp["w_up"].shape[0]
        first = 0 if tp is None else tp.span(held, cfg.num_experts).start
        return moe.apply_moe(
            mp, h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            act=cfg.act, groups=groups, first_expert=first,
            reduce=None if tp is None else (lambda r: tp.sum(r, "model")))[0]
