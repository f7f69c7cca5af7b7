"""The float model of every family of the reference's registry: ``init``,
``forward``, ``loss`` (with the MoE load-balance term, audio's frame cross
entropy) and serving through the Engine (``init_cache`` /
``init_paged_cache`` / ``prefill`` / ``prefill_chunk`` / ``decode_step``).

dense / moe / vlm / audio share the transformer trunk (its serving half
is :class:`~repro_torch.models.transformer.ServingTrunk`); mamba2 and
griffin get their own block assembly, as the reference's
``models/model.py``: mamba2 stacks SSD blocks, griffin interleaves RG-LRU
blocks with a sliding-window attention block every ``attn_every``-th
layer.  Their decode caches hold the recurrent states (``ssm`` / ``rnn``
and ``conv``, one entry per sequence whatever its length) and, for
griffin's attention layers, a ring buffer of ``min(max_len, window)``
slots.  They prefill at exact lengths only (state flows through pad
positions), have no paged layout and no chunked prefill; audio (an
encoder) has no decode path at all.  The refusals are the reference's.

On a mesh (``tp``) a recurrent block runs on this rank's block of its
width, the reference's "inner" / "rnn" over "model": mamba2's SSD heads
(the leaves cut component by component, :meth:`Model.param_cuts`),
``gate_norm``'s sum of squares and the row-split ``out_proj`` summed over
"model"; griffin's rnn channels (``w_rec`` / ``w_gate`` column-split, the
conv, gates and ``lam`` per channel) and the row-split ``w_out`` summed.
The ``ssm`` / ``rnn`` / ``conv`` states hold the rank's width.  griffin's
MQA attention blocks run whole on every rank.  A VLM's prefix prefill
looks its text tokens up in the rank's vocabulary slice.

The float linears are ``x @ w`` (``torch.matmul``), as the reference
computes them outside any Pallas kernel; the cache is float (kv16) and
attention reads it through the flash kernels on CUDA tensors at
``mode="auto"``, through their plain versions on the CPU or at
``mode="plain"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import griffin, layers, mamba2, transformer
from repro_torch.models.init import griffin_is_attn, init_lm, layer
from repro_torch.sharding import Segments

ENCODER_ONLY = "encoder-only architecture has no decode path"
RECURRENT = ("mamba2", "griffin")


def _rec_block(rec: dict, x: torch.Tensor, cfg, rnn=None, conv=None,
               decode: bool = False) -> tuple:
    """A whole griffin recurrent block: the RG-LRU half, then norm + MLP.
    Returns (x, rnn state, conv state)."""
    x, rnn_s, conv_s = griffin.apply_rglru_block(rec["rglru"], x, cfg, rnn,
                                                 conv, decode)
    m = layers.apply_norm(rec["ln_mlp"], x, cfg.norm)
    return x + layers.apply_mlp(rec["mlp"], m, cfg.act), rnn_s, conv_s


def griffin_forward(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Logits (B, T, vocab); attention blocks under the sliding window."""
    x = params["embed"][tokens.long()]
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    for blk in params["layers"]:
        if "kind_attn" in blk:
            x = transformer.call_block(cfg.remat, transformer.apply_block_full,
                                       blk["kind_attn"], x, cfg, pos, 0,
                                       cfg.window)[0]
        else:
            x = transformer.call_block(cfg.remat, _rec_block,
                                       blk["kind_rec"], x, cfg)[0]
    return transformer.head(params, cfg, x)


def mamba_forward(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Logits (B, T, vocab) through the stacked SSD blocks."""
    x = params["embed"][tokens.long()]
    for i in range(cfg.num_layers):
        x = transformer.call_block(cfg.remat, mamba2.apply_mamba2_block,
                                   layer(params["layers"], i), x, cfg)[0]
    return transformer.head(params, cfg, x)


@dataclasses.dataclass(frozen=True)
class Model(transformer.ServingTrunk):
    cfg: ModelConfig
    device: str = "cuda"
    mode: str = "auto"
    block_kv: Optional[int] = None
    # one rank's view of a serving mesh (the Engine sets it)
    tp: Optional[object] = dataclasses.field(default=None, compare=False,
                                             repr=False)

    kv_bits = 16

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.mode not in ops.MODES:
            raise ValueError(f"mode={self.mode!r}: use one of {ops.MODES}")

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w

    def _t(self, x) -> Optional[torch.Tensor]:
        return None if x is None else torch.as_tensor(x).to(self.device)

    # ---- construction and training ------------------------------------
    def init(self, seed: int) -> dict:
        """Seeded random float parameters on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_lm(self.cfg, gen, self.device)

    def forward(self, params: dict, batch: dict) -> torch.Tensor:
        """Logits of the whole sequence (a VLM's prefix positions first;
        audio reads ``embeds``)."""
        cfg, tokens = self.cfg, self._t(batch.get("tokens"))
        if cfg.family == "mamba2":
            return mamba_forward(params, cfg, tokens)
        if cfg.family == "griffin":
            return griffin_forward(params, cfg, tokens)
        prefix = batch.get("embeds", batch.get("prefix_embeds"))
        return transformer.forward(params, cfg, tokens, self._t(prefix))

    def loss(self, params: dict, batch: dict, tp=None) -> torch.Tensor:
        """The training loss; ``tp`` (a :class:`~repro_torch.train.
        parallel.TrainParallel`): one rank's shards of the dense trunk on a
        training mesh."""
        cfg = self.cfg
        batch = {k: self._t(v) for k, v in batch.items()}
        if cfg.family in RECURRENT:
            tokens = batch["tokens"]
            logits = self.forward(params, batch)
            return layers.cross_entropy(logits[:, :-1], tokens[:, 1:])
        return transformer.lm_loss(params, cfg, batch, tp)

    # ---- serving: what each family admits -------------------------------
    @property
    def supports_padded_prefill(self) -> bool:
        """End-padded prompts with per-sequence ``lengths`` are exact for
        the causal trunk only: recurrent state flows through pad positions,
        and a sliding-window cache holds ``window`` slots."""
        return self.cfg.family not in RECURRENT + ("audio",) \
            and not self.cfg.window

    @property
    def supports_chunked_prefill(self) -> bool:
        """Chunks read the cache as stored: the causal trunk, without a
        VLM's prefix (its absolute positions are prefix + text)."""
        return self.supports_padded_prefill and self.cfg.family != "vlm"

    def _rec_parts(self) -> int:
        """How many ranks share the recurrent width (1 unsharded)."""
        return self.tp.m if self.tp is not None and self.tp.rec else 1

    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        if cfg.family == "mamba2":
            ssm, conv = mamba2.init_mamba2_state(cfg, batch, self.device,
                                                 self._rec_parts())
            return {"ssm": ssm.repeat(cfg.num_layers, 1, 1, 1, 1),
                    "conv": conv.repeat(cfg.num_layers, 1, 1, 1),
                    "len": self._ints(None, 0, batch)}
        if cfg.family == "griffin":
            n_attn = sum(griffin_is_attn(cfg, i)
                         for i in range(cfg.num_layers))
            n_rec = cfg.num_layers - n_attn
            shape = (n_attn, batch, min(max_len, cfg.window),
                     self._heads()[1], cfg.resolved_head_dim)
            dt = getattr(torch, cfg.dtype)
            rnn, conv = griffin.init_rglru_state(cfg, batch, self.device,
                                                 self._rec_parts())
            return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                    "v": torch.zeros(shape, dtype=dt, device=self.device),
                    "rnn": rnn.repeat(n_rec, 1, 1),
                    "conv": conv.repeat(n_rec, 1, 1, 1),
                    "len": self._ints(None, 0, batch)}
        return super().init_cache(batch, max_len)

    def init_paged_cache(self, batch: int, num_pages: int, page_size: int,
                         max_pages_per_seq: int):
        """The transformer families' page pools; recurrent and windowed
        families have no paged layout (their state is O(1) or a ring
        buffer already)."""
        cfg = self.cfg
        if cfg.family in RECURRENT + ("audio",) or cfg.window:
            raise NotImplementedError(
                f"paged KV cache: unsupported for family={cfg.family} "
                f"window={cfg.window}")
        return super().init_paged_cache(batch, num_pages, page_size,
                                        max_pages_per_seq)

    # ---- serving: prefill ------------------------------------------------
    def prefill(self, params: dict, batch: dict, max_len: int):
        """Whole-prompt prefill into a fresh cache.  ``batch["lengths"]``
        (B,) marks end-padded prompts (``supports_padded_prefill`` only);
        a VLM's ``batch["prefix_embeds"]`` (B, P, d) precede its tokens and
        the cache holds both.  Returns (logits (B, 1, vocab) at each last
        valid position, cache)."""
        cfg = self.cfg
        if cfg.family == "audio":
            raise ValueError(ENCODER_ONLY)
        if batch.get("lengths") is not None and not self.supports_padded_prefill:
            raise ValueError(f"padded prefill is not exact for "
                             f"family={cfg.family}: recurrent state flows "
                             f"through pad positions")
        if cfg.family == "mamba2":
            return self._mamba_prefill(params, self._t(batch["tokens"]))
        if cfg.family == "griffin":
            return self._griffin_prefill(params, self._t(batch["tokens"]),
                                         max_len)
        prefix = batch.get("prefix_embeds")
        if prefix is None:
            return super().prefill(params, batch, max_len)
        if batch.get("lengths") is not None:
            raise ValueError("padded prefill with a VLM prefix: lengths "
                             "would be ambiguous (prefix + text)")
        tokens = self._t(batch["tokens"])
        x, pos, p_len = transformer.embed_inputs(
            params, cfg, tokens, self._t(prefix),
            embed_fn=lambda t: self._embed(params, t, self._positions(t)))
        bsz, t_all = x.shape[0], x.shape[1]
        cache = self.init_cache(bsz, max(max_len, t_all))
        for i in range(cfg.num_layers):
            x, k, v = self._block_full_kv(layer(params["layers"], i), x,
                                          pos, prefix_len=p_len)
            cache["k"][i, :, :t_all] = k
            cache["v"][i, :, :t_all] = v
        cache["len"] = self._ints(None, t_all, bsz)
        return self._head(params, x[:, -1:]), cache

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        return torch.arange(tokens.shape[1], device=self.device)[None, :]

    # ---- serving: the recurrent blocks on this rank's width -------------
    def _sum(self):
        """The sum over "model" where the recurrent width is split."""
        tp = self.tp
        return (lambda t: tp.sum(t, "model")) if tp is not None and tp.rec \
            else None

    def _mamba(self, p: dict, x, ssm=None, conv=None, decode=False):
        return mamba2.apply_mamba2_block(
            p, x, self.cfg, ssm, conv, decode, reduce=self._sum(),
            out=lambda h, w: self._out(h, w, self.cfg.d_inner))

    def _rec_block(self, rec: dict, x, rnn=None, conv=None, decode=False,
                   rows=None) -> tuple:
        """A whole griffin recurrent block (the RG-LRU half, then norm +
        MLP) on this rank's width; returns (x, rnn state, conv state)."""
        x, rnn_s, conv_s = griffin.apply_rglru_block(
            rec["rglru"], x, self.cfg, rnn, conv, decode,
            out=lambda h, w: self._out(h, w, self.cfg.rnn_dim))
        return x + self._mlp(rec, x, rows), rnn_s, conv_s

    def _mamba_prefill(self, params: dict, tokens: torch.Tensor):
        cfg = self.cfg
        bsz, t = tokens.shape
        x = self._embed(params, tokens, self._positions(tokens))
        ssm, conv = [], []
        for i in range(cfg.num_layers):
            x, s, c = self._mamba(layer(params["layers"], i), x)
            ssm.append(s)
            conv.append(c)
        cache = {"ssm": torch.stack(ssm), "conv": torch.stack(conv),
                 "len": self._ints(None, t, bsz)}
        return self._head(params, x[:, -1:]), cache

    def _griffin_prefill(self, params: dict, tokens: torch.Tensor,
                         max_len: int):
        """The whole prompt, then the ring buffer: position p of the last
        ``w = min(max_len, window)`` lands in slot p % w (a roll by T % w
        when T > w)."""
        cfg = self.cfg
        bsz, t = tokens.shape
        pos = self._positions(tokens)
        x = self._embed(params, tokens, pos)
        cache = self.init_cache(bsz, max_len)
        w = cache["k"].shape[2]
        ai = ri = 0
        for blk in params["layers"]:
            if "kind_attn" in blk:
                x, k, v = self._block_full_kv(blk["kind_attn"], x, pos,
                                              window=cfg.window)
                for key, val in (("k", k), ("v", v)):
                    if t <= w:
                        cache[key][ai, :, :t] = val
                    else:
                        cache[key][ai] = torch.roll(val[:, t - w:], t % w,
                                                    dims=1)
                ai += 1
            else:
                x, cache["rnn"][ri], cache["conv"][ri] = self._rec_block(
                    blk["kind_rec"], x)
                ri += 1
        cache["len"] = self._ints(None, t, bsz)
        return self._head(params, x[:, -1:]), cache

    def prefill_chunk(self, params: dict, batch: dict, cache, offset, *,
                      last_only: bool = False):
        if not self.supports_chunked_prefill:
            raise NotImplementedError(
                f"chunked prefill: unsupported for family={self.cfg.family} "
                f"window={self.cfg.window}")
        return super().prefill_chunk(params, batch, cache, offset,
                                     last_only=last_only)

    # ---- serving: decode -------------------------------------------------
    def decode_step(self, params: dict, token, cache):
        """token (B, 1) -> (logits (B, 1, vocab), cache), updated in place.
        A recurrent cache's ``len`` counts positions without saturating
        (griffin's ring wraps at its size)."""
        cfg = self.cfg
        if cfg.family == "audio":
            raise ValueError(ENCODER_ONLY)
        if cfg.family not in RECURRENT:
            return super().decode_step(params, token, cache)
        token = self._t(token)
        rows = self._rows(token.shape[0])
        if rows is not None:
            token = token[rows]          # the cache holds only these rows
        cur_len = cache["len"]
        x = self._embed(params, token, cur_len[:, None])
        if cfg.family == "mamba2":
            for i in range(cfg.num_layers):
                x, cache["ssm"][i], cache["conv"][i] = self._mamba(
                    layer(params["layers"], i), x, cache["ssm"][i],
                    cache["conv"][i], decode=True)
        else:
            ai = ri = 0
            for blk in params["layers"]:
                if "kind_attn" in blk:
                    x = self._block_decode(blk["kind_attn"], x,
                                           (cache["k"][ai], cache["v"][ai]),
                                           cur_len, rows)
                    ai += 1
                else:
                    x, cache["rnn"][ri], cache["conv"][ri] = self._rec_block(
                        blk["kind_rec"], x, cache["rnn"][ri],
                        cache["conv"][ri], decode=True, rows=rows)
                    ri += 1
        cache["len"] = (cur_len + 1).to(torch.int32)
        return self._head(params, self._gather_rows(x, rows)), cache

    # ---- sharding ------------------------------------------------------
    def param_logical_axes(self) -> dict:
        """Logical axis names of every parameter (the tree's structure),
        the reference's table: q/k/v and the MLP's up-projections split
        their outputs ("heads" / "kv_heads" / "mlp"), wo and w_down their
        inputs, the embedding and head the vocabulary; "fsdp_embed" marks
        the input-feature axes FSDP would split."""
        cfg = self.cfg
        L = ("layers",)

        def norm_ax(stacked: bool):
            base = {"scale": (L if stacked else ()) + (None,)}
            if cfg.norm == "layernorm":
                base["bias"] = (L if stacked else ()) + (None,)
            return base

        def mlp_ax(stacked: bool):
            pre = L if stacked else ()
            ax = {"w_up": pre + ("fsdp_embed", "mlp"),
                  "w_down": pre + ("mlp", "fsdp_embed")}
            if cfg.act in ("swiglu", "geglu"):
                ax["w_gate"] = pre + ("fsdp_embed", "mlp")
            return ax

        def attn_ax(stacked: bool):
            pre = L if stacked else ()
            ax = {"ln_attn": norm_ax(stacked),
                  "wq": pre + ("fsdp_embed", "heads"),
                  "wk": pre + ("fsdp_embed", "kv_heads"),
                  "wv": pre + ("fsdp_embed", "kv_heads"),
                  "wo": pre + ("heads", "fsdp_embed"),
                  "ln_mlp": norm_ax(stacked)}
            if cfg.qkv_bias:
                ax["bq"] = pre + ("heads",)
                ax["bk"] = pre + ("kv_heads",)
                ax["bv"] = pre + ("kv_heads",)
            if cfg.num_experts:
                ax["moe"] = {"router": pre + ("fsdp_embed", None),
                             "w_up": pre + ("expert", "fsdp_embed", None),
                             "w_down": pre + ("expert", None, "fsdp_embed")}
                if cfg.act in ("swiglu", "geglu"):
                    ax["moe"]["w_gate"] = pre + ("expert", "fsdp_embed",
                                                 None)
            else:
                ax["mlp"] = mlp_ax(stacked)
            return ax

        if cfg.family == "mamba2":
            lx = {"norm": norm_ax(True),
                  "in_proj": L + ("fsdp_embed", "inner"),
                  "conv_w": L + (None, "inner"),
                  "conv_b": L + ("inner",),
                  "a_log": L + (None,),
                  "d_skip": L + (None,),
                  "dt_bias": L + (None,),
                  "gate_norm": {"scale": L + (None,)},
                  "out_proj": L + ("inner", "fsdp_embed")}
        elif cfg.family == "griffin":
            lx = []
            for i in range(cfg.num_layers):
                if griffin_is_attn(cfg, i):
                    lx.append({"kind_attn": attn_ax(False)})
                    continue
                lx.append({"kind_rec": {
                    "rglru": {"norm": norm_ax(False),
                              "w_rec": ("fsdp_embed", "rnn"),
                              "w_gate": ("fsdp_embed", "rnn"),
                              "conv_w": (None, "rnn"),
                              "conv_b": ("rnn",),
                              "gate_a_w": ("rnn",), "gate_a_b": ("rnn",),
                              "gate_x_w": ("rnn",), "gate_x_b": ("rnn",),
                              "lam": ("rnn",),
                              "w_out": ("rnn", "fsdp_embed")},
                    "ln_mlp": norm_ax(False),
                    "mlp": mlp_ax(False)}})
        else:
            lx = attn_ax(True)
        axes = {"embed": ("vocab", "fsdp_embed"), "layers": lx,
                "ln_f": norm_ax(False)}
        if not cfg.tie_embeddings:
            axes["head"] = ("fsdp_embed", "vocab")
        return axes

    def _mamba_segments(self, tp) -> dict:
        """mamba2's concatenated leaves cut component by component
        (:mod:`repro_torch.sharding`'s docstring states the layout): by SSD
        heads over "model" where ``tp.rec``, else every component whole."""
        cfg = self.cfg
        ax = "model" if tp is not None and tp.rec else None
        gn = cfg.ssm_ngroups * cfg.ssm_state
        bc_ax = ax if ax and cfg.ssm_ngroups % tp.m == 0 else None
        di, h = cfg.d_inner, cfg.ssm_heads
        xbc = ((di, ax), (gn, bc_ax), (gn, bc_ax))
        heads = Segments(((h, ax),))
        return {"in_proj": Segments(((di, ax),) + xbc + ((h, ax),)),
                "conv": Segments(xbc), "heads": heads,
                "inner": Segments(((di, ax),))}

    def param_cuts(self, tp) -> Optional[dict]:
        """mamba2's leaves cut component by component (None for the other
        families)."""
        if self.cfg.family != "mamba2":
            return None
        seg = self._mamba_segments(tp)
        return {"layers": {"in_proj": seg["in_proj"], "conv_w": seg["conv"],
                           "conv_b": seg["conv"], "a_log": seg["heads"],
                           "d_skip": seg["heads"], "dt_bias": seg["heads"],
                           "gate_norm": {"scale": seg["inner"]}}}

    def cache_cuts(self, tp) -> Optional[dict]:
        """mamba2's conv state cut as its ``conv_w`` (None otherwise)."""
        if self.cfg.family != "mamba2":
            return None
        return {"conv": self._mamba_segments(tp)["conv"]}

    def cache_logical_axes(self, cache) -> dict:
        """Logical axes of a decode cache: K/V split over their KV heads
        ("cache_heads"), positions whole on every rank; a paged cache's by
        field (:func:`~repro_torch.serve.kv_cache.paged_cache_logical_axes`).
        """
        from repro_torch.serve.kv_cache import (PagedKVCache,
                                                paged_cache_logical_axes)
        if isinstance(cache, PagedKVCache):
            return paged_cache_logical_axes(cache)
        axes: dict = {"len": ("batch",)}
        if "k" in cache:
            axes["k"] = ("layers", "batch", None, "cache_heads", None)
            axes["v"] = ("layers", "batch", None, "cache_heads", None)
        if "ssm" in cache:
            axes["ssm"] = ("layers", "batch", "ssm_heads", None, None)
            axes["conv"] = ("layers", "batch", None, "act_inner")
        if "rnn" in cache:
            axes["rnn"] = ("layers", "batch", "act_rnn")
            axes["conv"] = ("layers", "batch", None, "act_rnn")
        return axes


def build_model(cfg: ModelConfig, device="cuda", mode: str = "auto") -> Model:
    return Model(cfg, device, mode)
