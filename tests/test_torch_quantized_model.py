"""Port parity: ``QuantizedModel`` logits against the reference's
``QuantizedModel(kernel_mode="ref")`` on identical packed codes.

The JAX packed tree (RTN codes of a seeded llama-micro, plus synthetic
``attn_t`` / ``mlp_t`` activation factors and ``bq``/``bk``/``bv`` biases
as a calibrated tree carries them) crosses over through
``repro_torch.bridge.from_jax_params``.

Tolerances (of the largest logit magnitude): the two frameworks differ
only in float32 summation order and transcendental ulps, about 1e-6 at
these seeds: 1e-5 at w4a16/kv16.  At w4a4/kv8 an ulp-level difference
just before a rounding step could move one activation or KV code by one
step (about 1e-3 of the logit range); no code moves at these seeds, and
1e-4 leaves room for summation order only.  Greedy tokens must agree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.models import build_model
from repro.serve.quantized import QuantizedModel as JQuantizedModel
from repro.serve.quantized import _kv_quantize as j_kv_quantize
from repro.serve.quantized import quantize_lm_packed as jquantize_lm_packed
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.quantizer import QuantConfig
from repro_torch.serve.quantized import QuantizedModel, _kv_quantize


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small shapes: as fast alone,
    and under parallel test workers torch does not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SETTINGS = {"w4a16kv16": dict(w_bits=4, a_bits=16, kv_bits=16, tol=1e-5),
            "w4a4kv8": dict(w_bits=4, a_bits=4, kv_bits=8, tol=1e-4)}


def _inject(params, cfg, rng):
    """Synthetic transform factors and biases in the reference's layout."""
    lp = dict(params["layers"])
    L, d = cfg.num_layers, cfg.d_model
    hq = cfg.num_heads * cfg.resolved_head_dim
    hkv = cfg.num_kv_heads * cfg.resolved_head_dim
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    for site in ("attn_t", "mlp_t"):
        lp[site] = {"a_inv": jnp.asarray(np.eye(d, dtype=np.float32)
                                         + 0.05 * f(L, d, d)),
                    "shift": jnp.asarray(0.1 * f(L, d))}
    for name, width in (("bq", hq), ("bk", hkv), ("bv", hkv)):
        lp[name] = jnp.asarray(0.05 * f(L, width))
    return dict(params, layers=lp)


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def setup(request):
    kv_heads = request.param
    jcfg = dataclasses.replace(jget_config("llama-micro"),
                               num_kv_heads=kv_heads)
    tcfg = dataclasses.replace(get_config("llama-micro"),
                               num_kv_heads=kv_heads)
    params = build_model(jcfg).init(jax.random.PRNGKey(kv_heads))
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 24))
    return jcfg, tcfg, params, tokens.astype(np.int32)


def _models(setup, name, group=32):
    jcfg, tcfg, params, _ = setup
    s = SETTINGS[name]
    jq = JQuantConfig(w_bits=s["w_bits"], a_bits=s["a_bits"],
                      group_size=group, lwc=False, kv_bits=s["kv_bits"])
    tq = QuantConfig(w_bits=s["w_bits"], a_bits=s["a_bits"],
                     group_size=group, kv_bits=s["kv_bits"])
    jpacked = _inject(jquantize_lm_packed(params, jcfg, jq), jcfg,
                      np.random.default_rng(1))
    tpacked = from_jax_params(_to_numpy(jpacked))
    return (JQuantizedModel(jcfg, jq, kernel_mode="ref"), jpacked,
            QuantizedModel(tcfg, tq, device="cpu"), tpacked, s["tol"])


class _Jitted:
    """The reference model's entry points under jit (one compile each)."""

    def __init__(self, model):
        self.prefill = jax.jit(model.prefill, static_argnames=("max_len",))
        self.decode_step = jax.jit(model.decode_step)


def _run(model, params, tokens, steps, to_np):
    """Prefill the first 16 tokens (lengths 16 and 11), then teacher-force
    ``steps`` decode tokens; returns stacked logits."""
    lengths = np.asarray([16, 11], np.int32)
    lg, cache = model.prefill(params, {"tokens": tokens[:, :16],
                                       "lengths": lengths}, max_len=64)
    out = [to_np(lg)]
    for i in range(steps):
        lg, cache = model.decode_step(params, tokens[:, 16 + i:17 + i], cache)
        out.append(to_np(lg))
    return np.concatenate(out, axis=1), cache


@pytest.mark.parametrize("name", list(SETTINGS))
def test_logits_match_reference(setup, name):
    jm, jp, tm, tp, tol = _models(setup, name)
    tokens = setup[3]
    want, _ = _run(_Jitted(jm), jp, jnp.asarray(tokens), 8, np.asarray)
    got, _ = _run(tm, tp, torch.from_numpy(tokens), 8,
                  lambda t: t.numpy())
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < tol, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", list(SETTINGS))
def test_chunked_prefill_equals_whole_prompt(setup, name):
    """8-row chunks through prefill_chunk (lengths 20 and 12: the second
    sequence ends in chunk 2 and idles with chunk_len 0 in chunk 3) give
    the whole-prompt cache and last-token logits."""
    _, _, tm, tp, _ = _models(setup, name)
    tokens = torch.from_numpy(setup[3][:, :20])
    lengths = torch.tensor([20, 12], dtype=torch.int32)
    whole, wcache = tm.prefill(tp, {"tokens": tokens, "lengths": lengths},
                               max_len=64)
    cache = tm.init_cache(2, 64)
    done = torch.zeros(2, dtype=torch.int32)
    last = []
    for _ in range(3):
        n = torch.clamp(lengths - done, 0, 8)
        chunk = torch.zeros((2, 8), dtype=torch.int32)
        for b in range(2):
            chunk[b, :n[b]] = tokens[b, done[b]:done[b] + n[b]]
        lg, cache = tm.prefill_chunk(tp, {"tokens": chunk, "chunk_len": n},
                                     cache, done, last_only=True)
        last.append(lg)
        done = done + n
    torch.testing.assert_close(cache["len"], lengths)
    for key in wcache:
        torch.testing.assert_close(cache[key], wcache[key], rtol=0, atol=0)
    torch.testing.assert_close(last[2][0], whole[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(last[1][1], whole[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_capacity_drops_write_and_saturates_len(setup, name):
    _, _, tm, tp, _ = _models(setup, name)
    tokens = torch.from_numpy(setup[3][:, :6])
    _, cache = tm.prefill(tp, {"tokens": tokens}, max_len=8)
    for i in range(2):
        _, cache = tm.decode_step(tp, tokens[:, i:i + 1], cache)
    assert cache["len"].tolist() == [8, 8]
    snap = {k: v.clone() for k, v in cache.items()}
    logits, cache = tm.decode_step(tp, tokens[:, 2:3], cache)
    assert cache["len"].tolist() == [8, 8]
    for key in snap:
        torch.testing.assert_close(cache[key], snap[key], rtol=0, atol=0)
    assert torch.isfinite(logits).all()


def test_kv_quantize_conserves_nan():
    """Codes cannot hold NaN but the scale does, as in the reference."""
    x = np.ones((2, 4, 64), np.float32)
    x[1, 2, 7] = np.nan
    codes, scale = _kv_quantize(torch.from_numpy(x), 8)
    jcodes, jscale = j_kv_quantize(jnp.asarray(x), 8)
    assert codes.dtype == torch.int8
    assert torch.isnan(scale[1, 2]) and np.isnan(np.asarray(jscale)[1, 2])
    keep = ~np.isnan(np.asarray(jscale))
    np.testing.assert_array_equal(scale.numpy()[keep], np.asarray(jscale)[keep])
    np.testing.assert_array_equal(codes.numpy()[keep], np.asarray(jcodes)[keep])
    deq = codes.to(torch.float32) * scale[..., None]
    assert torch.isnan(deq[1, 2]).all() and torch.isfinite(deq[0]).all()


def test_unported_features_raise(setup):
    """The other families are refused: mamba2 and griffin have no
    quantized path (nor in the reference); vlm and audio serve
    (``test_torch_quantized_vlm_audio.py``), and so do 3-bit weights
    (``test_torch_dense_archs.py``)."""
    tcfg = setup[1]
    for family in ("mamba2", "griffin"):
        with pytest.raises(NotImplementedError, match="no quantized path"):
            QuantizedModel(dataclasses.replace(tcfg, family=family),
                           QuantConfig(), device="cpu")
    for family in ("vlm", "audio"):
        QuantizedModel(dataclasses.replace(tcfg, family=family),
                       QuantConfig(), device="cpu")


def test_layerwise_random_packing_equals_packing_the_float_tree():
    """The CLI's one-layer-at-a-time init + RTN packing gives the bytes of
    ``quantize_lm_packed(init_lm(...))`` on the same generator seed, with
    the reference's shapes and init scales."""
    from repro_torch.launch.serve import random_packed_lm
    from repro_torch.models.init import init_lm
    from repro_torch.serve.quantized import quantize_lm_packed
    cfg = dataclasses.replace(get_config("llama-micro"), qkv_bias=True)
    qcfg = QuantConfig(w_bits=4, group_size=32)
    fp = init_lm(cfg, torch.Generator().manual_seed(4), "cpu")
    jfp = build_model(jget_config("llama-micro")).init(jax.random.PRNGKey(0))
    assert fp["embed"].shape == jfp["embed"].shape
    for k in ("wq", "wk", "wv", "wo"):
        assert fp["layers"][k].shape == jfp["layers"][k].shape
        std = 1.0 / np.sqrt(fp["layers"][k].shape[-2])
        assert fp["layers"][k].abs().max() <= 2 * std
    assert abs(fp["embed"].std().item() - 0.02) < 2e-3
    want = quantize_lm_packed(fp, cfg, qcfg)
    got = random_packed_lm(cfg, qcfg, 4, "cpu")
    wl, gl = want["layers"], got["layers"]
    pairs = [(wl[k], gl[k]) for k in ("wq", "wk", "wv", "wo")]
    pairs += [(wl["mlp"][k], gl["mlp"][k]) for k in ("w_gate", "w_up",
                                                     "w_down")]
    for a, b in pairs:
        for name in ("packed", "scale", "zp"):
            assert torch.equal(getattr(a, name), getattr(b, name))
    assert torch.equal(wl["bq"], gl["bq"])
    assert torch.equal(want["embed"], got["embed"])


def test_rtn_pack_refuses_a_symmetric_grid():
    """``ops.quantize_pack`` has no symmetric grid, so ``rtn_pack`` no
    longer refuses one: it packs it through ``quantize_codes``, and the
    packed tree of ``quantize_lm_packed`` at ``symmetric=True`` is byte-equal
    to the reference's ``quantize_lm_packed`` (stacked layers, w4 g32)."""
    from repro_torch.serve.quantized import quantize_lm_packed
    jcfg, tcfg = jget_config("llama-micro"), get_config("llama-micro")
    params = build_model(jcfg).init(jax.random.PRNGKey(9))
    jq = JQuantConfig(w_bits=4, group_size=32, lwc=False, symmetric=True)
    tq = QuantConfig(w_bits=4, group_size=32, symmetric=True)
    jp = jquantize_lm_packed(params, jcfg, jq)
    tp = quantize_lm_packed(from_jax_params(_to_numpy(params)), tcfg, tq)
    pairs = [(jp["layers"][k], tp["layers"][k]) for k in ("wq", "wk", "wv",
                                                           "wo")]
    pairs += [(jp["layers"]["mlp"][k], tp["layers"]["mlp"][k])
              for k in ("w_gate", "w_up", "w_down")]
    for j, t in pairs:
        assert (t.bits, t.group_size) == (4, 32)
        for f in ("packed", "scale", "zp"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
