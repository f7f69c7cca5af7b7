"""Port parity for the OPT family (opt-micro): LayerNorm, the ReLU MLP,
sinusoidal positions and ``chunked_attention`` against ``repro.models``;
the float forward and loss; ``QuantizedModel`` over the linear and paged
caches at kv8 and kv4 against the reference's ``QuantizedModel(kernel_mode=
"ref")``; OPT trees through the npz checkpoints both ways; and chunked
prefill against the whole prompt inside the port.
OPT calibration is in ``test_torch_opt_calibration.py``.

Every LayerNorm scale and bias and every qkv bias is perturbed with seeded
noise (the init leaves them 1 and 0, which would hide their paths).

Tolerances: LayerNorm, the MLP and attention within 1e-5 of their
magnitude (float32 summation order; the port's norm sums in float64);
``sinusoidal_at`` within 3.1e-5 absolute below position 512: the port
takes pow, sin and cos in float64 and rounds once, XLA in float32, whose
pow misses the rounded value for 1 of d 768's 384 frequencies, which
moves that angle by one ulp (3.05e-5 between 256 and 512 rad); the float
logits within 1e-5 of the largest logit and the loss within 1e-6
relative.  The packed
model: codes, scales and zero points of the packed tree byte-equal to the
reference's, logits within 1e-5 of the largest logit at a16 and 1e-4 at
a4 (room for summation order, not for a moved activation code), greedy
tokens equal.  Chunked == whole: the same cache bytes and last-token
logits within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.serve import kv_cache as jkvc
from repro.serve.quantized import QuantizedModel as JQuantizedModel
from repro.serve.quantized import quantize_lm_packed as jquantize_lm_packed
from repro.train import checkpoints as jckpt
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.quantizer import QuantConfig
from repro_torch.models import attention, layers, transformer
from repro_torch.models.init import layer
from repro_torch.models.model import build_model
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.quantized import QuantizedModel, quantize_lm_packed
from repro_torch.train import checkpoints


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small shapes: as fast alone,
    and under parallel test workers torch does not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = torch.from_numpy
ARCH = "opt-micro"


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _perturb(params: dict, rng) -> dict:
    """Seeded noise on every LayerNorm scale and bias and qkv bias."""
    f = lambda t: t + 0.1 * torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32))
    lp = params["layers"]
    for norm in ("ln_attn", "ln_mlp"):
        lp[norm] = {k: f(v) for k, v in lp[norm].items()}
    for b in ("bq", "bk", "bv"):
        lp[b] = f(lp[b])
    params["ln_f"] = {k: f(v) for k, v in params["ln_f"].items()}
    return params


@pytest.fixture(scope="module")
def opt():
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    tparams = _perturb(build_model(tcfg, "cpu").init(3),
                       np.random.default_rng(4))
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     tparams)
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def test_registry_matches_reference():
    for name in ("opt-125m", "opt-mini", "opt-micro"):
        j, t = jget_config(name), get_config(name)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
    c = get_config("opt-125m")
    assert (c.num_layers, c.d_model, c.num_heads, c.resolved_head_dim,
            c.d_ff, c.vocab_size) == (12, 768, 12, 64, 3072, 50272)


def test_layernorm_relu_mlp_and_positions_match_reference(opt):
    jcfg, _, jparams, tparams, _ = opt
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 9, jcfg.d_model)) * 3 + 1).astype(
        np.float32)
    for norm in ("ln_attn", "ln_mlp"):
        jp = jax.tree_util.tree_map(lambda t: t[0], jparams["layers"][norm])
        tp = layer(tparams["layers"][norm], 0)
        assert sorted(tp) == ["bias", "scale"]
        np.testing.assert_allclose(
            layers.apply_norm(tp, T(x), "layernorm").numpy(),
            np.asarray(jlayers.apply_norm(jp, jnp.asarray(x), "layernorm")),
            rtol=1e-5, atol=1e-5)
    jmlp = jax.tree_util.tree_map(lambda t: t[0], jparams["layers"]["mlp"])
    assert sorted(jmlp) == ["w_down", "w_up"]
    np.testing.assert_allclose(
        layers.apply_mlp(layer(tparams["layers"]["mlp"], 0), T(x),
                         "relu").numpy(),
        np.asarray(jlayers.apply_mlp(jmlp, jnp.asarray(x), "relu")),
        rtol=1e-5, atol=1e-5)
    pos = np.array([[0, 1, 7, 63], [100, 511, 3, 2]], np.int32)
    for d in (jcfg.d_model, 768):
        want = np.asarray(jtransformer.sinusoidal_at(jnp.asarray(pos), d))
        got = transformer.sinusoidal_at(T(pos), d).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=3.1e-5)
        np.testing.assert_allclose(
            transformer._sinusoidal(64, d).numpy(),
            np.asarray(jtransformer._sinusoidal(64, d)), rtol=0, atol=3.1e-5)


def test_sinusoidal_rows_do_not_depend_on_the_shape():
    """A position gets the same bits alone, in a chunk and in the whole
    table (prefill chunks and decode steps see the same positions)."""
    whole = transformer._sinusoidal(97, 128)
    alone = torch.cat([transformer.sinusoidal_at(torch.tensor([p]), 128)
                       for p in range(97)])
    chunks = torch.cat([transformer.sinusoidal_at(torch.arange(c, c + 8),
                                                  128)
                        for c in range(0, 97, 8)])[:97]
    assert torch.equal(whole, alone) and torch.equal(whole, chunks)


@pytest.mark.parametrize("g", [1, 2])
def test_chunked_attention_matches_reference(g):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 64, 2 * g, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=16, block_kv=16))
    got = attention.chunked_attention(T(q), T(k), T(v), 16, 16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(
        got, attention.dense_attention(T(q), T(k), T(v)).numpy(),
        rtol=1e-5, atol=2e-6)


def test_forward_and_loss_match_reference(opt):
    jcfg, tcfg, jparams, tparams, tokens = opt
    want = np.asarray(jax.jit(jbuild_model(jcfg).forward)(
        jparams, {"tokens": jnp.asarray(tokens)}))
    tm = build_model(tcfg, "cpu")
    got = tm.forward(tparams, {"tokens": tokens}).numpy()
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < 1e-5, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    jl = float(jlayers.cross_entropy(jnp.asarray(want[:, :-1]),
                                     jnp.asarray(tokens[:, 1:])))
    assert float(tm.loss(tparams, {"tokens": tokens})) == pytest.approx(
        jl, rel=1e-6)


# ---------------------------------------------------------------------------
# the packed model against the reference's, linear and paged, kv8 and kv4
# ---------------------------------------------------------------------------

SETTINGS = {"w4a4kv8": dict(a_bits=4, kv_bits=8, tol=1e-4),
            "w4a16kv4": dict(a_bits=16, kv_bits=4, tol=1e-5)}


@pytest.fixture(scope="module", params=list(SETTINGS))
def packed(request, opt):
    jcfg, tcfg, jparams, tparams, tokens = opt
    s = SETTINGS[request.param]
    jq = JQuantConfig(w_bits=4, a_bits=s["a_bits"], group_size=32, lwc=False,
                      kv_bits=s["kv_bits"])
    tq = QuantConfig(w_bits=4, a_bits=s["a_bits"], group_size=32,
                     kv_bits=s["kv_bits"])
    jp = jquantize_lm_packed(jparams, jcfg, jq)
    tp = quantize_lm_packed(tparams, tcfg, tq)
    return (JQuantizedModel(jcfg, jq, kernel_mode="ref"), jp,
            QuantizedModel(tcfg, tq, device="cpu"), tp, s["tol"], tokens)


def test_packed_tree_byte_equal_to_reference(packed):
    _, jp, _, tp, _, _ = packed
    jl, tl = jp["layers"], tp["layers"]
    names = [(jl[k], tl[k]) for k in ("wq", "wk", "wv", "wo")]
    names += [(jl["mlp"][k], tl["mlp"][k]) for k in ("w_up", "w_down")]
    assert "w_gate" not in tl["mlp"] and "w_gate" not in jl["mlp"]
    for j, t in names:
        assert (t.bits, t.group_size) == (j.bits, j.group_size)
        for f in ("packed", "scale", "zp"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))


def test_opt_trees_cross_the_checkpoints_both_ways(opt, packed, tmp_path):
    """The reference's float and packed OPT trees (LayerNorm and qkv
    biases, no ``w_gate``) read by ``load_tree`` byte for byte, QTensor
    bits and groups recovered; the port's packed tree written by
    ``checkpoints.save`` restored by the reference byte for byte."""
    jcfg, tcfg, jparams, tparams, _ = opt
    _, jp, tm, tp, _, _ = packed
    leaves = lambda tree: {k: np.asarray(v) for k, v in
                           jckpt._flatten(tree).items()}
    for name, jtree, ttree in (("float", jparams, tparams),
                               ("packed", jp, tp)):
        jckpt.save(tmp_path / name, 0, jtree)
        got = checkpoints.load_tree(tmp_path / name, tcfg, tm.qcfg,
                                    device="cpu")
        want = checkpoints.flatten(ttree)
        back = checkpoints.flatten(got)
        assert sorted(back) == sorted(want) == sorted(leaves(jtree))
        for k, (a, _) in want.items():
            assert back[k][0].tobytes() == a.tobytes(), (name, k)
    assert "bias" in got["layers"]["ln_attn"] and "bq" in got["layers"]
    for k in ("wq", "wo"):
        assert (got["layers"][k].bits, got["layers"][k].group_size) == \
            (tp["layers"][k].bits, tp["layers"][k].group_size)
    checkpoints.save(tmp_path / "port", 2, tp)
    restored, step = jckpt.restore(tmp_path / "port", jp)
    assert step == 2
    want, back = leaves(jp), leaves(restored)
    assert sorted(back) == sorted(want)
    for k in want:
        assert back[k].tobytes() == want[k].tobytes(), k


def test_linear_cache_matches_reference(packed):
    """Prefill of prompts 16 and 11, then 8 teacher-forced decode steps."""
    jm, jp, tm, tp, tol, tokens = packed
    lengths = np.asarray([16, 11], np.int32)
    jpre = jax.jit(jm.prefill, static_argnames=("max_len",))
    jstep = jax.jit(jm.decode_step)
    lg, jcache = jpre(jp, {"tokens": jnp.asarray(tokens[:, :16]),
                           "lengths": jnp.asarray(lengths)}, max_len=64)
    want = [np.asarray(lg)]
    tl, tcache = tm.prefill(tp, {"tokens": T(tokens[:, :16]),
                                 "lengths": T(lengths)}, max_len=64)
    got = [tl.numpy()]
    for i in range(8):
        tok = tokens[:, 16 + i:17 + i]
        lg, jcache = jstep(jp, jnp.asarray(tok), jcache)
        tl, tcache = tm.decode_step(tp, T(tok), tcache)
        want.append(np.asarray(lg))
        got.append(tl.numpy())
    want, got = np.concatenate(want, 1), np.concatenate(got, 1)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < tol, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_paged_cache_matches_reference(packed):
    """Paged prefill of prompts 13 and 6 in one chunk, then 8 decode steps
    growing pages of 4 at their boundaries, through both page stores:
    page tables equal, logits within tolerance, greedy tokens equal."""
    jm, jp, tm, tp, tol, toks = packed
    ps, lens = 4, np.asarray([13, 6], np.int32)
    jstore = jkvc.PagedCache(jm, max_batch=2, max_len=32, page_size=ps)
    tstore = kvc.PagedCache(tm, max_batch=2, max_len=32, page_size=ps)
    for slot, n in enumerate(lens):
        assert jstore.reserve(slot, int(n)) and tstore.reserve(slot, int(n))
    chunk = jax.jit(jm.prefill_chunk, static_argnames=("last_only",))
    step = jax.jit(jm.decode_step)
    first = toks[:, :13] * (np.arange(13)[None] < lens[:, None])
    want, jstore.cache = chunk(jp, {"tokens": jnp.asarray(first),
                                    "chunk_len": jnp.asarray(lens)},
                               jstore.cache, jnp.zeros(2, jnp.int32),
                               last_only=True)
    got, tstore.cache = tm.prefill_chunk(
        tp, {"tokens": T(first), "chunk_len": T(lens)}, tstore.cache,
        torch.zeros(2, dtype=torch.int32), last_only=True)
    wants, gots = [np.asarray(want)], [got.numpy()]
    cur = lens.copy()
    for i in range(8):
        for slot in range(2):
            assert jstore.ensure_append(slot, int(cur[slot]))
            assert tstore.ensure_append(slot, int(cur[slot]))
        tok = toks[:, 13 + i:14 + i]
        want, jstore.cache = step(jp, jnp.asarray(tok), jstore.cache)
        got, tstore.cache = tm.decode_step(tp, T(tok), tstore.cache)
        wants.append(np.asarray(want))
        gots.append(got.numpy())
        cur += 1
    np.testing.assert_array_equal(tstore.cache.page_table.numpy(),
                                  np.asarray(jstore.cache.page_table))
    want, got = np.concatenate(wants, 1), np.concatenate(gots, 1)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < tol, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    tstore.verify()


def test_chunked_prefill_equals_whole_prompt(packed):
    """8-row chunks at their offsets (the positions follow the offset)
    give the whole prompt's cache bytes and last-token logits; a paged
    decode step then equals the linear one bit for bit."""
    _, _, tm, tp, _, toks = packed
    tokens = T(toks[:, :20])
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
    for key in wcache:
        assert torch.equal(cache[key], wcache[key]), key
    torch.testing.assert_close(last[2][0], whole[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(last[1][1], whole[1], rtol=1e-5, atol=1e-5)
    lin = dataclasses.replace(tm, block_kv=8)
    store = kvc.PagedCache(lin, max_batch=2, max_len=64, page_size=8)
    for slot in range(2):
        assert store.reserve(slot, int(lengths[slot]))
        store.splice(slot, wcache, slot, int(lengths[slot]))
        assert store.ensure_append(slot, int(lengths[slot]))
    tok = whole[:, -1:].argmax(-1).to(torch.int32)
    dl, _ = lin.decode_step(tp, tok, wcache)
    dp, _ = lin.decode_step(tp, tok, store.cache)
    assert torch.equal(dl, dp)
