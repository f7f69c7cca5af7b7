"""Port parity: the float dense llama path (dense attention, the SwiGLU
MLP, the full-sequence block, ``forward``, the LM loss and the cross
entropy) against the reference on the same bridged weights and tokens.

Tolerances: float32 summation order and transcendental ulps (exp, silu,
rsqrt) differ between XLA and PyTorch; over two layers the logits stay
within 1e-5 of their largest magnitude and the loss within 1e-6
relative.  Greedy tokens must agree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.models import attention, layers, transformer
from repro_torch.models.model import build_model


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=[2], ids=["gqa"])
def setup(request):
    jcfg = dataclasses.replace(jget_config("llama-micro"),
                               num_kv_heads=request.param)
    tcfg = dataclasses.replace(get_config("llama-micro"),
                               num_kv_heads=request.param)
    tparams = build_model(tcfg, "cpu").init(request.param)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     tparams)
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (3, 40)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def test_forward_and_loss_match_reference(setup):
    jcfg, tcfg, jparams, tparams, tokens = setup
    jm = jbuild_model(jcfg)
    tm = build_model(tcfg, "cpu")
    want = np.asarray(jm.forward(jparams, {"tokens": jnp.asarray(tokens)}))
    got = tm.forward(tparams, {"tokens": tokens}).numpy()
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < 1e-5, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the reference's lm_loss on these logits (its MoE aux term is 0 here)
    jl = float(jlayers.cross_entropy(jnp.asarray(want[:, :-1]),
                                     jnp.asarray(tokens[:, 1:])))
    tl = float(tm.loss(tparams, {"tokens": tokens}))
    assert tl == pytest.approx(jl, rel=1e-6)


@pytest.mark.parametrize("g", [1, 4])
def test_dense_attention_matches_reference(g):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 24, 2 * g, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 2, 32)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jattn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal=True))
    got = attention.attention(T(q), T(k), T(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


def test_long_sequences_refuse():
    q = torch.zeros((1, attention.CHUNK_THRESHOLD + 1, 1, 8))
    with pytest.raises(NotImplementedError, match="chunked_attention"):
        attention.attention(q, q, q)


def test_mlp_and_cross_entropy_match_reference(setup):
    jcfg, _, jparams, tparams, tokens = setup
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jmlp = jax.tree_util.tree_map(lambda t: t[0], jparams["layers"]["mlp"])
    jmlp["b_up"] = jnp.asarray(rng.standard_normal(jcfg.d_ff), jnp.float32)
    tmlp = from_jax_params(_np(jmlp))
    np.testing.assert_allclose(
        layers.apply_mlp(tmlp, T(x), "swiglu").numpy(),
        np.asarray(jlayers.apply_mlp(jmlp, jnp.asarray(x), "swiglu")),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError):
        layers.apply_mlp(tmlp, T(x), "relu")
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = float(jlayers.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        got = float(layers.cross_entropy(T(logits), T(labels),
                                         None if m is None else T(m)))
        assert got == pytest.approx(want, rel=1e-6)


def test_block_with_merged_biases(setup):
    """A block as a calibrated fake-quant tree holds it: norm biases, qkv
    biases and MLP biases, honoured by presence."""
    from repro.models import transformer as jtransformer
    jcfg, tcfg, jparams, _, _ = setup
    rng = np.random.default_rng(9)
    jb = jax.tree_util.tree_map(lambda t: t[0], jparams["layers"])
    f = lambda *s: jnp.asarray(0.1 * rng.standard_normal(s), jnp.float32)
    hq, hkv = jb["wq"].shape[1], jb["wk"].shape[1]
    jb["ln_attn"]["bias"], jb["ln_mlp"]["bias"] = f(jcfg.d_model), \
        f(jcfg.d_model)
    jb["bq"], jb["bk"], jb["bv"] = f(hq), f(hkv), f(hkv)
    jb["mlp"]["b_gate"], jb["mlp"]["b_up"] = f(jcfg.d_ff), f(jcfg.d_ff)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    pos = np.arange(12)[None]
    want, _, _ = jax.jit(lambda b, x: jtransformer.apply_block_full(
        b, x, jcfg, jnp.asarray(pos), 0, 0, False))(jb, jnp.asarray(x))
    got = transformer.apply_block_full(from_jax_params(_np(jb)), T(x), tcfg,
                                       T(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
