"""The reference registry's four other dense archs, GeGLU / GELU, and 3-bit
packed serving, in the port against the reference.

* ``phi4-mini-3.8b``, ``qwen2.5-14b``, ``stablelm-12b`` and ``gemma-2b``
  field by field against ``repro.configs.archs`` (the port computes every
  arch in float32; the reference keeps these four in bfloat16).
* Cut copies keep each arch's structure (its G, qkv bias, RoPE theta, norm,
  MLP, tied or untied head; head_dim cut by 4, stablelm's 40 keeping
  160's D % 64 != 0) at 2 layers and narrow widths.  Float: the port's
  ``Model`` prefill + decode steps against the reference's full-sequence
  forward; packed W4A4 g32 kv8 (on the port's codes; GeGLU's ``w_gate``
  byte-equal to the reference's): the port's prefill + decode steps against
  the reference's ``QuantizedModel(kernel_mode="ref")`` prefill chunk over
  the same tokens.

3-bit serving and GeGLU calibration: ``test_torch_w3_geglu.py``.

Tolerances: the float logits within 1e-5 of the largest logit; packed a4
within 1e-4 (summation order, not a moved activation code); greedy tokens
equal.  GELU: ``torch``'s tanh GELU is not ``jax.nn.gelu(approximate=
True)`` bit for bit: of 1,000,000 draws from N(0, 9), 332,735 differ, by
at most 9.5e-7 absolute and 2.4e-7 |x| (ROADMAP queue 3), which the MLP
tests hold at 1e-5 of the output's magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget_config
from repro.core.qtensor import QTensor as JQTensor
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.core.quantizer import quantize_codes as jquantize_codes
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.serve.quantized import QuantizedModel as JQuantizedModel
from repro_torch.bridge import from_jax_params
from repro_torch.configs import DENSE_ARCHS, get_config
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantizer import QuantConfig
from repro_torch.launch.serve import teacher_forced
from repro_torch.models import layers
from repro_torch.models.model import Model
from repro_torch.serve.quantized import QuantizedModel, quantize_lm_packed

T = torch.from_numpy
ARCHS = ("phi4-mini-3.8b", "qwen2.5-14b", "stablelm-12b", "gemma-2b")
# 2 layers, narrow widths, each arch's G and structure kept
CUTS = {"phi4-mini-3.8b": dict(d_model=96, num_heads=6, num_kv_heads=2,
                               head_dim=32, d_ff=256),
        "qwen2.5-14b": dict(d_model=160, num_heads=10, num_kv_heads=2,
                            head_dim=32, d_ff=256),
        "stablelm-12b": dict(d_model=160, num_heads=8, num_kv_heads=2,
                             head_dim=40, d_ff=256),
        "gemma-2b": dict(d_model=128, num_heads=8, num_kv_heads=1,
                         head_dim=64, d_ff=256)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _to_jax(tree):
    """The port's (packed) tree as the reference's: the same bytes, port
    QTensors as reference QTensors, so both models run on one set of
    codes."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return JQTensor(*(jnp.asarray(t.numpy()) for t in (
            tree.packed, tree.scale, tree.zp)), tree.bits, tree.group_size)
    return jnp.asarray(tree.numpy())


def _byte_equal_to_eager_reference(qt: QTensor, w, jq) -> None:
    """A port QTensor against the reference's eager ``quantize_codes`` of
    the same float weight (under ``jit`` XLA divides through reciprocals;
    ROADMAP queue 3)."""
    j = jquantize_codes(jnp.asarray(w), jq)
    assert (qt.bits, qt.group_size) == (j.bits, j.group_size)
    for f in ("packed", "scale", "zp"):
        np.testing.assert_array_equal(getattr(qt, f).numpy(),
                                      np.asarray(getattr(j, f)))


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cut(name: str):
    kw = dict(CUTS[name], num_layers=2, vocab_size=512)
    return (dataclasses.replace(jget_config(name), dtype="float32", **kw),
            dataclasses.replace(get_config(name), **kw))


@pytest.mark.parametrize("name", ARCHS)
def test_registry_matches_reference(name):
    """Every field the port's config has equals the reference's, but the
    dtype (the port computes in float32)."""
    t, j = get_config(name), jget_config(name)
    assert name in DENSE_ARCHS and t.family == "dense"
    for f in dataclasses.fields(t):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (j.dtype, t.dtype) == ("bfloat16", "float32")
    assert (t.num_heads // t.num_kv_heads, t.resolved_head_dim) == {
        "phi4-mini-3.8b": (3, 128), "qwen2.5-14b": (5, 128),
        "stablelm-12b": (4, 160), "gemma-2b": (8, 256)}[name]


def test_gelu_tanh_within_bound_of_reference():
    """The GELU caveat: ulps apart from ``jax.nn.gelu(approximate=True)``,
    never more than 2.5e-7 |x| (+1e-12)."""
    x = (np.random.default_rng(0).standard_normal(1_000_000) * 3).astype(
        np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    got = F.gelu(T(x), approximate="tanh").numpy()
    d = np.abs(got.astype(np.float64) - want)
    assert np.all(d <= 2.5e-7 * np.abs(x) + 1e-12), d.max()


@pytest.mark.parametrize("act", ["geglu", "gelu"])
def test_gelu_mlps_match_reference(act):
    rng = np.random.default_rng(1)
    p = jlayers.init_mlp(jax.random.PRNGKey(2), 64, 192, act)
    assert ("w_gate" in p) == (act in layers.GATED)
    x = (rng.standard_normal((3, 7, 64)) * 2).astype(np.float32)
    want = np.asarray(jlayers.apply_mlp(p, jnp.asarray(x), act))
    got = layers.apply_mlp(from_jax_params(_np(p)), T(x), act).numpy()
    assert _rel(got, want) < 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def cut(request):
    """(reference cfg, port cfg, reference float tree, port tree, tokens):
    the port's seeded init (the reference's has the same tree and scales),
    norms and biases with seeded noise so their paths show."""
    jcfg, tcfg = _cut(request.param)
    tp = Model(tcfg, "cpu").init(7)
    rng = np.random.default_rng(8)
    noise = lambda t: t + 0.1 * T(rng.standard_normal(tuple(t.shape)
                                                      ).astype(np.float32))
    lp = tp["layers"]
    for k in ("ln_attn", "ln_mlp", "bq", "bk", "bv"):
        if k in lp:
            lp[k] = ({n: noise(v) for n, v in lp[k].items()}
                     if isinstance(lp[k], dict) else noise(lp[k]))
    tokens = rng.integers(0, 512, (2, 24)).astype(np.int32)
    return jcfg, tcfg, _to_jax(tp), tp, tokens


def test_float_logits_match_reference(cut):
    """Prefill of 16 tokens and 8 teacher-forced decode steps against the
    reference's full-sequence forward at the same positions."""
    jcfg, tcfg, jp, tp, tokens = cut
    assert ("head" in tp) == (not tcfg.tie_embeddings)
    assert ("w_gate" in tp["layers"]["mlp"]) == (tcfg.act in layers.GATED)
    want = np.asarray(jax.jit(jbuild_model(jcfg).forward)(
        jp, {"tokens": jnp.asarray(tokens)}))[:, 15:]
    got = teacher_forced(Model(tcfg, "cpu"), tp, T(tokens[:, :16]),
                         T(tokens[:, 16:]), 8, 32).numpy()
    assert _rel(got, want) < 1e-5
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_packed_w4a4_logits_match_reference(cut):
    """W4A4 g32 kv8 on the port's packed codes (the gated MLP's ``w_gate``
    byte-equal to the reference's eager ``quantize_codes``): the port's
    prefill + 8 decode steps against the reference's one prefill chunk
    over the same 24 tokens."""
    jcfg, tcfg, _, tp, tokens = cut
    jq = JQuantConfig(w_bits=4, a_bits=4, group_size=32, lwc=False,
                      kv_bits=8)
    tq = QuantConfig(w_bits=4, a_bits=4, group_size=32, kv_bits=8)
    tpk = quantize_lm_packed(tp, tcfg, tq)
    if tcfg.act == "geglu":
        _byte_equal_to_eager_reference(
            tpk["layers"]["mlp"]["w_gate"],
            tp["layers"]["mlp"]["w_gate"].numpy(), jq)
    jm = JQuantizedModel(jcfg, jq, kernel_mode="ref")
    lg, _ = jax.jit(jm.prefill_chunk)(
        _to_jax(tpk), {"tokens": jnp.asarray(tokens)}, jm.init_cache(2, 32),
        jnp.zeros(2, jnp.int32))
    want = np.asarray(lg)[:, 15:]
    got = teacher_forced(QuantizedModel(tcfg, tq, device="cpu"), tpk,
                         T(tokens[:, :16]), T(tokens[:, 16:]), 8,
                         32).numpy()
    assert _rel(got, want) < 1e-4
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
