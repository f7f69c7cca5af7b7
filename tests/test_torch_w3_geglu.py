"""3-bit packed serving and GeGLU calibration in the port, against the
reference.

* w3 g128 (the paper's W3A16 column) on llama-micro: codes byte-equal to
  the reference's eager ``quantize_codes`` (its ``quantize_lm_packed``
  packs with it), and the port's prefill + decode steps, over the linear
  and the paged cache, against the reference's ``QuantizedModel(
  kernel_mode="ref")`` prefill chunk over the same tokens and codes.  w3
  runs the plain versions on every device, as the reference runs its ref
  math.
* One GeGLU block (a 2-layer gemma-2b cut: G 8, head_dim 64, with an
  untied head) calibrated W4A4 g32 for one epoch against the reference:
  the ``w_gate`` site gets LWC; the untied head passes
  ``quantize_dense_model``, the packed ``finalize_model``, the npz
  checkpoints and the bridge.

Tolerances: w3 a16 logits within 1e-5 of the largest logit, greedy tokens
equal; calibration as ``test_torch_opt_calibration.py`` holds it (epoch
loss within 1e-5 relative, learned leaves within 1e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import calibration as jc
from repro.core.qtensor import QTensor as JQTensor
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.core.quantizer import quantize_codes as jquantize_codes
from repro.serve.quantized import QuantizedModel as JQuantizedModel
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core import calibration as tc
from repro_torch.core import sites
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantizer import QuantConfig
from repro_torch.launch.serve import teacher_forced
from repro_torch.models.init import layer
from repro_torch.models.model import Model
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.quantized import QuantizedModel, quantize_lm_packed
from repro_torch.train import checkpoints

T = torch.from_numpy


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
    """The port's packed tree as the reference's, byte for byte."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return JQTensor(*(jnp.asarray(t.numpy()) for t in (
            tree.packed, tree.scale, tree.zp)), tree.bits, tree.group_size)
    return jnp.asarray(tree.numpy())


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# 3-bit packed serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def w3():
    """The port's w3 g128 tree of a seeded llama-micro, the float tree, and
    the reference's logits over 24 tokens (one prefill chunk on the same
    codes)."""
    jcfg, tcfg = jget_config("llama-micro"), get_config("llama-micro")
    jq = JQuantConfig(w_bits=3, a_bits=16, group_size=128, lwc=False,
                      kv_bits=16)
    tq = QuantConfig(w_bits=3, a_bits=16, group_size=128, kv_bits=16)
    fp = Model(tcfg, "cpu").init(3)
    tp = quantize_lm_packed(fp, tcfg, tq)
    tokens = np.random.default_rng(4).integers(0, 512, (2, 24)).astype(
        np.int32)
    jm = JQuantizedModel(jcfg, jq, kernel_mode="ref")
    lg, _ = jax.jit(jm.prefill_chunk)(
        _to_jax(tp), {"tokens": jnp.asarray(tokens)}, jm.init_cache(2, 32),
        jnp.zeros(2, jnp.int32))
    return (QuantizedModel(tcfg, tq, device="cpu"), tp, fp, jq, tokens,
            np.asarray(lg)[:, 15:])


def test_w3_codes_byte_equal_to_reference(w3):
    """The stacked down projection (three groups along K = 384): packed
    codes, scales and zero points byte-equal to the reference's."""
    _, tp, fp, jq, _, _ = w3
    qt = tp["layers"]["mlp"]["w_down"]
    j = jquantize_codes(jnp.asarray(fp["layers"]["mlp"]["w_down"].numpy()),
                        jq)
    assert (qt.bits, qt.group_size) == (j.bits, j.group_size) == (3, 128)
    assert qt.packed.shape[-2] == 384 // 8 * 3
    for f in ("packed", "scale", "zp"):
        np.testing.assert_array_equal(getattr(qt, f).numpy(),
                                      np.asarray(getattr(j, f)))


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
def test_w3_logits_match_reference(w3, paged):
    """A prompt of 16 (paged: one chunk into pages of 4, the pages grown at
    their boundaries) and 8 decode steps: logits within 1e-5 of the
    reference's, greedy tokens equal."""
    tm, tp, _, _, toks, want = w3
    if not paged:
        got = teacher_forced(tm, tp, T(toks[:, :16]), T(toks[:, 16:]), 8,
                             32).numpy()
    else:
        st = kvc.PagedCache(tm, max_batch=2, max_len=32, page_size=4)
        assert st.reserve(0, 16) and st.reserve(1, 16)
        lg, st.cache = tm.prefill_chunk(tp, {"tokens": T(toks[:, :16])},
                                        st.cache,
                                        torch.zeros(2, dtype=torch.int32),
                                        last_only=True)
        out = [lg]
        for i in range(8):
            for slot in range(2):
                assert st.ensure_append(slot, 16 + i)
            lg, st.cache = tm.decode_step(tp, T(toks[:, 16 + i:17 + i]),
                                          st.cache)
            out.append(lg)
        got = torch.cat(out, 1).numpy()
        st.verify()
    assert _rel(got, want) < 1e-5
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# GeGLU calibration; the untied head through calibration and checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def geglu():
    kw = dict(d_model=128, num_heads=8, num_kv_heads=1, head_dim=64,
              d_ff=256, num_layers=2, vocab_size=512, tie_embeddings=False)
    jcfg = dataclasses.replace(jget_config("gemma-2b"), dtype="float32",
                               **kw)
    tcfg = dataclasses.replace(get_config("gemma-2b"), **kw)
    tparams = Model(tcfg, "cpu").init(5)
    tblock = layer(tparams["layers"], 0)
    jblock = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    tblock)
    x = np.random.default_rng(6).standard_normal(
        (4, 16, jcfg.d_model)).astype(np.float32)
    mode = dict(w_bits=4, a_bits=4, group_size=32)
    jq, tq = JQuantConfig(lwc=True, **mode), QuantConfig(lwc=True, **mode)
    jcc = jc.CalibConfig(epochs=1, alpha=0.1, batch_size=4)
    tcc = tc.CalibConfig(epochs=1, alpha=0.1, batch_size=4)
    jqp, jlosses = jc.calibrate_block(jblock, jnp.asarray(x), jnp.asarray(x),
                                      jcfg, jq, jcc)
    return dict(jcfg=jcfg, tcfg=tcfg, tparams=tparams, tblock=tblock, x=x,
                tq=tq, tcc=tcc, jqp=jqp, jlosses=jlosses)


def test_geglu_block_calibrates_like_reference(geglu):
    """The ``w_gate`` site gets LWC; one epoch's loss within 1e-5 relative
    of the reference's, every learned leaf within 1e-4."""
    c = geglu
    assert "mlp/w_gate" in sites.quantized_weights(c["tcfg"])
    x = T(c["x"])
    qp, losses = tc.calibrate_block(c["tblock"], x, x, c["tcfg"], c["tq"],
                                    c["tcc"])
    assert "mlp/w_gate" in qp["lwc"]
    assert sorted(qp["lwc"]) == sorted(c["jqp"]["lwc"])
    np.testing.assert_allclose(losses, c["jlosses"], rtol=1e-5)
    for path, p in tc._learnable(qp):
        want = c["jqp"]
        for part in path:
            want = want[part]
        assert np.max(np.abs(p.numpy() - np.asarray(want))) <= 1e-4, path


def test_untied_head_passes_calibration_and_checkpoints(geglu, tmp_path):
    """A one-epoch ``quantize_dense_model`` keeps the float head in the
    fake-quant tree, the packed finalize keeps it beside a packed
    ``w_gate``, the npz checkpoint round-trips it byte for byte, and the
    bridge carries the reference's."""
    c = geglu
    tparams, tcfg, ccfg = c["tparams"], c["tcfg"], tc.CalibConfig(
        epochs=1, batch_size=4)
    tokens = T(np.random.default_rng(9).integers(0, 512, (4, 16)))
    fake, info = tc.quantize_dense_model(tparams, tcfg, c["tq"], ccfg,
                                         tokens, log=False)
    assert torch.equal(fake["head"], tparams["head"])
    packed = tc.finalize_model(tparams, info["block_qps"], tcfg, c["tq"],
                               ccfg, deploy="packed")
    assert torch.equal(packed["head"], tparams["head"])
    assert isinstance(packed["layers"]["mlp"]["w_gate"], QTensor)
    checkpoints.save(tmp_path, 0, packed)
    back = checkpoints.load_tree(tmp_path, tcfg, c["tq"], device="cpu")
    assert torch.equal(back["head"], packed["head"])
    assert back["layers"]["mlp"]["w_gate"].bits == 4
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tparams)
    np.testing.assert_array_equal(from_jax_params(_np(jp))["head"].numpy(),
                                  np.asarray(jp["head"]))
