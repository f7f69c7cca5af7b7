"""Port parity: a one-epoch AffineQuant calibration of an opt-micro block
(W4A4 g32: diagonal LayerNorm sites whose shifts merge into the norms'
existing biases and correct ``bq``/``bk``/``bv`` and ``b_up``, and the
headwise ``vo`` site) and its packed finalize, against the reference on
the same numpy block and activations.  The block's LayerNorm scales and
biases and its qkv biases carry seeded noise (the init leaves them 1 and
0, which would hide their paths).

Tolerances, as ``test_torch_calibration.py`` holds llama's: epoch loss
within 1e-5 relative, learned leaves within 1e-4; finalized codes and
zero points byte-equal; scales within one float32 ulp (2.4e-7 relative),
``wv`` / ``wo`` within 1e-6 (their per-head transform sums in another
order than XLA); merged LayerNorm scale and bias byte-equal, the
shift-corrected biases within 1e-5.  The one-ulp scale is ROADMAP queue
3's sigmoid caveat: here 1 of ``w_up``'s 2,048 LWC scales differs by an
ulp on the same transformed weight.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import calibration as jc
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core import calibration as tc
from repro_torch.core.quantizer import QuantConfig
from repro_torch.models.init import layer
from repro_torch.models.model import build_model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = torch.from_numpy


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _perturb(block: dict, rng) -> dict:
    """Seeded noise on the LayerNorm scales and biases and qkv biases."""
    f = lambda t: t + 0.1 * torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32))
    for norm in ("ln_attn", "ln_mlp"):
        block[norm] = {k: f(v) for k, v in block[norm].items()}
    for b in ("bq", "bk", "bv"):
        block[b] = f(block[b])
    return block


@pytest.fixture(scope="module")
def calib():
    jcfg, tcfg = jget_config("opt-micro"), get_config("opt-micro")
    tblock = _perturb(layer(build_model(tcfg, "cpu").init(3)["layers"], 0),
                      np.random.default_rng(4))
    jblock = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    tblock)
    x = np.random.default_rng(1).standard_normal(
        (8, 32, jcfg.d_model)).astype(np.float32)
    mode = dict(w_bits=4, a_bits=4, group_size=32)
    jq, tq = JQuantConfig(lwc=True, **mode), QuantConfig(lwc=True, **mode)
    jcc = jc.CalibConfig(epochs=1, alpha=0.1, batch_size=4)
    tcc = tc.CalibConfig(epochs=1, alpha=0.1, batch_size=4)
    jqp, jlosses = jc.calibrate_block(jblock, jnp.asarray(x), jnp.asarray(x),
                                      jcfg, jq, jcc)
    return dict(jcfg=jcfg, tcfg=tcfg, jblock=jblock, tblock=tblock, x=x,
                jq=jq, tq=tq, jcc=jcc, tcc=tcc, jqp=jqp, jlosses=jlosses)


def _at(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def test_calibrate_block_matches_reference(calib):
    c = calib
    x = T(c["x"])
    qp, losses = tc.calibrate_block(c["tblock"], x, x, c["tcfg"], c["tq"],
                                    c["tcc"])
    assert {n: d["kind"] for n, d in qp["_sites"].items()} == {
        "ln_attn": "diagonal", "vo": "headwise", "ln_mlp": "diagonal"}
    assert sorted(qp["lwc"]) == sorted(c["jqp"]["lwc"])
    assert "mlp/w_gate" not in qp["lwc"]
    np.testing.assert_allclose(losses, c["jlosses"], rtol=1e-5)
    for path, p in tc._learnable(qp):
        want = np.asarray(_at(c["jqp"], path))
        assert np.max(np.abs(p.numpy() - want)) <= 1e-4, path


def test_finalize_packed_matches_eager_reference(calib):
    c = calib
    tqp = from_jax_params(_np(c["jqp"]))
    want = jc.finalize_block(c["jblock"], c["jqp"], c["jcfg"], c["jq"],
                             c["jcc"], deploy="packed")
    got = tc.finalize_block(c["tblock"], tqp, c["tcfg"], c["tq"], c["tcc"],
                            deploy="packed")
    for name in ("wq", "wk", "wv", "wo", "mlp/w_up", "mlp/w_down"):
        j, t = _at(want, name.split("/")), _at(got, name.split("/"))
        assert (t.bits, t.group_size) == (j.bits, j.group_size)
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
        np.testing.assert_array_equal(t.zp.numpy(), np.asarray(j.zp))
        np.testing.assert_allclose(
            t.scale.numpy(), np.asarray(j.scale),
            rtol=1e-6 if name in ("wv", "wo") else 2.4e-7, atol=0)
    assert "w_gate" not in got["mlp"]
    for norm in ("ln_attn", "ln_mlp"):
        assert sorted(got[norm]) == sorted(want[norm]) == ["bias", "scale"]
        for k in want[norm]:
            np.testing.assert_array_equal(got[norm][k].numpy(),
                                          np.asarray(want[norm][k]))
    for key in ("bq", "bk", "bv"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6)
    assert "b_up" in want["mlp"] and "b_up" in got["mlp"]
    np.testing.assert_allclose(got["mlp"]["b_up"].numpy(),
                               np.asarray(want["mlp"]["b_up"]),
                               rtol=1e-5, atol=1e-6)
