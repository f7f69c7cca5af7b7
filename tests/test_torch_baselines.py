"""Port parity: the PTQ baselines (``core/baselines.py``: RTN, AWQ, GPTQ,
SmoothQuant and the whole-model pipeline) against the reference's on the
same numpy weights and activations, and the reference tests' orderings.

Tolerances:
* RTN: byte-equal (the quantizer's op order and IEEE quotients).
* AWQ: the same chosen alpha; the layer outputs within 1e-5 relative.
  ``act_max ** alpha`` is ROADMAP queue 3's pow caveat (torch's pow and
  XLA's differ by an ulp for some inputs), so ``s`` can differ by an ulp
  and a code can move one level: at most 1e-3 of the entries.
* GPTQ: both solve in float64 (numpy on the host, torch here), so the
  dequantized weights agree within 1e-9 of their largest magnitude, which
  leaves no room for a moved code (one level is ~1e-1 of it).
* SmoothQuant: within 1e-6 relative (the same pow caveat).
* The whole-model pipeline on opt-micro and llama-micro (4 x 32 calibration
  tokens, w4 g32): RTN trees byte-equal; GPTQ weights within 1e-5 of each
  matrix's largest magnitude (the calibration stream runs through the
  float forward, whose summation order differs by ulps; measured 4.3e-7);
  AWQ weights off by more than 1e-5 of the matrix's largest magnitude in
  at most 1e-4 of the entries (moved codes in rows that 1/s shrinks;
  measured 7 of 393,216 on opt-micro); every method's logits on held-out
  tokens within 1e-5 of the largest logit (measured 1.1e-6) and greedy
  tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import baselines as jb
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.core.quantizer import fake_quant_weight as jfake_quant_weight
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import baselines as tb
from repro_torch.core.quantizer import QuantConfig
from repro_torch.models.model import build_model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = torch.from_numpy


def _correlated_acts(rng, n, d):
    """Activations with a shared low-rank structure and per-channel
    outliers, the regime where Hessian- and scale-aware methods win (the
    reference test's construction, drawn with numpy)."""
    x = rng.standard_normal((n, 8)) @ rng.standard_normal((8, d))
    return (x * np.where(rng.random(d) > 0.95, 8.0, 1.0)).astype(np.float32)


def _qcfgs(bits, g):
    return (JQuantConfig(w_bits=bits, group_size=g, lwc=False),
            QuantConfig(w_bits=bits, group_size=g, lwc=False))


@pytest.mark.parametrize("g", [32, 0])
def test_rtn_byte_equal(g):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 64, 48)).astype(np.float32)
    jq, tq = _qcfgs(4, g)
    got = tb.rtn_quantize_weight(T(w), tq)
    np.testing.assert_array_equal(
        got[1].numpy(),
        np.asarray(jb.rtn_quantize_weight(jnp.asarray(w[1]), jq)))
    assert torch.equal(got[0], tb.rtn_quantize_weight(T(w[0]), tq))


def _reference_alpha(w, x, jq, grid=11):
    """The alpha the reference's loop picks, its candidates recomputed
    with the reference's ops (its function returns only the weight)."""
    xf = jnp.asarray(x)
    act_max = jnp.maximum(jnp.max(jnp.abs(xf), axis=0), 1e-5)
    wf = jnp.asarray(w)
    y_ref = xf @ wf
    best, pick = np.inf, None
    for i in range(grid):
        s = jnp.clip(act_max ** (i / (grid - 1)), 1e-4, 1e4)
        w_eff = (1.0 / s)[:, None] * jfake_quant_weight(s[:, None] * wf, jq)
        err = float(jnp.mean(jnp.square(xf @ w_eff - y_ref)))
        if err < best:
            best, pick = err, (i / (grid - 1), np.asarray(w_eff))
    return pick


@pytest.mark.parametrize("bits,g", [(3, 0), (4, 32)])
def test_awq_same_alpha_and_outputs(bits, g):
    rng = np.random.default_rng(1 + bits)
    w = (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)
    x = _correlated_acts(rng, 128, 64)
    jq, tq = _qcfgs(bits, g)
    want = np.asarray(jb.awq_quantize_weight(jnp.asarray(w), jnp.asarray(x),
                                             jq))
    alpha, w_ref = _reference_alpha(w, x, jq)
    np.testing.assert_array_equal(w_ref, want)
    got_alpha, got = tb.awq_search(T(w), T(x), tq)
    assert got_alpha == alpha
    torch.testing.assert_close(tb.awq_quantize_weight(T(w), T(x), tq), got,
                               rtol=0, atol=0)
    y, y_ref = x @ got.numpy(), x @ want
    assert np.max(np.abs(y - y_ref)) <= 1e-5 * np.max(np.abs(y_ref))
    # a moved code shows as a difference far above the float noise
    moved = np.abs(got.numpy() - want) > 1e-4 * np.abs(want).max()
    assert moved.mean() <= 1e-3


@pytest.mark.parametrize("g", [0, 32, 96, 128])
def test_gptq_matches_float64_reference(g, monkeypatch):
    """Group 32 (inside a block of 64 columns), 96 (straddling blocks)
    and 128 (wider than a block): each column's grid reads the weights as
    the last write-back left them, in both."""
    rng = np.random.default_rng(20 + g)
    w = rng.standard_normal((192, 24))
    x = _correlated_acts(rng, 256, 192)
    x[:, 7] = 0.0                          # a dead input channel
    jq, tq = _qcfgs(4, g)
    # the reference returns float32 (jax without x64): keep its float64
    monkeypatch.setattr(jb, "jnp", type("np64", (), {
        "asarray": staticmethod(lambda a, dtype=None: np.asarray(a))}))
    want = jb.gptq_quantize_weight(w, x.astype(np.float64), jq)
    assert want.dtype == np.float64
    got = tb.gptq_quantize_weight(T(w), T(x.astype(np.float64)), tq).numpy()
    assert got.dtype == np.float64
    assert np.max(np.abs(got - want)) <= 1e-9 * np.max(np.abs(want))
    np.testing.assert_array_equal(got[7], want[7])


def test_smoothquant_transform_matches_reference():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    act_max = np.exp(rng.standard_normal(16)).astype(np.float32)
    jw, js = jb.smoothquant_transform(jnp.asarray(w), jnp.asarray(act_max))
    tw, ts = tb.smoothquant_transform(T(w), T(act_max))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    spread = lambda a: float(np.std(np.log(a)))
    assert spread(act_max / ts.numpy()) < spread(act_max)


# ---------------------------------------------------------------------------
# the reference tests' orderings, on the port
# ---------------------------------------------------------------------------

def _mse(x, w_q, w):
    return float(np.mean(np.square(x @ w_q - x @ w)))


def test_gptq_beats_rtn_and_awq_never_loses():
    rng = np.random.default_rng(0)
    x = _correlated_acts(rng, 256, 64)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    _, tq = _qcfgs(3, 0)
    rtn = tb.rtn_quantize_weight(T(w), tq).numpy()
    gptq = tb.gptq_quantize_weight(T(w), T(x), tq).numpy()
    assert _mse(x, gptq, w) < _mse(x, rtn, w)
    w = w * 0.1
    rtn = tb.rtn_quantize_weight(T(w), tq).numpy()
    awq = tb.awq_quantize_weight(T(w), T(x), tq).numpy()
    assert _mse(x, awq, w) <= _mse(x, rtn, w)


def test_gptq_high_bits_near_lossless():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    _, tq = _qcfgs(8, 0)
    w_q = tb.gptq_quantize_weight(T(w), T(x), tq).numpy()
    assert np.linalg.norm(w_q - w) / np.linalg.norm(w) < 0.01


# ---------------------------------------------------------------------------
# the whole-model pipeline against the reference's
# ---------------------------------------------------------------------------

def _linears(tree):
    lp = tree["layers"]
    out = {k: lp[k] for k in ("wq", "wk", "wv", "wo")}
    out.update({f"mlp/{k}": v for k, v in lp["mlp"].items()})
    return out


@pytest.fixture(scope="module", params=["opt-micro", "llama-micro"])
def arch(request):
    tcfg, jcfg = get_config(request.param), jget_config(request.param)
    tparams = build_model(tcfg, "cpu").init(5)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     tparams)
    rng = np.random.default_rng(7)
    calib = rng.integers(0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    test = rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    return tcfg, jcfg, tparams, jparams, calib, test


def _jit_stream(monkeypatch, jcfg):
    """The reference pipeline's float block forwards (the calibration stream
    and the linears' inputs) under one ``jit`` each, in place of op-by-op
    dispatch: the same functions, compiled once, so the test spends its
    time on the baselines and not on compiling single ops."""
    from repro.models import transformer as jtransformer
    block = jax.jit(jtransformer.apply_block_full,
                    static_argnums=(2, 4, 5, 6))
    inputs = jax.jit(jb.block_linear_inputs, static_argnums=(2,))
    monkeypatch.setattr(jtransformer, "apply_block_full", block)
    monkeypatch.setattr(jb, "block_linear_inputs", inputs)


@pytest.mark.parametrize("method", ["rtn", "awq", "gptq"])
def test_quantize_model_baseline_matches_reference(arch, method,
                                                   monkeypatch):
    tcfg, jcfg, tparams, jparams, calib, test = arch
    jq, tq = _qcfgs(4, 32)
    _jit_stream(monkeypatch, jcfg)
    want = jb.quantize_model_baseline(jparams, jcfg, jq, jnp.asarray(calib),
                                      method)
    info: dict = {}
    got = tb.quantize_model_baseline(tparams, tcfg, tq, T(calib), method,
                                     info=info)
    assert len(info["block_seconds"]) == tcfg.num_layers
    wl, gl = _linears(want), _linears(got)
    assert sorted(wl) == sorted(gl)
    assert ("mlp/w_gate" in gl) == (tcfg.act == "swiglu")
    for k in wl:
        a, b = np.asarray(wl[k]), gl[k].numpy()
        off = np.abs(b - a) > 1e-5 * np.abs(a).max()
        if method == "rtn":
            np.testing.assert_array_equal(b, a)
        elif method == "gptq":
            assert not off.any(), k
        else:
            assert off.mean() <= 1e-4, (k, off.sum())
    for norm in ("ln_attn", "ln_mlp"):     # untouched
        assert torch.equal(got["layers"][norm]["scale"],
                           tparams["layers"][norm]["scale"])
    a = np.asarray(jax.jit(jbuild_model(jcfg).forward)(
        want, {"tokens": jnp.asarray(test)}))
    b = build_model(tcfg, "cpu").forward(got, {"tokens": test}).numpy()
    assert np.max(np.abs(b - a)) <= 1e-5 * np.max(np.abs(a))
    np.testing.assert_array_equal(b.argmax(-1), a.argmax(-1))
    if method != "rtn":
        for blk in info["linear_mse"]:
            assert sorted(blk) == sorted(wl)
            for k, (mse, rtn_mse) in blk.items():
                if method == "awq":
                    assert mse <= rtn_mse, k
        if method == "gptq":
            assert all(sum(m for m, _ in blk.values())
                       < sum(r for _, r in blk.values())
                       for blk in info["linear_mse"])


def test_calibrate_cli_runs_the_baselines(tmp_path):
    """``--method rtn`` writes a packed tree whose codes are the fake-quant
    tree's (packed through quantize_pack, dequantized bit for bit); awq
    and gptq write none and say why."""
    import json

    from repro_torch.launch import calibrate as cli
    from repro_torch.serve.quantized import QuantizedModel
    base = ["--arch", "opt-micro", "--device", "cpu", "--wbits", "4",
            "--group", "32", "--calib-samples", "4", "--calib-seq", "16",
            "--out", str(tmp_path)]
    out = cli.calibrate(cli.build_parser().parse_args(base + ["--method",
                                                              "rtn"]))
    assert not out["qcfg"].lwc
    fake, packed = _linears(out["fake"]), _linears(out["packed"])
    for k in fake:
        torch.testing.assert_close(packed[k].dequantize(), fake[k], rtol=0,
                                   atol=0)
    QuantizedModel(out["cfg"], dataclasses.replace(out["qcfg"], kv_bits=8),
                   device="cpu")
    for method in ("awq", "gptq"):
        assert cli.main(base + ["--method", method]) == 0
        name = f"opt-micro-{method}-w4a16g32kv16"
        report = json.loads((tmp_path / f"{name}.json").read_text())
        assert "not packed" in report["packed"]
        assert {"fp_ppl", "quant_ppl", "block_seconds"} <= set(report)
        assert (tmp_path / name).exists()
        assert not (tmp_path / f"{name}-packed").exists()
