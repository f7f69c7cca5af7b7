"""Port parity: block-wise AffineQuant calibration, in weight-only mode
(w3a16, full ``ln_attn``/``ln_mlp`` sites under the gradual mask) and in
weight-activation mode (w4a4 g32, diagonal norm sites with shifts and the
headwise ``vo`` site), against the reference on the same numpy block and
activations.

The block is the port's seeded init (the reference's init has the same
tree and scales).  The reference calibrates it once per mode (3 epochs,
batches of 4); its learned parameters cross over through the bridge, so
the forward, one step's loss and gradients, and finalize are compared on
identical parameters.  Byte comparisons call the reference eagerly (under
``jit`` XLA divides by constants through reciprocals, its eager code does
not); the forward, loss and gradients, held to a tolerance, come from one
``jit`` of the step.

Tolerances: the quantized block forward within rtol 1e-4 / atol 1e-5;
one step's loss within 1e-5 relative and each gradient within 1e-4 of its
largest magnitude; a port calibration's per-epoch losses within 1e-5
relative of the reference's and its learned leaves within 1e-4 (measured
here: 3.7e-7 and 1.3e-5; halved learning rates miss both by far).  Packed
finalize: codes and zero points byte-equal, scales
byte-equal except ``wv`` / ``wo`` (within 1e-6 relative): their transform
solves the per-head inverse, which sums in another order than XLA, and
ROADMAP queue 3 records the probe that shows it; the quantizer itself is
byte-equal on the same transformed weight.  Fake finalize through the
float block equals the calibrated quantized block within rtol 5e-3 / atol
5e-4, as the reference's own test holds it.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import calibration as jc
from repro.core.packing import unpack as junpack
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.core.quantizer import fake_quant_activation as jfake_act
from repro.core.quantizer import quantize_codes as jquantize_codes
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core import calibration as tc
from repro_torch.core import sites
from repro_torch.core.quantizer import (QuantConfig, fake_quant_activation,
                                        fake_quant_weight, quantize_codes)
from repro_torch.launch import calibrate as calibrate_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer
from repro_torch.models.init import init_block


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
MODES = {"w3a16": dict(w_bits=3, a_bits=16, group_size=0),
         "w4a4": dict(w_bits=4, a_bits=4, group_size=32)}
LINEARS = ("wq", "wk", "wv", "wo", "mlp/w_gate", "mlp/w_up", "mlp/w_down")


def _np(tree):
    """numpy leaves; the ``_sites`` strings, ints and bools stay."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _at(tree, path):
    """The leaf at a key tuple, or at a ``/``-joined block path."""
    for part in (path.split("/") if isinstance(path, str) else path):
        tree = tree[part]
    return tree


@pytest.fixture(scope="module", params=list(MODES))
def mode(request):
    jcfg, tcfg = jget_config("llama-micro"), get_config("llama-micro")
    tblock = init_block(tcfg, torch.Generator().manual_seed(0), "cpu")
    jblock = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tblock)
    x = np.random.default_rng(1).standard_normal(
        (8, 32, jcfg.d_model)).astype(np.float32)
    jq = JQuantConfig(lwc=True, **MODES[request.param])
    tq = QuantConfig(lwc=True, **MODES[request.param])
    jcc = jc.CalibConfig(epochs=3, alpha=0.1, batch_size=4)
    tcc = tc.CalibConfig(epochs=3, alpha=0.1, batch_size=4)
    jqp, jlosses = jc.calibrate_block(jblock, jnp.asarray(x), jnp.asarray(x),
                                      jcfg, jq, jcc)
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, jblock=jblock,
                tblock=tblock, x=x, jq=jq, tq=tq, jcc=jcc, tcc=tcc, jqp=jqp,
                jlosses=jlosses, tqp=from_jax_params(_np(jqp)))


def _masks(m, epoch):
    return (jc._masks(m["jcfg"], jc._specs_from(m["jqp"]), epoch, m["jcc"]),
            tc._masks(tc._specs_from(m["tqp"]), epoch, m["tcc"]))


def test_sites_and_masks_match_reference(mode):
    specs = tc._specs_from(mode["tqp"])
    kinds = {n: s.kind for n, s in specs.items()}
    assert kinds == {n: s.kind for n, s in
                     jc._specs_from(mode["jqp"]).items()}
    assert kinds["vo"] == "headwise"
    assert kinds["ln_attn"] == ("full" if mode["name"] == "w3a16"
                                else "diagonal")
    for epoch in (1, 2, 3):
        jm, tm = _masks(mode, epoch)
        for name in jm:
            assert (jm[name] is None) == (tm[name] is None)
            if tm[name] is not None:
                np.testing.assert_array_equal(tm[name].numpy(),
                                              np.asarray(jm[name]))


@pytest.fixture(scope="module")
def jstep(mode):
    """The reference's step at its learned parameters, epoch 2's masks (a
    partial band), on all 8 samples: (block output, loss, gradients), one
    ``jit``."""
    jm, _ = _masks(mode, 2)
    xq = jnp.asarray(mode["x"])
    pos = jnp.arange(32)[None]
    target = jc.fp_block_forward(mode["jblock"], xq, mode["jcfg"], pos)

    def jloss(lp):
        qp = dict(lp, _sites=mode["jqp"]["_sites"])
        out = jc.quant_block_forward(mode["jblock"], qp, xq, mode["jcfg"],
                                     mode["jq"], mode["jcc"], jm, pos)
        return jnp.mean(jnp.square(out - target)), out

    (jlv, out), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {"affine": mode["jqp"]["affine"], "lwc": mode["jqp"]["lwc"]})
    return dict(out=np.asarray(out), loss=float(jlv), grads=jgrads,
                target=np.asarray(target))


def test_quant_block_forward_matches_reference(mode, jstep):
    _, tm = _masks(mode, 2)
    got = tc.quant_block_forward(mode["tblock"], mode["tqp"], T(mode["x"]),
                                 mode["tcfg"], mode["tq"], tm,
                                 torch.arange(32)[None])
    np.testing.assert_allclose(got.numpy(), jstep["out"], rtol=1e-4,
                               atol=1e-5)


def test_one_step_loss_and_gradients_match_reference(mode, jstep):
    """Loss and gradients at the reference's learned parameters, epoch 2's
    masks, on the same target."""
    _, tm = _masks(mode, 2)
    xq = mode["x"]
    pos = np.arange(32)[None]
    jlv, jgrads, target = jstep["loss"], jstep["grads"], jstep["target"]
    tqp = from_jax_params(_np(mode["jqp"]))
    leaves = tc._learnable(tqp)
    for _, p in leaves:
        p.requires_grad_(True)
    out = tc.quant_block_forward(mode["tblock"], tqp, T(xq), mode["tcfg"],
                                 mode["tq"], tm, T(pos))
    loss = torch.mean(torch.square(out - torch.tensor(target)))
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    assert loss.item() == pytest.approx(float(jlv), rel=1e-5)
    assert len(leaves) == len(jax.tree_util.tree_leaves(jgrads))
    for (path, _), g in zip(leaves, grads):
        want = np.asarray(_at(jgrads, path))  # path: the key tuple
        err = np.max(np.abs(g.numpy() - want))
        assert err <= 1e-4 * np.max(np.abs(want)), (path, err)


def test_calibrate_block_losses_within_2pct_of_reference(mode):
    """The port's 3-epoch run (six Adam steps) against the reference's:
    every epoch loss within 1e-5 relative and every learned affine and LWC
    leaf within 1e-4, far inside the 2% the losses were first held to.  With
    the learning rates halved the same run misses both bounds (at 2% a run
    that never updated would pass in the w4a4 mode)."""
    x = T(mode["x"])

    def gaps(ccfg):
        qp, losses = tc.calibrate_block(mode["tblock"], x, x, mode["tcfg"],
                                        mode["tq"], ccfg)
        assert len(losses) == len(mode["jlosses"]) == 3
        assert all(not p.requires_grad for _, p in tc._learnable(qp))
        loss = np.max(np.abs(np.array(losses) / mode["jlosses"] - 1))
        leaf = max(np.max(np.abs(p.numpy() - np.asarray(_at(mode["jqp"], k))))
                   for k, p in tc._learnable(qp))
        return loss, leaf

    loss, leaf = gaps(mode["tcc"])
    assert loss <= 1e-5 and leaf <= 1e-4, (loss, leaf)
    c = mode["tcc"]
    loss, leaf = gaps(dataclasses.replace(c, lr_affine=c.lr_affine / 2,
                                          lr_shift=c.lr_shift / 2,
                                          lr_lwc=c.lr_lwc / 2))
    assert loss > 1e-5 and leaf > 1e-4, (loss, leaf)


def test_finalize_packed_matches_eager_reference(mode):
    """Packed finalize from the reference's learned parameters; and one
    set of transformed weights (the port's), quantized with the learned
    clips by both quantizers, byte-equal for every linear, wv and wo
    included (their finalize scales differ only through the transform)."""
    want = jc.finalize_block(mode["jblock"], mode["jqp"], mode["jcfg"],
                             mode["jq"], mode["jcc"], deploy="packed")
    got = tc.finalize_block(mode["tblock"], mode["tqp"], mode["tcfg"],
                            mode["tq"], mode["tcc"], deploy="packed")
    _, tm = _masks(mode, 3)
    tw = tc.transformed_weights(mode["tblock"], mode["tqp"], mode["tcfg"],
                                tm)
    for name in LINEARS:
        j, t = _at(want, name), _at(got, name)
        assert (t.bits, t.group_size) == (j.bits, j.group_size)
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
        np.testing.assert_array_equal(t.zp.numpy(), np.asarray(j.zp))
        if name in ("wv", "wo"):
            np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(t.scale.numpy(),
                                          np.asarray(j.scale))
        lwc = mode["jqp"]["lwc"][name]
        j = jquantize_codes(jnp.asarray(tw[name].numpy()), mode["jq"], lwc)
        t = quantize_codes(tw[name], mode["tq"], from_jax_params(_np(lwc)))
        for a, b in ((t.packed, j.packed), (t.scale, j.scale),
                     (t.zp, j.zp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sorted(got) == sorted(want)
    for norm in ("ln_attn", "ln_mlp"):
        assert sorted(got[norm]) == sorted(want[norm])
        for k in want[norm]:
            np.testing.assert_array_equal(got[norm][k].numpy(),
                                          np.asarray(want[norm][k]))
    for key in ("attn_t", "mlp_t", "bq", "bk", "bv"):
        if key in want:
            for a, b in zip(jax.tree_util.tree_leaves(from_jax_params(
                    _np(want[key]))), jax.tree_util.tree_leaves(got[key])):
                np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                           atol=1e-6)


def test_finalize_fake_equals_calibrated_block(mode):
    """The fake-quant tree through the float block equals the calibrated
    quantized block.  It carries weights only, so at a4 the quantized block
    runs with float activations."""
    tq = dataclasses.replace(mode["tq"], a_bits=16)
    x = T(mode["x"])
    _, tm = _masks(mode, 3)
    pos = torch.arange(32)[None]
    want = tc.quant_block_forward(mode["tblock"], mode["tqp"], x,
                                  mode["tcfg"], tq, tm, pos)
    block = tc.finalize_block(mode["tblock"], mode["tqp"], mode["tcfg"],
                              mode["tq"], mode["tcc"], deploy="fake")
    got = transformer.apply_block_full(block, x, mode["tcfg"], pos)
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("sym,g", [(False, 32), (True, 0)])
def test_lwc_quantizer_matches_reference(sym, g, monkeypatch):
    """Random clip logits.  ``torch.sigmoid`` and ``jax.nn.sigmoid`` differ
    by an ulp for some inputs (ROADMAP queue 3), which can move a scale by
    an ulp and, rarely, a code by one level: with the port's sigmoid at
    most 1e-3 of the codes move, by one level.  At the reference's sigmoid
    the grids are byte-equal, and the packed codes dequantize to the
    fake-quant weight bit for bit (one rounding)."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((128, 48)).astype(np.float32)
    lwc = {k: rng.normal(2.0, 2.0, (128 // (g or 128), 1, 48)
                         ).astype(np.float32) for k in ("gamma", "beta")}
    jq = JQuantConfig(w_bits=4, group_size=g, symmetric=sym, lwc=True)
    tq = QuantConfig(w_bits=4, group_size=g, symmetric=sym, lwc=True)
    j = jquantize_codes(jnp.asarray(w), jq,
                        {k: jnp.asarray(v) for k, v in lwc.items()})
    tlwc = {k: T(v) for k, v in lwc.items()}
    t = quantize_codes(T(w), tq, tlwc)
    jcodes = np.asarray(junpack(j.packed, 4, 128)).astype(int)
    moved = np.abs(t.codes().numpy().astype(int) - jcodes)
    assert moved.max() <= 1 and moved.mean() <= 1e-3
    np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                               rtol=3e-7)
    monkeypatch.setattr(torch, "sigmoid", lambda z: torch.from_numpy(
        np.array(jax.nn.sigmoid(jnp.asarray(z.numpy())))))
    t = quantize_codes(T(w), tq, tlwc)
    for a, b in ((t.packed, j.packed), (t.scale, j.scale), (t.zp, j.zp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    torch.testing.assert_close(t.dequantize(),
                               fake_quant_weight(T(w), tq, tlwc),
                               rtol=0, atol=0)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_activation_byte_equal(sym, bits):
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((3, 7, 64)) * np.logspace(-3, 2, 64)
         ).astype(np.float32)
    jq = JQuantConfig(a_bits=bits, act_symmetric=sym)
    tq = QuantConfig(a_bits=bits, act_symmetric=sym)
    np.testing.assert_array_equal(
        fake_quant_activation(T(x), tq).numpy(),
        np.asarray(jfake_act(jnp.asarray(x), jq)))


def test_quantize_dense_model_beats_rtn():
    """The port's own whole-model pipeline reaches a lower output error
    than round-to-nearest on the same weights (as the reference's
    ``test_whole_model_pipeline_improves_over_rtn``)."""
    from repro_torch.models.model import build_model
    cfg = get_config("llama-micro")
    model = build_model(cfg, "cpu")
    params = model.init(0)
    toks = torch.randint(0, cfg.vocab_size, (8, 48),
                         generator=torch.Generator().manual_seed(5))
    qcfg = QuantConfig(w_bits=2, group_size=0, lwc=True)
    rtn = tc._stack_layers(params, [
        {**b, **{k: fake_quant_weight(b[k], qcfg) for k in
                 ("wq", "wk", "wv", "wo")},
         "mlp": {k: fake_quant_weight(v, qcfg) for k, v in b["mlp"].items()}}
        for b in tc._unstack_layers(params, cfg)])
    aq, info = tc.quantize_dense_model(params, cfg, qcfg,
                                       tc.CalibConfig(epochs=5, alpha=0.1),
                                       toks, log=False)
    assert len(info["step_seconds"]) == 2 * 5
    with torch.no_grad():
        full = model.forward(params, {"tokens": toks})
        err = lambda p: torch.mean(torch.square(
            model.forward(p, {"tokens": toks}) - full)).item()
        assert err(aq) < err(rtn)


def test_other_families_and_baselines_refuse():
    cfg = dataclasses.replace(get_config("llama-micro"), family="moe")
    with pytest.raises(NotImplementedError, match="item 11"):
        sites.block_sites(cfg, True)
    args = calibrate_cli.build_parser().parse_args(
        ["--arch", "llama-micro", "--device", "cpu", "--method", "gptq"])
    with pytest.raises(NotImplementedError, match="baselines"):
        calibrate_cli.calibrate(args)


def test_calibrate_then_serve_the_packed_tree(tmp_path, capsys):
    """The CLI pair: calibrate writes the fake-quant tree, the packed tree
    and the report; serve --load-packed serves the packed tree with the
    streams of the in-memory tree; serve --calibrate reports its agreement
    with the simulation; serve --ckpt packs a float tree on the RTN grid."""
    argv = ["--arch", "llama-micro", "--device", "cpu", "--method", "affine",
            "--wbits", "4", "--abits", "4", "--group", "32", "--epochs", "1",
            "--calib-samples", "8", "--calib-seq", "16", "--out",
            str(tmp_path)]
    assert calibrate_cli.main(argv) == 0
    name = "llama-micro-affine-w4a4g32kv16"
    report = json.loads((tmp_path / f"{name}.json").read_text())
    assert {"fp_ppl", "quant_ppl", "block_final_losses"} <= set(report)
    assert (tmp_path / name / "step_00000000" / "arrays.npz").exists()
    sflags = ["--arch", "llama-micro", "--device", "cpu", "--group", "32",
              "--abits", "4", "--max-len", "64", "--prompt-len", "12",
              "--max-new", "6", "--requests", "2"]
    out = serve_cli.main(sflags + ["--load-packed",
                                   str(tmp_path / f"{name}-packed")])
    again = calibrate_cli.calibrate(calibrate_cli.build_parser().parse_args(
        argv[:-2]))
    mem = serve_cli.serve(serve_cli.build_parser().parse_args(sflags),
                          again["packed"])
    assert [r.out_tokens for r in out["requests"]] == \
        [r.out_tokens for r in mem["requests"]]
    capsys.readouterr()
    serve_cli.main(sflags[:-8] + ["--abits", "16", "--kvbits", "16",
                                  "--max-len", "64", "--prompt-len", "12",
                                  "--max-new", "6", "--requests", "2",
                                  "--calibrate"])
    line = [l for l in capsys.readouterr().out.splitlines()
            if "greedy agreement" in l]
    assert len(line) == 1
    assert float(line[0].split("greedy agreement ")[1].split()[0]) >= 0.9
    out = serve_cli.main(sflags + ["--ckpt", str(tmp_path / name)])
    assert out["fake"] is None and len(out["requests"]) == 2
