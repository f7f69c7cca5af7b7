"""Port parity for quantized vlm and audio: AffineQuant / OmniQuant-diag
calibration, the RTN / AWQ / GPTQ baselines and packed serving of
paligemma-3b and hubert-xlarge at the reference's ``reduced()`` size (2
layers, d 64; paligemma MQA with GeGLU and RMSNorm, hubert LayerNorm, GELU
and sinusoidal positions), on the reference's seeded weights carried
across by ``from_jax_params``.

As the reference does, both calibrate as token trunks (the calibration
tokens' embeddings, no image prefix, no frames), paligemma causally and
hubert bidirectionally (``cfg.causal``), and both serve through
``QuantizedModel`` as the causal token trunk: packed hubert is causal
although its calibration and float forward are not (ROADMAP queue 3).

Tolerances, as the dense tests hold them:
* calibration (``test_torch_calibration.py``, ``test_torch_moe.py``):
  epoch losses within 1e-5 relative; the port's packed finalize of the
  reference's learned parameters byte-equal in codes and zero points,
  scales within 1e-6 relative (queue 3's headwise ``vo`` caveat); the
  port's own calibrated tree at most one code level away in at most 1e-3
  of the entries (measured: 1 of paligemma W4A16's 1,024 ``wv`` codes);
* ``quantize_lm_packed``: byte-equal;
* ``QuantizedModel`` (``test_torch_quantized_model.py``): logits within
  1e-4 of the largest logit at w4a4 / kv8 and 1e-5 at w4a16 / kv16, greedy
  tokens equal; chunked prefill leaves the whole prompt's cache byte for
  byte and its logits within 1e-5;
* the baselines (``test_torch_baselines.py``): RTN byte-equal, GPTQ within
  1e-5 of each matrix's largest magnitude, AWQ off by more than that in at
  most 1e-4 of the entries, logits within 1e-5 of the largest.  They
  calibrate on 4 x 64 tokens: GPTQ needs a Hessian of full rank, and at 4
  x 16 tokens (rank 64 below d_ff 128) paligemma's rank-deficient
  Hessians turned the stream's ulp differences into moved codes (3,456 of
  ``w_down``'s 16,384 entries);
* the Engine, inside the port: linear == paged and chunked == whole, token
  for token.

The reference's calibration step runs under its own ``jit``; its serving
entry points and the baselines' float block forwards are jitted here (one
compile each), where only a tolerance is compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import baselines as jb
from repro.core import calibration as jc
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.models import build_model as jbuild_model
from repro.serve.quantized import QuantizedModel as JQuantizedModel
from repro.serve.quantized import quantize_lm_packed as jquantize_lm_packed
from repro.train import checkpoints as jckpt
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core import baselines as tb
from repro_torch.core import calibration as tc
from repro_torch.core.quantizer import QuantConfig
from repro_torch.models.init import layer
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine, ServeConfig
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
VLM, AUDIO = "paligemma-3b", "hubert-xlarge"
ARCHS = (VLM, AUDIO)
GROUP = 32
# calibration modes: W4A4 (diagonal norm sites with shifts) and W4A16
# (full sites kept as activation factors)
CALIB = {"w4a4": 4, "w4a16": 16}
# serving settings and their logit tolerances (of the largest logit)
SERVE = {"w4a4kv8": (4, 8, 1e-4), "w4a16kv16": (16, 16, 1e-5)}
PREFILL, DECODE, MAX_LEN = 16, 6, 48


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


_SETUPS: dict = {}


def _setup(arch: str):
    """(reference config, port config, reference params, port params)."""
    if arch not in _SETUPS:
        jcfg = jget_config(arch).reduced()
        jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        _SETUPS[arch] = (jcfg, get_config(arch).reduced(), jp,
                         from_jax_params(_np(jp)))
    return _SETUPS[arch]


def _tokens(arch: str, shape, seed: int) -> np.ndarray:
    cfg = get_config(arch).reduced()
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _qcfgs(a_bits: int, kv_bits: int = 16, lwc: bool = False):
    kw = dict(w_bits=4, a_bits=a_bits, group_size=GROUP, kv_bits=kv_bits,
              lwc=lwc)
    return JQuantConfig(**kw), QuantConfig(**kw)


def _linears(tree) -> dict:
    lp = tree["layers"]
    out = {k: lp[k] for k in ("wq", "wk", "wv", "wo")}
    out.update({f"mlp/{k}": v for k, v in lp["mlp"].items()
                if k.startswith("w_")})
    return out


# ---------------------------------------------------------------------------
# calibration: quantize_dense_model(..., deploy="packed")
# ---------------------------------------------------------------------------

_CALIBRATED: dict = {}


def _calibrated(arch: str, mode: str):
    """Both packages' ``quantize_dense_model(..., deploy="packed")`` on
    the same weights and 4 x 16 calibration tokens (2 epochs, batch 4),
    computed once."""
    if (arch, mode) not in _CALIBRATED:
        jcfg, tcfg, jp, tp = _setup(arch)
        jq, tq = _qcfgs(CALIB[mode], lwc=True)
        kw = dict(epochs=2, alpha=0.1, batch_size=4)
        toks = _tokens(arch, (4, 16), 3)
        jpk, jinfo = jc.quantize_dense_model(
            jp, jcfg, jq, jc.CalibConfig(**kw), jnp.asarray(toks), log=False,
            deploy="packed")
        tpk, tinfo = tc.quantize_dense_model(
            tp, tcfg, tq, tc.CalibConfig(**kw), T(toks), log=False,
            deploy="packed")
        _CALIBRATED[arch, mode] = (jpk, jinfo, tpk, tinfo, tq)
    return _CALIBRATED[arch, mode]


@pytest.mark.parametrize("mode", list(CALIB))
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_dense_model_packed_matches_reference(arch, mode):
    """Losses within 1e-5; the port's finalize of the reference's learned
    parameters byte-equal in codes and zero points, scales within 1e-6;
    the port's own packed tree a code away at most, in at most 1e-3 of
    the entries (its learned parameters differ by float32 ulps, and the
    headwise ``vo`` transform sums in another order: queue 3)."""
    jpk, jinfo, tpk, tinfo, tq = _calibrated(arch, mode)
    _, tcfg, _, tp = _setup(arch)
    np.testing.assert_allclose(np.asarray(tinfo["block_losses"]),
                               np.asarray(jinfo["block_losses"]), rtol=1e-5)
    fin = tc.finalize_model(
        tp, [from_jax_params(_np(qp)) for qp in jinfo["block_qps"]], tcfg,
        tq, tc.CalibConfig(epochs=2, alpha=0.1), deploy="packed")
    jl, tl, fl = _linears(jpk), _linears(tpk), _linears(fin)
    assert sorted(jl) == sorted(tl) == sorted(fl)
    assert ("mlp/w_gate" in tl) == (arch == VLM)
    for k in jl:
        j, t, f = jl[k], tl[k], fl[k]
        assert (t.bits, t.group_size) == (f.bits, f.group_size) == (
            j.bits, j.group_size), k
        np.testing.assert_array_equal(f.packed.numpy(), np.asarray(j.packed),
                                      err_msg=k)
        np.testing.assert_array_equal(f.zp.numpy(), np.asarray(j.zp),
                                      err_msg=k)
        np.testing.assert_allclose(f.scale.numpy(), np.asarray(j.scale),
                                   rtol=1e-6, atol=0, err_msg=k)
        got, want = t.codes().numpy(), np.asarray(j.codes())
        moved = got != want
        assert moved.mean() <= 1e-3, (k, moved.sum())
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, k
    # W4A16 keeps the full sites as activation factors; W4A4 merges its
    # diagonal sites into the norms
    assert ("attn_t" in tpk["layers"]) == ("attn_t" in jpk["layers"]) == (
        mode == "w4a16")


def test_hubert_calibration_attends_bidirectionally():
    """The quantized and float block forwards take ``cfg.causal``: on
    hubert a change to the last token moves the first position's output,
    on the same block under a causal mask it does not."""
    _, tcfg, _, tp = _setup(AUDIO)
    tinfo, tq = _calibrated(AUDIO, "w4a4")[3:]
    qp = tinfo["block_qps"][0]
    bp = layer(tp["layers"], 0)
    rng = np.random.default_rng(9)
    x = T(rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32))
    moved = x.clone()
    moved[:, -1] = T(rng.standard_normal((2, tcfg.d_model)).astype(
        np.float32))
    pos = torch.arange(12)[None, :]
    masks = tc._masks(tc._specs_from(qp), 2, tc.CalibConfig(epochs=2),
                      "cpu")
    for cfg, opens in ((tcfg, True),
                       (dataclasses.replace(tcfg, causal=True), False)):
        with torch.no_grad():
            for fwd in (lambda z: tc.quant_block_forward(bp, qp, z, cfg, tq,
                                                         masks, pos),
                        lambda z: tc.fp_block_forward(bp, z, cfg, pos)):
                d0 = (fwd(moved)[:, 0] - fwd(x)[:, 0]).abs().max().item()
                assert (d0 > 1e-4) == opens, (cfg.causal, d0)


# ---------------------------------------------------------------------------
# packing and packed serving
# ---------------------------------------------------------------------------

_PACKED: dict = {}


def _jpacked(arch: str) -> dict:
    """The reference's RTN packing of the seeded tree (w4 g32: the same
    codes at every activation and KV width), computed once."""
    if arch not in _PACKED:
        jcfg, _, jp, _ = _setup(arch)
        _PACKED[arch] = jquantize_lm_packed(jp, jcfg, _qcfgs(4)[0])
    return _PACKED[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_lm_packed_byte_equal(arch):
    _, tcfg, _, tp = _setup(arch)
    tq = _qcfgs(4)[1]
    want = checkpoints.flatten(from_jax_params(_np(_jpacked(arch))))
    got = checkpoints.flatten(quantize_lm_packed(tp, tcfg, tq))
    assert sorted(got) == sorted(want)
    for k, (a, _) in want.items():
        assert got[k][0].tobytes() == a.tobytes(), k


_SERVED: dict = {}


def _served(arch: str, setting: str):
    """(reference model, reference packed tree, port model, the same tree
    in the port, tolerance); the tree is the reference's RTN packing."""
    if (arch, setting) not in _SERVED:
        jcfg, tcfg, _, _ = _setup(arch)
        a_bits, kv_bits, tol = SERVE[setting]
        jq, tq = _qcfgs(a_bits, kv_bits)
        jpk = _jpacked(arch)
        _SERVED[arch, setting] = (
            JQuantizedModel(jcfg, jq, kernel_mode="ref"), jpk,
            QuantizedModel(tcfg, tq, device="cpu"),
            from_jax_params(_np(jpk)), tol)
    return _SERVED[arch, setting]


def _teacher_forced(prefill, decode, params, tokens, lengths, to_np):
    """Logits (B, 1 + DECODE, vocab): the end-padded prompt's prefill,
    then DECODE steps fed the tokens after it."""
    lg, cache = prefill(params, {"tokens": tokens[:, :PREFILL],
                                 "lengths": lengths}, max_len=MAX_LEN)
    out = [to_np(lg)]
    for i in range(DECODE):
        lg, cache = decode(params, tokens[:, PREFILL + i:PREFILL + i + 1],
                           cache)
        out.append(to_np(lg))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("setting", list(SERVE))
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_model_matches_reference(arch, setting):
    """Padded prefill (lengths 16 and 11) + decode against the
    reference's; chunked prefill (chunks of 8) against the whole prompt."""
    jm, jpk, tm, tpk, tol = _served(arch, setting)
    toks = _tokens(arch, (2, PREFILL + DECODE), 5)
    lengths = np.asarray([PREFILL, 11], np.int32)
    want = _teacher_forced(
        jax.jit(jm.prefill, static_argnames=("max_len",)),
        jax.jit(jm.decode_step), jpk, jnp.asarray(toks),
        jnp.asarray(lengths), np.asarray)
    with torch.no_grad():
        got = _teacher_forced(tm.prefill, tm.decode_step, tpk, T(toks),
                              T(lengths), lambda t: t.numpy())
        assert _rel(got, want) < tol
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        whole, wcache = tm.prefill(tpk, {"tokens": T(toks[:, :PREFILL])},
                                   max_len=MAX_LEN)
        cache = tm.init_cache(2, MAX_LEN)
        for c0 in range(0, PREFILL, 8):
            lg, cache = tm.prefill_chunk(
                tpk, {"tokens": T(toks[:, c0:c0 + 8])}, cache,
                torch.full((2,), c0, dtype=torch.int32), last_only=True)
    for key in wcache:
        torch.testing.assert_close(cache[key], wcache[key], rtol=0, atol=0)
    torch.testing.assert_close(lg, whole, rtol=1e-5, atol=1e-5)


def test_packed_hubert_is_causal_as_the_reference():
    """The reference serves hubert as the causal token trunk: changing
    token 5 leaves positions 0-4 of a prefill chunk bit for bit in both
    packages and moves position 6."""
    jm, jpk, tm, tpk, tol = _served(AUDIO, "w4a4kv8")
    toks = _tokens(AUDIO, (1, 12), 7)
    moved = toks.copy()
    moved[0, 5] = (moved[0, 5] + 1) % tm.cfg.vocab_size
    jchunk = jax.jit(jm.prefill_chunk)
    zero = np.zeros((1,), np.int32)
    out = {}
    for name, t in (("base", toks), ("moved", moved)):
        out["j", name] = np.asarray(jchunk(
            jpk, {"tokens": jnp.asarray(t)}, jm.init_cache(1, 16),
            jnp.asarray(zero))[0])
        with torch.no_grad():
            out["t", name] = tm.prefill_chunk(
                tpk, {"tokens": T(t)}, tm.init_cache(1, 16), T(zero))[0
                                                                      ].numpy()
    for pkg in ("j", "t"):
        a, b = out[pkg, "base"], out[pkg, "moved"]
        np.testing.assert_array_equal(a[:, :5], b[:, :5])
        assert np.abs(a[:, 6] - b[:, 6]).max() > 1e-4 * np.abs(a).max()
    assert _rel(out["t", "base"], out["j", "base"]) < tol


def test_kv4_refused_where_32_does_not_divide_the_head_dim():
    """kv4 stores one bf16 scale per 32 values: the reduced configs' head
    dim of 16 (and hubert-xlarge's 80) is refused, as the reference's
    ``kv4_check_head_dim`` refuses it."""
    from repro.kernels.quantize_pack import kv4_check_head_dim as jcheck
    for cfg in (get_config(AUDIO), get_config(AUDIO).reduced(),
                get_config(VLM).reduced()):
        with pytest.raises(ValueError) as want:
            jcheck(cfg.resolved_head_dim)
        with pytest.raises(ValueError, match="head_dim % 32 == 0") as got:
            QuantizedModel(cfg, QuantConfig(kv_bits=4), device="cpu")
        assert str(got.value) == str(want.value)
    QuantizedModel(get_config(VLM), QuantConfig(kv_bits=4), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_linear_equals_paged_and_chunked_equals_whole(arch):
    """Five ragged prompts (20 new tokens each) through the Engine at
    w4a4 / kv8 over three slots: the linear cache, pages of 8, chunks of 8
    into an 8-page pool (which must preempt) give the same streams."""
    _, _, tm, tpk, _ = _served(arch, "w4a4kv8")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n) for n in
               (13, 5, 20, 9, 16)]
    streams, pre = {}, {}
    for name, kw in (("linear", {}),
                     ("paged", dict(paged=True, page_size=8)),
                     ("pool", dict(paged=True, page_size=8, num_pages=8,
                                   prefill_chunk=8))):
        eng = Engine(tm, tpk, ServeConfig(max_batch=3, max_len=MAX_LEN,
                                          max_new=20, prefill_bucket=8, **kw))
        reqs = [eng.submit(p) for p in prompts]
        eng.run()
        streams[name] = [list(r.out_tokens) for r in reqs]
        pre[name] = eng.preemptions
    assert all(len(s) == 20 for s in streams["linear"])
    assert streams["paged"] == streams["linear"]
    assert streams["pool"] == streams["linear"]
    assert pre["pool"] > 0


# ---------------------------------------------------------------------------
# the baselines
# ---------------------------------------------------------------------------

def _jit_stream(monkeypatch):
    """The reference pipeline's float block forwards under one ``jit``
    each, as ``test_torch_baselines.py`` does."""
    from repro.models import transformer as jtransformer
    monkeypatch.setattr(jtransformer, "apply_block_full", jax.jit(
        jtransformer.apply_block_full, static_argnums=(2, 4, 5, 6)))
    monkeypatch.setattr(jb, "block_linear_inputs", jax.jit(
        jb.block_linear_inputs, static_argnums=(2,)))


@pytest.mark.parametrize("arch", ARCHS)
def test_baselines_match_reference(arch, monkeypatch):
    """RTN, AWQ and GPTQ at W4A16 g32 on 4 x 64 calibration tokens, the
    calibration stream under the config's mask (bidirectional for
    hubert); the fake-quant trees' logits on held-out tokens through each
    package's float forward (paligemma: text only; hubert: the tokens'
    embeddings as frames)."""
    jcfg, tcfg, jp, tp = _setup(arch)
    jq, tq = _qcfgs(16)
    _jit_stream(monkeypatch)
    calib, test = _tokens(arch, (4, 64), 3), _tokens(arch, (2, 16), 4)
    jfwd = jax.jit(jbuild_model(jcfg).forward)
    tm = Model(tcfg, "cpu")

    def batches(jtree, ttree):
        if arch == VLM:
            return {"tokens": jnp.asarray(test)}, {"tokens": T(test)}
        return ({"embeds": jnp.take(jtree["embed"], jnp.asarray(test), 0)},
                {"embeds": ttree["embed"][T(test).long()]})

    for method in ("rtn", "awq", "gptq"):
        want = jb.quantize_model_baseline(jp, jcfg, jq, jnp.asarray(calib),
                                          method)
        got = tb.quantize_model_baseline(tp, tcfg, tq, T(calib), method)
        wl, gl = _linears(want), _linears(got)
        assert sorted(wl) == sorted(gl)
        for k in wl:
            a, b = np.asarray(wl[k]), gl[k].numpy()
            off = np.abs(b - a) > 1e-5 * np.abs(a).max()
            if method == "rtn":
                np.testing.assert_array_equal(b, a)
            elif method == "gptq":
                assert not off.any(), (method, k)
            else:
                assert off.mean() <= 1e-4, (method, k, off.sum())
        jbatch, tbatch = batches(want, got)
        a = np.asarray(jfwd(want, jbatch))
        with torch.no_grad():
            b = tm.forward(got, tbatch).numpy()
        assert _rel(b, a) <= 1e-5, method
        np.testing.assert_array_equal(b.argmax(-1), a.argmax(-1))


# ---------------------------------------------------------------------------
# checkpoints and the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_packed_trees_cross_the_checkpoints_both_ways(arch, tmp_path):
    """The reference's calibrated packed tree read by ``load_tree`` byte
    for byte (QTensor bits and groups recovered); the port's written by
    ``checkpoints.save`` and restored by the reference into its own tree,
    byte for byte."""
    jpk, _, tpk, _, tq = _calibrated(arch, "w4a16")
    jckpt.save(tmp_path / "ref", 0, jpk)
    got = checkpoints.load_tree(tmp_path / "ref", _setup(arch)[1], tq,
                                device="cpu")
    want = checkpoints.flatten(from_jax_params(_np(jpk)))
    back = checkpoints.flatten(got)
    assert sorted(back) == sorted(want)
    for k, (a, _) in want.items():
        assert back[k][0].tobytes() == a.tobytes(), k
    assert got["layers"]["wq"].group_size == GROUP
    checkpoints.save(tmp_path / "port", 2, tpk)
    restored, step = jckpt.restore(tmp_path / "port", jpk)
    assert step == 2
    mine = checkpoints.flatten(tpk)
    theirs = checkpoints.flatten(from_jax_params(_np(restored)))
    assert sorted(theirs) == sorted(mine)
    for k, (a, _) in mine.items():
        assert theirs[k][0].tobytes() == a.tobytes(), k


def test_calibrate_and_serve_clis_take_both_archs(tmp_path, capsys):
    """``launch/calibrate --reduced`` (AffineQuant W4A4, RTN) writes packed
    trees that ``launch/serve --reduced --load-packed`` serves through the
    Engine; ``launch/serve --ckpt`` packs the reference's float tree read
    from its npz checkpoint, the bytes of ``quantize_lm_packed``; ``--fp``
    still refuses hubert, whose float Model has no decode path."""
    from repro_torch.launch import calibrate, serve
    from repro_torch.models.model import ENCODER_ONLY
    for arch in ARCHS:
        for method in ("affine", "rtn"):
            calibrate.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--method", method, "--wbits", "4", "--abits",
                            "4", "--group", str(GROUP), "--epochs", "1",
                            "--calib-samples", "4", "--calib-seq", "16",
                            "--out", str(tmp_path)])
            d = tmp_path / f"{arch}-{method}-w4a4g32kv16-packed"
            out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--group", str(GROUP), "--abits", "4",
                              "--load-packed", str(d), "--requests", "2",
                              "--max-len", "32", "--prompt-len", "8",
                              "--max-new", "4", "--paged", "--page-size",
                              "8"])
            assert out["generated"] == 8
            assert out["statuses"] == {"COMPLETED": 2}
        _, tcfg, jp, tp = _setup(arch)
        jckpt.save(tmp_path / f"{arch}-float", 0, jp)
        out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--group", str(GROUP), "--abits", "4", "--ckpt",
                          str(tmp_path / f"{arch}-float"), "--requests", "2",
                          "--max-len", "32", "--prompt-len", "8",
                          "--max-new", "4"])
        assert out["statuses"] == {"COMPLETED": 2}
        want = checkpoints.flatten(quantize_lm_packed(tp, tcfg, out["qcfg"]))
        got = checkpoints.flatten(out["params"])
        assert sorted(got) == sorted(want)
        assert all(got[k][0].tobytes() == a.tobytes()
                   for k, (a, _) in want.items())
    text = capsys.readouterr().out
    assert "hubert-xlarge-smoke x2 layers w4a4g32kv8" in text
    with pytest.raises(ValueError, match=ENCODER_ONLY):
        serve.main(["--arch", AUDIO, "--reduced", "--fp", "--device", "cpu"])
