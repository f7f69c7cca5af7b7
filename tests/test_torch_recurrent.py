"""Port parity for the recurrent families, mamba2 (mamba2-1.3b) and griffin
(recurrentgemma-2b), at the reference's ``reduced()`` size (mamba2: 2
layers, d 64, SSD chunk 8, state 16; griffin: 3 layers (rec, rec, attn),
window 8).  The weights are the reference's seeded init, carried across
by ``from_jax_params`` (griffin's list layout included).

Tolerances: the SSD and RG-LRU pieces and each block within 1e-5 of the
output's magnitude (the port's doubling scan composes the pairs in another
order than ``associative_scan``); logits within 1e-5 of the largest logit
and losses within 1e-5 relative; prefill + decode against the reference's
own prefill + decode within 1e-5 of the largest logit (griffin's ring
decode sums its slots in slot order through ``ops.flash_decode``, the
reference masks absolute positions: the same set); the first train step as
``test_torch_train.py`` holds it; Engine streams greedy-equal to the
reference Engine's, or tied within 1e-5 (``launch/serve.near_greedy``).
The reference's outputs are computed once, jitted, in module fixtures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import griffin as jgriffin
from repro.models import mamba2 as jmamba2
from repro.models import transformer as jtransformer
from repro.optim import adam as jadam
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.train import checkpoints as jckpt
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.bridge import from_jax_params
from repro_torch.configs import OTHER_ARCHS, get_config
from repro_torch.core import sites
from repro_torch.core.quantizer import QuantConfig
from repro_torch.kernels import ops
from repro_torch.launch.serve import near_greedy, teacher_forced
from repro_torch.models import griffin, mamba2
from repro_torch.models.model import Model
from repro_torch.optim import adam
from repro_torch.serve.engine import Engine, RequestStatus, ServeConfig
from repro_torch.train import checkpoints
from repro_torch.train.step import TrainState, make_train_step


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
ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")
MAX_LEN = 32


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


_SETUPS: dict = {}


def _setup(arch: str):
    """(reference model, port model, reference params, port params): the
    reference's seeded init of the reduced config, carried across."""
    if arch not in _SETUPS:
        jm = jbuild_model(jget_config(arch).reduced())
        jp = jm.init(jax.random.PRNGKey(0))
        _SETUPS[arch] = (jm, Model(get_config(arch).reduced(), "cpu"), jp,
                         from_jax_params(_np(jp)))
    return _SETUPS[arch]


def _tokens(arch: str, t: int, b: int = 2, seed: int = 1) -> np.ndarray:
    vocab = get_config(arch).reduced().vocab_size
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


@pytest.fixture(scope="module")
def ref():
    """The reference's forward / loss and prefill + decode logits of each
    case, jitted, computed once: {case: array}."""
    out = {}
    for arch in ARCHS:
        jm, _, jp, _ = _setup(arch)
        toks = _tokens(arch, 21)
        out[arch, "forward"] = np.asarray(jax.jit(jm.forward)(
            jp, {"tokens": jnp.asarray(toks)}))
        out[arch, "loss"] = float(jax.jit(jm.loss)(
            jp, {"tokens": jnp.asarray(toks)}))
        prefill = jax.jit(jm.prefill, static_argnums=2)
        decode = jax.jit(jm.decode_step)
        for t in ((6, 20) if arch == "recurrentgemma-2b" else (13,)):
            full = _tokens(arch, t + 6, seed=2)
            lg, cache = prefill(jp, {"tokens": jnp.asarray(full[:, :t])},
                                MAX_LEN)
            seq = [lg]
            for i in range(6):
                lg, cache = decode(jp, jnp.asarray(full[:, t + i:t + i + 1]),
                                   cache)
                seq.append(lg)
            out[arch, "decode", t] = np.asarray(jnp.concatenate(seq, 1))
    return out


# ---------------------------------------------------------------------------
# configs and the pieces
# ---------------------------------------------------------------------------

def test_configs_match_reference():
    """The four archs of this slice, published and reduced, field for field
    (the port computes in float32), with the reference's parameter
    counts."""
    assert sorted(OTHER_ARCHS) == sorted(
        ARCHS + ("paligemma-3b", "hubert-xlarge"))
    for name in OTHER_ARCHS:
        j, t = jget_config(name), get_config(name)
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert t.param_count() == j.param_count()
        assert (t.d_inner, t.ssm_heads, t.rnn_dim) == \
            (j.d_inner, j.ssm_heads, j.rnn_dim)
        jr, tr = j.reduced(), t.reduced()
        for f in dataclasses.fields(tr):
            assert getattr(tr, f.name) == getattr(jr, f.name), (name, f.name)
        assert tr.param_count() == jr.param_count()
    g = get_config("recurrentgemma-2b").reduced()
    assert (g.num_layers, g.window, g.attn_every) == (3, 8, 3)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for state in (None, st):
        jy, js = jmamba2.causal_conv(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), None if state is None
                                     else jnp.asarray(state))
        ty, ts = mamba2.causal_conv(T(x), T(w), T(b),
                                    None if state is None else T(state))
        assert _rel(ty, jy) < 1e-6
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_ssd_chunked_and_decode_step_match_reference():
    """T = 21 over chunks of 8 (padded with dt = 0), with an initial
    state, with two state groups; the one-token step."""
    rng = np.random.default_rng(3)
    bsz, t, h, p, n = 2, 21, 4, 8, 6
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    for g, init in ((1, False), (1, True), (2, True)):
        x = rng.standard_normal((bsz, t, h, p)).astype(np.float32)
        dt = np.log1p(np.exp(rng.standard_normal((bsz, t, h)))).astype(
            np.float32)
        b, c = (rng.standard_normal((bsz, t, g, n)).astype(np.float32)
                for _ in range(2))
        s0 = (rng.standard_normal((bsz, h, p, n)).astype(np.float32)
              if init else None)
        jy, js = jax.jit(jmamba2.ssd_chunked, static_argnums=5)(
            *(jnp.asarray(v) for v in (x, dt, a, b, c)), 8,
            None if s0 is None else jnp.asarray(s0))
        ty, ts = mamba2.ssd_chunked(*(T(v) for v in (x, dt, a, b, c)), 8,
                                    None if s0 is None else T(s0))
        assert _rel(ty, jy) < 1e-5, (g, init)
        assert _rel(ts, js) < 1e-5, (g, init)
        jy1, js1 = jmamba2.ssd_decode_step(
            *(jnp.asarray(v[:, 0]) for v in (x, dt)), jnp.asarray(a),
            *(jnp.asarray(v[:, 0]) for v in (b, c)), js)
        ty1, ts1 = mamba2.ssd_decode_step(
            *(T(v[:, 0]) for v in (x, dt)), T(a),
            *(T(v[:, 0]) for v in (b, c)), ts)
        assert _rel(ty1, jy1) < 1e-5 and _rel(ts1, js1) < 1e-5


def test_rglru_scan_and_step_match_reference():
    """The doubling scan against ``associative_scan`` (T = 37, not a power
    of two; with and without an initial state), against a sequential loop
    of ``rglru_step``, and the step against the reference's."""
    jm, tm, jp, tp = _setup("recurrentgemma-2b")
    jr, tr = jp["layers"][0]["kind_rec"]["rglru"], \
        tp["layers"][0]["kind_rec"]["rglru"]
    # non-zero gates, so r and i vary per channel and step
    rng = np.random.default_rng(4)
    for k in ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b"):
        v = rng.standard_normal(jr[k].shape).astype(np.float32)
        jr, tr = {**jr, k: jnp.asarray(v)}, {**tr, k: T(v)}
    x = rng.standard_normal((2, 37, tm.cfg.rnn_dim)).astype(np.float32)
    h0 = rng.standard_normal((2, tm.cfg.rnn_dim)).astype(np.float32)
    jscan = jax.jit(jgriffin.rglru_scan)
    for init in (None, h0):
        jy, jh = jscan(jr, jnp.asarray(x),
                       None if init is None else jnp.asarray(init))
        ty, th = griffin.rglru_scan(tr, T(x), None if init is None
                                    else T(init))
        assert _rel(ty, jy) < 1e-5 and _rel(th, jh) < 1e-5
    h = T(h0)
    steps = []
    for i in range(x.shape[1]):
        y, h = griffin.rglru_step(tr, T(x[:, i:i + 1]), h)
        steps.append(y)
    assert _rel(torch.cat(steps, 1), ty) < 1e-5
    jy1, jh1 = jgriffin.rglru_step(jr, jnp.asarray(x[:, :1]),
                                   jnp.asarray(h0))
    ty1, th1 = griffin.rglru_step(tr, T(x[:, :1]), T(h0))
    assert _rel(ty1, jy1) < 1e-6 and _rel(th1, jh1) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_reference(arch):
    """A whole mamba2 block / RG-LRU half-block over 11 tokens, then one
    decode step from the states it returns."""
    jm, tm, jp, tp = _setup(arch)
    cfg = tm.cfg
    u = np.random.default_rng(5).standard_normal((2, 11, cfg.d_model)
                                                 ).astype(np.float32)
    if arch == "mamba2-1.3b":
        jb = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
        tb = {k: (v[0] if isinstance(v, torch.Tensor) else
                  {kk: vv[0] for kk, vv in v.items()})
              for k, v in tp["layers"].items()}
        jfn, tfn = jmamba2.apply_mamba2_block, mamba2.apply_mamba2_block
    else:
        jb = jp["layers"][0]["kind_rec"]["rglru"]
        tb = tp["layers"][0]["kind_rec"]["rglru"]
        jfn, tfn = jgriffin.apply_rglru_block, griffin.apply_rglru_block
    jfn = jax.jit(jfn, static_argnums=2, static_argnames="decode")
    jo, js, jc = jfn(jb, jnp.asarray(u[:, :10]), cfg)
    to, ts, tc = tfn(tb, T(u[:, :10]), cfg)
    for got, want in ((to, jo), (ts, js), (tc, jc)):
        assert _rel(got, want) < 1e-5
    jo, js, _ = jfn(jb, jnp.asarray(u[:, 10:]), cfg, js, jc, decode=True)
    to, ts, _ = tfn(tb, T(u[:, 10:]), cfg, ts, tc, decode=True)
    assert _rel(to, jo) < 1e-5 and _rel(ts, js) < 1e-5


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, ref):
    _, tm, _, tp = _setup(arch)
    toks = T(_tokens(arch, 21))
    assert _rel(tm.forward(tp, {"tokens": toks}), ref[arch, "forward"]) < 1e-5
    np.testing.assert_allclose(float(tm.loss(tp, {"tokens": toks})),
                               ref[arch, "loss"], rtol=1e-5)


@pytest.mark.parametrize("arch,t", [("mamba2-1.3b", 13),
                                    ("recurrentgemma-2b", 6),
                                    ("recurrentgemma-2b", 20)])
def test_prefill_and_decode_match_reference(arch, t, ref):
    """Prefill of T tokens and 6 decode steps against the reference's own
    decode path; griffin below the window (T 6: the ring fills and wraps
    during decode) and above it (T 20: prefill rolls the ring)."""
    _, tm, _, tp = _setup(arch)
    full = T(_tokens(arch, t + 6, seed=2))
    got = teacher_forced(tm, tp, full[:, :t], full[:, t:], 6, MAX_LEN)
    assert _rel(got, ref[arch, "decode", t]) < 1e-5
    lg, cache = tm.prefill(tp, {"tokens": full[:, :t]}, MAX_LEN)
    assert cache["len"].tolist() == [t, t]
    if arch == "recurrentgemma-2b":
        w = tm.cfg.window
        assert cache["k"].shape[2] == min(MAX_LEN, w)
        # position p of the last window lives in slot p % w
        k_all = tm._block_full_kv(tp["layers"][2]["kind_attn"],
                                  _hidden_before_attn(tm, tp, full[:, :t]),
                                  torch.arange(t)[None], window=w)[1]
        for p in range(max(0, t - w), t):
            assert torch.equal(cache["k"][0, :, p % w], k_all[:, p])


def _hidden_before_attn(tm, tp, tokens):
    """griffin reduced: the hidden state entering layer 2 (the attention
    block), through the two recurrent blocks."""
    from repro_torch.models.model import _rec_block
    x = tp["embed"][tokens.long()]
    for blk in tp["layers"][:2]:
        x = _rec_block(blk["kind_rec"], x, tm.cfg)[0]
    return x


def test_ring_decode_through_flash_decode_matches_masked_attention():
    """The ring buffer read through ``ops.flash_decode``'s plain version
    over min(len + 1, s) slots against the reference's absolute-position
    window mask (``_masked_decode_attention``), before and after the wrap,
    for a ring shorter than the window too."""
    rng = np.random.default_rng(6)
    b, hkv, g, d, w = 3, 2, 2, 16, 8
    for s in (8, 5):
        k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
                for _ in range(2))
        q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
        for cur in ([0, 3, 7], [8, 12, 30]):
            cur = np.asarray(cur, np.int32)
            base = (cur // s) * s
            pos = np.arange(s)[None] + base[:, None]
            pos = np.where(np.arange(s)[None] <= (cur % s)[:, None], pos,
                           pos - s)
            valid = (pos >= 0) & (pos <= cur[:, None]) & \
                (pos > cur[:, None] - w)
            want = jtransformer._masked_decode_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(valid))
            got = ops.flash_decode(T(q), (T(k), T(v)),
                                   torch.clamp_max(T(cur) + 1, s),
                                   mode="plain")
            assert _rel(got, want) < 1e-5, (s, cur)


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------

def test_engine_exact_length_groups_and_refusals():
    """Whole-prompt admission groups prompts of one exact length and passes
    no ``lengths``; chunked admission and the paged cache are refused with
    the reference's errors, and so is a padded prefill."""
    _, tm, _, tp = _setup("recurrentgemma-2b")
    assert not tm.supports_padded_prefill and not tm.supports_chunked_prefill
    calls = []

    class Spy(Model):
        def prefill(self, params, batch, max_len):
            calls.append((sorted(batch), tuple(batch["tokens"].shape),
                          max_len))
            return super().prefill(params, batch, max_len)

    spy = Spy(tm.cfg, "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32)
               for n in (9, 9, 5, 12)]
    eng = Engine(spy, tp, ServeConfig(max_batch=4, max_len=MAX_LEN,
                                      max_new=4, prefill_bucket=16))
    reqs = [eng.submit(p) for p in prompts]
    eng.run(max_steps=100)
    assert all(r.status is RequestStatus.COMPLETED for r in reqs)
    assert calls == [(["tokens"], (2, 9), 9), (["tokens"], (1, 5), 5),
                     (["tokens"], (1, 12), 12)]
    with pytest.raises(ValueError, match="chunked admission"):
        Engine(tm, tp, ServeConfig(prefill_chunk=8))
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        Engine(tm, tp, ServeConfig(paged=True, page_size=8, max_len=MAX_LEN))
    with pytest.raises(ValueError, match="padded prefill is not exact"):
        tm.prefill(tp, {"tokens": T(prompts[0][None]),
                        "lengths": T(np.asarray([9], np.int32))}, MAX_LEN)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        tm.prefill_chunk(tp, {"tokens": T(prompts[0][None])}, {}, [0])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference_engine(arch):
    """Five prompts of three lengths (griffin's longest past its window)
    through the reference Engine and the port's: each stream greedy-equal,
    or every token the port's greedy choice within 1e-5."""
    jm, tm, jp, tp = _setup(arch)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32)
               for n in (7, 7, 12, 12, 5)]
    kw = dict(max_batch=3, max_len=MAX_LEN, max_new=8)
    jeng = JEngine(jm, jp, JServeConfig(**kw))
    jreqs = [jeng.submit(p) for p in prompts]
    jeng.run()
    eng = Engine(tm, tp, ServeConfig(**kw))
    reqs = [eng.submit(p) for p in prompts]
    eng.run(max_steps=200)
    for p, jr, r in zip(prompts, jreqs, reqs):
        assert r.status is RequestStatus.COMPLETED
        assert len(r.out_tokens) == 8
        if list(r.out_tokens) == list(jr.out_tokens):
            continue
        gen = T(np.asarray([jr.out_tokens], np.int32))
        lg = teacher_forced(tm, tp, T(p[None]), gen, 7, MAX_LEN)
        assert near_greedy(lg, gen, 1e-5) == 1.0


# ---------------------------------------------------------------------------
# training, checkpoints, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_first_train_step_matches_reference(arch):
    """As ``test_torch_train.py``: the first step (lr_scale 0: the params
    stay, the moments carry the gradients), with remat on both sides and
    two microbatches."""
    jm, tm, jp, tp = _setup(arch)
    over = dict(remat=True, microbatches=2)
    jcfg = dataclasses.replace(jm.cfg, **over)
    tcfg = dataclasses.replace(tm.cfg, **over)
    jc, tc = jadam.AdamConfig(lr=3e-3), adam.AdamConfig(lr=3e-3)
    jstep = jax.jit(jmake_train_step(jbuild_model(jcfg), jc, 10, 2))
    tstep = make_train_step(Model(tcfg, "cpu"), tc, 10, 2)
    batch = _tokens(arch, 24, b=4, seed=9)
    jstate = JTrainState(jp, jadam.adam_init(jp, jc), jnp.int32(0))
    tstate = TrainState(tp, adam.adam_init(tp, tc),
                        torch.tensor(0, dtype=torch.int32))
    jnew, jmet = jstep(jstate, {"tokens": jnp.asarray(batch)})
    tnew, tmet = tstep(tstate, {"tokens": T(batch)})
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                   rtol=1e-5, err_msg=name)
    want = {k: np.asarray(v, np.float64)
            for k, v in jckpt._flatten(jnew).items()}
    got = {k: np.asarray(a, np.float64)
           for k, (a, _) in checkpoints.flatten(tnew).items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-5 * max(np.abs(w).max(),
                                                       1e-30), k


def test_trees_cross_the_checkpoints_both_ways(tmp_path):
    """griffin's list layout and mamba2's stacked layers, byte for byte:
    the port's save read by the reference's restore, the reference's save
    read by the port's restore, and the float loader of ``--ckpt`` gives
    griffin's list back."""
    from repro_torch.launch.calibrate import load_float_params
    for arch in ARCHS:
        jm, tm, jp, tp = _setup(arch)
        checkpoints.save(tmp_path / arch / "t", 1, tp)
        back, _ = jckpt.restore(tmp_path / arch / "t", jp)
        jckpt.save(tmp_path / arch / "j", 1, jp)
        mine, _ = checkpoints.restore(tmp_path / arch / "j", tp)
        want = jckpt._flatten(jp)
        for tree in (jckpt._flatten(back),
                     {k: a for k, (a, _) in
                      checkpoints.flatten(mine).items()}):
            assert sorted(tree) == sorted(want)
            for k, w in want.items():
                np.testing.assert_array_equal(np.asarray(tree[k]), w)
        loaded = load_float_params(tmp_path / arch / "j", tm.cfg,
                                   QuantConfig(), "cpu")
        got = checkpoints.flatten(loaded)
        assert sorted(got) == sorted(want)
        if arch == "recurrentgemma-2b":
            assert isinstance(loaded["layers"], list)
            assert "kind_attn" in loaded["layers"][2]
        np.testing.assert_array_equal(
            tm.forward(loaded, {"tokens": T(_tokens(arch, 5))}).numpy(),
            tm.forward(tp, {"tokens": T(_tokens(arch, 5))}).numpy())


def test_quantized_paths_refuse_and_the_clis_run(monkeypatch):
    """Calibration (and its CLI), the packer, ``QuantizedModel``, the
    baselines and the serve CLI's packed path refuse mamba2 and griffin
    (the reference has no quantized path for them); ``launch/serve --fp`` and
    ``launch/train`` run both (their reduced configs)."""
    from repro_torch.core.baselines import quantize_model_baseline
    from repro_torch.core.calibration import CalibConfig, quantize_dense_model
    from repro_torch.launch import calibrate as calibrate_cli
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.serve.quantized import QuantizedModel, quantize_lm_packed
    toks = torch.zeros((1, 8), dtype=torch.int32)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        for call in (
                lambda: quantize_dense_model({}, cfg, QuantConfig(),
                                             CalibConfig(), toks),
                lambda: quantize_lm_packed({}, cfg, QuantConfig()),
                lambda: QuantizedModel(cfg, QuantConfig(), device="cpu"),
                lambda: quantize_model_baseline({}, cfg, QuantConfig(), toks,
                                                "rtn"),
                lambda: sites.block_sites(cfg, True),
                lambda: calibrate_cli.main(["--arch", arch, "--device",
                                            "cpu"]),
                lambda: serve_cli.main(["--arch", arch, "--device", "cpu"])):
            with pytest.raises(NotImplementedError,
                               match="no quantized path"):
                call()
    monkeypatch.setattr(serve_cli, "get_config",
                        lambda name: get_config(name).reduced())
    for arch in ARCHS:
        out = serve_cli.main(["--arch", arch, "--fp", "--device", "cpu",
                              "--max-len", "32", "--prompt-len", "11",
                              "--max-new", "4", "--requests", "3"])
        assert out["statuses"] == {"COMPLETED": 3}
        res = train_cli.train(train_cli.build_parser().parse_args(
            ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
             "--global-batch", "4", "--seq", "16", "--ckpt-dir", ""]))
        assert len(res["history"]) == 3
        assert np.isfinite(res["final_loss"])
