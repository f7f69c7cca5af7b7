"""Port parity for the MoE family (qwen3-moe-30b-a3b and dbrx-132b at the
reference's ``reduced()`` size: 2 layers, d 64, 4 experts top-2): the
router, the capacity dispatch and ``apply_moe``; the float forward, the
loss with its load-balance term and the first train step; the packed tree
and ``QuantizedModel``; the Engine over both layouts; calibration; the npz
checkpoints.  The weights are the reference's seeded init, carried across
by ``from_jax_params``.

Tolerances: ``capacity`` equal; the dispatch's slot tokens byte-equal and
its gates within 1e-7 at a size where tokens drop; the expert ids equal
(no routing flip shows at these seeds: the tests count flips first, so a
flip would show as such and not as a logit error); ``apply_moe``'s output
and load-balance loss within 1e-5 of their magnitude; the float logits
within 1e-5 of the largest logit and the loss within 1e-5 relative; the
first train step as ``test_torch_train.py`` holds it (loss and grad norm
rtol 1e-5, every leaf within 1e-5 of its largest magnitude); packed expert
codes, scales and zero points byte-equal; ``QuantizedModel``'s logits
within 1e-5 of the largest logit at a16 and 1e-4 at a4 kv8, greedy tokens
equal; calibration losses within 1e-5 relative and at most 1e-3 of the
codes moved (one level: ``torch.sigmoid`` is not ``jax.nn.sigmoid`` bit
for bit, ROADMAP queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import calibration as jcal
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.core.sites import block_sites as jblock_sites
from repro.core.sites import quantized_weights as jquantized_weights
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.optim import adam as jadam
from repro.serve.quantized import QuantizedModel as JQuantizedModel
from repro.serve.quantized import quantize_lm_packed as jquantize_lm_packed
from repro.train import checkpoints as jckpt
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.bridge import from_jax_params
from repro_torch.configs import MOE_ARCHS, get_config
from repro_torch.core import calibration as tcal
from repro_torch.core import sites
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantizer import QuantConfig
from repro_torch.launch.serve import agreement
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.optim import adam
from repro_torch.serve.engine import Engine, RequestStatus, ServeConfig
from repro_torch.serve.quantized import QuantizedModel, quantize_lm_packed
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
ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b")


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _rel(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))
                 / np.max(np.abs(np.asarray(want))))


_SETUPS: dict = {}


def _setup(arch: str):
    """(reference cfg, port cfg, reference params, port params, tokens):
    the reference's seeded init of the reduced config, carried across."""
    if arch not in _SETUPS:
        jcfg = jget_config(arch).reduced()
        tcfg = get_config(arch).reduced()
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        tokens = np.random.default_rng(1).integers(
            0, jcfg.vocab_size, (2, 24)).astype(np.int32)
        _SETUPS[arch] = (jcfg, tcfg, jparams,
                         from_jax_params(_np(jparams)), tokens)
    return _SETUPS[arch]


# ---------------------------------------------------------------------------
# configs, the router, the dispatch and apply_moe
# ---------------------------------------------------------------------------

def test_registry_and_reduced_configs_match_reference():
    for name in ARCHS:
        j, t = jget_config(name), get_config(name)
        for f in dataclasses.fields(t):
            if f.name != "dtype":        # the port computes in float32
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        jr, tr = j.reduced(), t.reduced()
        for f in dataclasses.fields(tr):
            assert getattr(tr, f.name) == getattr(jr, f.name), f.name
        assert tr.param_count() == jr.param_count()
    assert sorted(MOE_ARCHS) == sorted(ARCHS)
    q = get_config("qwen3-moe-30b-a3b")
    assert (q.num_layers, q.d_model, q.num_experts, q.top_k, q.d_ff) == \
        (48, 2048, 128, 8, 768)
    assert q.param_count() == 30_532_108_288


def test_capacity_matches_reference():
    for n in (1, 4, 7, 64, 100, 512, 4096):
        for k, e in ((1, 4), (2, 4), (4, 16), (8, 128)):
            for cf in (1.0, 1.25, 4.0):
                assert moe.capacity(n, k, e, cf) == jmoe.capacity(n, k, e, cf)


def _routing(arch, n, seed):
    """Routed tokens of the reduced config's first layer: (cfg, router,
    tokens, the reference's gates and ids, the port's)."""
    jcfg, _, jparams, _, _ = _setup(arch)
    router = np.asarray(jparams["layers"]["moe"]["router"][0])
    # a router scaled up so the experts are unevenly loaded and tokens drop
    router = router * 40.0
    tok = np.random.default_rng(seed).standard_normal(
        (n, jcfg.d_model)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(tok) @ jnp.asarray(router), axis=-1)
    jg, ji = jax.lax.top_k(probs, jcfg.top_k)
    jg = jg / jnp.maximum(jnp.sum(jg, axis=-1, keepdims=True), 1e-9)
    _, tg, ti = moe.route(T(router), T(tok), jcfg.top_k)
    return jcfg, router, tok, np.asarray(jg), np.asarray(ji), tg, ti


def test_route_and_dispatch_match_reference():
    """Expert ids equal (flips counted first) and the router's gates within
    1e-6 (float32 ``tokens @ router`` sums in another order than XLA, and
    the router here is scaled up 40x); on the same routing, the slot
    tokens byte-equal at a capacity where tokens drop, the slot gates
    within 1e-7, and every kept (token, k) pair's slot holds that token."""
    jcfg, router, tok, jg, ji, tg, ti = _routing(ARCHS[0], 96, 2)
    flips = int(np.sum(np.any(ti.numpy() != ji, axis=-1)))
    assert flips == 0, f"{flips} tokens routed differently"
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-6)
    e, k = jcfg.num_experts, jcfg.top_k
    cap = 40
    counts = np.bincount(ji.reshape(-1), minlength=e)
    assert counts.max() > cap, counts           # tokens drop
    _, jtok, jgates = jmoe._dispatch_group(jnp.asarray(tok), jnp.asarray(jg),
                                           jnp.asarray(ji), e, k, cap)
    xe, ttok, tgates, slot = moe._dispatch_group(T(tok), T(jg),
                                                 T(ji).long(), e, k, cap)
    assert ttok.dtype == torch.int64
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tgates.numpy(), np.asarray(jgates), rtol=0,
                               atol=1e-7)
    assert torch.equal(xe, T(tok)[ttok.reshape(-1)].reshape(e, cap, -1))
    kept = slot >= 0
    assert int((~kept).sum()) == int(np.sum(np.maximum(counts - cap, 0)))
    flat = ttok.reshape(-1)
    rows = torch.arange(96)[:, None].expand(96, k)
    assert torch.equal(flat[slot[kept]], rows[kept])


def test_ties_break_to_the_lower_expert():
    probs_router = torch.zeros((4, 6))
    tokens = torch.ones((3, 4))
    _, _, ids = moe.route(probs_router, tokens, 3)
    assert ids.tolist() == [[0, 1, 2]] * 3
    jids = jax.lax.top_k(jnp.full((3, 6), 1.0 / 6), 3)[1]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch):
    jcfg, _, jparams, tparams, _ = _setup(arch)
    jp = jax.tree_util.tree_map(lambda t: t[0], jparams["layers"]["moe"])
    tp = {k: v[0] for k, v in tparams["layers"]["moe"].items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)
    kw = dict(top_k=jcfg.top_k, capacity_factor=jcfg.capacity_factor,
              act=jcfg.act)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), **kw)
    ty, taux = moe.apply_moe(tp, T(x), **kw)
    _, _, ids = moe.route(tp["router"], T(x).reshape(80, -1), jcfg.top_k)
    jprobs = jax.nn.softmax(jnp.asarray(x.reshape(80, -1)) @ jp["router"])
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jax.lax.top_k(jprobs, jcfg.top_k)[1]))
    assert ty.shape == x.shape and taux.dtype == torch.float32
    assert _rel(ty.numpy(), jy) < 1e-5
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)


# ---------------------------------------------------------------------------
# the float model, its loss and the first train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_with_aux_match_reference(arch):
    jcfg, tcfg, jparams, tparams, tokens = _setup(arch)
    jm, tm = jbuild_model(jcfg), Model(tcfg, "cpu")
    batch = {"tokens": jnp.asarray(tokens)}
    want = np.asarray(jax.jit(jm.forward)(jparams, batch))
    got = tm.forward(tparams, {"tokens": tokens}).numpy()
    assert _rel(got, want) < 1e-5
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    jl = float(jax.jit(jm.loss)(jparams, batch))
    tl = float(tm.loss(tparams, {"tokens": tokens}))
    assert tl == pytest.approx(jl, rel=1e-5)
    # the load-balance term is there: about 0.01 per layer at balance
    from repro_torch.models import transformer
    _, aux = transformer.forward_with_aux(tparams, tcfg, T(tokens))
    assert 0.5 * tcfg.num_layers < float(aux) < 4 * tcfg.num_layers


def test_first_train_step_matches_reference():
    """As ``test_torch_train.py``: lr_scale is 0 on the first step, so the
    params stay and the moments carry the gradients of the loss with its
    load-balance term; two microbatches."""
    jcfg, tcfg, jparams, tparams, tokens = _setup(ARCHS[0])
    jcfg = dataclasses.replace(jcfg, microbatches=2)
    tcfg = dataclasses.replace(tcfg, microbatches=2)
    jc, tc = jadam.AdamConfig(lr=3e-3), adam.AdamConfig(lr=3e-3)
    jstep = jax.jit(jmake_train_step(jbuild_model(jcfg), jc, 10, 2))
    tstep = make_train_step(Model(tcfg, "cpu"), tc, 10, 2)
    batch = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    jstate = JTrainState(jparams, jadam.adam_init(jparams, jc), jnp.int32(0))
    tstate = TrainState(tparams, adam.adam_init(tparams, tc),
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
    assert any("||moe||router" in k for k in got)
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-5 * np.abs(w).max(), k


# ---------------------------------------------------------------------------
# the packed tree, QuantizedModel and the Engine
# ---------------------------------------------------------------------------

SETTINGS = {"w4a16": dict(a_bits=16, kv_bits=16, tol=1e-5),
            "w4a4kv8": dict(a_bits=4, kv_bits=8, tol=1e-4)}
_PACKED: dict = {}


def _packed(name: str):
    if name not in _PACKED:
        jcfg, tcfg, jparams, tparams, tokens = _setup(ARCHS[0])
        s = SETTINGS[name]
        jq = JQuantConfig(w_bits=4, a_bits=s["a_bits"], group_size=32,
                          lwc=False, kv_bits=s["kv_bits"])
        tq = QuantConfig(w_bits=4, a_bits=s["a_bits"], group_size=32,
                         kv_bits=s["kv_bits"])
        _PACKED[name] = (JQuantizedModel(jcfg, jq, kernel_mode="ref"),
                         jquantize_lm_packed(jparams, jcfg, jq),
                         QuantizedModel(tcfg, tq, device="cpu"),
                         quantize_lm_packed(tparams, tcfg, tq), s["tol"],
                         tokens)
    return _PACKED[name]


def test_packed_experts_byte_equal_to_reference():
    """Every expert packed one (K, N) matrix at a time through
    ``quantize_pack``'s plain version: the bytes of the reference's
    ``quantize_codes``; the router stays float; ``from_jax_params`` carries
    the reference's stacked QTensor experts across."""
    _, jp, _, tp, _, _ = _packed("w4a16")
    jm, tm = jp["layers"]["moe"], tp["layers"]["moe"]
    assert sorted(tm) == sorted(jm) == ["router", "w_down", "w_gate", "w_up"]
    assert not isinstance(tm["router"], QTensor)
    np.testing.assert_array_equal(tm["router"].numpy(),
                                  np.asarray(jm["router"]))
    bridged = from_jax_params(_np(jp))["layers"]["moe"]
    for k in ("w_gate", "w_up", "w_down"):
        assert tm[k].packed.ndim == 4                       # (L, E, ., N)
        assert (tm[k].bits, tm[k].group_size) == (jm[k].bits,
                                                  jm[k].group_size)
        assert isinstance(bridged[k], QTensor)
        for f in ("packed", "scale", "zp"):
            np.testing.assert_array_equal(getattr(tm[k], f).numpy(),
                                          np.asarray(getattr(jm[k], f)))
            assert torch.equal(getattr(bridged[k], f), getattr(tm[k], f))


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_quantized_model_matches_reference(setting):
    """End-padded prompts of 16 and 11 tokens, then 8 teacher-forced
    decode steps over the linear cache; the experts run on the float
    activations at a4 too, as the reference's ``_moe_apply``."""
    jm, jp, tm, tp, tol, tokens = _packed(setting)
    lengths = np.asarray([16, 11], np.int32)
    lg, jcache = jax.jit(jm.prefill, static_argnames=("max_len",))(
        jp, {"tokens": jnp.asarray(tokens[:, :16]),
             "lengths": jnp.asarray(lengths)}, max_len=32)
    tl, tcache = tm.prefill(tp, {"tokens": T(tokens[:, :16]),
                                 "lengths": T(lengths)}, max_len=32)
    want, got = [np.asarray(lg)], [tl.numpy()]
    jstep = jax.jit(jm.decode_step)
    for i in range(8):
        tok = tokens[:, 16 + i:17 + i]
        lg, jcache = jstep(jp, jnp.asarray(tok), jcache)
        tl, tcache = tm.decode_step(tp, T(tok), tcache)
        want.append(np.asarray(lg))
        got.append(tl.numpy())
    want, got = np.concatenate(want, 1), np.concatenate(got, 1)
    assert _rel(got, want) < tol
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _engine(tm, tp, prompts, **kw):
    cfg = dict(max_batch=3, max_len=64, max_new=10, prefill_bucket=16,
               page_size=8)
    eng = Engine(tm, tp, ServeConfig(**{**cfg, **kw}))
    reqs = [eng.submit(p) for p in prompts]
    eng.run(max_steps=500)
    assert all(r.status is RequestStatus.COMPLETED for r in reqs)
    return eng, [list(r.out_tokens) for r in reqs]


def test_engine_linear_equals_paged_and_chunked_completes():
    """Whole-prompt admission runs the same prefill shapes over both
    layouts, so the expert capacities match and the paged streams equal
    the linear ones; chunked admission into a pool that preempts
    completes (capacity competes per chunk there: the reference's
    documented approximation, so its streams are logged, not held)."""
    _, _, tm, tp, _, _ = _packed("w4a4kv8")
    assert tm.supports_padded_prefill and tm.supports_chunked_prefill
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32)
               for n in (12, 5, 16, 9)]
    _, lin = _engine(tm, tp, prompts)
    eng, paged = _engine(tm, tp, prompts, paged=True)
    assert paged == lin
    assert eng._kv.allocator.num_free == eng._kv.allocator.num_pages
    eng, tight = _engine(tm, tp, prompts[:3], max_new=20, paged=True,
                         num_pages=7, prefill_chunk=8)
    assert eng.preemptions > 0, "the pool never ran dry"
    assert all(len(s) == 20 for s in tight)
    assert 0.0 <= agreement(lin, tight) <= 1.0


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_sites_and_quantized_weights_match_reference():
    for name in ARCHS:
        for wo in (True, False):
            j = jblock_sites(jget_config(name), wo)
            t = sites.block_sites(get_config(name), wo)
            assert [dataclasses.asdict(s) for s in t] == \
                [dataclasses.asdict(s) for s in j]
        assert sites.quantized_weights(get_config(name)) == \
            jquantized_weights(jget_config(name))
    assert not sites.block_sites(get_config(ARCHS[0]), False)[2].with_shift


def _jit_calibration_tail(monkeypatch):
    """The reference's stream advance and packed finalize under ``jit``
    (its op-by-op eager run of them took 12 of the test's 35 s): only a
    tolerance is compared there, and ``jit``'s reciprocal division moves
    at most a code or two."""
    fwd, fin = jcal.quant_block_forward, jcal.finalize_block

    def quant_block_forward(bp, qp, x, cfg, qcfg, ccfg, masks, positions):
        return jax.jit(lambda bp, a, lwc, x, m: fwd(
            bp, {"affine": a, "lwc": lwc, "_sites": qp["_sites"]}, x, cfg,
            qcfg, ccfg, m, positions))(bp, qp["affine"], qp["lwc"], x, masks)

    def finalize_block(bp, qp, cfg, qcfg, ccfg, deploy="fake"):
        return jax.jit(lambda bp, a, lwc: fin(
            bp, {"affine": a, "lwc": lwc, "_sites": qp["_sites"]}, cfg, qcfg,
            ccfg, deploy=deploy))(bp, qp["affine"], qp["lwc"])

    monkeypatch.setattr(jcal, "quant_block_forward", quant_block_forward)
    monkeypatch.setattr(jcal, "finalize_block", finalize_block)


def test_calibration_matches_reference(monkeypatch):
    """The reference's MoE calibration setup (``tests/test_calibration.py``:
    capacity factor 4, so no token drops; W4A16 per-channel LWC, alpha 0.1,
    3 epochs), on the first layer (the reference's compile of its step
    takes most of the test's time): per-epoch losses within 1e-5 relative,
    the packed finalize's expert codes within 1e-3 moved, the router
    transformed by the shared full ``ln_mlp`` site and its inverse kept as
    ``mlp_t``."""
    _jit_calibration_tail(monkeypatch)
    jcfg, tcfg, jparams, _, _ = _setup(ARCHS[0])
    jcfg = dataclasses.replace(jcfg, capacity_factor=4.0, num_layers=1)
    tcfg = dataclasses.replace(tcfg, capacity_factor=4.0, num_layers=1)
    jparams = dict(jparams, layers=jax.tree_util.tree_map(
        lambda x: x[:1], jparams["layers"]))
    tparams = from_jax_params(_np(jparams))
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (8, 32)).astype(np.int32)
    jq = JQuantConfig(w_bits=4, a_bits=16, group_size=0, lwc=True)
    tq = QuantConfig(w_bits=4, a_bits=16, group_size=0, lwc=True)
    kw = dict(epochs=3, alpha=0.1, batch_size=4)
    jpacked, jinfo = jcal.quantize_dense_model(
        jparams, jcfg, jq, jcal.CalibConfig(**kw), jnp.asarray(toks),
        log=False, deploy="packed")
    tpacked, tinfo = tcal.quantize_dense_model(
        tparams, tcfg, tq, tcal.CalibConfig(**kw), T(toks), log=False,
        deploy="packed")
    np.testing.assert_allclose(np.asarray(tinfo["block_losses"]),
                               np.asarray(jinfo["block_losses"]), rtol=1e-5)
    jl, tl = jpacked["layers"], tpacked["layers"]
    assert "mlp_t" in tl and "mlp_t" in jl
    np.testing.assert_allclose(tl["moe"]["router"].numpy(),
                               np.asarray(jl["moe"]["router"]), rtol=1e-5,
                               atol=1e-6)
    for k in ("w_gate", "w_up", "w_down"):
        got, want = tl["moe"][k].codes().numpy(), np.asarray(
            jl["moe"][k].codes())
        assert got.shape == want.shape == (1, 4, *want.shape[2:])
        moved = got != want
        assert moved.mean() <= 1e-3, (k, moved.mean())
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_moe_trees_cross_the_checkpoints_both_ways(tmp_path):
    """The reference's float and packed MoE trees read by ``load_tree``
    byte for byte (stacked (L, E, K, N) experts, QTensor bits and groups
    recovered); the port's packed tree restored by the reference."""
    jcfg, tcfg, jparams, tparams, _ = _setup(ARCHS[0])
    _, jp, tm, tp, _, _ = _packed("w4a16")
    for name, jtree, ttree in (("float", jparams, tparams),
                               ("packed", jp, tp)):
        jckpt.save(tmp_path / name, 0, jtree)
        got = checkpoints.load_tree(tmp_path / name, tcfg, tm.qcfg,
                                    device="cpu")
        want, back = checkpoints.flatten(ttree), checkpoints.flatten(got)
        assert sorted(back) == sorted(want)
        assert any(k.startswith("layers||moe||w_up") for k in back)
        for k, (a, _) in want.items():
            assert back[k][0].tobytes() == a.tobytes(), (name, k)
    assert got["layers"]["moe"]["w_up"].group_size == 32
    checkpoints.save(tmp_path / "port", 1, tp)
    restored, step = jckpt.restore(tmp_path / "port", jp)
    assert step == 1
    for k, v in jckpt._flatten(jp).items():
        assert np.asarray(jckpt._flatten(restored)[k]).tobytes() == \
            np.asarray(v).tobytes(), k
