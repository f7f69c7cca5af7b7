"""Port parity for the transformer trunk's other two families at the
reference's ``reduced()`` size: the VLM (paligemma-3b: 2 layers, d 64, 4
prefix slots under the prefix-LM mask) and the audio encoder
(hubert-xlarge: bidirectional, frame embeddings with sinusoidal positions
in, a frame cross entropy out, no decode path).  The weights are the
reference's seeded init, carried across by ``from_jax_params``.

Tolerances: the masks equal; attention within 1e-6 of its magnitude;
logits within 1e-5 of the largest logit, losses within 1e-5 relative;
prefill with a prefix + decode against the reference's within 1e-5 of the
largest logit; the first train step as ``test_torch_train.py`` holds it;
Engine streams greedy-equal to the reference Engine's, or tied within
1e-5.  The reference's outputs are computed once, jitted, in a module
fixture.
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
from repro.optim import adam as jadam
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.train import checkpoints as jckpt
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core import sites
from repro_torch.core.quantizer import QuantConfig
from repro_torch.launch.serve import near_greedy, teacher_forced
from repro_torch.models import attention
from repro_torch.models.model import ENCODER_ONLY, Model
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
VLM, AUDIO = "paligemma-3b", "hubert-xlarge"
MAX_LEN = 48


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


_SETUPS: dict = {}


def _setup(arch: str):
    """(reference model, port model, reference params, port params)."""
    if arch not in _SETUPS:
        jm = jbuild_model(jget_config(arch).reduced())
        jp = jm.init(jax.random.PRNGKey(0))
        _SETUPS[arch] = (jm, Model(get_config(arch).reduced(), "cpu"), jp,
                         from_jax_params(_np(jp)))
    return _SETUPS[arch]


def _batch(arch: str, t: int = 17, seed: int = 1) -> dict:
    """Seeded numpy inputs: tokens and prefix embeddings (VLM), or frame
    embeddings, frame labels and a mask (audio)."""
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if arch == AUDIO:
        return {"embeds": f(2, t, cfg.d_model),
                "labels": rng.integers(0, cfg.vocab_size, (2, t)).astype(
                    np.int32),
                "mask": (rng.random((2, t)) > 0.2).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (2, t)).astype(
                np.int32),
            "prefix_embeds": 0.5 * f(2, cfg.num_prefix, cfg.d_model)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: T(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's forwards, losses and VLM prefill + decode logits,
    jitted, computed once."""
    out = {}
    for arch in (VLM, AUDIO):
        jm, _, jp, _ = _setup(arch)
        b = _batch(arch)
        out[arch, "forward"] = np.asarray(jax.jit(jm.forward)(jp, _j(b)))
        out[arch, "loss"] = float(jax.jit(jm.loss)(jp, _j(b)))
    jm, _, jp, _ = _setup(VLM)
    b = _batch(VLM, t=19, seed=2)
    lg, cache = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(b["tokens"][:, :13]),
             "prefix_embeds": jnp.asarray(b["prefix_embeds"])}, MAX_LEN)
    decode = jax.jit(jm.decode_step)
    seq = [lg]
    for i in range(6):
        lg, cache = decode(jp, jnp.asarray(b["tokens"][:, 13 + i:14 + i]),
                           cache)
        seq.append(lg)
    out["decode"] = np.asarray(jnp.concatenate(seq, 1))
    return out


# ---------------------------------------------------------------------------
# masks and attention
# ---------------------------------------------------------------------------

MASKS = [dict(causal=True, window=3, prefix_len=0),
         dict(causal=True, window=0, prefix_len=5),
         dict(causal=False, window=0, prefix_len=0)]


def test_mask_bias_matches_reference():
    """Causal, windowed, prefix-LM, bidirectional and their mixes, with the
    queries at an offset, equal to the reference's ``_mask_bias``."""
    q_pos, kv_pos = np.arange(6, 16), np.arange(16)
    for causal in (True, False):
        for window in (0, 3):
            for prefix_len in (0, 4):
                want = jattn._mask_bias(jnp.asarray(q_pos),
                                        jnp.asarray(kv_pos), causal, window,
                                        prefix_len)
                got = attention.mask_bias(T(q_pos), T(kv_pos), causal,
                                          window, prefix_len)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mask", MASKS, ids=["window", "prefix", "bidir"])
def test_attention_under_each_mask_matches_reference(mask):
    """The dense path and the chunked (online-softmax, blocks of 8) path,
    GQA with two query heads a KV head."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = jattn.dense_attention(jq, jk, jv, **mask)
    assert _rel(attention.dense_attention(T(q), T(k), T(v), **mask),
                want) < 1e-6
    want_c = jattn.chunked_attention(jq, jk, jv, block_q=8, block_kv=8,
                                     **mask)
    got_c = attention.chunked_attention(T(q), T(k), T(v), 8, 8, **mask)
    assert _rel(got_c, want_c) < 1e-6
    assert _rel(got_c, want) < 1e-5


# ---------------------------------------------------------------------------
# the VLM
# ---------------------------------------------------------------------------

def test_vlm_forward_and_loss_with_prefix_match_reference(ref):
    """Logits over prefix + text, and the text-only next-token loss."""
    _, tm, _, tp = _setup(VLM)
    b = _t(_batch(VLM))
    got = tm.forward(tp, b)
    assert got.shape[1] == tm.cfg.num_prefix + b["tokens"].shape[1]
    assert _rel(got, ref[VLM, "forward"]) < 1e-5
    np.testing.assert_allclose(float(tm.loss(tp, b)), ref[VLM, "loss"],
                               rtol=1e-5)


def test_vlm_prefill_with_prefix_and_decode_match_reference(ref):
    """Prefill of 4 prefix slots + 13 text tokens under the prefix-LM mask,
    then 6 decode steps through ``ops.flash_decode`` over the cache that
    holds both; a padded prefill with a prefix is refused."""
    _, tm, _, tp = _setup(VLM)
    b = _batch(VLM, t=19, seed=2)
    toks, prefix = T(b["tokens"]), T(b["prefix_embeds"])
    lg, cache = tm.prefill(tp, {"tokens": toks[:, :13],
                                "prefix_embeds": prefix}, MAX_LEN)
    assert cache["len"].tolist() == [17, 17]
    seq = [lg]
    for i in range(6):
        lg, cache = tm.decode_step(tp, toks[:, 13 + i:14 + i], cache)
        seq.append(lg)
    assert _rel(torch.cat(seq, 1), ref["decode"]) < 1e-5
    with pytest.raises(ValueError, match="VLM prefix"):
        tm.prefill(tp, {"tokens": toks, "prefix_embeds": prefix,
                        "lengths": torch.tensor([19, 10])}, MAX_LEN)


def test_vlm_text_engine_matches_reference():
    """Text-only prompts through the reference Engine and the port's
    (padded buckets, as the reference: a VLM takes end padding but not
    chunks); the port's paged streams equal its linear ones; chunked
    admission is refused."""
    jm, tm, jp, tp = _setup(VLM)
    assert tm.supports_padded_prefill and not tm.supports_chunked_prefill
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32)
               for n in (9, 14, 5)]
    kw = dict(max_batch=3, max_len=MAX_LEN, max_new=6, prefill_bucket=16)
    jeng = JEngine(jm, jp, JServeConfig(**kw))
    jreqs = [jeng.submit(p) for p in prompts]
    jeng.run()
    streams = []
    for paged in (False, True):
        eng = Engine(tm, tp, ServeConfig(**kw, paged=paged, page_size=8))
        reqs = [eng.submit(p) for p in prompts]
        eng.run(max_steps=100)
        assert all(r.status is RequestStatus.COMPLETED for r in reqs)
        streams.append([list(r.out_tokens) for r in reqs])
    assert streams[0] == streams[1]
    for p, jr, s in zip(prompts, jreqs, streams[0]):
        if s != list(jr.out_tokens):
            gen = T(np.asarray([jr.out_tokens], np.int32))
            lg = teacher_forced(tm, tp, T(p[None]), gen, 5, MAX_LEN)
            assert near_greedy(lg, gen, 1e-5) == 1.0
    with pytest.raises(ValueError, match="chunked admission"):
        Engine(tm, tp, ServeConfig(prefill_chunk=8))


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------

def test_audio_forward_and_frame_loss_match_reference(ref):
    """Frame embeddings plus sinusoidal positions, bidirectional attention
    (the first frame's logits move with the last frame), and the masked
    frame cross entropy."""
    _, tm, _, tp = _setup(AUDIO)
    b = _t(_batch(AUDIO))
    got = tm.forward(tp, b)
    assert _rel(got, ref[AUDIO, "forward"]) < 1e-5
    np.testing.assert_allclose(float(tm.loss(tp, b)), ref[AUDIO, "loss"],
                               rtol=1e-5)
    moved = dict(b, embeds=b["embeds"].clone())
    moved["embeds"][:, -1] += torch.randn(moved["embeds"][:, -1].shape,
                                          generator=torch.Generator()
                                          .manual_seed(0))
    assert (tm.forward(tp, moved)[:, 0] - got[:, 0]).abs().max() > 1e-4


def test_encoder_only_refusals():
    """audio has no decode path: prefill, decode_step, the paged cache,
    chunks and padding are refused, and so are the serve and train
    CLIs."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    _, tm, _, tp = _setup(AUDIO)
    assert not tm.supports_padded_prefill and not tm.supports_chunked_prefill
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match=ENCODER_ONLY):
        tm.prefill(tp, {"tokens": toks}, 8)
    with pytest.raises(ValueError, match=ENCODER_ONLY):
        tm.decode_step(tp, toks[:, :1], tm.init_cache(1, 8))
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        tm.init_paged_cache(1, 4, 8, 2)
    with pytest.raises(ValueError, match=ENCODER_ONLY):
        serve_cli.main(["--arch", AUDIO, "--fp", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="frame embeddings"):
        train_cli.train(train_cli.build_parser().parse_args(
            ["--arch", AUDIO, "--reduced", "--device", "cpu"]))


def test_remaining_refusals_hold():
    """Quantized vlm and audio are ported; what stays refused is what the
    reference refuses: quantizing mamba2 and griffin (calibration, the
    packer, ``QuantizedModel``, the baselines, the calibrate and serve
    CLIs' packed paths), the float audio model's decode, and ``--fp`` on
    audio in the serve CLI."""
    from repro_torch.core.baselines import quantize_model_baseline
    from repro_torch.core.calibration import CalibConfig, quantize_dense_model
    from repro_torch.launch import calibrate as calibrate_cli
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve.quantized import QuantizedModel, quantize_lm_packed
    toks = torch.zeros((1, 8), dtype=torch.int32)
    for arch in ("mamba2-1.3b", "recurrentgemma-2b"):
        cfg = get_config(arch).reduced()
        for call in (
                lambda: quantize_dense_model({}, cfg, QuantConfig(),
                                             CalibConfig(), toks),
                lambda: quantize_lm_packed({}, cfg, QuantConfig()),
                lambda: QuantizedModel(cfg, QuantConfig(), device="cpu"),
                lambda: quantize_model_baseline({}, cfg, QuantConfig(), toks,
                                                "gptq"),
                lambda: sites.block_sites(cfg, False),
                lambda: calibrate_cli.main(["--arch", arch, "--reduced",
                                            "--device", "cpu"]),
                lambda: serve_cli.main(["--arch", arch, "--reduced",
                                        "--device", "cpu"])):
            with pytest.raises(NotImplementedError, match="no quantized path"):
                call()
    _, tm, _, tp = _setup(AUDIO)
    with pytest.raises(ValueError, match=ENCODER_ONLY):
        tm.decode_step(tp, toks[:, :1], tm.init_cache(1, 8))
    for flag in ("--fp", "--compare-fp"):
        with pytest.raises(ValueError, match=ENCODER_ONLY):
            serve_cli.main(["--arch", AUDIO, "--reduced", flag, "--device",
                            "cpu"])
    for cfg in (get_config(VLM), get_config(AUDIO)):
        assert [s.name for s in sites.block_sites(cfg, False)] == [
            "ln_attn", "vo", "ln_mlp"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_first_train_step_matches_reference(arch):
    """As ``test_torch_train.py``: the first step (lr_scale 0), under remat
    and in two microbatches, on prefix + text (VLM) or frames and labels
    (audio)."""
    jm, tm, jp, tp = _setup(arch)
    over = dict(remat=True, microbatches=2)
    jc, tc = jadam.AdamConfig(lr=3e-3), adam.AdamConfig(lr=3e-3)
    jstep = jax.jit(jmake_train_step(
        jbuild_model(dataclasses.replace(jm.cfg, **over)), jc, 10, 2))
    tstep = make_train_step(
        Model(dataclasses.replace(tm.cfg, **over), "cpu"), tc, 10, 2)
    b = _batch(arch, seed=5)
    if arch == VLM:
        b = {**b, **{k: np.concatenate([v, v[::-1]]) for k, v in b.items()}}
    else:
        b.pop("mask")
    jstate = JTrainState(jp, jadam.adam_init(jp, jc), jnp.int32(0))
    tstate = TrainState(tp, adam.adam_init(tp, tc),
                        torch.tensor(0, dtype=torch.int32))
    jnew, jmet = jstep(jstate, _j(b))
    tnew, tmet = tstep(tstate, _t(b))
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
