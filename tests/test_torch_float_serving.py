"""The port's float ``Model`` served like the packed one: ``prefill``,
``prefill_chunk`` and ``decode_step`` over the linear and the paged cache
against the reference's ``Model`` (llama-micro and opt-micro, the same
float tree in both), and through the Engine.

Tolerances: logits within 1e-5 of the largest logit, greedy tokens equal
(the two frameworks differ in float32 summation order and transcendental
ulps only; the port's positions and norms take float64 steps, PERF.md).

The Engine's contracts for the float model (``launch/row_probe.py``): a
row of ``torch.matmul`` is not the same bits at every row count (on the
CPU the one-row product differs from the batched one in every row), so
the float streams are token for token only where the row counts match:
linear == paged (the plain versions tiled one page per tile on the linear
cache too).  Chunked admission and a preempted resume prefill other row
counts, and are held to the logits: teacher-forced on each served stream,
the chunked prefill's logits lie within 1e-5 of the whole prompt's at
every served position, and every served token is the greedy choice of the
whole-prompt path's teacher-forced logits or ties it within 1e-5 of the
largest logit.  Their greedy agreement with the linear streams is
asserted only through that bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serve import kv_cache as jkvc
from repro_torch.configs import get_config
from repro_torch.launch.serve import agreement, near_greedy, teacher_forced
from repro_torch.models.model import Model, build_model
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.engine import Engine, RequestStatus, ServeConfig

T = torch.from_numpy
TOL = 1e-5
PS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: as fast at these shapes, and parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module", params=["llama-micro", "opt-micro"])
def fp(request):
    """(reference Model, its params, jitted steps, port Model, port params,
    tokens): the port's seeded init (the reference's has the same tree and
    scales) in both, the OPT norms and biases perturbed so their paths
    show."""
    jcfg = jget_config(request.param)
    jm = jbuild_model(jcfg)
    tm = Model(get_config(request.param), "cpu", block_kv=PS)
    tp = tm.init(1)
    if jcfg.norm == "layernorm":
        rng = np.random.default_rng(2)
        noise = lambda t: t + 0.1 * T(rng.standard_normal(tuple(t.shape))
                                      .astype(np.float32))
        lp = tp["layers"]
        for k in ("ln_attn", "ln_mlp"):
            lp[k] = {n: noise(v) for n, v in lp[k].items()}
        for k in ("bq", "bk", "bv"):
            lp[k] = noise(lp[k])
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    steps = {"prefill": jax.jit(jm.prefill, static_argnames=("max_len",)),
             "chunk": jax.jit(jm.prefill_chunk,
                              static_argnames=("last_only",)),
             "decode": jax.jit(jm.decode_step)}
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    return jm, jp, steps, tm, tp, tokens


def test_prefill_and_decode_match_reference_linear(fp):
    """End-padded prompts of 16 and 11 tokens, then 8 decode steps."""
    _, jp, st, tm, tp, tokens = fp
    lengths = np.asarray([16, 11], np.int32)
    batch = {"tokens": tokens[:, :16], "lengths": lengths}
    lg, jc = st["prefill"](jp, {k: jnp.asarray(v) for k, v in batch.items()},
                           max_len=48)
    tl, tc = tm.prefill(tp, {k: T(v) for k, v in batch.items()}, max_len=48)
    want, got = [np.asarray(lg)], [tl.numpy()]
    for i in range(8):
        tok = tokens[:, 16 + i:17 + i]
        lg, jc = st["decode"](jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, T(tok), tc)
        want.append(np.asarray(lg))
        got.append(tl.numpy())
    want, got = np.concatenate(want, 1), np.concatenate(got, 1)
    assert _rel(got, want) < TOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_prefill_chunk_matches_reference_linear(fp):
    """Two chunks of 12 (the second ragged: 12 and 5 valid rows), logits at
    every row, into the linear cache."""
    jm, jp, st, tm, tp, tokens = fp
    jc, tc = jm.init_cache(2, 48), tm.init_cache(2, 48)
    wants, gots = [], []
    for c0, n in ((0, (12, 12)), (12, (12, 5))):
        b = {"tokens": tokens[:, c0:c0 + 12], "chunk_len": np.asarray(
            n, np.int32)}
        off = np.full(2, c0, np.int32)
        lg, jc = st["chunk"](jp, {k: jnp.asarray(v) for k, v in b.items()},
                             jc, jnp.asarray(off))
        tl, tc = tm.prefill_chunk(tp, {k: T(v) for k, v in b.items()}, tc,
                                  T(off))
        valid = np.arange(12)[None] < np.asarray(n)[:, None]
        wants.append(np.asarray(lg)[valid])
        gots.append(tl.numpy()[valid])
    want, got = np.concatenate(wants), np.concatenate(gots)
    assert _rel(got, want) < TOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(tc["len"].numpy(), [24, 17])


def test_paged_cache_matches_reference(fp):
    """Paged prefill of prompts 13 and 6 in one chunk, then 8 decode steps
    growing pages of 4 through both page stores: page tables equal,
    logits within TOL, greedy tokens equal."""
    jm, jp, st, tm, tp, toks = fp
    ps, lens = 4, np.asarray([13, 6], np.int32)
    jstore = jkvc.PagedCache(jm, max_batch=2, max_len=32, page_size=ps)
    tstore = kvc.PagedCache(tm, max_batch=2, max_len=32, page_size=ps)
    for slot, n in enumerate(lens):
        assert jstore.reserve(slot, int(n)) and tstore.reserve(slot, int(n))
    first = toks[:, :13] * (np.arange(13)[None] < lens[:, None])
    want, jstore.cache = st["chunk"](
        jp, {"tokens": jnp.asarray(first), "chunk_len": jnp.asarray(lens)},
        jstore.cache, jnp.zeros(2, jnp.int32), last_only=True)
    got, tstore.cache = tm.prefill_chunk(
        tp, {"tokens": T(first), "chunk_len": T(lens)}, tstore.cache,
        torch.zeros(2, dtype=torch.int32), last_only=True)
    wants, gots = [np.asarray(want)], [got.numpy()]
    cur = lens.copy()
    for i in range(8):
        for slot in range(2):
            assert jstore.ensure_append(slot, int(cur[slot]))
            assert tstore.ensure_append(slot, int(cur[slot]))
        tok = toks[:, 13 + i:14 + i]
        want, jstore.cache = st["decode"](jp, jnp.asarray(tok), jstore.cache)
        got, tstore.cache = tm.decode_step(tp, T(tok), tstore.cache)
        wants.append(np.asarray(want))
        gots.append(got.numpy())
        cur += 1
    np.testing.assert_array_equal(tstore.cache.page_table.numpy(),
                                  np.asarray(jstore.cache.page_table))
    want, got = np.concatenate(wants, 1), np.concatenate(gots, 1)
    assert _rel(got, want) < TOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert tstore.cache.k.dtype == torch.float32 and tstore.cache.k_scale \
        is None
    tstore.verify()


# ---------------------------------------------------------------------------
# the Engine over the float model
# ---------------------------------------------------------------------------

def _engine(tm, tp, prompts, **kw):
    cfg = dict(max_batch=3, max_len=64, max_new=10, prefill_bucket=16,
               page_size=PS)
    eng = Engine(tm, tp, ServeConfig(**{**cfg, **kw}))
    reqs = [eng.submit(p) for p in prompts]
    eng.run(max_steps=500)
    assert all(r.status is RequestStatus.COMPLETED for r in reqs)
    return eng, [list(r.out_tokens) for r in reqs]


def test_engine_float_streams_equal_across_layouts(fp):
    """Whole-prompt admission: the paged engine's greedy streams equal the
    linear engine's token for token (same row counts in every product),
    and every page comes back; the memory report counts the float tree."""
    _, _, _, tm, tp, _ = fp
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32)
               for n in (12, 5, 16, 9)]
    lin_eng, lin = _engine(tm, tp, prompts)
    eng, paged = _engine(tm, tp, prompts, paged=True)
    assert paged == lin
    assert eng._kv.allocator.num_free == eng._kv.allocator.num_pages
    eng._kv.verify()
    n_params = sum(t.numel() for t in jax.tree_util.tree_leaves(
        {k: v for k, v in tp.items()}))
    assert lin_eng.memory_report()["weight_bytes"] == 4 * n_params


def test_chunked_and_preempted_float_streams_meet_the_logits_contract(fp):
    """Chunks of 8 into a pool too small for the three sequences: the
    engine preempts and resumes; each stream, teacher-forced, has chunked
    prefill logits within TOL of the whole prompt's and every served token
    within TOL of the whole-prompt path's greedy choice."""
    _, _, _, tm, tp, _ = fp
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tm.cfg.vocab_size, 16).astype(np.int32)
               for _ in range(3)]
    _, lin = _engine(tm, tp, prompts, max_new=20)
    eng, tight = _engine(tm, tp, prompts, max_new=20, paged=True,
                         num_pages=9, prefill_chunk=8)
    assert eng.preemptions > 0, "the pool never ran dry"
    assert eng._kv.allocator.num_free == 9
    p = T(np.stack(prompts))
    gen = torch.tensor(tight, dtype=torch.int32)
    whole = teacher_forced(tm, tp, p, gen, 19, 64)
    chunked = teacher_forced(tm, tp, p, gen, 19, 64, chunk=8)
    assert _rel(chunked.numpy(), whole.numpy()) < TOL
    assert near_greedy(whole, gen, TOL) == 1.0
    assert 0.0 <= agreement(lin, tight) <= 1.0


def test_float_model_modes_and_build():
    """``mode`` is checked as ``QuantizedModel``'s is; ``build_model``
    passes device and mode through; the float model keeps a kv16 cache."""
    cfg = get_config("llama-micro")
    with pytest.raises(ValueError, match="mode"):
        Model(cfg, "cpu", mode="pallas")
    m = build_model(cfg, "cpu", "plain")
    assert (m.mode, m.kv_bits, m.kv_quantized) == ("plain", 16, False)
    assert m.supports_padded_prefill and m.supports_chunked_prefill
    cache = m.init_cache(2, 16)
    assert sorted(cache) == ["k", "len", "v"]
    assert cache["k"].shape == (2, 2, 16, 4, 32)
    mamba = Model(get_config("mamba2-1.3b").reduced(), "cpu")
    assert not (mamba.supports_padded_prefill
                or mamba.supports_chunked_prefill)
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        mamba.init_paged_cache(2, 4, 8, 2)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        mamba.prefill_chunk({}, {"tokens": torch.zeros((1, 4))}, {}, [0])


def test_serve_cli_float_compare_and_w3(capsys):
    """``launch/serve.py --compare-fp --wbits 3``: the seeded float tree
    through ``Model``, then its W3A16 g32 packing through
    ``QuantizedModel`` (the plain dequant), every request completed, the
    agreement line printed; ``--fp`` alone serves the same float streams."""
    from repro_torch.launch import serve as cli
    argv = ["--arch", "llama-micro", "--device", "cpu", "--group", "32",
            "--max-len", "64", "--prompt-len", "12", "--max-new", "6",
            "--abits", "16", "--kvbits", "16"]
    out = cli.main(argv + ["--compare-fp", "--wbits", "3"])
    text = capsys.readouterr().out
    assert "greedy-token agreement fp vs packed-w3a16g32kv16" in text
    assert isinstance(out["model"], cli.QuantizedModel)
    assert isinstance(out["fp"]["model"], Model)
    for run in (out, out["fp"]):
        assert run["statuses"] == {"COMPLETED": 4}
    assert out["params"]["layers"]["wq"].bits == 3
    fp = cli.main(argv + ["--fp"])
    assert [r.out_tokens for r in fp["requests"]] == \
        [r.out_tokens for r in out["fp"]["requests"]]
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv + ["--fp", "--compare-fp"])
