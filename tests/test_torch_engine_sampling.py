"""Seeded temperature / top-k sampling in the port's Engine.

The reference draws with threefry keys ``fold_in(fold_in(seed, rid), n)``,
which torch cannot reproduce, so sampled streams are held inside the port:
a request's stream depends on (seed, rid, tokens generated so far) and its
own logits only, so it is the same alone, co-batched in another slot and
after a preemption; seeds differ; and the draws follow
``softmax(logits / T)`` on the top-k support (a chi-square test).  Across
frameworks the contract is greedy: ``top_k = 1`` equals greedy, which
equals the reference Engine's greedy stream, and the top-k support equals
the reference's mask (ties at the k-th kept).

llama-micro w8 a16 kv8, pages of 8, the plain versions (as in the
reference's ``tests/test_engine_sched.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import gammaincc

from repro.configs import get_config as jget_config
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.models import build_model
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.quantized import QuantizedModel as JQuantizedModel
from repro.serve.quantized import quantize_lm_packed as jquantize_lm_packed
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.quantizer import QuantConfig
from repro_torch.serve.engine import (Engine, ServeConfig, row_seed, sample,
                                      sampling_logits)
from repro_torch.serve.quantized import QuantizedModel

PS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("llama-micro")
    jq = JQuantConfig(w_bits=8, a_bits=16, group_size=32, lwc=False,
                      kv_bits=8)
    jp = jquantize_lm_packed(build_model(jcfg).init(jax.random.PRNGKey(0)),
                             jcfg, jq)
    tq = QuantConfig(w_bits=8, a_bits=16, group_size=32, kv_bits=8)
    return (JQuantizedModel(jcfg, jq, kernel_mode="ref", flash_block_kv=PS),
            jp, QuantizedModel(get_config("llama-micro"), tq, device="cpu",
                               block_kv=PS),
            from_jax_params(jax.tree_util.tree_map(np.asarray, jp)))


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n) for n in lens]


def _scfg(**kw):
    return dict(dict(max_batch=2, max_len=64, max_new=6, prefill_bucket=16,
                     page_size=PS), **kw)


def _run(served, prompts, **kw):
    eng = Engine(served[2], served[3], ServeConfig(**_scfg(**kw)))
    for p in prompts:
        eng.submit(p)
    return eng, [r.out_tokens for r in eng.run(max_steps=500)]


SAMPLED = dict(temperature=0.8, top_k=40, seed=3)


def test_sampled_stream_alone_cobatched_and_preempted(served):
    """Each request's sampled stream is the same alone (slot 0), beside
    other requests (its rid, in another slot and batch) and through a
    tight pool that preempts and resumes it."""
    prompts = _prompts([15, 14, 13])
    alone = []
    for i, p in enumerate(prompts):
        # rid i alone: i placeholder requests cancelled ahead of it
        eng = Engine(served[2], served[3], ServeConfig(**_scfg(
            max_batch=1, max_new=16, **SAMPLED)))
        for _ in range(i):
            eng.cancel(eng.submit(p).rid)
        req = eng.submit(p)
        eng.run(max_steps=200)
        alone.append(req.out_tokens)
    _, together = _run(served, prompts, max_batch=3, max_new=16, **SAMPLED)
    assert together == alone
    eng, tight = _run(served, prompts, max_batch=3, max_new=16, paged=True,
                      num_pages=7, prefill_chunk=4, **SAMPLED)
    assert eng.preemptions > 0, "the pool never ran dry"
    assert tight == alone
    _, greedy = _run(served, prompts, max_batch=3, max_new=16)
    assert greedy != alone


def test_sampling_seeded_and_deterministic(served):
    prompts = _prompts([9, 14])
    _, a = _run(served, prompts, temperature=0.8, seed=7)
    _, b = _run(served, prompts, temperature=0.8, seed=7)
    _, c = _run(served, prompts, temperature=0.8, seed=8)
    assert a == b and a != c


def test_top_k_one_equals_greedy_and_the_reference_engine(served):
    """top_k = 1 leaves only the argmax: the stream is greedy's, which is
    the reference Engine's greedy stream on the same codes."""
    prompts = _prompts([9, 14, 21])
    _, greedy = _run(served, prompts)
    _, topk1 = _run(served, prompts, temperature=0.5, top_k=1)
    assert topk1 == greedy
    jeng = JEngine(served[0], served[1], JServeConfig(**_scfg()))
    for p in prompts:
        jeng.submit(p)
    assert [r.out_tokens for r in jeng.run(max_steps=200)] == greedy


def _tied_logits():
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((6, 50)).astype(np.float32) * 3
    lg[0, [3, 9, 17]] = lg[0].max() + 1.0       # a tie at the top
    top = np.sort(lg[1])[::-1]
    lg[1, np.argsort(lg[1])[::-1][5:8]] = top[4]    # ties at the 5th
    lg[2, :] = 1.25                              # all tied
    return lg


@pytest.mark.parametrize("k", [1, 3, 5, 40])
def test_top_k_support_equals_reference(k):
    """The port's top-k support equals the reference's mask on the same
    float32 logits (``lg < kth`` masked, ties at the k-th kept)."""
    lg = _tied_logits()
    t = 0.7
    got = torch.isfinite(sampling_logits(torch.from_numpy(lg), t, k))
    jl = jnp.asarray(lg).astype(jnp.float32) / t
    kth = jax.lax.top_k(jl, k)[0][:, -1:]
    want = np.asarray(jnp.isfinite(jnp.where(jl < kth, -jnp.inf, jl)))
    assert (got.numpy() == want).all()
    assert (got.sum(-1) >= k).all()


def test_sample_frequencies_follow_softmax_on_the_support():
    """20,000 draws of one row (one seed each) against softmax(lg / T) on
    its top-k support: chi-square p > 1e-3, and nothing drawn off the
    support."""
    lg = _tied_logits()[1, :12]
    t, k, n = 0.8, 6, 20_000
    rows = torch.from_numpy(np.tile(lg, (n, 1)))
    toks = sample(rows, t, k, [row_seed(5, rid, 0) for rid in range(n)])
    counts = np.bincount(toks.numpy(), minlength=12)
    masked = sampling_logits(torch.from_numpy(lg[None]), t, k)[0]
    support = torch.isfinite(masked).numpy()
    assert counts[~support].sum() == 0
    p = torch.softmax(masked.double(), -1).numpy()[support]
    obs = counts[support]
    stat = float(((obs - n * p) ** 2 / (n * p)).sum())
    pval = float(gammaincc((support.sum() - 1) / 2, stat / 2))
    assert pval > 1e-3, (stat, pval)


def test_sample_rows_depend_only_on_their_seed():
    """A row's draw is the same whatever other rows share the call, and
    rows without a seed take the argmax."""
    lg = torch.from_numpy(_tied_logits())
    seeds = [row_seed(1, r, 4) for r in range(6)]
    full = sample(lg, 1.0, 0, seeds)
    part = sample(lg[[4, 1]], 1.0, 0, [seeds[4], seeds[1]])
    assert part.tolist() == full[[4, 1]].tolist()
    idle = sample(lg, 1.0, 0, [None] * 6)
    assert idle.tolist() == torch.argmax(lg, -1).tolist()
