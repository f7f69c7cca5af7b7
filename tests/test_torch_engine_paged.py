"""The port's Engine over the paged cache, with chunked admission and
preemption: the scheduling contracts of the reference's
``tests/test_engine_sched.py`` carried over, and the paged greedy streams
against the reference's paged Engine (``kernel_mode="ref"``) on the same
packed codes.

As in the reference's tests, the model is llama-micro on w8 a16 kv8 with
the plain versions tiled one page per tile on the linear cache too
(``block_kv = page_size``): there linear and paged decode are equal bit
for bit, so every comparison here is token for token.
"""
import jax
import numpy as np
import pytest

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
from repro_torch.serve.engine import Engine, RequestStatus, ServeConfig
from repro_torch.serve.quantized import QuantizedModel

PS = 8


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("llama-micro")
    jq = JQuantConfig(w_bits=8, a_bits=16, group_size=32, lwc=False,
                      kv_bits=8)
    jp = jquantize_lm_packed(build_model(jcfg).init(jax.random.PRNGKey(0)),
                             jcfg, jq)
    tq = QuantConfig(w_bits=8, a_bits=16, group_size=32, kv_bits=8)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    return (JQuantizedModel(jcfg, jq, kernel_mode="ref", flash_block_kv=PS),
            jp, QuantizedModel(get_config("llama-micro"), tq, device="cpu",
                               block_kv=PS), tp)


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _scfg(**kw):
    return dict(dict(max_batch=2, max_len=64, max_new=6, prefill_bucket=16,
                     page_size=PS), **kw)


def _run(served, prompts, **kw):
    eng = Engine(served[2], served[3], ServeConfig(**_scfg(**kw)))
    for p in prompts:
        eng.submit(p)
    return eng, eng.run(max_steps=500)


def _streams(reqs):
    return [r.out_tokens for r in reqs]


def test_paged_streams_equal_linear_and_reference_engine(served):
    """A mixed-length trace: the paged engine's streams equal the linear
    engine's and the reference's paged engine's; no sequence ever holds
    more than ceil((len + 1) / page_size) pages; every page comes back."""
    prompts = _prompts([5, 20, 11, 33, 8, 47, 3, 26])
    _, lin = _run(served, prompts, max_batch=3, max_new=8)
    eng = Engine(served[2], served[3],
                 ServeConfig(**_scfg(max_batch=3, max_new=8, paged=True)))
    for p in prompts:
        eng.submit(p)
    al = eng._kv.allocator
    while eng.step():
        for slot, req in enumerate(eng._slots):
            if req is not None:
                assert len(al.owned[slot]) <= -(-(eng._seq_len[slot] + 1)
                                                // PS)
    paged = eng.run()
    assert _streams(paged) == _streams(lin)
    assert all(r.status is RequestStatus.COMPLETED for r in paged)
    assert al.num_free == al.num_pages
    eng._kv.verify()

    jeng = JEngine(served[0], served[1],
                   JServeConfig(**_scfg(max_batch=3, max_new=8, paged=True)))
    for p in prompts:
        jeng.submit(p)
    assert _streams(paged) == _streams(jeng.run(max_steps=500))


def test_page_pool_steady_state_over_many_requests(served):
    """Eight requests through a pool that holds about two at a time: peak
    use stays within the pool and the free list refills."""
    eng = Engine(served[2], served[3],
                 ServeConfig(**_scfg(paged=True, num_pages=8, max_new=4)))
    reqs = [eng.submit(p) for p in _prompts([12, 9, 15, 11, 8, 14, 10, 13])]
    eng.run(max_steps=500)
    assert all(r.status is RequestStatus.COMPLETED for r in reqs)
    assert eng._kv.allocator.peak_in_use <= 8
    assert eng._kv.allocator.num_free == 8
    eng._kv.verify()


def test_preempt_resume_round_trip(served):
    """Three growing sequences in a pool too small for them: the longest
    is evicted, resumes by prefilling prompt + generated tokens, and every
    stream equals an unpreempted run."""
    prompts = _prompts([15, 14, 13])
    _, base = _run(served, prompts, max_batch=3, max_new=24)
    eng, tight = _run(served, prompts, max_batch=3, max_new=24, paged=True,
                      num_pages=9)
    assert eng.preemptions > 0, "the pool never ran dry"
    assert _streams(tight) == _streams(base)
    assert eng._kv.allocator.num_free == 9


@pytest.mark.parametrize("chunk", [0, 8])
def test_oversized_request_raises(served, chunk):
    """A prompt the idle pool can never hold is refused at submit, naming
    the pool, and leaves the engine serving."""
    eng = Engine(served[2], served[3], ServeConfig(**_scfg(
        paged=True, num_pages=2, prefill_chunk=chunk)))
    with pytest.raises(ValueError, match="pool"):
        eng.submit(_prompts([40])[0])               # 6 pages; pool holds 2
    req = eng.submit(_prompts([9])[0])
    eng.run(max_steps=100)
    assert req.done and len(req.out_tokens) == 6


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_admission_equals_whole_prompt(served, paged):
    """Prompts fed 8 tokens a step, interleaved with decode, give the
    streams of whole-prompt bucketed admission, on both layouts."""
    prompts = _prompts([5, 20, 11, 33, 8, 26])
    _, whole = _run(served, prompts, paged=paged)
    _, chunked = _run(served, prompts, paged=paged, prefill_chunk=8)
    assert _streams(chunked) == _streams(whole)


def test_preempt_mid_prefill_resumes_token_identical(served):
    """The short request's decode crosses a page boundary with the pool
    dry while the long prompt is half chunked: the mid-prefill request
    holds the most pages, is evicted, and resumes through the chunked path
    to the streams of a roomy run."""
    prompts = _prompts([10, 30])
    _, roomy = _run(served, prompts, max_new=10, prefill_chunk=4)
    eng = Engine(served[2], served[3], ServeConfig(**_scfg(
        max_new=10, prefill_chunk=4, paged=True, num_pages=6)))
    for p in prompts:
        eng.submit(p)
    mid_prefill = []
    orig = eng._preempt

    def spy(slot):
        mid_prefill.append(eng._prefill_prog[slot] is not None)
        orig(slot)

    eng._preempt = spy
    tight = eng.run(max_steps=500)
    assert any(mid_prefill), "no mid-prefill eviction happened"
    assert _streams(tight) == _streams(roomy)
    assert eng._kv.allocator.num_free == 6


def test_preemption_cap_ends_failed_pool(served):
    """With ``max_preemptions=0`` the first eviction ends the evicted
    mid-prefill request FAILED_POOL; the other request completes with the
    stream of a roomy run and every page comes back."""
    prompts = _prompts([10, 30])
    _, roomy = _run(served, prompts, max_new=10, prefill_chunk=4)
    eng, reqs = _run(served, prompts, max_new=10, prefill_chunk=4,
                     paged=True, num_pages=6, max_preemptions=0)
    assert [r.status for r in reqs] == [RequestStatus.COMPLETED,
                                        RequestStatus.FAILED_POOL]
    assert "preemption storm" in reqs[1].error
    assert reqs[0].out_tokens == roomy[0].out_tokens
    assert eng._kv.allocator.num_free == 6
    eng._kv.verify()


def test_stalled_evictions_end_failed_pool(served):
    """A request evicted ``stall_preemptions`` times in a row without
    growing (here mid-prefill each time) ends FAILED_POOL; evictions that
    follow growth do not count."""
    eng = Engine(served[2], served[3], ServeConfig(**_scfg(
        prefill_chunk=4, paged=True, stall_preemptions=2)))
    req = eng.submit(_prompts([30])[0])
    for _ in range(3):
        eng.step()                               # admitted, one chunk
        assert eng._slots[0] is req and eng._prefill_prog[0] is not None
        eng._preempt(0)
        if req.done:
            break
        assert req.status is RequestStatus.QUEUED and eng._pending[0] is req
    assert (req.status, req.preemptions, req.stalls) == (
        RequestStatus.FAILED_POOL, 3, 2)
    assert eng._kv.allocator.num_free == eng._kv.allocator.num_pages
