"""The port's Engine failure model: every case of the reference's
``tests/test_engine_faults.py`` and the seeded fault traces of
``tests/test_engine_fuzz.py``, carried over to ``repro_torch``, plus the KV
quantizer's NaN contract the quarantine's detection rests on.

As in the reference's tests the model is llama-micro on w8 a16 kv8 with
pages of 8 and the plain versions tiled one page per tile on the linear
cache too (``block_kv = page_size``): linear and paged decode are then
equal bit for bit, so "survivors equal their solo runs" is exact.  The
packed codes are the reference's, bridged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.models import build_model
from repro.serve.quantized import _kv_quantize as j_kv_quantize
from repro.serve.quantized import quantize_lm_packed as jquantize_lm_packed
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.quantizer import QuantConfig
from repro_torch.serve import faults as flt
from repro_torch.serve.engine import (Engine, QueueFull, RequestStatus,
                                      ServeConfig)
from repro_torch.serve.faults import Fault, FaultPlan
from repro_torch.serve.kv_cache import (LinearCache, PagedCache,
                                        PageIntegrityError, pages_for)
from repro_torch.serve.quantized import QuantizedModel, _kv_quantize

PS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: as fast at these shapes, and parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SERVED: dict = {}


def _served(kv_bits=8):
    """(port model, bridged packed tree) of llama-micro w8 a16 at
    ``kv_bits``; one packed tree serves every cache width."""
    if "tree" not in _SERVED:
        jcfg = jget_config("llama-micro")
        jp = jquantize_lm_packed(
            build_model(jcfg).init(jax.random.PRNGKey(0)), jcfg,
            JQuantConfig(w_bits=8, a_bits=16, group_size=32, lwc=False))
        _SERVED["tree"] = from_jax_params(
            jax.tree_util.tree_map(np.asarray, jp))
    if kv_bits not in _SERVED:
        tq = QuantConfig(w_bits=8, a_bits=16, group_size=32, kv_bits=kv_bits)
        _SERVED[kv_bits] = QuantizedModel(get_config("llama-micro"), tq,
                                          device="cpu", block_kv=PS)
    return _SERVED[kv_bits], _SERVED["tree"]


@pytest.fixture(scope="module")
def served():
    return _served(8)


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n) for n in lens]


def _scfg(**kw):
    base = dict(max_batch=2, max_len=64, max_new=6, prefill_bucket=16,
                page_size=PS)
    base.update(kw)
    return ServeConfig(**base)


def _engine(served, faults=None, **kw):
    return Engine(served[0], served[1], _scfg(**kw), faults=faults)


def _pool_conserved(eng):
    eng._kv.verify()
    al = eng._kv.allocator
    return al.num_free == al.num_pages and all(not o for o in al.owned)


# ---------------------------------------------------------------------------
# the quantizer's poison contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [4, 8])
def test_kv_quantize_conserves_nan(kv_bits):
    """Codes cannot hold NaN but the float scale carries it: a non-finite
    K/V row yields a non-finite scale, so dequantization reproduces the
    poison, and the clean row's scales stay finite."""
    x = torch.ones((2, 4, 64))
    x[1, 2, 7] = float("nan")
    codes, scale = _kv_quantize(x, kv_bits)
    assert codes.dtype == torch.int8
    assert torch.isnan(scale.float()).any()
    assert torch.isfinite(scale[0].float()).all()


@pytest.mark.parametrize("kv_bits", [4, 8])
def test_kv_quantize_byte_equal_to_eager_reference(kv_bits):
    """On random magnitudes (many decades, a NaN row) the port's
    quantize-on-write gives the eager reference's codes and scales byte
    for byte; a NaN scale is NaN in both (its payload bits are not part
    of the contract: bf16 NaNs differ there)."""
    rng = np.random.default_rng(kv_bits)
    x = (rng.standard_normal((3, 17, 4, 64))
         * 10.0 ** rng.uniform(-4, 4, (3, 17, 4, 1))).astype(np.float32)
    x[2, 5, 1, 9] = np.nan
    codes, scale = _kv_quantize(torch.from_numpy(x), kv_bits)
    jcodes, jscale = j_kv_quantize(jnp.asarray(x), kv_bits)
    assert codes.numpy().tobytes() == np.asarray(jcodes).tobytes()
    nan = torch.isnan(scale.float()).numpy()
    assert nan.any()
    assert (nan == np.isnan(np.asarray(jscale, np.float32))).all()
    got = scale.view(torch.int16 if kv_bits == 4 else torch.int32).numpy()
    want = np.asarray(jscale).view(np.int16 if kv_bits == 4 else np.int32)
    assert got[~nan].tobytes() == want[~nan].tobytes()


# ---------------------------------------------------------------------------
# submit-boundary validation
# ---------------------------------------------------------------------------

def test_submit_validation_errors(served):
    eng = _engine(served)
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(np.zeros((2, 3), np.int32))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(_prompts([64])[0])   # linear: needs 65 > max_len
    paged = _engine(served, paged=True, num_pages=2)
    with pytest.raises(ValueError, match="pool"):
        paged.submit(_prompts([40])[0])
    with pytest.raises(ValueError, match="max_new"):
        _engine(served, max_new=0)
    with pytest.raises(ValueError, match="max_queue"):
        _engine(served, max_queue=-1)
    assert eng._all == [] and paged._all == []


def test_unservable_remedy_matches_cause(served):
    """Each unservable cause names its own limit and remedy."""
    pool = _engine(served, paged=True, num_pages=2)
    with pytest.raises(ValueError, match="num_pages up") as e:
        pool.submit(_prompts([40])[0])
    assert "max-len" not in str(e.value)
    mlen = _engine(served, paged=True, max_len=32, num_pages=64,
                   max_pages_per_seq=8)
    with pytest.raises(ValueError, match="max-len") as e:
        mlen.submit(_prompts([40])[0])
    assert "num_pages" not in str(e.value)
    mpps = _engine(served, paged=True, max_len=64, num_pages=64,
                   max_pages_per_seq=2)
    with pytest.raises(ValueError, match="max_pages_per_seq") as e:
        mpps.submit(_prompts([40])[0])
    assert "num_pages up" not in str(e.value) \
        and "max-len" not in str(e.value)


def test_queue_full_backpressure(served):
    """REJECTED_QUEUE_FULL: a bounded queue raises QueueFull at submit; the
    rejected request is terminal (on_done fired) and the engine serves the
    admitted ones."""
    done = []
    eng = _engine(served, max_batch=1, max_new=2, max_queue=2)
    for p in _prompts([5, 7]):
        eng.submit(p, on_done=lambda r: done.append(r.rid))
    with pytest.raises(QueueFull) as exc:
        eng.submit(_prompts([6])[0], on_done=lambda r: done.append(r.rid))
    rej = exc.value.request
    assert rej.status is RequestStatus.REJECTED_QUEUE_FULL
    assert rej.done and rej.rid in done
    reqs = eng.run()
    assert eng.status_counts() == {"COMPLETED": 2, "REJECTED_QUEUE_FULL": 1}
    assert sorted(done) == [r.rid for r in reqs]


def test_request_status_and_serve_config_match_reference():
    """The port's statuses and ServeConfig fields are the reference's (the
    mesh of ``Engine(mesh=...)`` is no ServeConfig field)."""
    from repro.serve.engine import RequestStatus as JStatus
    from repro.serve.engine import ServeConfig as JServeConfig
    assert [(s.name, s.value) for s in RequestStatus] == \
        [(s.name, s.value) for s in JStatus]
    assert {f.name: f.default for f in dataclasses.fields(ServeConfig)} == \
        {f.name: f.default for f in dataclasses.fields(JServeConfig)}


# ---------------------------------------------------------------------------
# FAILED_NAN: quarantine isolates the poisoned slot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunked", [False, True])
def test_nan_quarantine_isolates_slot(served, chunked):
    """A NaN injected into one co-batched request's decode logits: it ends
    FAILED_NAN, every survivor equals its solo run, the pool is
    conserved."""
    prompts = _prompts([13, 9, 11])
    solo = []
    for p in prompts:
        eng = _engine(served, max_batch=1)
        eng.submit(p)
        solo.append(eng.run()[0].out_tokens)
    plan = FaultPlan(Fault(point=flt.NAN_LOGITS, rid=1, after_step=2))
    eng = _engine(served, plan, max_batch=3, paged=True,
                  prefill_chunk=8 if chunked else 0)
    for p in prompts:
        eng.submit(p)
    reqs = eng.run(max_steps=100)
    assert reqs[1].status is RequestStatus.FAILED_NAN
    assert "non-finite" in reqs[1].error
    assert plan.fired(flt.NAN_LOGITS) == 1
    for i in (0, 2):
        assert reqs[i].status is RequestStatus.COMPLETED
        assert reqs[i].out_tokens == solo[i], f"survivor {i} diverged"
    assert _pool_conserved(eng)


def test_nan_quarantine_scrubs_slot(served):
    """Quarantine zeroes the victim's pages (or linear slot) before they
    are recycled; other slots' contents stay."""
    store = PagedCache(served[0], max_batch=2, max_len=32, page_size=PS)
    assert store.reserve(0, 10) and store.reserve(1, 5)
    store.cache.k_scale += float("nan")
    store.scrub(0)
    ks = store.cache.k_scale
    for page in store.allocator.owned[0]:
        assert torch.isfinite(ks[:, page]).all()
    for page in store.allocator.owned[1]:
        assert torch.isnan(ks[:, page]).all()
    lin = LinearCache(served[0], max_batch=2, max_len=32)
    lin.cache["k_scale"] += float("nan")
    assert lin.quarantine(0) == []
    ks = lin.cache["k_scale"]
    assert torch.isfinite(ks[:, 0]).all() and torch.isnan(ks[:, 1]).all()


def test_nan_quarantine_never_scrubs_shared_pages(served):
    """Quarantine under sharing zeroes only refcount-1 pages, unmaps the
    slot's pages from the prefix map and names the co-readers."""
    store = PagedCache(served[0], max_batch=3, max_len=32, page_size=PS,
                       prefix_cache=True)
    toks = np.arange(19, dtype=np.int32)
    assert store.reserve(0, len(toks) + 1, tokens=toks)
    store.register_prefix(0, toks)            # 2 full pages enter the map
    assert store.reserve(1, len(toks) + 1, tokens=toks)
    assert store.matched_tokens(1) == 2 * PS
    shared = store.allocator.owned[0][:2]
    excl1 = [p for p in store.allocator.owned[1] if p not in shared]
    store.cache.k_scale += float("nan")
    assert store.quarantine(1) == [0]
    ks = store.cache.k_scale
    for page in excl1:
        assert torch.isfinite(ks[:, page]).all()
    for page in shared:
        assert torch.isnan(ks[:, page]).all()
    assert not store._prefix_map
    store.free(1)
    store.verify()


def _shared_prefix_run(served, prefix, paged=True):
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(0, 512, 19)
    prompts = [np.concatenate([sys_prompt, rng.integers(0, 512, n)])
               for n in (5, 9, 13)]
    plan = FaultPlan(Fault(point=flt.NAN_LOGITS, rid=1, after_step=12))
    eng = _engine(served, plan, max_batch=2, max_new=8, paged=paged,
                  prefill_chunk=PS, prefix_cache=prefix,
                  integrity_checks=paged)
    r0 = eng.submit(prompts[0])
    eng.run(max_steps=200)           # the writer completes and registers
    rs = [eng.submit(p) for p in prompts[1:]]
    eng.run(max_steps=400)
    late = eng.submit(prompts[2])    # after the quarantine unmapped the map
    eng.run(max_steps=400)
    if paged:
        assert _pool_conserved(eng)
    return [r0] + rs + [late]


def test_nan_quarantine_fails_shared_prefix_readers(served):
    """A poisoned request whose prompt pages are shared: its co-reader
    fails FAILED_NAN too, a late request re-prefills the unmapped prefix,
    and completed streams equal the no-sharing engine's; the linear
    control fails only the victim."""
    base = _shared_prefix_run(served, False)
    reqs = _shared_prefix_run(served, True)
    assert [r.status for r in reqs] == [
        RequestStatus.COMPLETED, RequestStatus.FAILED_NAN,
        RequestStatus.FAILED_NAN, RequestStatus.COMPLETED]
    assert "poisoned" in reqs[2].error and "rid=1" in reqs[2].error
    for got, want in ((reqs[0], base[0]), (reqs[3], base[3])):
        assert got.out_tokens == want.out_tokens
    n = len(reqs[2].out_tokens)
    assert reqs[2].out_tokens == base[2].out_tokens[:n]
    lin = _shared_prefix_run(served, False, paged=False)
    assert [r.status for r in lin] == [
        RequestStatus.COMPLETED, RequestStatus.FAILED_NAN,
        RequestStatus.COMPLETED, RequestStatus.COMPLETED]


# ---------------------------------------------------------------------------
# FAILED_DEADLINE / CANCELLED
# ---------------------------------------------------------------------------

def test_deadline_expires_running_request(served):
    plan = FaultPlan(Fault(point=flt.DEADLINE, rid=0, after_step=2))
    eng = _engine(served, plan, max_new=8, paged=True)
    r0 = eng.submit(_prompts([9])[0])
    r1 = eng.submit(_prompts([7])[0])
    eng.run(max_steps=100)
    assert r0.status is RequestStatus.FAILED_DEADLINE
    assert 0 < len(r0.out_tokens) < 8
    assert r1.status is RequestStatus.COMPLETED and len(r1.out_tokens) == 8
    assert _pool_conserved(eng)


def test_deadline_expires_queued_request(served):
    """A wall-clock TTL already past at the first step: the queued request
    never runs; a later submission is unaffected."""
    eng = _engine(served, max_batch=1, max_new=2)
    doomed = eng.submit(_prompts([5])[0], ttl_s=1e-9)
    ok = eng.submit(_prompts([7])[0])
    eng.run(max_steps=100)
    assert doomed.status is RequestStatus.FAILED_DEADLINE
    assert doomed.out_tokens == [] and "queued" in doomed.error
    assert ok.status is RequestStatus.COMPLETED


def test_default_ttl_applies_to_every_submit(served):
    eng = _engine(served, max_batch=1, max_new=2, default_ttl_s=1e-9)
    a = eng.submit(_prompts([5])[0])
    b = eng.submit(_prompts([7])[0], ttl_s=0)      # explicit: no deadline
    eng.run(max_steps=100)
    assert a.status is RequestStatus.FAILED_DEADLINE
    assert b.status is RequestStatus.COMPLETED


def test_cancel_reclaims_pages_in_every_phase(served):
    eng = _engine(served, max_batch=1, max_new=8, paged=True,
                  prefill_chunk=4)
    mid = eng.submit(_prompts([12])[0])
    queued = eng.submit(_prompts([5])[0])
    eng.step()                    # `mid` is mid-prefill, `queued` waits
    assert eng._prefill_prog[0] is not None
    assert eng.cancel(queued.rid) and queued.status is RequestStatus.CANCELLED
    assert eng.cancel(mid.rid) and mid.status is RequestStatus.CANCELLED
    assert _pool_conserved(eng)
    decoding = eng.submit(_prompts([5])[0])
    for _ in range(4):
        eng.step()
    assert decoding.out_tokens
    assert eng.cancel(decoding.rid)
    assert decoding.status is RequestStatus.CANCELLED
    assert _pool_conserved(eng)
    assert not eng.cancel(decoding.rid)
    assert not eng.cancel(999)


# ---------------------------------------------------------------------------
# FAILED_CALLBACK
# ---------------------------------------------------------------------------

def test_on_token_exception_fails_only_its_request(served):
    def bomb(r, t):
        if len(r.out_tokens) == 3:
            raise RuntimeError("consumer exploded")

    eng = _engine(served, max_batch=2, max_new=6, paged=True)
    victim = eng.submit(_prompts([9])[0], on_token=bomb)
    other = eng.submit(_prompts([7])[0])
    eng.run(max_steps=100)
    assert victim.status is RequestStatus.FAILED_CALLBACK
    assert len(victim.out_tokens) == 3
    assert other.status is RequestStatus.COMPLETED
    assert len(other.out_tokens) == 6
    assert _pool_conserved(eng)


def test_on_done_exception_is_detached(served):
    def bomb(_r):
        raise RuntimeError("done-handler exploded")

    eng = _engine(served, max_batch=1, max_new=2)
    req = eng.submit(_prompts([5])[0], on_done=bomb)
    reqs = eng.run(max_steps=50)
    assert req.status is RequestStatus.COMPLETED
    assert req.on_done is None
    assert reqs == [req]


def test_on_done_fires_once_at_the_end_not_at_preemption(served):
    """A preempted request is requeued, not finished: on_done fires once,
    after its last token, and the stream equals an unpressured run."""
    prompts = _prompts([15, 14, 13])
    roomy = _engine(served, max_batch=3, max_new=24)
    for p in prompts:
        roomy.submit(p)
    want = [r.out_tokens for r in roomy.run()]
    eng = _engine(served, max_batch=3, max_new=24, paged=True, num_pages=9)
    done = []
    reqs = [eng.submit(p, on_done=lambda r: done.append(
        (r.rid, r.status, len(r.out_tokens)))) for p in prompts]
    eng.run(max_steps=500)
    assert eng.preemptions > 0
    assert sorted(done) == [(r.rid, RequestStatus.COMPLETED, 24)
                            for r in reqs]
    assert [r.out_tokens for r in reqs] == want


# ---------------------------------------------------------------------------
# FAILED_POOL: storm guard and watchdog
# ---------------------------------------------------------------------------

def test_preemption_storm_guard_fails_stalled_request(served):
    """The long prompt is evicted mid-prefill twice without growing; the
    stall guard fails it FAILED_POOL while both shorts complete with the
    streams of an unpressured run."""
    prompts = _prompts([8, 14, 30])
    roomy = _engine(served, max_batch=3, max_new=16, prefill_chunk=2)
    for p in prompts:
        roomy.submit(p)
    base = roomy.run(max_steps=300)
    eng = _engine(served, max_batch=3, max_new=16, prefill_chunk=2,
                  paged=True, num_pages=7, stall_preemptions=1)
    s1, s2, long_req = (eng.submit(p) for p in prompts)
    eng.run(max_steps=300)
    assert long_req.status is RequestStatus.FAILED_POOL
    assert "storm" in long_req.error
    assert long_req.stalls >= 1 and long_req.preemptions >= 2
    for got, want in ((s1, base[0]), (s2, base[1])):
        assert got.status is RequestStatus.COMPLETED
        assert got.out_tokens == want.out_tokens
    assert _pool_conserved(eng)


def test_watchdog_degrades_starved_admission(served):
    plan = FaultPlan(Fault(point=flt.ALLOC_FAIL, count=0))   # never drains
    eng = _engine(served, plan, paged=True, watchdog_steps=4)
    for p in _prompts([9, 7]):
        eng.submit(p)
    reqs = eng.run(max_steps=60)
    assert all(r.status is RequestStatus.FAILED_POOL for r in reqs)
    assert all("watchdog" in r.error for r in reqs)
    assert _pool_conserved(eng)


def test_engine_recovers_after_fault_drains(served):
    plan = FaultPlan(Fault(point=flt.ALLOC_FAIL, count=3))
    eng = _engine(served, plan, paged=True, max_new=4, watchdog_steps=8)
    for p in _prompts([9, 7]):
        eng.submit(p)
    eng.run(max_steps=200)
    assert plan.drained
    assert eng.status_counts() == {"COMPLETED": 2}
    late = eng.submit(_prompts([11])[0])
    eng.run(max_steps=200)
    assert late.status is RequestStatus.COMPLETED
    assert len(late.out_tokens) == 4
    assert _pool_conserved(eng)


# ---------------------------------------------------------------------------
# fault plumbing
# ---------------------------------------------------------------------------

def test_splice_corruption_caught_by_integrity_checks(served):
    plan = FaultPlan(Fault(point=flt.SPLICE_CORRUPT))
    eng = _engine(served, plan, max_batch=1, max_new=2, paged=True,
                  integrity_checks=True)
    eng.submit(_prompts([9])[0])
    with pytest.raises(PageIntegrityError, match="diverged"):
        eng.run(max_steps=50)


def test_fault_plan_is_deterministic(served):
    def go():
        plan = FaultPlan(Fault(point=flt.NAN_LOGITS, prob=0.3, count=2,
                               after_step=1), seed=42)
        eng = _engine(served, plan, max_batch=2, max_new=6, paged=True)
        for p in _prompts([9, 7, 11]):
            eng.submit(p)
        eng.run(max_steps=200)
        return plan.log, [(r.status.name, r.out_tokens) for r in eng._all]

    assert go() == go()


def test_fault_plan_rejects_unknown_point():
    with pytest.raises(ValueError, match="unknown injection point"):
        Fault(point="definitely_not_a_point")


# ---------------------------------------------------------------------------
# seeded fault traces (the reference's check_fault_trace, on the port)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    prompt_lens: tuple
    max_new: int
    max_batch: int
    prefill_chunk: int
    kv_bits: int
    pool_slack: int
    seed: int = 0
    fault: str = ""


def _run_solo(model, params, scfg, prompt):
    eng = Engine(model, params, scfg)
    eng.submit(prompt)
    return eng.run()[0].out_tokens


def _check_page_bound(eng):
    """A sequence never holds more pages than its reservation (mid-prefill)
    or ceil((len + 1) / page_size) (decoding)."""
    al = eng._kv.allocator
    for slot, req in enumerate(eng._slots):
        if req is None:
            continue
        owned = len(al.owned[slot])
        if eng._prefill_prog[slot] is not None:
            assert owned <= pages_for(req.resume_len, PS)
        else:
            assert owned <= pages_for(eng._seq_len[slot] + 1, PS)


def _plan(fault, victim):
    point = {"nan": flt.NAN_LOGITS, "alloc": flt.ALLOC_FAIL,
             "deadline": flt.DEADLINE, "callback": flt.CALLBACK_RAISE}[fault]
    if fault == "alloc":
        return FaultPlan(Fault(point=point, count=3, after_step=1))
    return FaultPlan(Fault(point=point, rid=victim, after_step=1))


_FAULT_STATUS = {"nan": RequestStatus.FAILED_NAN,
                 "deadline": RequestStatus.FAILED_DEADLINE,
                 "callback": RequestStatus.FAILED_CALLBACK}


def _check_fault_trace(tr: Trace):
    """No hang, the pool conserved, the victim contained (its fault's
    status or COMPLETED, a prefix of its solo stream), every other request
    equal to its solo run, and a fresh submission served afterwards."""
    model, params = _served(tr.kv_bits)
    rng = np.random.default_rng(tr.seed)
    prompts = [rng.integers(0, 512, n) for n in tr.prompt_lens]
    max_len = -(-(max(tr.prompt_lens) + tr.max_new + 1) // PS) * PS
    pool_min = pages_for(max(tr.prompt_lens) + tr.max_new, PS)
    scfg = ServeConfig(max_batch=tr.max_batch, max_len=max_len,
                       max_new=tr.max_new, prefill_bucket=16, page_size=PS,
                       paged=True, num_pages=pool_min + tr.pool_slack,
                       prefill_chunk=tr.prefill_chunk, watchdog_steps=8)
    solo = [_run_solo(model, params, dataclasses.replace(
        scfg, max_batch=1, num_pages=0), p) for p in prompts]
    victim = len(prompts) // 2
    plan = _plan(tr.fault, victim)
    eng = Engine(model, params, scfg, faults=plan)
    for p in prompts:
        eng.submit(p, on_token=lambda r, t: _check_page_bound(eng))
    budget = 200 + 80 * len(prompts)
    reqs = eng.run(max_steps=budget)
    for i, r in enumerate(reqs):
        if tr.fault != "alloc" and i == victim:
            assert r.status in (_FAULT_STATUS[tr.fault],
                                RequestStatus.COMPLETED), (tr, r.status)
            assert r.out_tokens == solo[i][:len(r.out_tokens)]
            if r.status is RequestStatus.COMPLETED:
                assert plan.fired() == 0
        else:
            assert r.status is RequestStatus.COMPLETED, (tr, i, r.status)
            assert r.out_tokens == solo[i], f"survivor {i} diverged on {tr}"
    assert _pool_conserved(eng)
    late = eng.submit(prompts[0])
    eng.run(max_steps=budget)
    assert late.status is RequestStatus.COMPLETED
    assert late.out_tokens == solo[0]


@pytest.mark.parametrize("fault", ["nan", "alloc", "deadline", "callback"])
def test_fault_trace_seeded(fault):
    _check_fault_trace(Trace(prompt_lens=(13, 9, 21), max_new=5,
                             max_batch=2, prefill_chunk=8, kv_bits=8,
                             pool_slack=3, seed=3, fault=fault))


def test_fault_trace_seeded_kv4_pressure():
    """NaN quarantine under pool pressure on the packed int4 cache."""
    _check_fault_trace(Trace(prompt_lens=(15, 14, 13), max_new=6,
                             max_batch=3, prefill_chunk=4, kv_bits=4,
                             pool_slack=2, seed=2, fault="nan"))
