"""Prefix caching in the port's Engine, and a differential harness that
runs the port's Engine and the reference's Engine on the same traces.

* The page keys: the blake2b chain is seeded with the kv-config identity
  in the reference's dtype names, so equal token histories give byte-equal
  keys in both packages.
* Shared pages are never written: their bytes stay unchanged across a
  step that prefills one sharer while another decodes (the decode step's
  droppable token for a mid-prefill slot lands at ``lens``, which reserve
  publishes at the matched length: the slot's first exclusive page).
* The shared-prefix traces of the reference's ``tests/test_engine_fuzz.py``
  (sharing == no sharing, hits, conservation, faults through the sharing
  engine), on the port.
* The differential harness: 13 seeded traces over the linear and the paged
  cache, pages of 4/8/16, chunks of 0/4/8/16, prefix caching on and off and
  every fault point; the two engines must agree on submit outcomes,
  statuses, errors, streams, preemptions, ``prefix_stats``, the fault
  plan's firings, the prefix map's keys and the final allocator state.

llama-micro on w8 a16 kv8 (kv4 for one trace), the plain versions tiled
one page per tile (``block_kv = page_size``) on both sides; the reference
runs with ``kernel_mode="ref"``.
"""
import dataclasses
from typing import Optional

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.models import build_model
from repro.serve import faults as jflt
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import QueueFull as JQueueFull
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.kv_cache import PagedCache as JPagedCache
from repro.serve.kv_cache import PageIntegrityError as JPageIntegrityError
from repro.serve.quantized import QuantizedModel as JQuantizedModel
from repro.serve.quantized import quantize_lm_packed as jquantize_lm_packed
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.quantizer import QuantConfig
from repro_torch.serve import faults as flt
from repro_torch.serve.engine import (Engine, QueueFull, RequestStatus,
                                      ServeConfig)
from repro_torch.serve.kv_cache import (PagedCache, PageIntegrityError,
                                        pages_for)
from repro_torch.serve.quantized import QuantizedModel

PS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SERVED: dict = {}


def _served(kv_bits=8):
    """(reference model, reference tree, port model, bridged tree) of
    llama-micro w8 a16 at ``kv_bits``; one packed tree serves every cache
    width."""
    if "tree" not in _SERVED:
        jcfg = jget_config("llama-micro")
        jp = jquantize_lm_packed(
            build_model(jcfg).init(jax.random.PRNGKey(0)), jcfg,
            JQuantConfig(w_bits=8, a_bits=16, group_size=32, lwc=False))
        _SERVED["tree"] = (jp, from_jax_params(
            jax.tree_util.tree_map(np.asarray, jp)))
    if kv_bits not in _SERVED:
        jq = JQuantConfig(w_bits=8, a_bits=16, group_size=32, lwc=False,
                          kv_bits=kv_bits)
        tq = QuantConfig(w_bits=8, a_bits=16, group_size=32, kv_bits=kv_bits)
        _SERVED[kv_bits] = (
            JQuantizedModel(jget_config("llama-micro"), jq,
                            kernel_mode="ref", flash_block_kv=PS),
            QuantizedModel(get_config("llama-micro"), tq, device="cpu",
                           block_kv=PS))
    (jp, tp), (jm, tm) = _SERVED["tree"], _SERVED[kv_bits]
    return jm, jp, tm, tp


# ---------------------------------------------------------------------------
# page keys and the write path
# ---------------------------------------------------------------------------

def _models(kv_bits):
    """(reference model, port model) of llama-micro w8 a16 at ``kv_bits``:
    no weights (the page keys need the cache format only)."""
    jq = JQuantConfig(w_bits=8, a_bits=16, group_size=32, lwc=False,
                      kv_bits=kv_bits)
    tq = QuantConfig(w_bits=8, a_bits=16, group_size=32, kv_bits=kv_bits)
    return (JQuantizedModel(jget_config("llama-micro"), jq, kernel_mode="ref"),
            QuantizedModel(get_config("llama-micro"), tq, device="cpu"))


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_page_keys_equal_reference(kv_bits):
    """Equal token histories give byte-equal chain keys in both packages,
    and the keys differ between cache formats."""
    jm, tm = _models(kv_bits)
    toks = np.random.default_rng(kv_bits).integers(0, 512, 37)
    jstore = JPagedCache(jm, 2, 64, PS, prefix_cache=True)
    tstore = PagedCache(tm, 2, 64, PS, prefix_cache=True)
    assert tstore._seed == jstore._seed
    keys = tstore._page_keys(toks)
    assert len(keys) == 37 // PS and keys == jstore._page_keys(toks)
    other = PagedCache(_models(16 if kv_bits != 16 else 8)[1], 2, 64, PS,
                       prefix_cache=True)
    assert other._page_keys(toks)[0] != keys[0]


def _pool_bytes(store, pages):
    c = store.cache
    return [t[:, p].clone() for p in pages
            for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None]


def test_shared_pages_unchanged_across_mixed_prefill_decode_steps():
    """A writer registers 2 full pages; two readers adopt them, one
    decodes while the other is still mid-prefill: every step leaves every
    shared page's bytes as they were at registration, and a mid-prefill
    sharer's device ``lens`` is its matched length from reserve on."""
    _, _, tm, tp = _served(8)
    rng = np.random.default_rng(11)
    sys_prompt = rng.integers(0, 512, 19)
    prompts = [np.concatenate([sys_prompt, rng.integers(0, 512, n)])
               for n in (3, 2, 13)]
    eng = Engine(tm, tp, ServeConfig(
        max_batch=3, max_len=64, max_new=8, page_size=PS, paged=True,
        prefill_chunk=4, prefix_cache=True, integrity_checks=True))
    eng.submit(prompts[0])
    eng.run(max_steps=100)
    kv = eng._kv
    shared = sorted(kv._prefix_map.values())
    assert len(shared) == 2
    snap = _pool_bytes(kv, shared)
    rs = [eng.submit(p) for p in prompts[1:]]
    mixed = 0
    while any(not r.done for r in rs):
        eng.step()
        for slot, req in enumerate(eng._slots):
            if req is not None and eng._prefill_prog[slot] is not None:
                assert kv.allocator.owned[slot][:2] == \
                    [p for p in kv.allocator.owned[slot][:2] if p in shared]
        decoding = [s for s, r in enumerate(eng._slots) if r is not None
                    and eng._prefill_prog[s] is None]
        prefilling = [s for s, r in enumerate(eng._slots) if r is not None
                      and eng._prefill_prog[s] is not None]
        mixed += bool(decoding and prefilling)
        assert all(torch.equal(a, b)
                   for a, b in zip(snap, _pool_bytes(kv, shared)))
    assert mixed > 0, "no step decoded while a sharer was mid-prefill"
    assert eng.prefix_stats["hits"] == 2
    assert [r.status for r in rs] == [RequestStatus.COMPLETED] * 2


def test_reserve_publishes_matched_lens_and_rolls_back_adopt():
    """reserve with a prefix hit sets the device lens to the matched
    length; a reserve whose fresh pages are missing undoes its adopt."""
    _, _, tm, _ = _served(8)
    store = PagedCache(tm, 3, 64, PS, num_pages=5, prefix_cache=True)
    toks = np.arange(19, dtype=np.int32)
    assert store.reserve(0, 20, tokens=toks)            # 3 pages
    store.register_prefix(0, toks)
    assert store.reserve(1, 20, tokens=toks)            # adopt 2, 1 fresh
    assert store.matched_tokens(1) == 16
    assert store.cache.lens.tolist()[1] == 16
    before = (list(store.allocator.free_list),
              [set(o) for o in store.allocator.owners])
    assert not store.reserve(2, 40, tokens=np.arange(40, dtype=np.int32))
    assert (list(store.allocator.free_list),
            [set(o) for o in store.allocator.owners]) == before
    assert store.allocator.owned[2] == []
    store.verify()


# ---------------------------------------------------------------------------
# shared-prefix traces (the reference's check_prefix_trace, on the port)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PTrace:
    prompt_lens: tuple       # suffix lengths after the shared prefix
    max_new: int
    max_batch: int
    prefill_chunk: int
    kv_bits: int
    pool_slack: int
    seed: int = 0
    fault: str = ""
    prefix_len: int = 0


def _prefix_prompts(tr, vocab=512):
    rng = np.random.default_rng(tr.seed)
    prefix = rng.integers(0, vocab, tr.prefix_len)
    return [np.concatenate([prefix, rng.integers(0, vocab, n)])
            for n in tr.prompt_lens]


def _run(tm, tp, scfg, prompts, faults=None):
    eng = Engine(tm, tp, scfg, faults=faults)
    reqs = [eng.submit(p) for p in prompts]
    eng.run(max_steps=200 + 80 * len(prompts))
    assert all(r.done for r in reqs)
    eng._kv.verify()
    al = eng._kv.allocator
    assert al.num_free == al.num_pages and all(not o for o in al.owned)
    return [r.out_tokens for r in reqs], reqs, eng


def _pcfg(tr, prefix, tight=False, **kw):
    longest = tr.prefix_len + max(tr.prompt_lens)
    return ServeConfig(
        max_batch=tr.max_batch,
        max_len=-(-(longest + tr.max_new + 1) // PS) * PS,
        max_new=tr.max_new, prefill_bucket=16, page_size=PS, paged=True,
        num_pages=(pages_for(longest + tr.max_new, PS) + tr.pool_slack
                   if tight else 0),
        prefill_chunk=tr.prefill_chunk, prefix_cache=prefix, **kw)


def _check_prefix_trace(tr, expect_preempt=False):
    """Sharing == no sharing (concurrent, serial, tight pool), every prompt
    token adopted or prefilled exactly once, and serial runs hit."""
    _, _, tm, tp = _served(tr.kv_bits)
    prompts = _prefix_prompts(tr)
    base, _, _ = _run(tm, tp, _pcfg(tr, False), prompts)
    outs, reqs, eng = _run(tm, tp, _pcfg(tr, True), prompts)
    assert outs == base
    st = eng.prefix_stats
    assert st["lookups"] == len(prompts)
    if not eng.preemptions:
        assert st["matched_tokens"] + st["prefilled_tokens"] == \
            sum(len(p) for p in prompts)
    outs, _, eng = _run(tm, tp, dataclasses.replace(
        _pcfg(tr, True), max_batch=1), prompts)
    assert outs == base
    if tr.prefix_len >= PS:
        st = eng.prefix_stats
        assert st["hits"] >= len(prompts) - 1
        assert st["matched_tokens"] >= \
            (len(prompts) - 1) * (tr.prefix_len // PS) * PS
    outs, _, eng = _run(tm, tp, _pcfg(tr, True, tight=True), prompts)
    assert outs == base
    if expect_preempt:
        assert eng.preemptions > 0


def test_prefix_trace_seeded_kv8():
    _check_prefix_trace(PTrace(prompt_lens=(5, 9, 13), max_new=5,
                               max_batch=2, prefill_chunk=8, kv_bits=8,
                               pool_slack=4, seed=1, prefix_len=19))


def test_prefix_trace_seeded_pressure_kv4():
    """Refcount x eviction on the packed int4 cache: a tight pool preempts
    sequences holding shared pages, and the resumes re-match."""
    _check_prefix_trace(PTrace(prompt_lens=(7, 6, 5), max_new=16,
                               max_batch=3, prefill_chunk=4, kv_bits=4,
                               pool_slack=2, seed=2, prefix_len=8),
                        expect_preempt=True)


_FAULTS = {"nan": (flt.NAN_LOGITS, RequestStatus.FAILED_NAN),
           "alloc": (flt.ALLOC_FAIL, None),
           "deadline": (flt.DEADLINE, RequestStatus.FAILED_DEADLINE)}


@pytest.mark.parametrize("fault", ["nan", "alloc", "deadline"])
def test_prefix_fault_trace_seeded(fault):
    """Faults through the sharing engine: every stream is a prefix of its
    solo no-fault run, a NaN co-reader ends FAILED_NAN naming the poison,
    the pool is conserved, and a late submission is served."""
    tr = PTrace(prompt_lens=(5, 9, 13), max_new=5, max_batch=3,
                prefill_chunk=8, kv_bits=8, pool_slack=3, seed=3,
                fault=fault, prefix_len=19)
    _, _, tm, tp = _served(8)
    prompts = _prefix_prompts(tr)
    scfg = _pcfg(tr, True, tight=True, watchdog_steps=8)
    solo = [_run(tm, tp, dataclasses.replace(
        scfg, max_batch=1, num_pages=0, prefix_cache=False), [p])[0][0]
        for p in prompts]
    point, status = _FAULTS[fault]
    victim = len(prompts) // 2
    plan = flt.FaultPlan(flt.Fault(point=point, count=3, after_step=1)
                         if fault == "alloc" else
                         flt.Fault(point=point, rid=victim, after_step=1))
    outs, reqs, eng = _run(tm, tp, scfg, prompts, faults=plan)
    for i, r in enumerate(reqs):
        assert r.out_tokens == solo[i][:len(r.out_tokens)]
        if status is not None and i == victim:
            assert r.status in (status, RequestStatus.COMPLETED)
        elif fault == "nan" and r.status is RequestStatus.FAILED_NAN:
            assert "poisoned" in r.error
        else:
            assert r.status is RequestStatus.COMPLETED
            assert r.out_tokens == solo[i]
    late = eng.submit(prompts[0])
    eng.run(max_steps=400)
    assert late.status is RequestStatus.COMPLETED
    assert late.out_tokens == solo[0]


# ---------------------------------------------------------------------------
# the differential harness: port Engine against reference Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DTrace:
    """One seeded trace: ``waves`` of prompt lengths (each wave submitted
    after the previous one drained, so later waves can hit the prefix
    map), a shared prefix of ``prefix_len`` tokens, and one fault."""
    name: str
    waves: tuple
    paged: bool = True
    page_size: int = 8
    chunk: int = 0
    prefix: bool = False
    prefix_len: int = 0
    max_new: int = 5
    num_pages: int = 0
    max_queue: int = 0
    eos_pick: Optional[int] = None   # EOS = this index of a base stream
    fault: Optional[dict] = None     # Fault kwargs; point by name
    integrity: bool = False
    seed: int = 0
    kv_bits: int = 8


TRACES = [
    # linear cache, chunks 0/4/8/16
    DTrace("linear-whole", ((13, 3, 26),), paged=False, seed=1),
    DTrace("linear-chunk4-nan", ((9, 14, 5),), paged=False, chunk=4,
           fault=dict(point="nan", rid=1, after_step=3), seed=2),
    DTrace("linear-chunk8-deadline", ((17, 6, 11),), paged=False, chunk=8,
           fault=dict(point="deadline", rid=0, after_step=2), seed=3),
    DTrace("linear-chunk16-callback", ((21, 7),), paged=False, chunk=16,
           fault=dict(point="callback", rid=1, after_step=1), seed=4),
    # pages of 8, a pool of 24
    DTrace("p8-whole-alloc", ((9, 7, 12),), fault=dict(
        point="alloc", count=3, after_step=1), seed=6),
    DTrace("p8-chunk8-prefix-alloc", ((6, 4), (6, 4)), chunk=8, prefix=True,
           prefix_len=16, fault=dict(point="alloc", count=4, after_step=2),
           seed=10),
    DTrace("p8-chunk4-prefix-callback", ((7,), (2, 11)), chunk=4,
           prefix=True, prefix_len=17,
           fault=dict(point="callback", rid=1, after_step=1), seed=12),
    DTrace("p8-whole-splice-corrupt", ((9,),), integrity=True,
           fault=dict(point="splice"), seed=13),
    # pages of 8, a pool of 7: preemption with shared pages, FAILED_POOL
    DTrace("p8-chunk8-prefix-tight", ((5, 9, 13),), chunk=8, prefix=True,
           prefix_len=19, num_pages=7, seed=8),
    DTrace("p8-chunk8-pool", ((6, 12, 45),), chunk=8, max_new=16,
           num_pages=7, seed=16),
    # pages of 4
    DTrace("p4-chunk4-prefix-nan-readers", ((5,), (9, 13)), page_size=4,
           chunk=4, prefix=True, prefix_len=19, max_new=8,
           fault=dict(point="nan", rid=1, after_step=19), seed=9),
    DTrace("p4-chunk8-queue-eos", ((6, 11, 8, 5),), page_size=4, chunk=8,
           max_queue=2, eos_pick=2, seed=14),
    # pages of 16
    DTrace("p16-chunk16-prefix-nan-prob", ((9, 4, 12), (9, 4)),
           page_size=16, chunk=16, prefix=True, prefix_len=20,
           fault=dict(point="nan", prob=0.3, count=2, after_step=1), seed=15),
]

_POINTS = {"nan": "NAN_LOGITS", "alloc": "ALLOC_FAIL", "deadline": "DEADLINE",
           "callback": "CALLBACK_RAISE", "splice": "SPLICE_CORRUPT"}


def _dtrace_prompts(tr):
    rng = np.random.default_rng(tr.seed)
    prefix = rng.integers(0, 512, tr.prefix_len)
    return [[np.concatenate([prefix, rng.integers(0, 512, n)]).astype(
        np.int32) for n in wave] for wave in tr.waves]


def _dtrace_cfg(tr, cls, eos):
    # one batch, capacity and prompt bucket for every trace: the
    # reference's jitted steps compile once per shape and are shared
    # across traces
    kw = dict(max_batch=3, max_len=64, max_new=tr.max_new,
              prefill_bucket=64, eos_token=eos, paged=tr.paged, page_size=tr.page_size,
              num_pages=tr.num_pages, prefill_chunk=tr.chunk,
              prefix_cache=tr.prefix, max_queue=tr.max_queue,
              integrity_checks=tr.integrity, watchdog_steps=8)
    if tr.name == "p8-chunk8-pool":
        kw["stall_preemptions"] = 1
    return cls(**kw)


_JAX_STEPS: dict = {}


def _jax_engine(jm, jp, scfg, plan):
    """A reference Engine whose jitted step functions are shared with the
    first engine built on the same model: they depend only on the model
    and the sampling config, so the traces do not compile them again."""
    eng = JEngine(jm, jp, scfg, faults=plan)
    key = (id(jm), scfg.temperature, scfg.top_k)
    steps = _JAX_STEPS.setdefault(key, {})
    for name in ("_decode", "_prefill", "_chunk"):
        if hasattr(eng, name):
            setattr(eng, name, steps.setdefault(name, getattr(eng, name)))
    return eng


def _drive(eng, waves, errors):
    """Submit each wave, drain it, and record what happened."""
    submits = []
    for wave in waves:
        for p in wave:
            try:
                submits.append(("ok", eng.submit(p).rid))
            except errors as e:
                submits.append((type(e).__name__, e.request.rid))
        eng.run(max_steps=600)
    return submits


def _outcome(eng, plan, submits):
    kv = eng._kv
    out = {"submits": submits,
           "requests": [(r.rid, r.status.name, r.error, list(r.out_tokens),
                         r.preemptions) for r in eng._all],
           "prefix_stats": dict(eng.prefix_stats),
           "fired": None if plan is None else
           [(s, pt, sorted(ctx.items())) for s, pt, ctx in plan.log]}
    if hasattr(kv, "allocator"):
        al = kv.allocator
        out.update(prefix_map=dict(kv._prefix_map),
                   free_list=list(al.free_list),
                   owned=[list(o) for o in al.owned],
                   owners=[sorted(o) for o in al.owners],
                   peak=al.peak_in_use)
    return out


def _run_both(tr):
    jm, jp, tm, tp = _served(tr.kv_bits)
    waves = _dtrace_prompts(tr)
    eos = -1
    if tr.eos_pick is not None:      # EOS = a token of a base greedy stream
        probe = Engine(tm, tp, _dtrace_cfg(tr, ServeConfig, -1))
        probe.submit(waves[0][0])
        eos = probe.run()[0].out_tokens[tr.eos_pick]
    res = []
    for side in ("jax", "torch"):
        mod = jflt if side == "jax" else flt
        plan = None
        if tr.fault is not None:
            f = dict(tr.fault)
            f["point"] = getattr(mod, _POINTS[f["point"]])
            plan = mod.FaultPlan(mod.Fault(**f), seed=tr.seed)
        if side == "jax":
            eng = _jax_engine(jm, jp, _dtrace_cfg(tr, JServeConfig, eos),
                              plan)
            errors, integrity = JQueueFull, JPageIntegrityError
        else:
            eng = Engine(tm, tp, _dtrace_cfg(tr, ServeConfig, eos),
                         faults=plan)
            errors, integrity = QueueFull, PageIntegrityError
        try:
            submits = _drive(eng, waves, errors)
            raised = None
        except integrity as e:
            submits, raised = None, str(e)
        res.append((_outcome(eng, plan, submits), raised))
    return res


@pytest.mark.parametrize("tr", TRACES, ids=lambda t: t.name)
def test_port_engine_matches_reference_engine(tr):
    (want, jraised), (got, traised) = _run_both(tr)
    assert traised == jraised
    for key in want:
        assert got[key] == want[key], (tr.name, key)
    if tr.name == "p8-whole-splice-corrupt":
        assert "diverged" in traised


def test_serve_cli_prefix_cache_waves(capsys):
    """``serve --prefix-cache``: the replay wave adopts the pages the cold
    wave left (each prompt's 2 full pages below its last token) and gives
    the cold wave's streams; the last line reports the statuses."""
    from repro_torch.launch import serve as serve_cli
    argv = ["--arch", "llama-micro", "--device", "cpu", "--wbits", "8",
            "--group", "32", "--abits", "16", "--kvbits", "8", "--requests",
            "3", "--prompt-len", "20", "--max-new", "4", "--max-batch", "3",
            "--max-len", "64", "--paged", "--page-size", str(PS)]
    with pytest.raises(ValueError, match="--paged"):
        serve_cli.serve(serve_cli.build_parser().parse_args(
            [a for a in argv if a != "--paged"] + ["--prefix-cache"]))
    out = serve_cli.main(argv + ["--prefix-cache"])
    cold, replay = ([r.out_tokens for r in reqs]
                    for reqs, _ in out["prefix"]["waves"].values())
    assert replay == cold and all(len(s) == 4 for s in cold)
    assert out["prefix"]["stats"] == {"lookups": 6, "hits": 3,
                                      "matched_tokens": 3 * 2 * PS,
                                      "prefilled_tokens": 3 * 20 + 3 * 4}
    assert "statuses {'COMPLETED': 3}" in \
        capsys.readouterr().out.strip().splitlines()[-1]
