"""Port parity: the paged KV cache — the paged and kv4 plain attention
versions against the reference's ``repro.kernels.ref`` oracles, the write
destinations, the page allocator, and ``QuantizedModel`` over a
``PagedKVCache`` against the reference's ``QuantizedModel`` in ref mode.

Tolerances: the attention versions sum over D and over positions in
another order than XLA, and exp differs by an ulp: 2e-6 of the output's
max magnitude, as in ``test_torch_kernels_plain.py``.  Page tables, codes
and bf16 scales are integer data and byte-equal.  Model logits: 1e-5 of
the largest logit at a16 (summation order only), 1e-4 at a4 (room for
summation order ahead of the activation rounding), greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.kernels import ref
from repro.models import build_model
from repro.serve import kv_cache as jkvc
from repro.serve.quantized import QuantizedModel as JQuantizedModel
from repro.serve.quantized import quantize_lm_packed as jquantize_lm_packed
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.quantizer import QuantConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (flash_decode_paged_plain,
                                              flash_decode_plain)
from repro_torch.kernels.flash_prefill import (flash_prefill_paged_plain,
                                               flash_prefill_plain)
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.quantized import QuantizedModel


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small shapes: as fast alone,
    and under parallel test workers torch does not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    """numpy (bfloat16 included) -> torch."""
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, rel=2e-6):
    want = np.asarray(want)
    err = np.max(np.abs(np.asarray(got) - want))
    assert err <= rel * max(1.0, np.max(np.abs(want))), err


def _entries(rng, lead, hkv, d, kv_bits):
    """(k, v, k_scale, v_scale) numpy arrays of cache rows ``lead``."""
    f = lambda: rng.standard_normal(lead + (hkv, d)).astype(np.float32)
    if kv_bits == 16:
        return f(), f(), None, None
    if kv_bits == 8:
        c = lambda: rng.integers(-128, 128, lead + (hkv, d)).astype(np.int8)
        s = lambda: (rng.random(lead + (hkv,)) * 0.05 + 0.01
                     ).astype(np.float32)
        return c(), c(), s(), s()
    c = lambda: rng.integers(-128, 128, lead + (hkv, d // 2)).astype(np.int8)
    s = lambda: np.asarray(jnp.asarray(
        rng.random(lead + (hkv, d // 32)) * 0.5 + 0.05, jnp.bfloat16))
    return c(), c(), s(), s()


def _paged(rng, lens, hkv, d, ps, kv_bits, max_pages):
    """Pools with spare pages, a shuffled page table holding
    ceil(len / ps) pages per row and -1 past them."""
    need = [-(-n // ps) for n in lens]
    num_pages = sum(need) + 3
    perm = rng.permutation(num_pages)
    pt = np.full((len(lens), max_pages), -1, np.int32)
    used = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[used:used + n]
        used += n
    return _entries(rng, (num_pages, ps), hkv, d, kv_bits), pt


def _gather(entry, pt):
    """The linear (B, max_pages * ps, ...) cache a page table spells out
    (a -1 entry reads page 0)."""
    if entry is None:
        return None
    g = entry[np.maximum(pt, 0)]
    return np.ascontiguousarray(g.reshape(pt.shape[0], -1, *g.shape[3:]))


KV_BITS = [16, 8, 4]


@pytest.mark.parametrize("kv_bits", KV_BITS)
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_decode_plain_matches_ref(kv_bits, g, ps):
    """Zero length, one token, a page boundary and a mid-page tail, over a
    shuffled table with -1 tails; the linear plain version over the
    gathered cache with one page per tile is equal bit for bit."""
    rng = np.random.default_rng(kv_bits + g + ps)
    hkv, d, max_pages = 2, 64, 4
    lens = np.asarray([0, 1, ps, 2 * ps + 7], np.int32)
    (k, v, ks, vs), pt = _paged(rng, lens, hkv, d, ps, kv_bits, max_pages)
    q = rng.standard_normal((4, hkv, g, d)).astype(np.float32)
    want = ref.flash_decode_paged_ref(_j(q), _j(k), _j(v), _j(pt), _j(lens),
                                      _j(ks), _j(vs))
    got = flash_decode_paged_plain(_t(q), _t(k), _t(v), _t(pt), _t(lens),
                                   _t(ks), _t(vs))
    _close(got, want)
    assert not got[0].any()
    lin = flash_decode_plain(_t(q), *(_t(_gather(e, pt))
                                      for e in (k, v)), _t(lens),
                             *(_t(_gather(e, pt)) for e in (ks, vs)),
                             block_kv=ps)
    assert torch.equal(got, lin)


@pytest.mark.parametrize("kv_bits", KV_BITS)
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_prefill_plain_matches_ref(kv_bits, g, ps):
    """Chunks at offset 0 and mid-sequence across page boundaries, and a
    chunk_len 0 row (zeros)."""
    rng = np.random.default_rng(100 + kv_bits + g + ps)
    hkv, d, c, max_pages = 2, 64, 12, 5
    off = np.asarray([0, ps - 3, 2 * ps, 5], np.int32)
    cl = np.asarray([12, 9, 0, 1], np.int32)
    (k, v, ks, vs), pt = _paged(rng, off + cl, hkv, d, ps, kv_bits,
                                max_pages)
    q = rng.standard_normal((4, hkv, c, g, d)).astype(np.float32)
    want = ref.flash_prefill_paged_ref(_j(q), _j(k), _j(v), _j(pt), _j(off),
                                       _j(cl), _j(ks), _j(vs))
    got = flash_prefill_paged_plain(_t(q), _t(k), _t(v), _t(pt), _t(off),
                                    _t(cl), _t(ks), _t(vs))
    _close(got, want)
    assert not got[2].any() and not got[1, :, 9:].any()
    lin = flash_prefill_plain(_t(q), *(_t(_gather(e, pt)) for e in (k, v)),
                              _t(off), _t(cl),
                              *(_t(_gather(e, pt)) for e in (ks, vs)),
                              block_kv=ps)
    assert torch.equal(got, lin)


@pytest.mark.parametrize("g", [1, 4])
def test_linear_kv4_plain_matches_ref(g):
    rng = np.random.default_rng(g)
    b, s, hkv, d, c = 3, 64, 2, 64, 16
    k, v, ks, vs = _entries(rng, (b, s), hkv, d, 4)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    lens = np.asarray([0, 17, 64], np.int32)
    want = ref.flash_decode_ref(_j(q), _j(k), _j(v), _j(lens), _j(ks),
                                _j(vs), block_kv=16)
    got = flash_decode_plain(_t(q), _t(k), _t(v), _t(lens), _t(ks), _t(vs),
                             block_kv=16)
    _close(got, want)
    q5 = rng.standard_normal((b, hkv, c, g, d)).astype(np.float32)
    off = np.asarray([0, 30, 48], np.int32)
    cl = np.asarray([16, 0, 5], np.int32)
    want = ref.flash_prefill_ref(_j(q5), _j(k), _j(v), _j(off), _j(cl),
                                 _j(ks), _j(vs), block_kv=16)
    got = flash_prefill_plain(_t(q5), _t(k), _t(v), _t(off), _t(cl), _t(ks),
                              _t(vs), block_kv=16)
    _close(got, want)


def test_ops_paged_dispatch_and_shape_checks():
    rng = np.random.default_rng(4)
    (k, v, ks, vs), pt = _paged(rng, [5, 9], 2, 32, 8, 4, 3)
    kv = tuple(_t(e) for e in (k, v, ks, vs))
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 32)).astype(np.float32))
    cur = torch.tensor([5, 9], dtype=torch.int32)
    auto = ops.flash_decode(q, kv, cur, page_table=_t(pt))
    plain = ops.flash_decode(q, kv, cur, page_table=_t(pt), mode="plain")
    assert auto.shape == (2, 1, 4, 32) and torch.equal(auto, plain)
    one = ops.flash_prefill(q, kv, cur - 1, torch.ones_like(cur),
                            page_table=_t(pt))
    torch.testing.assert_close(one, auto, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="page_table"):
        ops.flash_decode(q, kv, cur, page_table=_t(pt)[:1])
    with pytest.raises(ValueError, match="pools"):
        ops.flash_decode(q, (kv[0][..., :8],) + kv[1:], cur,
                         page_table=_t(pt))


def test_page_allocator_accounting_and_double_free():
    al = kvc.PageAllocator(num_pages=6, max_pages_per_seq=4, max_batch=2)
    assert al.allocate(0, 3) == [0, 1, 2]
    assert al.allocate(1, 4) is None                 # pool holds 3 more
    assert al.allocate(1, 2) == [3, 4]
    assert al.allocate(0, 2) is None                 # past max_pages_per_seq
    assert (al.num_in_use, al.num_free, al.peak_in_use) == (5, 1, 5)
    assert al.exclusive_pages(0) == 3 and al.owners[4] == {1}
    assert al.free(0) == 3
    assert al.free_list[-1] == 0                     # LIFO: reused first
    assert al.allocate(0, 1) == [0]
    al.owned[0].append(2)                            # 2 is on the free list
    with pytest.raises(kvc.PageIntegrityError, match="double-free"):
        al.free(0)
    al.owned[0].remove(2)
    al.owned[0].append(3)                            # 3 is slot 1's
    al.owners[3].discard(1)
    with pytest.raises(kvc.PageIntegrityError, match="corrupted handoff"):
        al.free(0)


def test_write_destinations_match_reference_and_drop_unallocated():
    """The reference's destinations byte for byte; a write to an
    unallocated page or past capacity leaves the pool untouched."""
    pt = np.asarray([[2, -1], [0, 1]], np.int32)
    ps, num_pages = 4, 3
    for lens in ([4, 7], [8, 8], [0, 3]):
        want = jkvc.token_write_dest(jnp.asarray(pt), jnp.asarray(lens), ps,
                                     num_pages)
        got = kvc.token_write_dest(_t(pt), torch.tensor(lens), ps, num_pages)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    off, cl = np.asarray([3, 5], np.int32), np.asarray([4, 2], np.int32)
    want = jkvc.chunk_write_dest(jnp.asarray(pt), jnp.asarray(off),
                                 jnp.asarray(cl), 4, ps, num_pages)
    got = kvc.chunk_write_dest(_t(pt), _t(off), _t(cl), 4, ps, num_pages)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    rows = num_pages * ps
    pool = torch.zeros((num_pages, ps, 2))
    # seq 0 at len 4 -> logical page 1 unallocated: dropped
    dest = kvc.token_write_dest(_t(pt), torch.tensor([4, 7]), ps, num_pages)
    kvc.paged_token_write(pool, torch.ones((2, 2)),
                          kvc.token_write_index(dest, rows))
    assert pool.sum() == 2 and pool[1, 3].tolist() == [1.0, 1.0]
    # both at capacity: nothing written
    dest = kvc.token_write_dest(_t(pt), torch.tensor([8, 8]), ps, num_pages)
    kvc.paged_token_write(pool, torch.full((2, 2), 5.0),
                          kvc.token_write_index(dest, rows))
    assert pool.sum() == 2
    # chunk rows past the allocated page drop
    pool.zero_()
    index = kvc.paged_chunk_write_index(got, rows)
    kvc.paged_chunk_write(pool, torch.ones((2, 4, 2)), index)
    assert pool.sum() == 2 * int((np.asarray(want) < rows).sum())


# ---------------------------------------------------------------------------
# QuantizedModel over a PagedKVCache against the reference model
# ---------------------------------------------------------------------------

MODELS = {"w4a16kv4": dict(a_bits=16, kv_bits=4, tol=1e-5),
          "w4a4kv8": dict(a_bits=4, kv_bits=8, tol=1e-4)}


@pytest.fixture(scope="module", params=list(MODELS))
def models(request):
    s = MODELS[request.param]
    jcfg = dataclasses.replace(jget_config("llama-micro"), num_kv_heads=2)
    tcfg = dataclasses.replace(get_config("llama-micro"), num_kv_heads=2)
    jq = JQuantConfig(w_bits=4, a_bits=s["a_bits"], group_size=32,
                      lwc=False, kv_bits=s["kv_bits"])
    tq = QuantConfig(w_bits=4, a_bits=s["a_bits"], group_size=32,
                     kv_bits=s["kv_bits"])
    params = build_model(jcfg).init(jax.random.PRNGKey(7))
    jp = jquantize_lm_packed(params, jcfg, jq)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    return (JQuantizedModel(jcfg, jq, kernel_mode="ref"), jp,
            QuantizedModel(tcfg, tq, device="cpu"), tp, s["tol"])


def test_paged_model_matches_reference(models):
    """Paged prefill of prompts 13 and 6 in one chunk at offset 0, then 8
    teacher-forced decode steps growing pages at the boundaries, through
    both frameworks' page stores (page size 4): page tables byte-equal,
    logits within tolerance, greedy tokens equal."""
    jm, jp, tm, tp, tol = models
    ps, lens = 4, np.asarray([13, 6], np.int32)
    toks = np.random.default_rng(2).integers(
        0, jm.cfg.vocab_size, (2, 24)).astype(np.int32)
    jstore = jkvc.PagedCache(jm, max_batch=2, max_len=32, page_size=ps)
    tstore = kvc.PagedCache(tm, max_batch=2, max_len=32, page_size=ps)
    for slot, n in enumerate(lens):
        assert jstore.reserve(slot, int(n)) and tstore.reserve(slot, int(n))
    chunk = jax.jit(jm.prefill_chunk, static_argnames=("last_only",))
    step = jax.jit(jm.decode_step)
    first = toks[:, :13] * (np.arange(13)[None] < lens[:, None])
    want, jcache = chunk(jp, {"tokens": jnp.asarray(first),
                              "chunk_len": jnp.asarray(lens)},
                         jstore.cache, jnp.zeros(2, jnp.int32),
                         last_only=True)
    got, tcache = tm.prefill_chunk(tp, {"tokens": _t(first),
                                        "chunk_len": _t(lens)},
                                   tstore.cache, torch.zeros(2, dtype=torch.int32),
                                   last_only=True)
    wants, gots = [np.asarray(want)], [got.numpy()]
    jstore.cache, tstore.cache = jcache, tcache
    cur = lens.copy()
    for i in range(8):
        for slot in range(2):
            assert jstore.ensure_append(slot, int(cur[slot]))
            assert tstore.ensure_append(slot, int(cur[slot]))
        tok = toks[:, 13 + i:14 + i]
        want, jstore.cache = step(jp, jnp.asarray(tok), jstore.cache)
        got, tstore.cache = tm.decode_step(tp, _t(tok), tstore.cache)
        wants.append(np.asarray(want))
        gots.append(got.numpy())
        cur += 1
    np.testing.assert_array_equal(tstore.cache.page_table.numpy(),
                                  np.asarray(jstore.cache.page_table))
    np.testing.assert_array_equal(tstore.cache.lens.numpy(),
                                  np.asarray(jstore.cache.lens))
    assert tstore.cache.lens.tolist() == (lens + 8).tolist()
    want, got = np.concatenate(wants, 1), np.concatenate(gots, 1)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < tol, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    tstore.verify()


def test_paged_decode_equals_linear_decode(models):
    """One page per tile on both layouts: the paged decode step gives the
    linear step's logits bit for bit, and the pool holds the linear
    cache's rows."""
    _, _, tm, tp, _ = models
    tm = dataclasses.replace(tm, block_kv=8)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, (2, 10)).astype(np.int32))
    lg, lin = tm.prefill(tp, {"tokens": toks}, max_len=32)
    store = kvc.PagedCache(tm, max_batch=2, max_len=32, page_size=8)
    for slot in range(2):
        assert store.reserve(slot, 10)
        store.splice(slot, lin, slot, 10)
    tok = lg[:, -1:].argmax(-1).to(torch.int32)
    paged = store.cache
    for n in range(10, 13):
        for slot in range(2):
            assert store.ensure_append(slot, n)
        dl, lin = tm.decode_step(tp, tok, lin)
        dp, paged = tm.decode_step(tp, tok, paged)
        assert torch.equal(dl, dp)
        tok = dl[:, -1:].argmax(-1).to(torch.int32)
    assert torch.equal(lin["len"], paged.lens)
    pt = paged.page_table.long().clamp_min(0)
    for key in kvc.SEQ_KEYS:
        pool = getattr(paged, key)
        if pool is None:
            continue
        g = pool[:, pt].reshape(pool.shape[0], 2, -1, *pool.shape[3:])
        assert torch.equal(g[:, :, :13], lin[key][:, :, :13])
