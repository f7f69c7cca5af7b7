"""Port parity: the four kernels' plain PyTorch versions against the
reference's ``repro.kernels.ref`` oracles, on the same numpy inputs.

Tolerances:
* quant_matmul: the integer dot is exact in both and the float32 epilogue
  runs the same ops in the same order, so the results are equal up to a
  few float32 ulps (XLA may contract a multiply-add): rtol 1e-6 of the
  output's max magnitude.
* dequant_matmul and the attention kernels: float32 sums over K or D are
  taken in another order by XLA and by PyTorch, and exp differs by an ulp:
  2e-6 of the output's max magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack as jpack
from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.dequant_matmul import dequant_matmul_plain
from repro_torch.kernels.flash_decode import flash_decode_plain
from repro_torch.kernels.flash_prefill import flash_prefill_plain
from repro_torch.kernels.int8_matmul import quant_matmul_plain
from repro_torch.core.qtensor import QTensor


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


def _close(got, want, rel):
    want = np.asarray(want)
    err = np.max(np.abs(np.asarray(got) - want))
    assert err <= rel * max(1.0, np.max(np.abs(want))), err


def _packed_weight(rng, k, n, bits, g):
    codes = rng.integers(0, 2 ** bits, (k, n)).astype(np.uint8)
    packed = np.array(jpack(jnp.asarray(codes), bits))
    gs = g or k
    scale = (rng.random((k // gs, n)) * 0.02 + 0.001).astype(np.float32)
    zp = rng.integers(0, 2 ** bits, (k // gs, n)).astype(np.float32)
    return packed, scale, zp


@pytest.mark.parametrize("g", [0, 32])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_dequant_matmul_plain_matches_ref(bits, g):
    rng = np.random.default_rng(bits + g)
    x = rng.standard_normal((5, 128)).astype(np.float32)
    packed, scale, zp = _packed_weight(rng, 128, 48, bits, g)
    want = ref.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(packed),
                                  jnp.asarray(scale), jnp.asarray(zp),
                                  bits=bits, group_size=g)
    got = dequant_matmul_plain(T(x), T(packed), T(scale), T(zp), bits=bits,
                               group_size=g)
    _close(got, want, 2e-6)


@pytest.mark.parametrize("a_bits", [4, 8])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quant_matmul_plain_matches_ref(bits, a_bits):
    rng = np.random.default_rng(100 * bits + a_bits)
    x = rng.standard_normal((6, 128)).astype(np.float32)
    packed, scale, zp = _packed_weight(rng, 128, 40, bits, 32)
    want = ref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(packed),
                                jnp.asarray(scale), jnp.asarray(zp),
                                bits=bits, group_size=32, a_bits=a_bits)
    got = quant_matmul_plain(T(x), T(packed), T(scale), T(zp), bits=bits,
                             group_size=32, a_bits=a_bits)
    _close(got, want, 1e-6)


def _cache(rng, b, s, hkv, d, kv8):
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    if not kv8:
        return (k, v, None, None)
    ks = (rng.random((b, s, hkv)) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random((b, s, hkv)) * 0.05 + 0.01).astype(np.float32)
    kq = rng.integers(-128, 128, (b, s, hkv, d)).astype(np.int8)
    vq = rng.integers(-128, 128, (b, s, hkv, d)).astype(np.int8)
    return (kq, vq, ks, vs)


def _both(cache):
    jx = tuple(None if a is None else jnp.asarray(a) for a in cache)
    tx = tuple(None if a is None else T(a) for a in cache)
    return jx, tx


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("lens", [(64, 16), (0, 37), (5, 1)])
def test_flash_decode_plain_matches_ref(lens, g, kv8):
    """Block-multiple, ragged and zero lengths; GQA folding G in {1, 4}."""
    rng = np.random.default_rng(sum(lens) + g)
    b, s, hkv, d = 2, 64, 2, 32
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    cur = np.asarray(lens, np.int32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _both(_cache(rng, b, s, hkv, d,
                                                          kv8))
    want = ref.flash_decode_ref(jnp.asarray(q), jk, jv, jnp.asarray(cur), jks,
                                jvs, block_kv=16)
    got = flash_decode_plain(T(q), tk, tv, T(cur), tks, tvs, block_kv=16)
    _close(got, want, 2e-6)
    assert not np.asarray(got)[cur == 0].any()


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("offs,cls", [((0, 16), (16, 8)), ((3, 40), (0, 5)),
                                      ((0, 0), (7, 1))])
def test_flash_prefill_plain_matches_ref(offs, cls, g, kv8):
    """Chunks at offset 0 and mid-cache, ragged chunk_len, chunk_len 0
    (a row that visits no tile and returns zeros)."""
    rng = np.random.default_rng(sum(offs) + sum(cls) + g)
    b, s, hkv, c, d = 2, 64, 2, 16, 32
    q = rng.standard_normal((b, hkv, c, g, d)).astype(np.float32)
    off, cl = np.asarray(offs, np.int32), np.asarray(cls, np.int32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _both(_cache(rng, b, s, hkv, d,
                                                          kv8))
    want = ref.flash_prefill_ref(jnp.asarray(q), jk, jv, jnp.asarray(off),
                                 jnp.asarray(cl), jks, jvs, block_kv=16)
    got = flash_prefill_plain(T(q), tk, tv, T(off), T(cl), tks, tvs,
                              block_kv=16)
    _close(got, want, 2e-6)
    assert not got[1, :, cls[1]:].any()


@pytest.mark.parametrize("kv8", [False, True])
def test_one_token_prefill_equals_decode(kv8):
    """The resume contract: a C = 1 chunk at offset len-1 is decode."""
    rng = np.random.default_rng(7)
    b, s, hkv, g, d = 3, 64, 2, 4, 32
    q = T(rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32))
    kv = tuple(T(a) for a in _cache(rng, b, s, hkv, d, kv8) if a is not None)
    cur = torch.tensor([1, 33, 64], dtype=torch.int32)
    dec = ops.flash_decode(q, kv, cur, block_kv=16)
    pre = ops.flash_prefill(q, kv, cur - 1, torch.ones(b, dtype=torch.int32),
                            block_kv=16)
    torch.testing.assert_close(pre, dec, rtol=0, atol=1e-6)


def test_ops_dispatch_shapes_and_modes():
    rng = np.random.default_rng(3)
    packed, scale, zp = _packed_weight(rng, 64, 24, 4, 32)
    qt = QTensor(T(packed), T(scale), T(zp), 4, 32)
    x = T(rng.standard_normal((2, 3, 64)).astype(np.float32))
    for a_bits in (4, 16):
        auto = ops.quant_matmul(x, qt, a_bits=a_bits)
        plain = ops.quant_matmul(x, qt, a_bits=a_bits, mode="plain")
        assert auto.shape == (2, 3, 24)
        torch.testing.assert_close(auto, plain, rtol=0, atol=0)
        empty = ops.quant_matmul(x[:, :0], qt, a_bits=a_bits)
        assert empty.shape == (2, 0, 24) and not empty.any()
    with pytest.raises(ValueError):
        ops.quant_matmul(x, qt, a_bits=12)
    with pytest.raises(ValueError):
        ops.dequant_matmul(x, qt, mode="kernel")
