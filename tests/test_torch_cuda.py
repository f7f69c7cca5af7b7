"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  Shapes are
small and ragged on purpose (M not a tile multiple, N not a multiple of
64, K tails, G = 5 query heads per KV head, D = 32, 72 and 128, pages of
8, 16, 24 and 64 so a 32-position tile spans pages or a page spans tiles) — the
full-width shapes run in ``chip_smoke.py``.  A paged kernel must equal its
linear kernel bit for bit on the same contents.

Tolerances: w4a8_matmul has an exact integer dot and the plain version's
float32 epilogue in the same order, so it must equal the plain version bit
for bit (``torch.equal``) in both bodies, and its rows are the same at every
M; dequant_matmul and the attention kernels sum in
another order than the plain version: 1e-5 of the output's magnitude, and
each pins its own order: a one-token prefill chunk equals decode, a chunk
split in two equals the whole, and dequant_matmul's rows are the same at
every M, all bit for bit.
int8_matmul, w8a8_matmul and quantize_pack must equal their plain versions
bit for bit (``torch.equal``): an exact integer dot with the same float32
epilogue, and the same IEEE quotients and roundings.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.packing import pack
from repro_torch.kernels import ops
from repro_torch.kernels.dequant_matmul import (dequant_matmul,
                                                dequant_matmul_plain)
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_paged,
                                              flash_decode_paged_plain,
                                              flash_decode_plain)
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               flash_prefill_paged,
                                               flash_prefill_paged_plain,
                                               flash_prefill_plain)
from repro_torch.core.qtensor import QTensor
from repro_torch.kernels.int8_matmul import (int8_body, int8_matmul,
                                             int8_matmul_plain,
                                             quant_matmul_plain,
                                             w4a8_matmul, w8a8_body,
                                             w8a8_dynamic_plain, w8a8_matmul)
from repro_torch.kernels.quantize_pack import (kv4_quantize, quantize_pack,
                                               quantize_pack_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(got, want):
    torch.cuda.synchronize()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1.0)).item()


def _weight(rng, k, n, bits, g, dev):
    codes = torch.from_numpy(rng.integers(0, 2 ** bits, (k, n)).astype(np.uint8))
    gs = g or k
    scale = torch.from_numpy((rng.random((k // gs, n)) * 0.02 + 1e-3
                              ).astype(np.float32))
    zp = torch.from_numpy(rng.integers(0, 2 ** bits, (k // gs, n)
                                       ).astype(np.float32))
    return pack(codes, bits).to(dev), scale.to(dev), zp.to(dev)


SHAPES = [(1, 128, 64, 4, 32), (37, 384, 200, 2, 64), (70, 1024, 130, 8, 0),
          (4, 520, 96, 4, 8)]


@pytest.mark.parametrize("m,k,n,bits,g", SHAPES)
def test_dequant_matmul_kernel(dev, m, k, n, bits, g):
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev)
    w = _weight(rng, k, n, bits, g, dev)
    got = dequant_matmul(x, *w, bits=bits, group_size=g)
    want = dequant_matmul_plain(x, *w, bits=bits, group_size=g)
    assert _err(got, want) < 1e-5


# K not a multiple of the kernel's 512-row split, N not a multiple of 4;
# g8 / g32 / g128 and per-channel (g0)
SPLIT_SHAPES = [(640, 130, 32), (1152, 45, 128), (1000, 70, 0), (520, 97, 8)]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n,g", SPLIT_SHAPES)
def test_dequant_matmul_rows_equal_across_m(dev, bits, k, n, g):
    """A row of y is the same bit for bit at every M and in both bodies
    (decode M <= 8, tile M > 8): the first rows of an M = 70 product equal
    the same rows run at M = 1, 4 and 8."""
    rng = np.random.default_rng(bits + k + n + g)
    x = torch.from_numpy(rng.standard_normal((70, k)).astype(np.float32)).to(dev)
    w = _weight(rng, k, n, bits, g, dev)
    full = dequant_matmul(x, *w, bits=bits, group_size=g)
    assert _err(full, dequant_matmul_plain(x, *w, bits=bits, group_size=g)) < 1e-5
    for m in (1, 4, 8):
        assert torch.equal(dequant_matmul(x[:m], *w, bits=bits, group_size=g),
                           full[:m])


def test_dequant_matmul_nan_row_stays_in_its_row(dev):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((12, 640)).astype(np.float32)).to(dev)
    x[3, 600] = float("nan")
    w = _weight(rng, 640, 40, 4, 32, dev)
    for rows in (slice(0, 5), slice(0, 12)):          # decode and tile bodies
        y = dequant_matmul(x[rows].contiguous(), *w, bits=4, group_size=32)
        assert torch.isnan(y[3]).all()
        assert torch.isfinite(y[[0, 1, 2, 4]]).all()


# Every route of both bodies: decode M 1..8 (its 1/2/4/8-row variants) and
# the tensor-core tile past 8; K with many groups (the decode grid's group
# runs, 2816 = 22 groups of 128) and one K-wide group (g 0, walked in
# chunks); groups of 8 and 24 (an MMA step meets several groups; 2-bit
# quads straddle two groups); K tails inside a 32-deep step; N not a
# multiple of 16 or 64 (byte loads).
W4A8_SHAPES = SHAPES + [
    (8, 2816, 200, 4, 128), (9, 2816, 136, 4, 128), (4, 2816, 96, 2, 32),
    (70, 520, 96, 4, 8), (5, 1024, 72, 2, 8), (70, 384, 72, 2, 24),
    (4, 768, 130, 2, 24), (2, 4096, 64, 4, 0), (70, 640, 80, 8, 32),
    (3, 640, 80, 8, 32), (1, 1000, 144, 8, 0), (9, 1000, 40, 2, 0)]


@pytest.mark.parametrize("a_bits", [4, 8])
@pytest.mark.parametrize("m,k,n,bits,g", W4A8_SHAPES)
def test_w4a8_matmul_kernel(dev, m, k, n, bits, g, a_bits):
    rng = np.random.default_rng(m + k + a_bits)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev)
    w = _weight(rng, k, n, bits, g, dev)
    got = w4a8_matmul(x, *w, bits=bits, group_size=g, a_bits=a_bits)
    want = quant_matmul_plain(x, *w, bits=bits, group_size=g, a_bits=a_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n,g", SPLIT_SHAPES)
def test_w4a8_matmul_rows_equal_across_m(dev, bits, k, n, g):
    """A row of y is the same bit for bit at every M and in both bodies
    (decode M <= 8, tile M > 8): the first rows of an M = 70 product equal
    the same rows run at M = 1, 4 and 8."""
    rng = np.random.default_rng(bits + k + n + g + 1)
    x = torch.from_numpy(rng.standard_normal((70, k)).astype(np.float32)).to(dev)
    w = _weight(rng, k, n, bits, g, dev)
    full = w4a8_matmul(x, *w, bits=bits, group_size=g, a_bits=4)
    assert torch.equal(full, quant_matmul_plain(x, *w, bits=bits,
                                                group_size=g, a_bits=4))
    for m in (1, 4, 8):
        assert torch.equal(w4a8_matmul(x[:m], *w, bits=bits, group_size=g,
                                       a_bits=4), full[:m])


def test_w4a8_matmul_nan_row_stays_in_its_row(dev):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((12, 256)).astype(np.float32)).to(dev)
    x[2, 17] = float("nan")
    w = _weight(rng, 256, 64, 4, 64, dev)
    for rows in (slice(0, 5), slice(0, 12)):          # decode and tile bodies
        y = w4a8_matmul(x[rows].contiguous(), *w, bits=4, group_size=64,
                        a_bits=4)
        assert torch.isnan(y[2]).all()
        assert torch.isfinite(y[[0, 1, 3, 4]]).all()


# (M, K, N): decode-shaped (M <= 8) and tile-shaped M, ragged in all three
# (K not a multiple of 16 or 4, N not a multiple of 64 or 4; these take the
# masked bodies), then shapes the TMA bodies take (K and N multiples of 16):
# M not a multiple of the 128-row tile, a K tail past the 128-deep slabs
# (1040), N below one tile, and a grid of more tiles than the card has SMs
# (520 x 8192)
INT8_SHAPES = [(1, 128, 64), (5, 200, 130), (8, 1000, 96), (9, 256, 128),
               (37, 384, 200), (70, 130, 45), (130, 520, 258),
               (4, 1040, 272), (3, 4096, 160), (9, 160, 48),
               (200, 1040, 272), (129, 384, 400), (520, 256, 8192)]


def _int8_body_expected(m, k, n):
    if m <= 8:
        return "decode"
    return "wgmma" if k > 0 and k % 16 == 0 and n % 16 == 0 else "mma_sync"


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_matmul_kernel(dev, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x_q = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(dev)
    x_scale = torch.from_numpy((rng.random((m, 1)) * 0.05 + 0.01).astype(np.float32)).to(dev)
    w_q = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(dev)
    w_scale = torch.from_numpy((rng.random(n) * 0.05 + 0.01).astype(np.float32)).to(dev)
    got = int8_matmul(x_q, x_scale, w_q, w_scale)
    assert torch.equal(got, int8_matmul_plain(x_q, x_scale, w_q, w_scale))


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_body_by_shape(dev, m, k, n):
    x_q = torch.zeros((m, k), dtype=torch.int8, device=dev)
    w_q = torch.zeros((k, n), dtype=torch.int8, device=dev)
    assert int8_body(x_q, w_q) == _int8_body_expected(m, k, n)
    assert w8a8_body(x_q.float(), w_q) == _int8_body_expected(m, k, n)
    # a 16-byte misaligned x_q leaves TMA for the masked tile body
    if m > 8:
        x_off = torch.zeros(m * k + 4, dtype=torch.int8, device=dev)[4:]
        assert int8_body(x_off.view(m, k), w_q) == "mma_sync"


@pytest.mark.parametrize("m", [4, 16])
def test_int8_matmul_empty_k(dev, m):
    """K = 0: y is zeros in the decode body and, at M > 8, in the masked
    body (TMA takes no empty dimension).  w8a8 has no plain version here:
    a row of no values has no scale."""
    x_q = torch.zeros((m, 0), dtype=torch.int8, device=dev)
    w_q = torch.zeros((0, 32), dtype=torch.int8, device=dev)
    x_scale = torch.ones((m, 1), device=dev)
    w_scale = torch.ones(32, device=dev)
    assert int8_body(x_q, w_q) == _int8_body_expected(m, 0, 32)
    got = int8_matmul(x_q, x_scale, w_q, w_scale)
    assert torch.equal(got, int8_matmul_plain(x_q, x_scale, w_q, w_scale))


@pytest.mark.parametrize("m", [4, 16])
def test_int8_matmul_worst_case_accumulator(dev, m):
    """All codes -128 at K = 11008: acc = 128 * 128 * 11008 = 180,355,072,
    inside int32, in the decode (M = 4) and wgmma (M = 16) bodies."""
    k, n = 11008, 64
    x_q = torch.full((m, k), -128, dtype=torch.int8, device=dev)
    w_q = torch.full((k, n), -128, dtype=torch.int8, device=dev)
    x_scale = torch.full((m, 1), 0.5, device=dev)
    w_scale = torch.full((n,), 0.25, device=dev)
    got = int8_matmul(x_q, x_scale, w_q, w_scale)
    assert torch.equal(got, int8_matmul_plain(x_q, x_scale, w_q, w_scale))
    assert got[0, 0].item() == float(np.float32(180355072)) * 0.5 * 0.25


@pytest.mark.parametrize("k,n", [(1040, 272), (4096, 384), (1000, 130)])
def test_int8_rows_equal_across_m(dev, k, n):
    """Rows at M = 4 (decode body) equal the same rows at M = 512 (wgmma
    body, or the masked mma_sync body at the ragged shape), both entries."""
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.standard_normal((512, k)).astype(np.float32)).to(dev)
    x_q = torch.from_numpy(rng.integers(-128, 128, (512, k)).astype(np.int8)).to(dev)
    x_scale = torch.from_numpy((rng.random((512, 1)) * 0.05 + 0.01).astype(np.float32)).to(dev)
    w_q = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(dev)
    w_scale = torch.from_numpy((rng.random(n) * 0.05 + 0.01).astype(np.float32)).to(dev)
    whole = int8_matmul(x_q, x_scale, w_q, w_scale)
    assert torch.equal(int8_matmul(x_q[:4], x_scale[:4], w_q, w_scale),
                       whole[:4])
    assert torch.equal(whole, int8_matmul_plain(x_q, x_scale, w_q, w_scale))
    whole = w8a8_matmul(x, w_q, w_scale)
    assert torch.equal(w8a8_matmul(x[:4].contiguous(), w_q, w_scale),
                       whole[:4])


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_w8a8_matmul_kernel(dev, m, k, n):
    rng = np.random.default_rng(1 + m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev)
    x[m // 2] = 0.0                                   # the 1e-8 clamp
    w_q = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(dev)
    w_scale = torch.from_numpy((rng.random(n) * 0.05 + 0.01).astype(np.float32)).to(dev)
    got = w8a8_matmul(x, w_q, w_scale)
    assert torch.equal(got, w8a8_dynamic_plain(x, w_q, w_scale))
    assert torch.equal(ops.w8a8_matmul(x.reshape(1, m, k), w_q, w_scale),
                       got.reshape(1, m, n))


def test_w8a8_matmul_nan_row_stays_in_its_row(dev):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((12, 256)).astype(np.float32)).to(dev)
    x[3, 100] = float("nan")
    for n in (40, 48):              # the mma_sync and wgmma tile bodies
        w_q = torch.from_numpy(rng.integers(-128, 128, (256, n)).astype(np.int8)).to(dev)
        w_scale = torch.ones(n, device=dev)
        for rows in (slice(0, 5), slice(0, 12)):      # decode and tile bodies
            y = w8a8_matmul(x[rows].contiguous(), w_q, w_scale)
            assert torch.isnan(y[3]).all()
            assert torch.isfinite(y[[0, 1, 2, 4]]).all()


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n,g", [(256, 100, 32), (512, 130, 0), (128, 64, 8),
                                   (1024, 96, 128)])
def test_quantize_pack_kernel(dev, bits, k, n, g):
    rng = np.random.default_rng(bits + k + n + g)
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.05).astype(np.float32)).to(dev)
    got = quantize_pack(w, bits=bits, group_size=g)
    want = quantize_pack_plain(w, bits, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ops_bits3_on_the_card_takes_the_plain_route(dev):
    """3-bit weights never reach a kernel: ops packs and multiplies them with
    the plain versions on CUDA tensors too, as the reference sends them to
    its ref math."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy((rng.standard_normal((128, 40)) * 0.05).astype(np.float32)).to(dev)
    packed, scale, zp = ops.quantize_pack(w, bits=3, group_size=0)
    for a, b in zip((packed, scale, zp), quantize_pack_plain(w, 3, 0)):
        assert torch.equal(a, b)
    qt = QTensor(packed, scale, zp, 3, 128)
    x = torch.from_numpy(rng.standard_normal((5, 128)).astype(np.float32)).to(dev)
    assert torch.equal(ops.dequant_matmul(x, qt),
                       dequant_matmul_plain(x, packed, scale, zp, bits=3,
                                            group_size=128))
    assert torch.equal(ops.quant_matmul(x, qt, a_bits=8),
                       quant_matmul_plain(x, packed, scale, zp, bits=3,
                                          group_size=128, a_bits=8))


def _cache(rng, b, s, hkv, d, kv8, dev):
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    if not kv8:
        return tuple(t.to(dev) for t in (f(b, s, hkv, d), f(b, s, hkv, d)))
    c = lambda: torch.from_numpy(rng.integers(-128, 128, (b, s, hkv, d)
                                              ).astype(np.int8))
    sc = lambda: torch.from_numpy((rng.random((b, s, hkv)) * 0.05 + 0.01
                                   ).astype(np.float32))
    return tuple(t.to(dev) for t in (c(), c(), sc(), sc()))


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("g,d", [(1, 128), (4, 32), (5, 64)])
def test_flash_decode_kernel(dev, g, d, kv8):
    rng = np.random.default_rng(g + d)
    b, s, hkv = 3, 128, 2
    q = torch.from_numpy(rng.standard_normal((b, hkv, g, d)).astype(np.float32)).to(dev)
    kv = _cache(rng, b, s, hkv, d, kv8, dev)
    cur = torch.tensor([0, 1, 77], dtype=torch.int32, device=dev)
    got = flash_decode(q, kv[0], kv[1], cur, *kv[2:])
    want = flash_decode_plain(q, kv[0], kv[1], cur, *kv[2:], block_kv=32)
    assert _err(got, want) < 1e-5
    assert not got[0].any()


def test_flash_decode_kernel_ignores_poisoned_stale_slot(dev):
    """A NaN past cur_len never enters p @ v in the kernel."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 2, 1, 64)).astype(np.float32)).to(dev)
    kv = _cache(rng, 2, 64, 2, 64, True, dev)
    kv[3][:, 40] = float("nan")
    cur = torch.tensor([40, 12], dtype=torch.int32, device=dev)
    assert torch.isfinite(flash_decode(q, kv[0], kv[1], cur, *kv[2:])).all()


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("offs,cls", [((0, 50), (20, 0)), ((3, 100), (13, 7))])
def test_flash_prefill_kernel(dev, offs, cls, g, kv8):
    rng = np.random.default_rng(sum(offs) + g)
    b, s, hkv, c, d = 2, 128, 2, 20, 128
    q = torch.from_numpy(rng.standard_normal((b, hkv, c, g, d)).astype(np.float32)).to(dev)
    kv = _cache(rng, b, s, hkv, d, kv8, dev)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    cl = torch.tensor(cls, dtype=torch.int32, device=dev)
    got = flash_prefill(q, kv[0], kv[1], off, cl, *kv[2:])
    want = flash_prefill_plain(q, kv[0], kv[1], off, cl, *kv[2:], block_kv=32)
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_one_token_prefill_kernel_equals_decode_kernel(dev, kv_bits):
    rng = np.random.default_rng(2)
    b, s, hkv, g, d = 3, 128, 2, 4, 128
    q = torch.from_numpy(rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)).to(dev)
    kv = _entries(rng, (b, s), hkv, d, kv_bits, dev)
    cur = torch.tensor([1, 70, 128], dtype=torch.int32, device=dev)
    dec = ops.flash_decode(q, kv, cur)
    pre = ops.flash_prefill(q, kv, cur - 1, torch.ones_like(cur))
    assert torch.equal(dec, pre)


@pytest.mark.parametrize("abits,kvbits,tol", [(4, 8, 5e-3), (16, 16, 1e-4)])
def test_quantized_model_kernels_match_plain(dev, abits, kvbits, tol):
    """Teacher-forced prefill + 4 decode steps, kernels vs plain versions.
    At a4 an ulp-level difference in an attention output can move one
    activation code by one step, so the a4 tolerance is looser."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.launch.serve import random_packed_lm
    from repro_torch.serve.quantized import QuantizedModel
    cfg = get_config("llama-micro")
    qcfg = QuantConfig(w_bits=4, a_bits=abits, group_size=32, kv_bits=kvbits)
    params = random_packed_lm(cfg, qcfg, 0, dev)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 28)).astype(np.int32))
    out = {}
    for mode in ("auto", "plain"):
        m = QuantizedModel(cfg, qcfg, mode=mode, device=dev)
        lg, cache = m.prefill(params, {"tokens": toks[:, :24]}, max_len=64)
        seq = [lg]
        for i in range(24, 28):
            lg, cache = m.decode_step(params, toks[:, i:i + 1], cache)
            seq.append(lg)
        out[mode] = torch.cat(seq, 1)
    assert _err(out["auto"], out["plain"]) < tol


# ---- kv4 and the paged kernels ------------------------------------------

def _entries(rng, lead, hkv, d, kv_bits, dev):
    """(k, v, k_scale, v_scale) cache rows ``lead`` on the card: float32,
    random int8 codes with float32 scales, or kv4-quantized values."""
    f = lambda: torch.from_numpy(
        rng.standard_normal(lead + (hkv, d)).astype(np.float32))
    if kv_bits == 16:
        return f().to(dev), f().to(dev), None, None
    if kv_bits == 8:
        return tuple(t.to(dev) for t in _cache(rng, lead[0], lead[1], hkv, d,
                                                True, "cpu"))
    (k, ks), (v, vs) = kv4_quantize(f()), kv4_quantize(f())
    return k.to(dev), v.to(dev), ks.to(dev), vs.to(dev)


def _paged_case(rng, lens, hkv, d, ps, kv_bits, max_pages, dev):
    """Pools with spare pages and a shuffled page table (-1 past each
    row's pages), plus the linear cache the table spells out."""
    need = [-(-n // ps) for n in lens]
    num_pages = sum(need) + 2
    perm = rng.permutation(num_pages)
    pt = np.full((len(lens), max_pages), -1, np.int32)
    used = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[used:used + n]
        used += n
    pools = _entries(rng, (num_pages, ps), hkv, d, kv_bits, dev)
    pt = torch.from_numpy(pt).to(dev)
    idx = pt.long().clamp_min(0)
    lin = tuple(None if e is None else
                e[idx].reshape(len(lens), -1, *e.shape[2:]).contiguous()
                for e in pools)
    return pools, pt, lin


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_decode_paged_kernel(dev, kv_bits, ps, g):
    """Ragged lengths (0, 1, a page boundary, a mid-page tail) over a
    shuffled table: within 1e-5 of the paged plain version and equal bit
    for bit to the linear kernel on the same contents."""
    rng = np.random.default_rng(kv_bits + ps + g)
    hkv, d = 2, 64
    lens = [0, 1, ps, 2 * ps + 7]
    pools, pt, lin = _paged_case(rng, lens, hkv, d, ps, kv_bits, 4, dev)
    q = torch.from_numpy(rng.standard_normal((4, hkv, g, d)).astype(
        np.float32)).to(dev)
    cur = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = flash_decode_paged(q, pools[0], pools[1], pt, cur, *pools[2:])
    want = flash_decode_paged_plain(q, pools[0], pools[1], pt, cur,
                                    *pools[2:])
    assert _err(got, want) < 1e-5
    assert not got[0].any()
    assert torch.equal(got, flash_decode(q, lin[0], lin[1], cur, *lin[2:]))


# Edges of the decode body: walks of up to 1024 positions (32 tiles) wrap
# its staging ring several times; lengths on and beside tile edges; G = 5
# (two row blocks per KV head); D = 72 (kv8 takes the value-by-value path,
# kv16 16-byte copies of a head row that is no multiple of 16 values);
# pages of 24, so a 32-position tile straddles a page boundary mid-tile.
EDGE_LENS = [0, 1, 31, 32, 33, 500, 1024]


@pytest.mark.parametrize("ps", [24, 64])
@pytest.mark.parametrize("g", [1, 5])
@pytest.mark.parametrize("kv_bits,d", [(16, 128), (8, 128), (4, 128),
                                       (16, 72), (8, 72)])
def test_flash_decode_long_walks_and_edges(dev, kv_bits, d, g, ps):
    """Within 1e-5 of the plain version, the paged kernel equal to the
    linear one, and a one-token prefill chunk equal to decode in both
    layouts, all bit for bit."""
    rng = np.random.default_rng(50 + kv_bits + d + g + ps)
    hkv, b = 2, len(EDGE_LENS)
    pools, pt, lin = _paged_case(rng, EDGE_LENS, hkv, d, ps, kv_bits,
                                 -(-1024 // ps), dev)
    q = torch.from_numpy(rng.standard_normal((b, hkv, g, d)).astype(
        np.float32)).to(dev)
    cur = torch.tensor(EDGE_LENS, dtype=torch.int32, device=dev)
    got = flash_decode(q, lin[0], lin[1], cur, *lin[2:])
    want = flash_decode_plain(q, lin[0], lin[1], cur, *lin[2:], block_kv=ps)
    assert _err(got, want) < 1e-5
    assert not got[0].any()
    assert torch.equal(flash_decode_paged(q, pools[0], pools[1], pt, cur,
                                          *pools[2:]), got)
    q4 = q.reshape(b, 1, hkv * g, d)
    off, one = torch.clamp(cur - 1, min=0), (cur > 0).to(torch.int32)
    for table, cache in ((None, lin), (pt, pools)):
        assert torch.equal(
            ops.flash_decode(q4, cache, cur, page_table=table),
            ops.flash_prefill(q4, cache, off, one, page_table=table))


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("g", [2, 5])
def test_flash_decode_rows_per_block(dev, kv_bits, g):
    """With enough (batch, kv-head) pairs (4 x 36) the decode kernel folds
    2 or 4 query heads into a block; each row equals the same row computed
    one row a block (a 2-head slice of the same cache), bit for bit, and
    the paged kernel equals the linear one."""
    rng = np.random.default_rng(70 + kv_bits + g)
    hkv, d, ps = 36, 128, 32
    lens = [0, 33, 100, 257]
    pools, pt, lin = _paged_case(rng, lens, hkv, d, ps, kv_bits, 9, dev)
    q = torch.from_numpy(rng.standard_normal((4, hkv, g, d)).astype(
        np.float32)).to(dev)
    cur = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = flash_decode(q, lin[0], lin[1], cur, *lin[2:])
    want = flash_decode_plain(q, lin[0], lin[1], cur, *lin[2:], block_kv=ps)
    assert _err(got, want) < 1e-5
    assert torch.equal(flash_decode_paged(q, pools[0], pools[1], pt, cur,
                                          *pools[2:]), got)
    part = [t[:, :, :2].contiguous() for t in lin]
    one_row = flash_decode(q[:, :2].contiguous(), part[0], part[1], cur,
                           *part[2:])
    assert torch.equal(one_row, got[:, :2])


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_prefill_paged_kernel(dev, kv_bits, ps, g):
    rng = np.random.default_rng(10 + kv_bits + ps + g)
    hkv, d, c = 2, 64, 20
    offs, cls = [0, ps - 3, 2 * ps, 5], [20, 9, 0, 1]
    pools, pt, lin = _paged_case(rng, [o + n for o, n in zip(offs, cls)],
                                 hkv, d, ps, kv_bits, 5, dev)
    q = torch.from_numpy(rng.standard_normal((4, hkv, c, g, d)).astype(
        np.float32)).to(dev)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    cl = torch.tensor(cls, dtype=torch.int32, device=dev)
    got = flash_prefill_paged(q, pools[0], pools[1], pt, off, cl, *pools[2:])
    want = flash_prefill_paged_plain(q, pools[0], pools[1], pt, off, cl,
                                     *pools[2:])
    assert _err(got, want) < 1e-5
    assert not got[2].any()
    assert torch.equal(got, flash_prefill(q, lin[0], lin[1], off, cl,
                                          *lin[2:]))


def _prefill_in_two(call, q, off, cl, c1):
    """The chunk as rows [0, c1) at offset ``off`` and rows [c1, C) at
    ``off + c1``, each with its share of ``chunk_len``, joined back."""
    first = call(q[:, :, :c1].contiguous(), off, torch.clamp(cl, max=c1))
    second = call(q[:, :, c1:].contiguous(), off + c1,
                  torch.clamp(cl - c1, min=0))
    return torch.cat([first, second], dim=2)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_bits", [16, 8, 4])
@pytest.mark.parametrize("g,d", [(1, 128), (4, 64)])
def test_prefill_two_chunks_equal_whole(dev, paged, kv_bits, g, d):
    """A chunk split in two (after 16, 17 or 70 tokens) equals the whole chunk
    bit for bit, linear and paged, with ragged chunk_len including 0; C*G
    spans several 64-row blocks."""
    rng = np.random.default_rng(40 + kv_bits + g + paged)
    hkv, c, ps = 2, 80, 16
    offs, cls = [0, 37, 60, 9], [80, 23, 0, 1]
    ends = [o + c for o in offs]
    pools, pt, lin = _paged_case(rng, ends, hkv, d, ps, kv_bits, 9, dev)
    q = torch.from_numpy(rng.standard_normal((4, hkv, c, g, d)).astype(
        np.float32)).to(dev)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    cl = torch.tensor(cls, dtype=torch.int32, device=dev)
    if paged:
        call = lambda qq, o, n: flash_prefill_paged(qq, pools[0], pools[1], pt,
                                                    o, n, *pools[2:])
    else:
        call = lambda qq, o, n: flash_prefill(qq, lin[0], lin[1], o, n, *lin[2:])
    whole = call(q, off, cl)
    for c1 in (16, 17, 70):
        assert torch.equal(_prefill_in_two(call, q, off, cl, c1), whole)


@pytest.mark.parametrize("g", [1, 4])
def test_kv4_linear_kernels(dev, g):
    rng = np.random.default_rng(20 + g)
    b, s, hkv, d, c = 3, 96, 2, 128, 12
    kv = _entries(rng, (b, s), hkv, d, 4, dev)
    q = torch.from_numpy(rng.standard_normal((b, hkv, g, d)).astype(
        np.float32)).to(dev)
    cur = torch.tensor([0, 33, 96], dtype=torch.int32, device=dev)
    got = flash_decode(q, kv[0], kv[1], cur, *kv[2:])
    want = flash_decode_plain(q, kv[0], kv[1], cur, *kv[2:], block_kv=32)
    assert _err(got, want) < 1e-5
    q5 = torch.from_numpy(rng.standard_normal((b, hkv, c, g, d)).astype(
        np.float32)).to(dev)
    off = torch.tensor([0, 40, 84], dtype=torch.int32, device=dev)
    cl = torch.tensor([12, 0, 7], dtype=torch.int32, device=dev)
    got = flash_prefill(q5, kv[0], kv[1], off, cl, *kv[2:])
    want = flash_prefill_plain(q5, kv[0], kv[1], off, cl, *kv[2:],
                               block_kv=32)
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_one_token_paged_prefill_equals_paged_decode(dev, kv_bits):
    rng = np.random.default_rng(30 + kv_bits)
    hkv, g, d, ps = 2, 4, 64, 16
    lens = [1, 16, 17, 40]
    pools, pt, _ = _paged_case(rng, lens, hkv, d, ps, kv_bits, 3, dev)
    q = torch.from_numpy(rng.standard_normal((4, 1, hkv * g, d)).astype(
        np.float32)).to(dev)
    cur = torch.tensor(lens, dtype=torch.int32, device=dev)
    dec = ops.flash_decode(q, pools, cur, page_table=pt)
    pre = ops.flash_prefill(q, pools, cur - 1, torch.ones_like(cur),
                            page_table=pt)
    assert torch.equal(dec, pre)


@pytest.mark.parametrize("kvbits", [8, 4])
def test_paged_engine_kernels_match_plain(dev, kvbits):
    """The paged engine with chunked admission and a pool small enough to
    preempt, through the kernels: every request completes, and the
    kernels' greedy streams equal the plain versions' on this short
    a16 trace."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.launch.serve import random_packed_lm
    from repro_torch.serve.engine import Engine, RequestStatus, ServeConfig
    from repro_torch.serve.quantized import QuantizedModel
    cfg = get_config("llama-micro")
    qcfg = QuantConfig(w_bits=4, a_bits=16, group_size=32, kv_bits=kvbits)
    params = random_packed_lm(cfg, qcfg, 0, dev)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (10, 30, 7)]
    streams = {}
    for mode in ("auto", "plain"):
        eng = Engine(QuantizedModel(cfg, qcfg, mode=mode, device=dev), params,
                     ServeConfig(max_batch=2, max_len=64, max_new=10,
                                 paged=True, page_size=8, num_pages=6,
                                 prefill_chunk=4))
        reqs = [eng.submit(p) for p in prompts]
        eng.run(max_steps=500)
        assert all(r.status is RequestStatus.COMPLETED for r in reqs)
        streams[mode] = [r.out_tokens for r in reqs]
    assert streams["auto"] == streams["plain"]


@pytest.mark.parametrize("abits,group", [(16, 0), (4, 32)])
def test_calibrate_block_step_on_the_card_equals_the_cpu(dev, abits, group):
    """AffineQuant calibration (w3a16 full sites, or w4a4 diagonal and
    headwise sites) at llama-micro width, 8 samples in batches of 4 for 2
    epochs, so four Adam steps: every epoch loss on the card is the CPU's
    within 1e-5 relative, and every learned affine and LWC leaf within 1e-4
    (the products sum in another order on the card; TF32 stays off).  With
    the learning rates halved the same run lands outside both bounds."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import (CalibConfig, _learnable,
                                              calibrate_block)
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.models.init import init_block
    cfg = get_config("llama-micro")
    qcfg = QuantConfig(w_bits=3 if abits == 16 else 4, a_bits=abits,
                       group_size=group)
    block = init_block(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 16, cfg.d_model)).astype(np.float32))
    ccfg = CalibConfig(epochs=2, alpha=0.1, batch_size=4)
    want_qp, want = calibrate_block(block, x, x, cfg, qcfg, ccfg)
    on_dev = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(dev))
              for k, v in block.items()}
    xd = x.to(dev)

    def gaps(ccfg):
        qp, got = calibrate_block(on_dev, xd, xd, cfg, qcfg, ccfg)
        assert len(got) == len(want) == 2
        loss = max(abs(g / w - 1) for g, w in zip(got, want))
        leaf = max((p.cpu() - q).abs().max().item() for (_, p), (_, q)
                   in zip(_learnable(qp), _learnable(want_qp)))
        return loss, leaf

    loss, leaf = gaps(ccfg)
    assert loss <= 1e-5 and leaf <= 1e-4, (loss, leaf)
    half = dataclasses.replace(ccfg, lr_affine=ccfg.lr_affine / 2,
                               lr_shift=ccfg.lr_shift / 2,
                               lr_lwc=ccfg.lr_lwc / 2)
    loss, leaf = gaps(half)
    assert loss > 1e-5 and leaf > 1e-4, (loss, leaf)
