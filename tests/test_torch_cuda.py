"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  Shapes are
small and ragged on purpose (M not a tile multiple, N not a multiple of
64, K tails, G = 5 query heads per KV head, D = 32, 72, 80 and 128, pages of
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
# g8 / g32 / g128 and per-channel (g0); the narrow-N linears 2048 -> 256
# and 2048 -> 512 and the long-K 5120 -> 1280 (K cut across blocks), and
# 1024 -> 33800, whose M = 512 product has enough 128 x 128 tiles to walk
# all of K in each block
SPLIT_SHAPES = [(640, 130, 32), (1152, 45, 128), (1000, 70, 0), (520, 97, 8),
                (2048, 256, 128), (2048, 512, 32), (5120, 1280, 128),
                (4096, 4096, 8), (2048, 16384, 0), (1024, 33800, 0)]
# the row counts held against an M = 512 product: the decode body's 1 / 2-4
# / 5-8 row variants and tile bodies at 9, 64 and 70 rows
ROWS_ACROSS_M = (1, 4, 8, 9, 64, 70)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n,g", SPLIT_SHAPES)
def test_dequant_matmul_rows_equal_across_m(dev, bits, k, n, g):
    """A row of y is the same bit for bit at every M and in every body
    (decode M <= 8; the tile shapes, folding K in one block or cutting it
    across blocks): the first rows of an M = 512 product equal the same
    rows run at M = 1, 4, 8, 9, 64 and 70."""
    rng = np.random.default_rng(bits + k + n + g)
    x = torch.from_numpy(rng.standard_normal((512, k)).astype(np.float32)).to(dev)
    w = _weight(rng, k, n, bits, g, dev)
    full = dequant_matmul(x, *w, bits=bits, group_size=g)
    assert _err(full, dequant_matmul_plain(x, *w, bits=bits, group_size=g)) < 1e-5
    for m in ROWS_ACROSS_M:
        assert torch.equal(dequant_matmul(x[:m], *w, bits=bits, group_size=g),
                           full[:m]), m


def test_dequant_matmul_bodies_cover_every_tile(dev):
    """The row-equality shapes above run every body of the kernel on this
    card: decode, the tile body folding K in one block and cutting it
    across blocks, and both tile shapes."""
    from repro_torch.kernels.dequant_matmul import plan
    seen = set()
    for k, n, _ in SPLIT_SHAPES:
        for m in ROWS_ACROSS_M + (512,):
            p = plan(m, k, n)
            seen.add((p["body"], p["bm"], p["bn"]))
    assert {body for body, _, _ in seen} == {"decode", "tile", "tile_split"}
    assert {(bm, bn) for body, bm, bn in seen if body != "decode"} == {
        (128, 128), (64, 64)}, seen


@pytest.mark.parametrize("k,n,m", [(640, 40, 12), (2048, 256, 512),
                                   (2048, 16384, 512), (1024, 33800, 512)])
def test_dequant_matmul_nan_row_stays_in_its_row(dev, k, n, m):
    """A NaN in row 3 of x poisons row 3 of y only, in the decode body and
    in the tile body, K folded in one block or cut across blocks."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev)
    x[3, 600] = float("nan")
    w = _weight(rng, k, n, 4, 32, dev)
    for rows in (slice(0, 5), slice(0, m)):           # decode and tile bodies
        y = dequant_matmul(x[rows].contiguous(), *w, bits=4, group_size=32)
        assert torch.isnan(y[3]).all()
        assert torch.isfinite(y[[0, 1, 2, 4]]).all()
        if rows.stop > 5:
            assert torch.isfinite(y[5:]).all()


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


# groups of 64, 128 and 256 keep their weights in registers; the rest read
# a unit again to pack it; N % 4 != 0 takes one column a lane; N % 16 != 0
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n,g", [(256, 100, 32), (512, 130, 0), (128, 64, 8),
                                   (1024, 96, 128), (512, 72, 64),
                                   (1024, 200, 256), (384, 45, 128)])
def test_quantize_pack_kernel(dev, bits, k, n, g):
    rng = np.random.default_rng(bits + k + n + g)
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.05).astype(np.float32)).to(dev)
    got = quantize_pack(w, bits=bits, group_size=g)
    want = quantize_pack_plain(w, bits, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b,k,n,g", [(1, 2048, 768, 128), (3, 2048, 768, 128),
                                     (128, 2048, 768, 128), (3, 512, 72, 64),
                                     (3, 256, 100, 32), (3, 384, 45, 0)])
def test_quantize_pack_batched_kernel(dev, b, k, n, g):
    """A (B, K, N) stack in one launch equals B calls on its (K, N)
    matrices and the plain version, byte for byte (qwen3-moe's 128 experts
    of 2048 x 768 g128; N not a multiple of 16 or of 4)."""
    from repro_torch.kernels import _lib
    rng = np.random.default_rng(b + k + n + g)
    w = torch.from_numpy((rng.standard_normal((b, k, n)) * 0.05
                          ).astype(np.float32)).to(dev)
    _lib.reset_launches()
    got = quantize_pack(w, bits=4, group_size=g)
    assert _lib.LAUNCHES["quantize_pack"] == 1
    assert [t.shape[0] for t in got] == [b] * 3
    for i in range(b):
        one = quantize_pack(w[i], bits=4, group_size=g)
        plain = quantize_pack_plain(w[i], 4, g)
        for a, c, d in zip(got, one, plain):
            assert torch.equal(a[i], c) and torch.equal(a[i], d)


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


# The quantized vlm and audio archs' linears (hubert-xlarge 1280 -> 1280,
# 1280 -> 5120, 5120 -> 1280; paligemma-3b 2048 -> 2048, 2048 -> 256,
# 2048 -> 16384, 16384 -> 2048) at w4 g128, in both bodies of each matmul.
VLM_AUDIO_LINEARS = [(1280, 1280), (1280, 5120), (5120, 1280), (2048, 2048),
                     (2048, 256), (2048, 16384), (16384, 2048)]


@pytest.mark.parametrize("k,n", VLM_AUDIO_LINEARS)
def test_matmuls_at_vlm_audio_linear_shapes(dev, k, n):
    """w4a8_matmul equals its plain version bit for bit and dequant_matmul
    is within 1e-5 of its own, at M = 4 (decode bodies) and M = 24 (tile
    bodies); the rows at M = 4 equal the first rows at M = 24."""
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.standard_normal((24, k)).astype(np.float32)).to(dev)
    w = _weight(rng, k, n, 4, 128, dev)
    q24 = w4a8_matmul(x, *w, bits=4, group_size=128, a_bits=4)
    d24 = dequant_matmul(x, *w, bits=4, group_size=128)
    assert torch.equal(q24, quant_matmul_plain(x, *w, bits=4, group_size=128,
                                               a_bits=4))
    assert _err(d24, dequant_matmul_plain(x, *w, bits=4, group_size=128)) < 1e-5
    assert torch.equal(w4a8_matmul(x[:4], *w, bits=4, group_size=128,
                                   a_bits=4), q24[:4])
    assert torch.equal(dequant_matmul(x[:4], *w, bits=4, group_size=128),
                       d24[:4])


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_attention_kernels_at_head_dim_80(dev, kv_bits, paged):
    """hubert-xlarge's attention shape (Hkv 16, G 1, D 80: the
    value-by-value copies, no multiple of 64 or 32): decode and a 20-row
    prefill chunk within 1e-5 of the plain versions, over the linear cache
    or pages of 16 (bit for bit the linear kernels on the same
    contents)."""
    rng = np.random.default_rng(80 + kv_bits + paged)
    hkv, d, c = 16, 80, 20
    lens = [0, 1, 33, 90]
    pools, pt, lin = _paged_case(rng, lens, hkv, d, 16, kv_bits, 6, dev)
    q = torch.from_numpy(rng.standard_normal((4, hkv, 1, d)).astype(
        np.float32)).to(dev)
    cur = torch.tensor(lens, dtype=torch.int32, device=dev)
    qc = torch.from_numpy(rng.standard_normal((4, hkv, c, 1, d)).astype(
        np.float32)).to(dev)
    off = torch.clamp_min(cur - c, 0)
    cl = cur - off
    if paged:
        got = flash_decode_paged(q, pools[0], pools[1], pt, cur, *pools[2:])
        want = flash_decode_paged_plain(q, pools[0], pools[1], pt, cur,
                                        *pools[2:])
        gotc = flash_prefill_paged(qc, pools[0], pools[1], pt, off, cl,
                                   *pools[2:])
        wantc = flash_prefill_paged_plain(qc, pools[0], pools[1], pt, off,
                                          cl, *pools[2:])
        assert torch.equal(got, flash_decode(q, lin[0], lin[1], cur,
                                             *lin[2:]))
        assert torch.equal(gotc, flash_prefill(qc, lin[0], lin[1], off, cl,
                                               *lin[2:]))
    else:
        got = flash_decode(q, lin[0], lin[1], cur, *lin[2:])
        want = flash_decode_plain(q, lin[0], lin[1], cur, *lin[2:],
                                  block_kv=32)
        gotc = flash_prefill(qc, lin[0], lin[1], off, cl, *lin[2:])
        wantc = flash_prefill_plain(qc, lin[0], lin[1], off, cl, *lin[2:],
                                    block_kv=32)
    assert _err(got, want) < 1e-5 and _err(gotc, wantc) < 1e-5
    assert not got[0].any()


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


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
@pytest.mark.parametrize("ps", [8, 64])
def test_flash_prefill_paged_resumed_over_shared_pages(dev, kv_bits, ps):
    """A prefix hit: row 1 resumes a chunk at offset 2 * ps over row 0's
    first two pages.  Its output equals, bit for bit, the same chunk over
    private copies of those pages, and the shared pages' bytes stay as they
    were (attention only reads the pools)."""
    rng = np.random.default_rng(60 + kv_bits + ps)
    hkv, d, g, c = 2, 64, 4, ps + 3
    pools = _entries(rng, (8, ps), hkv, d, kv_bits, dev)
    for e in pools:
        if e is not None:
            e[5:7] = e[0:2]                     # private copies of 0 and 1
    before = [e[0:2].clone() for e in pools if e is not None]
    q = torch.from_numpy(rng.standard_normal((2, hkv, c, g, d)).astype(
        np.float32)).to(dev)
    off = torch.tensor([ps - 3, 2 * ps], dtype=torch.int32, device=dev)
    cl = torch.tensor([3, c], dtype=torch.int32, device=dev)
    outs = []
    for row1 in ([0, 1, 3, 4], [5, 6, 3, 4]):
        pt = torch.tensor([[0, 1, 2, -1], row1], dtype=torch.int32,
                          device=dev)
        outs.append(flash_prefill_paged(q, pools[0], pools[1], pt, off, cl,
                                        *pools[2:]))
        want = flash_prefill_paged_plain(q, pools[0], pools[1], pt, off, cl,
                                         *pools[2:])
        assert _err(outs[-1], want) < 1e-5
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, e[0:2]) for a, e in
               zip(before, [e for e in pools if e is not None]))


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_quarantine_zeroes_only_exclusive_pages_on_the_card(dev, kv_bits):
    """NaN quarantine over CUDA pools: the quarantined slot's refcount-1
    pages are zeroed, the pages it shares with a live reader keep their
    (poisoned) bytes, the co-reader is named and the prefix map emptied."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.serve.kv_cache import PagedCache
    from repro_torch.serve.quantized import QuantizedModel
    model = QuantizedModel(get_config("llama-micro"), QuantConfig(
        w_bits=8, a_bits=16, group_size=32, kv_bits=kv_bits), device="cuda")
    store = PagedCache(model, max_batch=3, max_len=32, page_size=8,
                       prefix_cache=True)
    toks = np.arange(19, dtype=np.int32)
    assert store.reserve(0, 20, tokens=toks)
    store.register_prefix(0, toks)
    assert store.reserve(1, 20, tokens=toks)
    assert store.cache.lens.tolist()[1] == 16
    shared = store.allocator.owned[0][:2]
    excl = [p for p in store.allocator.owned[1] if p not in shared]
    for t in (store.cache.k, store.cache.v):
        t.fill_(7)
    for t in (store.cache.k_scale, store.cache.v_scale):
        t.fill_(float("nan"))
    assert store.quarantine(1) == [0]
    c = store.cache
    for p in excl:
        assert not c.k[:, p].any() and not c.v[:, p].any()
        assert not c.k_scale[:, p].any() and not c.v_scale[:, p].any()
    for p in shared + [store.allocator.owned[0][2]]:
        assert (c.k[:, p] == 7).all() and torch.isnan(c.k_scale[:, p]).all()
    assert not store._prefix_map
    store.free(1)
    store.verify()


def test_sampler_rows_independent_of_the_batch_on_the_card(dev):
    """The per-(seed, rid, position) sampler on CUDA logits: a row draws
    the same token whatever rows share the call, a repeated call draws
    the same tokens, and every draw lies in its row's top-k support."""
    from repro_torch.serve.engine import row_seed, sample, sampling_logits
    rng = np.random.default_rng(7)
    lg = torch.from_numpy(rng.standard_normal((6, 32000)).astype(
        np.float32) * 4).to(dev)
    seeds = [row_seed(0, rid, 3) for rid in range(6)]
    full = sample(lg, 0.8, 40, seeds)
    assert torch.equal(full, sample(lg, 0.8, 40, seeds))
    assert torch.equal(sample(lg[[4, 1]], 0.8, 40, [seeds[4], seeds[1]]),
                       full[[4, 1]])
    support = torch.isfinite(sampling_logits(lg, 0.8, 40))
    assert support[torch.arange(6, device=dev), full].all()
    many = torch.stack([sample(lg[:1], 0.8, 40, [row_seed(0, 0, n)])
                        for n in range(64)])
    assert len(set(many.flatten().tolist())) > 1


def test_rmsnorm_rows_equal_at_every_row_count(dev):
    """A row normalised inside a 20-row prefill chunk equals, bit for bit,
    the same row normalised alone (a decode step): at a4 one bit of the
    norm can move an activation code, and a preempted request resumes
    through a chunk where it had decoded.  A float32 mean on the card
    differed in 15 of these 80 rows."""
    from repro_torch.models import layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4, 20, 4096, device=dev, generator=gen) * 3
    p = {"scale": torch.rand(4096, device=dev, generator=gen) + 0.5}
    whole = layers.apply_norm(p, x, "rmsnorm")
    rows = torch.cat([layers.apply_norm(p, x[:, i:i + 1], "rmsnorm")
                      for i in range(20)], dim=1)
    assert torch.equal(whole, rows)


def test_layernorm_rows_equal_at_every_row_count(dev):
    """OPT's LayerNorm keeps the same contract as the RMSNorm above: a row
    normalised inside a 20-row chunk equals the row alone, bit for bit
    (mean and variance accumulate in float64), at opt-125m's width; and
    so do the sinusoidal positions of a chunk and of single positions."""
    from repro_torch.models import layers, transformer
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(4, 20, 768, device=dev, generator=gen) * 3 + 0.5
    p = {"scale": torch.rand(768, device=dev, generator=gen) + 0.5,
         "bias": torch.randn(768, device=dev, generator=gen) * 0.1}
    whole = layers.apply_norm(p, x, "layernorm")
    rows = torch.cat([layers.apply_norm(p, x[:, i:i + 1], "layernorm")
                      for i in range(20)], dim=1)
    assert torch.equal(whole, rows)
    pos = torch.arange(300, 512, device=dev)
    table = transformer.sinusoidal_at(pos, 768)
    alone = torch.cat([transformer.sinusoidal_at(pos[i:i + 1], 768)
                       for i in range(0, 212, 7)])
    assert torch.equal(table[::7], alone)
    assert torch.equal(table.cpu(),
                       transformer.sinusoidal_at(pos.cpu(), 768))


@pytest.mark.parametrize("arch", ["opt-micro", "llama-micro"])
def test_quantize_layers_through_the_kernel(dev, arch):
    """RTN packing of a (stacked) float layer tree on the card runs the
    quantize_pack kernel, one launch per stacked leaf (all its layers), and
    gives ``quantize_codes``' bytes (packed codes, scales, zero points)."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantizer import QuantConfig, quantize_codes
    from repro_torch.kernels import _lib
    from repro_torch.models.init import init_lm
    from repro_torch.serve.quantized import (PACKED_MLP, PACKED_WEIGHTS,
                                             quantize_layers)
    cfg = get_config(arch)
    lp = init_lm(cfg, torch.Generator(device="cuda").manual_seed(2),
                 dev)["layers"]
    for qcfg in (QuantConfig(w_bits=4, group_size=32),
                 QuantConfig(w_bits=2, group_size=0)):
        _lib.reset_launches()
        got = quantize_layers(lp, qcfg)
        torch.cuda.synchronize()
        names = [(got[k], lp[k]) for k in PACKED_WEIGHTS]
        names += [(got["mlp"][k], lp["mlp"][k]) for k in PACKED_MLP
                  if k in lp["mlp"]]
        assert _lib.LAUNCHES["quantize_pack"] == len(names)
        for qt, w in names:
            want = quantize_codes(w, qcfg)
            assert (qt.bits, qt.group_size) == (want.bits, want.group_size)
            for f in ("packed", "scale", "zp"):
                assert torch.equal(getattr(qt, f), getattr(want, f)), f
        assert torch.equal(got["ln_attn"]["scale"], lp["ln_attn"]["scale"])


# ---- the dense registry's attention shapes; the float model -----------------

@pytest.mark.parametrize("kv_bits", [16, 8, 4])
@pytest.mark.parametrize("d,g,hkv", [(128, 3, 2), (128, 5, 2), (160, 4, 2),
                                     (256, 8, 1)])
def test_attention_kernels_at_dense_arch_shapes(dev, d, g, hkv, kv_bits):
    """phi4-mini (G 3), qwen2.5 (G 5), stablelm (D 160: the value-by-value
    copies at D % 64 != 0) and gemma (MQA G 8, D 256: the largest shared
    memory request): decode and prefill against their plain versions, and
    the paged kernels bit for bit against the linear ones."""
    rng = np.random.default_rng(d + g + kv_bits)
    ps, lens = 16, [0, 21, 37, 64]
    pools, pt, lin = _paged_case(rng, lens, hkv, d, ps, kv_bits, 4, dev)
    q = torch.from_numpy(rng.standard_normal((4, hkv, g, d)).astype(
        np.float32)).to(dev)
    cur = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = flash_decode(q, lin[0], lin[1], cur, *lin[2:])
    want = flash_decode_plain(q, lin[0], lin[1], cur, *lin[2:], block_kv=32)
    assert _err(got, want) < 1e-5
    assert torch.equal(flash_decode_paged(q, pools[0], pools[1], pt, cur,
                                          *pools[2:]), got)
    offs, cls = [0, 1, 30, 40], [0, 20, 7, 20]
    c = 20
    qc = torch.from_numpy(rng.standard_normal((4, hkv, c, g, d)).astype(
        np.float32)).to(dev)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    cl = torch.tensor(cls, dtype=torch.int32, device=dev)
    got = flash_prefill(qc, lin[0], lin[1], off, cl, *lin[2:])
    want = flash_prefill_plain(qc, lin[0], lin[1], off, cl, *lin[2:],
                               block_kv=32)
    assert _err(got, want) < 1e-5
    assert torch.equal(flash_prefill_paged(qc, pools[0], pools[1], pt, off,
                                           cl, *pools[2:]), got)


@pytest.mark.parametrize("arch", ["llama-micro", "opt-micro"])
def test_float_model_kernels_match_plain(dev, arch):
    """The float Model on the card: teacher-forced prefill + 4 decode steps
    through the kv16 kernels against the plain versions (float linears are
    ``torch.matmul`` in both), within 1e-5; linear and paged decode give
    the same greedy stream through the Engine."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import teacher_forced
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = get_config(arch)
    params = Model(cfg, dev).init(0)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 28)).astype(np.int32))
    out = {mode: teacher_forced(Model(cfg, dev, mode), params, toks[:, :24],
                                toks[:, 24:], 4, 64)
           for mode in ("auto", "plain")}
    assert _err(out["auto"], out["plain"]) < 1e-5
    streams = []
    for paged in (False, True):
        eng = Engine(Model(cfg, dev), params, ServeConfig(
            max_batch=2, max_len=64, max_new=8, paged=paged, page_size=16))
        reqs = [eng.submit(t.numpy()) for t in toks[:, :24]]
        eng.run()
        streams.append([r.out_tokens for r in reqs])
    assert streams[0] == streams[1]


def _leaves_within(got: dict, want: dict, rel: float, skip=()) -> None:
    """Each checkpoint leaf of ``got`` within ``rel`` of the largest
    magnitude of the same leaf of ``want``."""
    assert sorted(got) == sorted(want)
    for k, (w, _) in want.items():
        if k in skip:
            continue
        g = got[k][0].astype(np.float64)
        w = w.astype(np.float64)
        err = np.abs(g - w).max()
        assert err <= rel * np.abs(w).max(), (k, err, np.abs(w).max())


@pytest.mark.parametrize("arch", ["llama-micro", "opt-micro"])
def test_train_step_on_the_card_equals_the_cpu(dev, arch, monkeypatch):
    """One train step (the first: lr_scale 0, so the params stay and the
    moments carry the gradients) on the card and on the CPU from the same
    params and tokens: loss within 1e-5 relative, every leaf within 1e-5
    of its largest magnitude.  OPT's key bias has a zero gradient in exact
    arithmetic and holds rounding noise on both devices: held to 1e-6 of
    the largest moment of its tree instead.  OPT's ReLU has a kink: a
    pre-activation within a rounding step of zero can take the other side
    on the other device (one of opt-micro's 131,072 did, at 3.7e-8, and
    moved a column of w_up's gradient by 3.6e-2 of the leaf), so the CPU
    step takes the card's ReLU masks, and every pre-activation whose sign
    differs must lie within 1e-6 of its layer's largest."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovCorpus
    from repro_torch.models import layers
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamConfig, adam_init
    from repro_torch.train import checkpoints
    from repro_torch.train.step import TrainState, make_train_step
    from repro_torch.utils import tree_map
    masks, seen = [], []

    class _Relu:
        """F with a ReLU that records its masks (the card's run) or applies
        them in order (the CPU's run), recording its inputs in both."""
        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def relu(x):
            seen.append(x.detach().cpu())
            if not cpu_run:
                masks.append(seen[-1] > 0)
                return F.relu(x)
            return x * masks[len(seen) - len(masks) - 1].to(x.device, x.dtype)

    monkeypatch.setattr(layers, "F", _Relu())
    cfg = get_config(arch)
    params = build_model(cfg, "cpu").init(0)
    adam = AdamConfig(lr=3e-3)
    tokens = torch.from_numpy(MarkovCorpus(cfg.vocab_size, branching=4,
                                           buckets=128, seed=0)
                              .sample(8, 32, seed=1))
    out, cpu_run = [], False
    for i, device in enumerate((dev, "cpu")):
        cpu_run = i == 1
        p = tree_map(lambda t: t.to(device), params)
        state = TrainState(p, adam_init(p, adam),
                           torch.zeros((), dtype=torch.int32, device=device))
        new, m = make_train_step(build_model(cfg, device), adam, 10, 2)(
            state, {"tokens": tokens.to(device)})
        out.append((checkpoints.flatten(new), float(m["loss"])))
    (card, lg), (cpu, lc) = out
    n = len(masks)
    assert n == (cfg.num_layers if cfg.act == "relu" else 0)
    for mask, z in zip(masks, seen[n:]):
        flipped = mask != (z > 0)
        assert torch.all(z[flipped].abs() <= 1e-6 * z.abs().max())
    assert abs(lg - lc) <= 1e-5 * lc
    zero = [k for k in cpu if k.endswith("||bk")]
    for kind in ("||mu||", "||nu||"):
        top = max(np.abs(a).max() for k, (a, _) in cpu.items() if kind in k)
        assert all(np.abs(card[k][0]).max() <= 1e-6 * top
                   for k in zero if kind in k)
    _leaves_within(card, cpu, 1e-5, skip=zero)


def test_adam_update_on_the_card_equals_the_cpu(dev):
    """Three AdamW updates (clipping, decay on the matrix) on the card and
    on the CPU: every leaf within 1e-6 of its largest magnitude."""
    from repro_torch.optim import AdamConfig, adam_init, adam_update
    from repro_torch.train import checkpoints
    rng = np.random.default_rng(4)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    params = {"w": f32(3, 64, 96), "b": f32(96)}
    grads = [{"w": 3 * f32(3, 64, 96), "b": f32(96)} for _ in range(3)]
    cfg = AdamConfig(lr=1e-2, weight_decay=0.1)
    out = []
    for device in ("cpu", dev):
        p = {k: v.to(device) for k, v in params.items()}
        state = adam_init(p, cfg)
        for g in grads:
            p, state = adam_update(p, {k: v.to(device) for k, v in g.items()},
                                   state, cfg, 0.7)
        out.append(checkpoints.flatten({"p": p, **state}))
    assert int(out[1]["count"][0]) == 3
    _leaves_within(out[1], out[0], 1e-6)


# ---------------------------------------------------------------------------
# the MoE family: qwen3-moe-30b-a3b's narrowest linear and its attention
# shape, and the MoE layer on the card against its CPU plain path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [4, 70])
def test_w4a8_matmul_at_the_moe_kv_width(dev, m):
    """qwen3-moe's k / v projection, 2048 -> 512 (the narrowest N the
    serving path gives the kernel), bit for bit; rows equal across M."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((m, 2048)).astype(
        np.float32)).to(dev)
    w = _weight(rng, 2048, 512, 4, 128, dev)
    got = w4a8_matmul(x, *w, bits=4, group_size=128, a_bits=4)
    assert torch.equal(got, quant_matmul_plain(x, *w, bits=4, group_size=128,
                                               a_bits=4))
    assert torch.equal(w4a8_matmul(x[:4], *w, bits=4, group_size=128,
                                   a_bits=4), got[:4])


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_attention_kernels_at_the_moe_shape(dev, kv_bits):
    """Hkv 4, G 8, D 128 (qwen3-moe): decode and a ragged prefill chunk
    within 1e-5 of the plain versions, over pages of 64 bit for bit equal
    to the linear kernels on the same contents."""
    rng = np.random.default_rng(kv_bits)
    hkv, g, d, ps, c = 4, 8, 128, 64, 20
    lens = [1, 64, 150, 200]
    pools, pt, lin = _paged_case(rng, lens, hkv, d, ps, kv_bits, 4, dev)
    cur = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.standard_normal((4, hkv, g, d)).astype(
        np.float32)).to(dev)
    got = flash_decode(q, lin[0], lin[1], cur, *lin[2:])
    want = flash_decode_plain(q, lin[0], lin[1], cur, *lin[2:], block_kv=64)
    assert _err(got, want) < 1e-5
    assert torch.equal(flash_decode_paged(q, pools[0], pools[1], pt, cur,
                                          *pools[2:]), got)
    qc = torch.from_numpy(rng.standard_normal((4, hkv, c, g, d)).astype(
        np.float32)).to(dev)
    off = torch.tensor([0, 44, 130, 180], dtype=torch.int32, device=dev)
    cl = cur - off
    got = flash_prefill(qc, lin[0], lin[1], off, cl, *lin[2:])
    want = flash_prefill_plain(qc, lin[0], lin[1], off, cl, *lin[2:],
                               block_kv=64)
    assert _err(got, want) < 1e-5
    assert torch.equal(flash_prefill_paged(qc, pools[0], pools[1], pt, off,
                                           cl, *pools[2:]), got)


def test_apply_moe_on_the_card_equals_the_cpu(dev):
    """512 tokens through 16 experts top-4 (d 256, d_ff 128) on the card
    and on the CPU: routing flips counted (float32 ``tokens @ router`` sums
    in another order on each device) and at most 1% of the tokens; with
    every token kept (capacity factor E / k) the tokens whose experts agree
    give outputs within 1e-5 of the output's magnitude, and without a flip
    the load-balance loss too; the card's combine gives the same bits on a
    second call."""
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, 256, 128, 16, "swiglu", "cpu")
    x = torch.randn((4, 128, 256), generator=gen)
    kw = dict(top_k=4, capacity_factor=4.0, act="swiglu")
    y_cpu, aux_cpu = moe.apply_moe(p, x, **kw)
    pd = {k: v.to(dev) for k, v in p.items()}
    y, aux = moe.apply_moe(pd, x.to(dev), **kw)
    assert torch.equal(moe.apply_moe(pd, x.to(dev), **kw)[0], y)
    ids_cpu = torch.sort(moe.route(p["router"], x.reshape(512, -1), 4)[2])[0]
    ids = torch.sort(moe.route(pd["router"], x.to(dev).reshape(512, -1),
                               4)[2])[0].cpu()
    kept = (ids == ids_cpu).all(-1)
    assert int((~kept).sum()) <= 5, int((~kept).sum())
    y, y_cpu = y.cpu().reshape(512, -1), y_cpu.reshape(512, -1)
    err = (y[kept] - y_cpu[kept]).abs().max() / y_cpu.abs().max()
    assert err < 1e-5, err
    if kept.all():          # a flip moves the load-balance counts
        assert abs(float(aux) - float(aux_cpu)) <= 1e-5 * float(aux_cpu)


@pytest.mark.parametrize("b", [4, 48])
def test_flash_decode_at_the_griffin_shape_over_a_wrapped_ring(dev, b):
    """recurrentgemma's local attention (Hkv 1, G 10, D 256, kv16) over a
    wrapped ring of 2,048 slots (every slot valid) and ragged lengths: the
    kernel within 1e-5 of its plain version; at B 48 the kernel folds 4
    query heads into a block (row tiles 4 + 4 + 2), and each row equals
    the same row computed alone."""
    rng = np.random.default_rng(b)
    s, hkv, g, d = 2048, 1, 10, 256
    lens = ([2048, 2048, 1000, 1] * b)[:b]
    kv = _cache(rng, b, s, hkv, d, False, dev)
    q = torch.from_numpy(rng.standard_normal((b, hkv, g, d)).astype(
        np.float32)).to(dev)
    cur = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = flash_decode(q, kv[0], kv[1], cur)
    want = flash_decode_plain(q, kv[0], kv[1], cur, block_kv=256)
    assert _err(got, want) < 1e-5
    one = flash_decode(q[:1].contiguous(), kv[0][:1].contiguous(),
                       kv[1][:1].contiguous(), cur[:1])
    assert _err(one, got[:1]) < 1e-6


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b",
                                  "paligemma-3b"])
def test_recurrent_and_vlm_models_on_the_card_match_the_cpu(dev, arch):
    """The reduced float Model of each family on the card against the CPU
    from the same params: prefill of 20 tokens + 6 decode steps within
    1e-5 (griffin's prompt rolls its 8-slot ring and its decode runs
    flash_decode over the wrapped ring; the VLM prefills a prefix)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.utils import tree_map
    cfg = get_config(arch).reduced()
    params = Model(cfg, "cpu").init(0)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 26)).astype(np.int32))
    prefix = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, cfg.num_prefix, cfg.d_model)).astype(np.float32))

    def run(device):
        m, p = Model(cfg, device), tree_map(lambda t: t.to(device), params)
        batch = {"tokens": toks[:, :20]}
        if cfg.num_prefix:
            batch["prefix_embeds"] = prefix
        lg, cache = m.prefill(p, batch, 32)
        seq = [lg]
        for i in range(6):
            lg, cache = m.decode_step(p, toks[:, 20 + i:21 + i], cache)
            seq.append(lg)
        return torch.cat(seq, 1).cpu()

    assert _err(run(dev), run("cpu")) < 1e-5


# ---------------------------------------------------------------------------
# mesh slices: a rank's kernel call on its slice is the same bits as the
# same part of the whole call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["w4a8_matmul", "dequant_matmul"])
def test_matmul_column_slices_equal_the_full_product(dev, name):
    """Contiguous column slices of a packed weight (codes, scales and zero
    points cut alike; N / 2 = 100 and N / 4 = 50 are ragged) give the same
    columns as the full product, in the decode and tile bodies."""
    gen = torch.Generator(device=dev).manual_seed(21)
    k, n, g = 256, 200, 32
    codes = torch.randint(0, 16, (k, n), generator=gen, device=dev,
                          dtype=torch.uint8)
    qt = QTensor(pack(codes, 4),
                 torch.rand((k // g, n), generator=gen, device=dev) * 0.01
                 + 1e-3,
                 torch.randint(0, 16, (k // g, n), generator=gen,
                               device=dev).to(torch.float32), 4, g)
    for m in (1, 4, 70):
        x = torch.randn((m, k), generator=gen, device=dev)
        call = ((lambda w: ops.quant_matmul(x, w, a_bits=4))
                if name == "w4a8_matmul" else
                (lambda w: ops.dequant_matmul(x, w)))
        whole = call(qt)
        for parts in (2, 4):
            step = n // parts
            for r in range(parts):
                cols = slice(r * step, (r + 1) * step)
                part = QTensor(*(t[:, cols].contiguous() for t in (
                    qt.packed, qt.scale, qt.zp)), 4, g)
                assert torch.equal(call(part), whole[:, cols]), (m, parts, r)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_attention_head_slices_equal_the_full_call(dev, kv_bits):
    """The four attention kernels on contiguous head slices of q and of
    the cache (G = 5, 4 KV heads cut to 2 and 1) give the same heads as
    the full call, linear and paged."""
    gen = torch.Generator(device=dev).manual_seed(22)
    b, s, ps, hkv, grp, d = 3, 48, 8, 4, 5, 64
    hq = hkv * grp
    pt = torch.randperm(b * (s // ps), generator=torch.Generator().manual_seed(
        3)).to(torch.int32).reshape(b, s // ps).to(dev)
    dk = d // 2 if kv_bits == 4 else d
    pools = [torch.randint(-128, 128, (b * s // ps, ps, hkv, dk),
                           generator=gen, device=dev, dtype=torch.int8)
             for _ in range(2)]
    sshape = (b * s // ps, ps, hkv) + ((d // 32,) if kv_bits == 4 else ())
    pools += [(torch.rand(sshape, generator=gen, device=dev) * 0.05 + 0.01
               ).to(torch.bfloat16 if kv_bits == 4 else torch.float32)
              for _ in range(2)]
    idx = pt.long()
    lin = [t[idx].reshape(b, s, *t.shape[2:]).contiguous() for t in pools]
    cur = torch.tensor([30, 1, 48], dtype=torch.int32, device=dev)
    off = torch.tensor([0, 17, 40], dtype=torch.int32, device=dev)
    cl = torch.tensor([12, 8, 0], dtype=torch.int32, device=dev)
    qd = torch.randn((b, 1, hq, d), generator=gen, device=dev)
    qp = torch.randn((b, 12, hq, d), generator=gen, device=dev)
    calls = [(qd, lin, lambda q, kv: ops.flash_decode(q, kv, cur)),
             (qd, pools, lambda q, kv: ops.flash_decode(q, kv, cur,
                                                        page_table=pt)),
             (qp, lin, lambda q, kv: ops.flash_prefill(q, kv, off, cl)),
             (qp, pools, lambda q, kv: ops.flash_prefill(q, kv, off, cl,
                                                         page_table=pt))]
    for q, kv, call in calls:
        whole = call(q, kv)
        for parts in (2, 4):
            hs, qs = hkv // parts, hq // parts
            for r in range(parts):
                got = call(q[:, :, r * qs:(r + 1) * qs].contiguous(),
                           [t[:, :, r * hs:(r + 1) * hs].contiguous()
                            for t in kv])
                assert torch.equal(got, whole[:, :, r * qs:(r + 1) * qs])


def test_mesh_1x1_nccl_engine_equals_no_mesh(dev):
    """``Engine(mesh=make_serving_mesh(1, 1))`` in one process: a world of
    one over NCCL, the llama-micro W4A4 kv8 paged streams of the
    unsharded engine token for token."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import random_packed_lm
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.quantized import QuantizedModel
    cfg = get_config("llama-micro")
    q = QuantConfig(w_bits=4, a_bits=4, group_size=32, kv_bits=8)
    params = random_packed_lm(cfg, q, 0, dev)
    model = QuantizedModel(cfg, q, device="cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n) for n in (13, 9, 26, 5)]
    scfg = ServeConfig(max_batch=2, max_len=48, max_new=8, page_size=8,
                       paged=True, num_pages=6, prefill_chunk=8)

    def run(mesh):
        eng = Engine(model, params, scfg, mesh=mesh)
        reqs = [eng.submit(p) for p in prompts]
        eng.run(max_steps=600)
        return [r.out_tokens for r in reqs], eng.memory_report()

    base, base_mem = run(None)
    mesh = make_serving_mesh(1, 1)
    try:
        assert dist.get_backend() == "nccl"
        got, mem = run(mesh)
    finally:
        dist.destroy_process_group()
    assert got == base
    assert mem == base_mem


def test_bmm_expert_blocks_on_the_card(dev):
    """``launch/row_probe --batches`` at small expert shapes: a rank's
    product over its E / m experts (held in a tensor of its own), m = 2
    and 4, against the whole E.  Through ``expert_bmm`` (torch.bmm on
    blocks of E / 4 experts, the MoE's product) the same bits, at a decode
    step's capacity and a prefill's; a single torch.bmm call over E / m
    experts at most 1e-6 of the largest magnitude away (its bits may move
    with the batch count)."""
    from repro_torch.launch.row_probe import BATCH_CAPS, probe_batches
    for e, d, f in ((32, 64, 128), (16, 256, 96)):
        for cap in BATCH_CAPS:
            for m, (_, _, rel, up, down) in probe_batches(e, d, f, cap,
                                                          dev).items():
                assert rel <= 1e-6, (e, d, f, cap, m, rel)
                assert up == down == 0, (e, d, f, cap, m, up, down)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-1.3b"])
def test_mesh_1x1_nccl_engine_families_equal_no_mesh(dev, arch):
    """A world of one over NCCL serves reduced qwen3-moe (packed W4A4 kv8,
    paged) and mamba2 (float): the unsharded engine's streams token for
    token and its bytes."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import random_packed_lm
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.quantized import QuantizedModel
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(7)
    if cfg.num_experts:
        q = QuantConfig(w_bits=4, a_bits=4, group_size=32, kv_bits=8)
        params = random_packed_lm(cfg, q, 0, dev)
        model = QuantizedModel(cfg, q, device="cuda", block_kv=8)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in (13, 9, 26, 5)]
        scfg = ServeConfig(max_batch=2, max_len=48, max_new=8, page_size=8,
                           paged=True, num_pages=6, prefill_chunk=8)
    else:
        model = Model(cfg, "cuda")
        params = model.init(0)
        prompts = [rng.integers(0, cfg.vocab_size, 12) for _ in range(4)]
        scfg = ServeConfig(max_batch=2, max_len=48, max_new=8)

    def run(mesh):
        eng = Engine(model, params, scfg, mesh=mesh)
        reqs = [eng.submit(p) for p in prompts]
        eng.run(max_steps=600)
        return [r.out_tokens for r in reqs], eng.memory_report()

    base, base_mem = run(None)
    mesh = make_serving_mesh(1, 1)
    try:
        assert dist.get_backend() == "nccl"
        got, mem = run(mesh)
    finally:
        dist.destroy_process_group()
    assert got == base
    assert mem == base_mem
