"""Port parity: the kv4 cache format (nibble packing and block-32
microscaling) against the reference's ``repro.core.packing`` and
``repro.kernels.quantize_pack`` on the same numpy inputs.

Codes, packed bytes and bf16 scales are integer data: byte-equal, no
tolerance (a NaN scale is NaN on both sides; its payload bits are the
framework's own).  Dequantized values are a small integer times a bf16 scale,
exact in float32 on both sides: equal too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_nibbles as jpack_nibbles
from repro.core.packing import unpack_nibbles as junpack_nibbles
from repro.kernels.quantize_pack import kv4_dequant as jkv4_dequant
from repro.kernels.quantize_pack import kv4_quantize as jkv4_quantize
from repro_torch.core.packing import pack_nibbles, unpack_nibbles
from repro_torch.kernels.quantize_pack import (kv4_check_head_dim,
                                               kv4_dequant, kv4_quantize)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small shapes: as fast alone,
    and under parallel test workers torch does not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _jbytes(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_nibbles_byte_equal_over_all_256_pairs():
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8), indexing="ij")
    codes = np.stack([lo.ravel(), hi.ravel()], axis=-1).astype(np.int32)
    packed = pack_nibbles(torch.from_numpy(codes))
    want = np.asarray(jpack_nibbles(jnp.asarray(codes)))
    np.testing.assert_array_equal(packed.numpy(), want)
    assert len(set(packed.numpy()[:, 0].tolist())) == 256
    np.testing.assert_array_equal(unpack_nibbles(packed).numpy(), codes)
    np.testing.assert_array_equal(
        unpack_nibbles(packed).numpy(),
        np.asarray(junpack_nibbles(jnp.asarray(want))))
    with pytest.raises(ValueError):
        pack_nibbles(torch.zeros((2, 3), dtype=torch.int32))


@pytest.mark.parametrize("shape", [(3, 4, 64), (2, 5, 2, 128)])
def test_kv4_quantize_byte_equal_to_reference(shape):
    """Seeded inputs over a wide range of magnitudes, an all-zero block and
    a NaN element (its block keeps a NaN scale and zero codes)."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape)
         * np.exp(rng.uniform(-6, 6, shape[:-1] + (1,)))).astype(np.float32)
    rows = x.reshape(-1, shape[-1])            # a view
    rows[0, :32] = 0.0
    rows[7, 5] = np.nan
    codes, scales = kv4_quantize(torch.from_numpy(x))
    jcodes, jscales = jkv4_quantize(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scales.dtype == torch.bfloat16
    assert codes.shape == shape[:-1] + (shape[-1] // 2,)
    assert scales.shape == shape[:-1] + (shape[-1] // 32,)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    nan = torch.isnan(scales)
    np.testing.assert_array_equal(nan.numpy(), np.isnan(
        np.asarray(jscales, np.float32)))
    np.testing.assert_array_equal(_bytes(scales)[~nan.numpy()],
                                  _jbytes(jscales)[~nan.numpy()])
    flat_nan = nan.reshape(-1, shape[-1] // 32)
    assert flat_nan[7, 0] and flat_nan.sum() == 1
    deq = kv4_dequant(codes, scales)
    np.testing.assert_array_equal(        # NaN compares equal here
        deq.numpy(), np.asarray(jkv4_dequant(jcodes, jscales)))


def test_kv4_dequant_requant_is_a_fixed_point():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((6, 3, 96)).astype(np.float32))
    codes, scales = kv4_quantize(x)
    again, again_s = kv4_quantize(kv4_dequant(codes, scales))
    assert torch.equal(again, codes)
    assert torch.equal(again_s.view(torch.int16), scales.view(torch.int16))


def test_kv4_head_dim_check():
    kv4_check_head_dim(64)
    with pytest.raises(ValueError, match="head_dim"):
        kv4_check_head_dim(48)
    with pytest.raises(ValueError, match="head_dim"):
        kv4_quantize(torch.zeros((2, 48)))
