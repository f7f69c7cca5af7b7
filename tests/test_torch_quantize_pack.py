"""Port parity: the per-group quantize + pack plain version against the
reference's ``ref.quantize_pack_ref`` and its Pallas body in interpret
mode, on the same numpy weights, and the 3-bit route of ``ops``.

Tolerance: none against ``ref``.  Packed bytes, scales and zero points
are equal (the same IEEE quotient and round-half-even on both sides).  The
Pallas body runs under ``jit``, where XLA turns the division by the
constant ``2^bits - 1`` into a multiply by its reciprocal, so its scales
may sit an ulp from the quotient: against it the packed bytes are equal
and scale and zp within rtol 1e-6, the tolerance the reference's own
``test_quantize_pack_kernel_matches_ref`` holds it to.  The 3-bit
``dequant_matmul`` check sums a float32 product over K in another order
than XLA: 2e-6 of the output's max magnitude, as in
``test_torch_kernels_plain.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.quantize_pack import quantize_pack as pallas_quantize_pack
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantizer import QuantConfig, quantize_codes
from repro_torch.kernels import ops
from repro_torch.kernels.quantize_pack import (quantize_pack,
                                               quantize_pack_plain)

T = torch.from_numpy


def _weight(seed, k=256, n=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)) * 0.05).astype(np.float32)


def _equal(got, want):
    for name, g, w in zip(("packed", "scale", "zp"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("g", [32, 0])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_pack_plain_matches_ref_and_pallas(bits, g):
    w = _weight(bits + g)
    got = quantize_pack_plain(T(w), bits, g)
    _equal(got, ref.quantize_pack_ref(jnp.asarray(w), bits=bits,
                                      group_size=g))
    p, sc, zp = pallas_quantize_pack(jnp.asarray(w), bits=bits,
                                     group_size=g, bn=w.shape[1],
                                     interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(p))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(sc), rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(zp), rtol=1e-6)
    # the wrapper and ops run the plain version for CPU tensors
    _equal(quantize_pack(T(w), bits=bits, group_size=g), got)
    _equal(ops.quantize_pack(T(w), bits=bits, group_size=g), got)


@pytest.mark.parametrize("g", [64, 0])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_pack_plain_equals_quantize_codes(bits, g):
    """The packer and the serving tree's quantizer emit the same bytes."""
    w = _weight(100 + bits + g)
    qt = quantize_codes(T(w), QuantConfig(w_bits=bits, group_size=g))
    _equal(quantize_pack_plain(T(w), bits, g), (qt.packed, qt.scale, qt.zp))


def test_quantize_pack_rejects_groups_the_reference_rejects():
    w = T(_weight(7, k=96))
    for g in (64, 12):       # does not divide K; not a multiple of 8
        with pytest.raises(ValueError):
            quantize_pack(w, bits=4, group_size=g)
        with pytest.raises(ValueError):
            ops.quantize_pack(w, bits=3, group_size=g)


def test_ops_bits3_takes_the_plain_route_like_ref():
    """3-bit codes are storage-only: ops packs and multiplies them with the
    plain versions, byte-equal and close to the reference's ref math."""
    w = _weight(3, k=128, n=40)
    packed, scale, zp = ops.quantize_pack(T(w), bits=3, group_size=0)
    want = ref.quantize_pack_ref(jnp.asarray(w), bits=3, group_size=0)
    _equal((packed, scale, zp), want)
    x = np.random.default_rng(4).standard_normal((5, 128)).astype(np.float32)
    qt = QTensor(packed, scale, zp, 3, 128)
    y = ops.dequant_matmul(T(x), qt)
    y_ref = np.asarray(ref.dequant_matmul_ref(
        jnp.asarray(x), *want, bits=3, group_size=0))
    err = np.max(np.abs(y.numpy() - y_ref))
    assert err <= 2e-6 * max(1.0, np.max(np.abs(y_ref))), err
    y_a8 = ops.quant_matmul(T(x), qt, a_bits=8)
    want_a8 = np.asarray(ref.quant_matmul_ref(
        jnp.asarray(x), *want, bits=3, group_size=128, a_bits=8))
    err = np.max(np.abs(y_a8.numpy() - want_a8))
    assert err <= 1e-6 * max(1.0, np.max(np.abs(want_a8))), err
