"""Port parity: packing, QTensor and the RTN quantizer are byte-equal to
the reference (same inputs, made from a seed with numpy)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.core.quantizer import quantize_codes as jquantize_codes
from repro_torch.core import packing as tpack
from repro_torch.core.quantizer import QuantConfig, quantize_codes


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small shapes: as fast alone,
    and under parallel test workers torch does not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_pack_unpack_byte_equal(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2 ** bits, (3, 64, 24)).astype(np.uint8)
    jp = np.asarray(jpack.pack(jnp.asarray(codes), bits))
    tp = tpack.pack(torch.from_numpy(codes), bits).numpy()
    np.testing.assert_array_equal(tp, jp)
    assert tp.shape == (3, tpack.packed_rows(64, bits), 24)
    np.testing.assert_array_equal(
        tpack.unpack(torch.from_numpy(jp.copy()), bits, 64).numpy(), codes)


@pytest.mark.parametrize("group", [0, 64])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_codes_byte_equal(bits, group):
    rng = np.random.default_rng(10 * bits + group)
    w = (rng.standard_normal((2, 128, 40)) * 0.05).astype(np.float32)
    jqt = jquantize_codes(jnp.asarray(w), JQuantConfig(
        w_bits=bits, group_size=group, lwc=False))
    tqt = quantize_codes(torch.from_numpy(w), QuantConfig(
        w_bits=bits, group_size=group))
    assert (tqt.bits, tqt.group_size) == (jqt.bits, jqt.group_size)
    for name in ("packed", "scale", "zp"):
        np.testing.assert_array_equal(getattr(tqt, name).numpy(),
                                      np.asarray(getattr(jqt, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tqt.dequantize().numpy(),
                                  np.asarray(jqt.dequantize()))
    np.testing.assert_array_equal(tqt[1].codes().numpy(),
                                  np.asarray(jqt.codes())[1])
