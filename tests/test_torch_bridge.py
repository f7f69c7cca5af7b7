"""The bridge carries every leaf of a reference tree byte for byte, bf16
leaves included (numpy holds them as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses), and passes a calibration tree's site
descriptions (strings, ints, bools) through unchanged."""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.qtensor import QTensor as JQTensor
from repro_torch.bridge import from_jax_params
from repro_torch.core.qtensor import QTensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8, "uint8": torch.uint8}


def _same_bytes(t: torch.Tensor, a: np.ndarray) -> None:
    assert t.dtype == _DTYPES[a.dtype.name]
    assert tuple(t.shape) == a.shape
    got = t.contiguous().view(torch.uint8).numpy().tobytes()
    assert got == np.ascontiguousarray(a).tobytes()


def test_bridge_carries_bf16_f32_int8_uint8_leaves_byte_for_byte():
    rng = np.random.default_rng(0)
    # values that need every bf16 bit: signs, subnormal-sized, large
    f = (rng.standard_normal((6, 5))
         * np.logspace(-30, 30, 5)).astype(np.float32)
    bf16 = np.asarray(jnp.asarray(f, dtype=jnp.bfloat16))
    packed = rng.integers(0, 256, (16, 5)).astype(np.uint8)
    qscale = np.asarray(jnp.asarray(rng.random((2, 5)) + 0.5,
                                    dtype=jnp.bfloat16))
    qzp = rng.integers(0, 16, (2, 5)).astype(np.float32)
    tree = {
        "bf16": bf16, "f32": f,
        "i8": rng.integers(-128, 128, (3, 7)).astype(np.int8),
        "u8": packed,
        "w": JQTensor(packed, qscale, qzp, bits=4, group_size=16),
    }
    assert bf16.dtype.name == "bfloat16"
    out = from_jax_params(tree)
    for name in ("bf16", "f32", "i8", "u8"):
        _same_bytes(out[name], tree[name])
    w = out["w"]
    assert isinstance(w, QTensor) and (w.bits, w.group_size) == (4, 16)
    _same_bytes(w.packed, packed)
    _same_bytes(w.scale, qscale)
    _same_bytes(w.zp, qzp)
    # the bf16 values themselves, not only their bytes
    np.testing.assert_array_equal(out["bf16"].float().numpy(),
                                  bf16.astype(np.float32))


def test_bridge_carries_a_calibration_parameter_tree():
    """The reference's learnable tree for one block: affine matrices,
    shifts and LWC logits become tensors byte for byte; ``_sites`` (str,
    int and bool leaves) pass through as they are."""
    import jax
    from repro.configs import get_config
    from repro.core.calibration import CalibConfig, init_block_quant_params
    from repro.core.quantizer import QuantConfig
    from repro.models import build_model
    cfg = get_config("llama-micro")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    block = jax.tree_util.tree_map(lambda x: x[0], params["layers"])
    qp = init_block_quant_params(block, cfg, QuantConfig(w_bits=4, a_bits=4,
                                                         group_size=32),
                                 CalibConfig())
    host = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, qp)
    out = from_jax_params(host)
    assert out["_sites"] == qp["_sites"]
    assert out["_sites"]["vo"]["kind"] == "headwise"
    assert isinstance(out["_sites"]["ln_attn"]["with_shift"], bool)
    for site in qp["affine"]:
        for k, v in qp["affine"][site].items():
            _same_bytes(out["affine"][site][k], np.asarray(v))
    for w in qp["lwc"]:
        for k, v in qp["lwc"][w].items():
            _same_bytes(out["lwc"][w][k], np.asarray(v))
    assert from_jax_params([np.ones(2, np.float32), "x", 3])[1:] == ["x", 3]
