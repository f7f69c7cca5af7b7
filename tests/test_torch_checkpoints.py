"""Port parity: the npz checkpoints in both directions, and the calibrated
-tree acceptance.

The reference writes a float llama-micro tree, a bf16 tree and two trees
that its own AffineQuant calibration packed (``quantize_dense_model(
deploy="packed")``: w4a16 g32 with full transform sites, so ``attn_t`` /
``mlp_t`` factors; w4a4 g32 with diagonal sites merged into the norms, so
norm and q/k/v biases).  The port reads each byte for byte, recovering
every QTensor's bits and group size from the config and the shapes; the
reference restores what the port writes.  The calibrated trees, read by
``load_tree``, are served by the port's ``QuantizedModel`` on the CPU and
held against the reference's ``QuantizedModel(kernel_mode="ref")`` on the
reference's own tree: prefill and 32 teacher-forced decode steps, over the
linear cache and over pages of 4 (the reference keeps its paged logits
equal to its linear ones), within ``test_torch_quantized_model.py``'s
tolerances (1e-5 of the largest logit at w4a16 kv16, 1e-4 at w4a4 kv8),
greedy tokens equal.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.calibration import CalibConfig as JCalibConfig
from repro.core.calibration import quantize_dense_model as jquantize_dense
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.serve.quantized import QuantizedModel as JQuantizedModel
from repro.train import checkpoints as jckpt
from repro_torch.configs import get_config
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantizer import QuantConfig
from repro_torch.models.model import build_model
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.quantized import QuantizedModel
from repro_torch.train import checkpoints


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small shapes: as fast alone,
    and under parallel test workers torch does not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SETTINGS = {"w4a16kv16": dict(a_bits=16, kv_bits=16, tol=1e-5),
            "w4a4kv8": dict(a_bits=4, kv_bits=8, tol=1e-4)}


def _leaves(tree):
    """{path: numpy} of a reference tree, by the reference's own keys."""
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def _same(t: torch.Tensor, a: np.ndarray) -> None:
    assert tuple(t.shape) == a.shape
    got = t.contiguous().view(torch.uint8).numpy().tobytes()
    assert got == np.ascontiguousarray(a).tobytes()


def _port_leaves(tree) -> dict:
    return {k: v for k, (v, _) in checkpoints.flatten(tree).items()}


@pytest.fixture(scope="module")
def jparams():
    """A float llama-micro tree as the reference holds it: the port's seeded
    init (the reference's tree, keys and scales) as JAX arrays."""
    tree = build_model(get_config("llama-micro"), "cpu").init(0)
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.fixture(scope="module", params=list(SETTINGS))
def calibrated(request, jparams, tmp_path_factory):
    """A reference-calibrated, reference-saved packed tree."""
    s = SETTINGS[request.param]
    jcfg = jget_config("llama-micro")
    jq = JQuantConfig(w_bits=4, a_bits=s["a_bits"], group_size=32, lwc=True,
                      kv_bits=s["kv_bits"])
    tq = QuantConfig(w_bits=4, a_bits=s["a_bits"], group_size=32,
                     kv_bits=s["kv_bits"])
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (8, 16))
    packed, _ = jquantize_dense(jparams, jcfg, jq,
                                JCalibConfig(epochs=1, alpha=0.1),
                                jnp.asarray(toks, jnp.int32), log=False,
                                deploy="packed")
    d = tmp_path_factory.mktemp(request.param)
    jckpt.save(d, 0, packed)
    return request.param, jcfg, jq, tq, packed, d, s["tol"]


def test_float_tree_read_byte_for_byte(jparams, tmp_path):
    jckpt.save(tmp_path, 5, jparams)
    tree = checkpoints.load_tree(tmp_path, get_config("llama-micro"),
                                 QuantConfig(), device="cpu")
    want = _leaves(jparams)
    got = _port_leaves(tree)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        _same(torch.from_numpy(got[k]), a)


def test_packed_tree_read_byte_for_byte(calibrated):
    name, jcfg, jq, tq, packed, d, _ = calibrated
    tree = checkpoints.load_tree(d, get_config("llama-micro"), tq,
                                 device="cpu")
    for k in ("wq", "wk", "wv", "wo"):
        qt = tree["layers"][k]
        assert isinstance(qt, QTensor)
        assert (qt.bits, qt.group_size) == (packed["layers"][k].bits,
                                            packed["layers"][k].group_size)
    assert ("attn_t" in tree["layers"]) == (name == "w4a16kv16")
    assert ("bias" in tree["layers"]["ln_attn"]) == (name == "w4a4kv8")
    want = _leaves(packed)
    got = _port_leaves(tree)
    assert sorted(got) == sorted(want)
    assert "layers||wq||.packed" in got
    for k, a in want.items():
        _same(torch.from_numpy(got[k]), a)
    with pytest.raises(ValueError, match="3-bit"):
        checkpoints.load_tree(d, get_config("llama-micro"),
                              QuantConfig(w_bits=3, group_size=32),
                              device="cpu")


def test_bf16_leaves_read_byte_for_byte(tmp_path):
    rng = np.random.default_rng(1)
    f = (rng.standard_normal((6, 5)) * np.logspace(-30, 30, 5)
         ).astype(np.float32)
    tree = {"bf": jnp.asarray(f, jnp.bfloat16), "f": jnp.asarray(f)}
    jckpt.save(tmp_path, 0, tree)
    man = json.loads((tmp_path / "step_00000000" / "manifest.json"
                      ).read_text())
    assert man["leaves"]["bf"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "step_00000000" / "arrays.npz") as z:
        assert z["bf"].dtype.str == "|V2"
    got = checkpoints.load_tree(tmp_path, get_config("llama-micro"),
                                QuantConfig(), device="cpu")
    assert got["bf"].dtype == torch.bfloat16
    _same(got["bf"], np.asarray(tree["bf"]))
    np.testing.assert_array_equal(got["bf"].float().numpy(),
                                  np.asarray(tree["bf"]).astype(np.float32))
    # and back: the port writes the reference's bytes and manifest dtype
    checkpoints.save(tmp_path / "port", 0, got)
    again = checkpoints.load_tree(tmp_path / "port",
                                  get_config("llama-micro"), QuantConfig(),
                                  device="cpu")
    assert torch.equal(again["bf"].view(torch.int16),
                       got["bf"].view(torch.int16))


def test_port_save_restored_by_reference(calibrated, tmp_path):
    """The port writes the reference's keys: ``restore`` into the
    reference's own tree structure gives back every byte."""
    _, jcfg, _, tq, packed, d, _ = calibrated
    tree = checkpoints.load_tree(d, get_config("llama-micro"), tq,
                                 device="cpu")
    checkpoints.save(tmp_path, 3, tree)
    restored, step = jckpt.restore(tmp_path, packed)
    assert step == 3
    want, got = _leaves(packed), _leaves(restored)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes()


def test_retention_latest_step_and_tmp(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(3, dtype=torch.int32)}}
    assert checkpoints.latest_step(tmp_path) is None
    for s in (1, 2, 3, 4, 5):
        checkpoints.save(tmp_path, s, tree, keep=2, extra={"note": "x"})
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [4, 5] and checkpoints.latest_step(tmp_path) == 5
    assert not list(tmp_path.glob("*.tmp"))
    (tmp_path / "step_00000009.tmp").mkdir()      # a crashed write
    assert checkpoints.latest_step(tmp_path) == 5
    man = json.loads((tmp_path / "step_00000005" / "manifest.json"
                      ).read_text())
    assert man["step"] == 5 and man["extra"] == {"note": "x"}
    got = checkpoints.load_tree(tmp_path, get_config("llama-micro"),
                                QuantConfig(), device="cpu")
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    with pytest.raises(FileNotFoundError):
        checkpoints.load_tree(tmp_path / "nope", get_config("llama-micro"),
                              QuantConfig(), device="cpu")


def _serve(model, params, tokens, to_np, paged_store=None, steps=32):
    """Prefill 16 tokens, then ``steps`` teacher-forced decode steps."""
    if paged_store is None:
        lg, cache = model.prefill(params, {"tokens": tokens[:, :16]},
                                  max_len=64)
    else:
        for slot in range(2):
            assert paged_store.reserve(slot, 16)
        lg, cache = model.prefill_chunk(
            params, {"tokens": tokens[:, :16]}, paged_store.cache,
            torch.zeros(2, dtype=torch.int32), last_only=True)
    out = [to_np(lg)]
    for i in range(steps):
        if paged_store is not None:
            paged_store.cache = cache
            for slot in range(2):
                assert paged_store.ensure_append(slot, 16 + i)
            cache = paged_store.cache
        lg, cache = model.decode_step(params, tokens[:, 16 + i:17 + i], cache)
        out.append(to_np(lg))
    return np.concatenate(out, axis=1)


def test_calibrated_tree_served_like_reference(calibrated):
    """ROADMAP queue 1 item 1's acceptance, on both cache layouts."""
    _, jcfg, jq, tq, packed, d, tol = calibrated
    tcfg = get_config("llama-micro")
    tree = checkpoints.load_tree(d, tcfg, tq, device="cpu")
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    jm = JQuantizedModel(jcfg, jq, kernel_mode="ref")

    class Jitted:
        prefill = staticmethod(jax.jit(jm.prefill,
                                       static_argnames=("max_len",)))
        decode_step = staticmethod(jax.jit(jm.decode_step))

    want = _serve(Jitted, packed, jnp.asarray(tokens), np.asarray)
    tm = QuantizedModel(tcfg, tq, device="cpu")
    for store in (None, kvc.PagedCache(tm, 2, 64, 4)):
        got = _serve(tm, tree, torch.from_numpy(tokens), lambda t: t.numpy(),
                     store)
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err < tol, (store is not None, err)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
