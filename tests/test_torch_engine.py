"""Port parity: the port's Engine against the reference Engine
(``kernel_mode="ref"``) on the same packed codes and the same seeded
mixed-length trace — greedy streams must be identical — plus the port
engine's own scheduling contracts."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.models import build_model
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.quantized import QuantizedModel as JQuantizedModel
from repro.serve.quantized import quantize_lm_packed as jquantize_lm_packed
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.quantizer import QuantConfig
from repro_torch.serve.engine import Engine, RequestStatus, ServeConfig
from repro_torch.serve.quantized import QuantizedModel

SERVE = dict(max_batch=2, max_len=64, max_new=6, prefill_bucket=16)
LENGTHS = (5, 17, 9, 30, 3)


def _trace(vocab):
    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


@pytest.fixture(scope="module", params=[16, 4], ids=["w4a16kv8", "w4a4kv8"])
def packed(request):
    a_bits = request.param
    jcfg = jget_config("llama-micro")
    jq = JQuantConfig(w_bits=4, a_bits=a_bits, group_size=32, lwc=False,
                      kv_bits=8)
    params = build_model(jcfg).init(jax.random.PRNGKey(3))
    jp = jquantize_lm_packed(params, jcfg, jq)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    tq = QuantConfig(w_bits=4, a_bits=a_bits, group_size=32, kv_bits=8)
    return (JQuantizedModel(jcfg, jq, kernel_mode="ref"), jp,
            QuantizedModel(get_config("llama-micro"), tq, device="cpu"), tp)


def _port_engine(packed, **over):
    return Engine(packed[2], packed[3], ServeConfig(**dict(SERVE, **over)))


def test_greedy_streams_match_reference_engine(packed):
    jm, jp, _, _ = packed
    prompts = _trace(jm.cfg.vocab_size)
    jeng = JEngine(jm, jp, JServeConfig(**SERVE))
    teng = _port_engine(packed)
    for p in prompts:
        jeng.submit(p)
        teng.submit(p)
    want = [r.out_tokens for r in jeng.run(max_steps=200)]
    got = [r.out_tokens for r in teng.run(max_steps=200)]
    assert got == want
    assert all(len(t) == SERVE["max_new"] for t in got)


def test_fifo_admission_order(packed):
    eng = _port_engine(packed, max_batch=1)
    reqs = [eng.submit(p) for p in _trace(512)]
    finished = []
    while len(finished) < len(reqs):
        eng.step()
        finished += [r.rid for r in reqs
                     if r.done and r.rid not in finished]
    assert finished == [r.rid for r in reqs]
    assert all(r.status is RequestStatus.COMPLETED for r in reqs)


def test_retire_at_eos_and_max_new(packed):
    prompts = _trace(512)
    base = _port_engine(packed)
    for p in prompts:
        base.submit(p)
    streams = [r.out_tokens for r in base.run()]
    eos = streams[1][2]
    eng = _port_engine(packed, eos_token=eos)
    for p in prompts:
        eng.submit(p)
    for got, full in zip((r.out_tokens for r in eng.run()), streams):
        cut = full.index(eos) + 1 if eos in full else len(full)
        assert got == full[:cut]


def test_retire_at_capacity(packed):
    eng = _port_engine(packed, max_len=16, max_new=50)
    req = eng.submit(np.arange(10, dtype=np.int32))
    eng.run(max_steps=50)
    # retired when the slot is one token short of capacity
    assert req.done and len(req.out_tokens) == 16 - 1 - 10 + 1


def test_submit_rejects_unservable_prompts(packed):
    eng = _port_engine(packed)
    with pytest.raises(ValueError):
        eng.submit(np.zeros((SERVE["max_len"],), np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.zeros((0,), np.int32))
    assert not eng._pending


@pytest.mark.parametrize("over", [dict(temperature=0.7),
                                  dict(prefix_cache=True)])
def test_unported_engine_options_raise(packed, over):
    with pytest.raises(NotImplementedError):
        _port_engine(packed, **over)


def test_memory_report_counts_packed_weights_and_kv8_cache(packed):
    eng = _port_engine(packed)
    rep = eng.memory_report()
    cfg = packed[2].cfg
    kv = (2 * cfg.num_layers * SERVE["max_batch"] * SERVE["max_len"]
          * cfg.num_kv_heads * (cfg.resolved_head_dim + 4)
          + 4 * SERVE["max_batch"])
    assert rep["kv_bytes"] == kv
    pb = lambda k, n: k // 8 * 4 * n + 2 * 4 * (k // 32) * n   # w4 g32
    d, ff = cfg.d_model, cfg.d_ff
    layer = 2 * 4 * d + 4 * pb(d, d) + 2 * pb(d, ff) + pb(ff, d)
    assert rep["weight_bytes"] == (cfg.vocab_size * d + d) * 4 \
        + cfg.num_layers * layer
