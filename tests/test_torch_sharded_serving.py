"""Mesh-native sharded serving in the port: an Engine over a (data, model)
mesh gives the unsharded engine's streams, statuses and preemption counts
token for token (the reference's ``tests/test_sharded_serving.py``
contract).

The gloo lane runs each mesh in separate processes (one torch thread
each), started by :func:`_spawn`; each runs :func:`child_main` of this
module, which imports neither jax nor the reference (the JAX comparison
imports them inside its test).  Setup as the reference's: llama-micro W8A16
g32 kv4, pages of 8 and chunks of 8, a tight pool that preempts, a clean
trace, an injected NaN with the victim quarantined, prefix caching; plus a
W4A4 trace, the float model (held to logits: its row-split ``wo`` /
``w_down`` sum partial products) and per-rank bytes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.quantizer import QuantConfig
from repro_torch.launch.mesh import free_port, make_serving_mesh
from repro_torch.launch.serve import random_packed_lm, teacher_forced
from repro_torch.models.model import Model
from repro_torch.serve import faults as flt
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kv_cache import pages_for
from repro_torch.serve.quantized import QuantizedModel

ROOT = os.path.join(os.path.dirname(__file__), "..")
PS = 8
LENS = (13, 9, 26, 5)     # 13+8 and 9+8 cross into a third page mid-decode
MAX_NEW = 8
MAX_LEN = -(-(max(LENS) + MAX_NEW + 1) // PS) * PS
POOL_MIN = pages_for(max(LENS) + MAX_NEW, PS)
VICTIM = len(LENS) // 2
FLOAT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread here, and no world of one left behind by the
    in-process 1 x 1 mesh."""
    import torch.distributed as dist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


_SERVED: dict = {}


def served(wbits: int = 8, abits: int = 16):
    """(model, packed tree) of llama-micro at w{wbits} a{abits} g32 kv4
    from the seeded init (the same tree in every process)."""
    key = (wbits, abits)
    if key not in _SERVED:
        cfg = get_config("llama-micro")
        q = QuantConfig(w_bits=wbits, a_bits=abits, group_size=32, kv_bits=4)
        _SERVED[key] = (QuantizedModel(cfg, q, device="cpu", block_kv=PS),
                        random_packed_lm(cfg, q, 0, "cpu"))
    return _SERVED[key]


def prompts(lens=LENS, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n) for n in lens]


def prefix_prompts():
    rng = np.random.default_rng(11)
    system = rng.integers(0, 512, 19)
    return [np.concatenate([system, rng.integers(0, 512, n)])
            for n in (5, 9, 13)]


def scfg(tight=False, **kw) -> ServeConfig:
    return ServeConfig(**dict(dict(
        max_batch=2, max_len=MAX_LEN, max_new=MAX_NEW, prefill_bucket=16,
        page_size=PS, paged=True, num_pages=(POOL_MIN + 1) if tight else 0,
        prefill_chunk=PS, watchdog_steps=8), **kw))


def _engine_run(model, params, cfg, mesh, reqs, faults=None) -> dict:
    eng = Engine(model, params, cfg, faults=faults, mesh=mesh)
    out = [eng.submit(p) for p in reqs]
    eng.run(max_steps=600)
    eng._kv.verify()
    if cfg.paged:
        al = eng._kv.allocator
        assert al.num_free == al.num_pages
    return {"streams": [list(r.out_tokens) for r in out],
            "statuses": [r.status.name for r in out],
            "preemptions": sum(r.preemptions for r in out),
            "hits": eng.prefix_stats["hits"], "memory": eng.memory_report(),
            "engine": eng}


def _float_case(mesh) -> dict:
    """The float llama-micro on ``mesh`` against the unsharded float
    engine: greedy agreement counted, teacher-forced logits on the
    unsharded streams compared (the float Engine's contract)."""
    cfg = get_config("llama-micro")
    model = Model(cfg, "cpu", block_kv=PS)
    params = model.init(0)
    reqs = prompts(lens=(12, 12, 12, 12))
    c = scfg(paged=False, prefill_chunk=0)
    base = _engine_run(model, params, c, None, reqs)
    got = _engine_run(model, params, c, mesh, reqs)
    p = torch.as_tensor(np.stack(reqs), dtype=torch.int32)
    gen = torch.as_tensor(base["streams"], dtype=torch.int32)
    eng = got["engine"]
    tf = [teacher_forced(m, w, p, gen, MAX_NEW - 1, MAX_LEN)
          for m, w in ((model, params), (eng.model, eng.params))]
    agree = float(np.mean(np.array(base["streams"])
                          == np.array(got["streams"])))
    rel = ((tf[1] - tf[0]).abs().max() / tf[0].abs().max()).item()
    return {"agreement": agree, "logit_rel": rel}


def run_case(case: str, mesh) -> dict:
    """One trace of the acceptance matrix on ``mesh`` (None: unsharded)."""
    if case == "float":
        return _float_case(mesh)
    model, params = served(*((4, 4) if case == "w4a4" else (8, 16)))
    if case in ("tight", "w4a4"):
        out = _engine_run(model, params, scfg(True), mesh, prompts())
    elif case == "loose":
        out = _engine_run(model, params, scfg(), mesh, prompts())
    elif case == "fault":
        plan = flt.FaultPlan(flt.Fault(point=flt.NAN_LOGITS, rid=VICTIM,
                                       after_step=1))
        out = _engine_run(model, params, scfg(), mesh, prompts(), plan)
    elif case == "prefix":
        out = _engine_run(model, params,
                          scfg(max_len=48, prefix_cache=mesh is not None),
                          mesh, prefix_prompts())
    else:
        raise ValueError(case)
    del out["engine"]
    return out


CASES = ("tight", "loose", "fault", "prefix", "w4a4", "float")


def child_main(rank: int, world: int, port: int, out_dir: str,
               shapes: list) -> None:
    """One rank: join the gloo group, run every case on every mesh shape,
    write the results."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world
    torch.set_num_threads(1)
    init_world(rank, world, port, "cpu")
    try:
        res = {}
        for shape in shapes:
            mesh = make_serving_mesh(*shape, device="cpu")
            for case in CASES:
                # the float check teacher-forces one whole batch: data 1
                if case != "float" or shape[0] == 1:
                    res[f"{shape[0]}x{shape[1]}/{case}"] = run_case(case,
                                                                    mesh)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


_CHILD = ("import sys, json; import test_torch_sharded_serving as t; "
          "t.child_main(int(sys.argv[1]), int(sys.argv[2]), "
          "int(sys.argv[3]), sys.argv[4], json.loads(sys.argv[5]))")


def _spawn(world: int, shapes: list) -> dict:
    """Run :func:`child_main` in ``world`` processes; returns rank 0's
    results after checking every rank reported the same."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.dirname(__file__)]))
    port = free_port()
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(r), str(world), str(port),
             out, json.dumps(shapes)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                p.kill()
        assert all(p.returncode == 0 for p in procs), "\n".join(logs)
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for r, res in enumerate(ranks[1:], 1):
        for key, val in res.items():
            if "memory" in val:
                val = {k: v for k, v in val.items() if k != "memory"}
            want = {k: v for k, v in ranks[0][key].items() if k != "memory"}
            assert val == want, (r, key)
    return ranks[0]


@pytest.fixture(scope="module")
def base():
    return {case: run_case(case, None) for case in CASES if case != "float"}


@pytest.fixture(scope="module")
def meshes():
    out = _spawn(2, [(1, 2), (2, 1)])
    out.update(_spawn(4, [(2, 2), (1, 4)]))
    return out


def _same(got: dict, want: dict) -> None:
    assert got["streams"] == want["streams"]
    assert got["statuses"] == want["statuses"]
    assert got["preemptions"] == want["preemptions"]


# ---------------------------------------------------------------------------
# in-process: a 1 x 1 mesh, validation, loading
# ---------------------------------------------------------------------------

def test_mesh_engine_identity_1x1(base):
    """A 1 x 1 mesh engine (params and cache cut by their specs, the
    model bound to its rank) is token-identical to mesh=None."""
    model, params = served()
    got = _engine_run(model, params, scfg(), make_serving_mesh(
        1, 1, device="cpu"), prompts())
    _same(got, base["loose"])
    rep = got["memory"]
    assert rep["device_count"] == 1
    assert rep == dict(base["loose"]["memory"], device_count=1)


def test_serving_mesh_validation():
    with pytest.raises(ValueError, match="needs"):
        make_serving_mesh(3, 2, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        make_serving_mesh(0, 1, device="cpu")


def test_float_ckpt_on_mesh_loads_to_the_cpu(tmp_path, monkeypatch):
    """On a mesh a float ``--ckpt`` tree loads to the CPU, as
    ``--load-packed`` does, so only each rank's shards reach the card; off
    a mesh it loads to the serving device ("cuda" here is only the name
    the loader is asked for: the load itself is recorded and done on the
    CPU)."""
    from repro_torch.launch import serve
    from repro_torch.train import checkpoints
    cfg = get_config("llama-micro")
    checkpoints.save(str(tmp_path), 0, Model(cfg, "cpu").init(0))
    asked = []

    def load(ckpt, cfg, qcfg, device):
        asked.append(str(device))
        return checkpoints.load_tree(ckpt, cfg, qcfg, device="cpu")
    monkeypatch.setattr(serve, "load_float_params", load)
    argv = ["--arch", "llama-micro", "--fp", "--ckpt", str(tmp_path)]
    for flags in ([], ["--mesh-model", "2"], ["--mesh-data", "2"]):
        args = serve.build_parser().parse_args(argv + flags)
        tree = serve.load_params(args, cfg, serve.quant_config(args),
                                 "cuda")[0]
        leaves = [t for t in torch.utils._pytree.tree_leaves(tree)
                  if torch.is_tensor(t)]
        assert leaves and all(t.device.type == "cpu" for t in leaves)
    assert asked == ["cuda", "cpu", "cpu"]


# ---------------------------------------------------------------------------
# the gloo lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["1x2", "2x1", "2x2"])
def test_tight_pool_preempts_and_streams_equal(base, meshes, shape):
    assert base["tight"]["preemptions"] > 0, "tight pool never preempted"
    _same(meshes[f"{shape}/tight"], base["tight"])


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_clean_trace_streams_equal(base, meshes, shape):
    _same(meshes[f"{shape}/loose"], base["loose"])


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_nan_fault_quarantined_alike(base, meshes, shape):
    got, want = meshes[f"{shape}/fault"], base["fault"]
    _same(got, want)
    assert want["statuses"][VICTIM] == "FAILED_NAN"
    assert all(s == "COMPLETED" for i, s in enumerate(want["statuses"])
               if i != VICTIM)
    assert [t for i, t in enumerate(want["streams"]) if i != VICTIM] == \
        [t for i, t in enumerate(base["loose"]["streams"]) if i != VICTIM]


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_prefix_cache_on_mesh_equals_no_sharing(base, meshes, shape):
    got = meshes[f"{shape}/prefix"]
    assert got["streams"] == base["prefix"]["streams"]
    assert got["hits"] >= 1


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_w4a4_sharded_streams_equal(base, meshes, shape):
    assert base["w4a4"]["preemptions"] > 0
    _same(meshes[f"{shape}/w4a4"], base["w4a4"])


def test_per_device_bytes_shrink_with_model(base, meshes):
    one = base["loose"]["memory"]
    two, four = meshes["1x2/loose"]["memory"], meshes["1x4/loose"]["memory"]
    assert (two["device_count"], four["device_count"]) == (2, 4)
    for key in ("weight_bytes", "kv_bytes"):
        assert four[key] < two[key] < one[key], key
    # data parallelism replicates the weights and the page pool
    assert meshes["2x1/loose"]["memory"]["weight_bytes"] == \
        one["weight_bytes"]


def test_float_model_on_mesh_within_logit_tolerance(meshes):
    """The float model's row-split wo / w_down sum partial products over
    "model" (the reference's table), so its sharded logits are held to the
    float Engine's tolerance and its greedy agreement is counted."""
    for shape in ("1x2", "1x4"):
        got = meshes[f"{shape}/float"]
        assert got["logit_rel"] <= FLOAT_TOL, (shape, got)
        assert got["agreement"] >= 0.9, (shape, got)


# ---------------------------------------------------------------------------
# the CLI, the reference, and a repair
# ---------------------------------------------------------------------------

def test_serve_cli_mesh_matches_unsharded():
    """``launch/serve --mesh-data 1 --mesh-model 2`` starts two ranks
    itself; each serves the unsharded CLI's streams."""
    from repro_torch.launch import serve
    argv = ["--arch", "llama-micro", "--device", "cpu", "--group", "32",
            "--max-len", "64", "--prompt-len", "12", "--max-new", "6",
            "--paged", "--page-size", "8", "--requests", "3"]
    want = serve.main(argv)
    got = serve.main(argv + ["--mesh-data", "1", "--mesh-model", "2"])
    assert len(got["ranks"]) == 2
    for rank in got["ranks"]:
        assert rank["streams"] == [r.out_tokens for r in want["requests"]]
        assert rank["memory"]["weight_bytes"] < want["weight_bytes"]


def test_compare_fp_refuses_audio_before_any_float_weight(monkeypatch):
    from repro_torch.launch import serve

    def no_float(*a, **k):
        raise AssertionError("the float tree was built before the refusal")
    monkeypatch.setattr(serve, "float_lm", no_float)
    monkeypatch.setattr(serve, "init_lm", no_float)
    with pytest.raises(ValueError, match="encoder"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                    "cpu", "--compare-fp", "--group", "32"])


def test_unsharded_engine_agrees_with_jax_engine():
    """The engine the mesh is held to still agrees with the reference's on
    the same packed codes (the cross-framework contract), on this file's
    setup."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.core.quantizer import QuantConfig as JQuantConfig
    from repro.models import build_model
    from repro.serve.engine import Engine as JEngine
    from repro.serve.engine import ServeConfig as JServeConfig
    from repro.serve.quantized import QuantizedModel as JQuantizedModel
    from repro.serve.quantized import quantize_lm_packed
    from repro_torch.bridge import from_jax_params
    jcfg = jget_config("llama-micro")
    jq = JQuantConfig(w_bits=8, a_bits=16, group_size=32, lwc=False,
                      kv_bits=4)
    jp = quantize_lm_packed(build_model(jcfg).init(jax.random.PRNGKey(0)),
                            jcfg, jq)
    jeng = JEngine(JQuantizedModel(jcfg, jq, kernel_mode="ref",
                                   flash_block_kv=PS), jp,
                   JServeConfig(**dataclasses.asdict(scfg(True))))
    jreqs = [jeng.submit(p) for p in prompts()]
    jeng.run(max_steps=600)
    model, _ = served()
    got = _engine_run(model, from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp)), scfg(True), None, prompts())
    assert got["streams"] == [list(r.out_tokens) for r in jreqs]
    assert got["preemptions"] == sum(r.preemptions for r in jreqs)
