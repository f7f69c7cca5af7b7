"""Mesh-native serving of the MoE, recurrent and float-vlm families in the
port (``Engine(mesh=...)`` over gloo), held to the unsharded model.

Contracts, by what a mesh changes:

* The MoE dispatch groups are the reference's (``repro.models.moe.
  _num_groups``): one group a "data" shard, each with its own capacity, so
  a "data" axis changes which tokens drop.  The port's grouped
  ``apply_moe`` is held to the reference's under a patched group count
  (outputs within 1e-5 relative, expert ids equal), and its expert-parallel
  apply (a rank's block of the experts, zero-filled pair rows summed) to
  the whole apply bit for bit.
* The packed MoE (W4A4 g32 kv8) on a mesh: streams, statuses, preemptions
  and prefix hits equal a single-device engine run under the mesh's
  dispatch groups (``sharding.use_mesh``: at data 1 that is the unsharded
  engine), over a preempting pool and with prefix caching.  Its linears
  are the packed kernels' plain versions, whose column slices are the same
  bits, and the experts multiply in blocks of E / ``moe.EXPERT_SPLITS``,
  the same ``torch.bmm`` calls on a rank as on one device.
* The float families (MoE, mamba2, griffin, the vlm with its prefix) sum
  row-split products over "model" (``wo`` / ``w_down``, ``out_proj``,
  ``w_out``), which reorders float sums: teacher-forced logits (the rows
  whole on every rank) within 1e-5 of the largest unsharded logit, and the
  engine's greedy streams counted against the unsharded engine's.
* A rank holds fewer weight bytes where "model" splits the model.

The gloo lane runs each mesh in processes of its own (one torch thread
each), started by :func:`_spawn`; each runs :func:`child_main`, which
imports neither jax nor the reference.
"""
import copy
import dataclasses
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
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kv_cache import pages_for
from repro_torch.serve.quantized import QuantizedModel
from repro_torch.sharding import (cut_segments, make_serving_rules,
                                  use_mesh)

ROOT = os.path.join(os.path.dirname(__file__), "..")
MOE = "qwen3-moe-30b-a3b"
FAMILIES = ("mamba2-1.3b", "recurrentgemma-2b", "paligemma-3b")
PS = 8
LENS = (13, 9, 26, 5)
MAX_NEW = 8
MAX_LEN = -(-(max(LENS) + MAX_NEW + 1) // PS) * PS
FLOAT_TOL = 1e-5
FLOAT_LEN = 12            # equal prompts: teacher-forced as one batch
T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    import torch.distributed as dist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the cases, run unsharded here and on every mesh in the children
# ---------------------------------------------------------------------------

def prompts(lens=LENS, vocab=256, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lens]


def prefix_prompts(vocab=256):
    rng = np.random.default_rng(11)
    system = rng.integers(0, vocab, 19)
    return [np.concatenate([system, rng.integers(0, vocab, n)])
            for n in (5, 9, 13)]


def packed_moe():
    """Reduced qwen3-moe W4A4 g32 kv8 from the seeded init at a capacity
    factor of 0.5: every prefill call drops pairs, so the dispatch groups
    decide which."""
    cfg = dataclasses.replace(get_config(MOE).reduced(), capacity_factor=0.5)
    q = QuantConfig(w_bits=4, a_bits=4, group_size=32, kv_bits=8)
    return (QuantizedModel(cfg, q, device="cpu", block_kv=PS),
            random_packed_lm(cfg, q, 0, "cpu"))


def float_model(arch: str):
    model = Model(get_config(arch).reduced(), "cpu", block_kv=PS)
    return model, model.init(0)


def _engine_run(model, params, cfg, mesh, reqs) -> dict:
    eng = Engine(model, params, cfg, mesh=mesh)
    out = [eng.submit(p) for p in reqs]
    eng.run(max_steps=600)
    eng._kv.verify()
    if cfg.paged:
        assert eng._kv.allocator.num_free == eng._kv.allocator.num_pages
    return {"streams": [list(r.out_tokens) for r in out],
            "statuses": [r.status.name for r in out],
            "preemptions": sum(r.preemptions for r in out),
            "hits": eng.prefix_stats["hits"], "memory": eng.memory_report(),
            "engine": eng}


def _whole_rows(model):
    """``model`` with its rows whole on every rank (teacher-forced calls
    prefill the whole batch into one cache)."""
    if model.tp is None:
        return model
    tp = copy.copy(model.tp)
    tp.batch = False
    return dataclasses.replace(model, tp=tp)


def _forced(model, params) -> torch.Tensor:
    """Teacher-forced logits of 4 seeded prompts of FLOAT_LEN tokens and
    MAX_NEW - 1 seeded decode tokens (the same inputs on every mesh)."""
    rng = np.random.default_rng(3)
    v = model.cfg.vocab_size
    p = T(rng.integers(0, v, (4, FLOAT_LEN)).astype(np.int32))
    g = T(rng.integers(0, v, (4, MAX_NEW)).astype(np.int32))
    return teacher_forced(_whole_rows(model), params, p, g, MAX_NEW - 1,
                          MAX_LEN)


def _prefix_forced(model, params) -> torch.Tensor:
    """The vlm's prefix prefill (its seeded prefix slots + FLOAT_LEN text
    tokens) and 6 teacher-forced decode steps."""
    cfg = model.cfg
    rng = np.random.default_rng(5)
    prefix = T((0.02 * rng.standard_normal((2, cfg.num_prefix, cfg.d_model))
                ).astype(np.float32))
    text = T(rng.integers(0, cfg.vocab_size, (2, FLOAT_LEN)).astype(np.int32))
    gen = T(rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32))
    m = _whole_rows(model)
    with torch.no_grad():
        lg, cache = m.prefill(params, {"tokens": text,
                                       "prefix_embeds": prefix}, MAX_LEN)
        seq = [lg]
        for i in range(gen.shape[1]):
            lg, cache = m.decode_step(params, gen[:, i:i + 1], cache)
            seq.append(lg)
    return torch.cat(seq, 1)


def _packed_cfg(**kw) -> ServeConfig:
    return ServeConfig(**dict(dict(
        max_batch=2, max_len=MAX_LEN, max_new=MAX_NEW, prefill_bucket=16,
        page_size=PS, paged=True, prefill_chunk=PS, watchdog_steps=8,
        num_pages=pages_for(max(LENS) + MAX_NEW, PS) + 1), **kw))


def run_case(case: str, mesh) -> dict:
    """One case on ``mesh`` (None: a single device).  Returns the served
    streams and statuses, the rank's bytes and, for the float cases, the
    teacher-forced logits (``forced``; the vlm's prefix prefill under
    ``prefix``)."""
    if case in ("moe-tight", "moe-prefix"):
        model, params = packed_moe()
        if case == "moe-tight":
            out = _engine_run(model, params, _packed_cfg(), mesh, prompts())
        else:
            out = _engine_run(model, params, _packed_cfg(
                max_len=48, num_pages=0, prefix_cache=True), mesh,
                prefix_prompts())
        eng = out.pop("engine")
        out["experts"] = int(eng.params["layers"]["moe"]["w_up"]
                             .packed.shape[1])
        return out
    model, params = float_model(MOE if case == "moe-float" else case)
    reqs = prompts((FLOAT_LEN,) * 4, model.cfg.vocab_size)
    out = _engine_run(model, params, ServeConfig(
        max_batch=2, max_len=MAX_LEN, max_new=MAX_NEW), mesh, reqs)
    eng = out.pop("engine")
    out["forced"] = _forced(eng.model, eng.params)
    if model.cfg.family == "vlm":
        out["prefix"] = _prefix_forced(eng.model, eng.params)
    return out


CASES = ("moe-tight", "moe-prefix", "moe-float") + FAMILIES
SHAPES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}


def grouped(shape):
    """The single-device run a mesh of ``shape`` is held to: its MoE
    dispatch groups bound (a world-free (names, sizes) mesh)."""
    return use_mesh((("data", "model"), shape), make_serving_rules())


def child_main(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank: join the gloo group, run every case on every mesh shape
    of this world, save the results (``rank<r>.pt``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world
    torch.set_num_threads(1)
    init_world(rank, world, port, "cpu")
    try:
        res = {}
        for shape in SHAPES[world]:
            mesh = make_serving_mesh(*shape, device="cpu")
            for case in CASES:
                # the recurrent and vlm lane runs at data 1 and 2 x 2
                if case in FAMILIES and shape == (2, 1):
                    continue
                res[f"{shape[0]}x{shape[1]}/{case}"] = run_case(case, mesh)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


_CHILD = ("import sys; import test_torch_sharded_families as t; "
          "t.child_main(int(sys.argv[1]), int(sys.argv[2]), "
          "int(sys.argv[3]), sys.argv[4])")


def _spawn(world: int, out: str):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.dirname(__file__)]))
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(r), str(world), str(port), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _collect(procs, out: str) -> dict:
    """Rank 0's results after checking every rank reported the same
    streams, statuses, preemptions and logits."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"))
             for r in range(len(procs))]
    for r, res in enumerate(ranks[1:], 1):
        for key, val in res.items():
            for k, v in val.items():
                if k == "memory":
                    continue
                want = ranks[0][key][k]
                same = torch.equal(v, want) if torch.is_tensor(v) \
                    else v == want
                assert same, (r, key, k)
    return ranks[0]


@pytest.fixture(scope="module")
def runs():
    """The meshes (two worlds, started first) and, while they run, every
    case on one device: unsharded, and under each mesh's groups."""
    with tempfile.TemporaryDirectory() as d2, \
            tempfile.TemporaryDirectory() as d4:
        procs = {2: _spawn(2, d2), 4: _spawn(4, d4)}
        base = {c: run_case(c, None) for c in CASES}
        for shape in ((2, 1), (2, 2)):
            with grouped(shape):
                for c in ("moe-tight", "moe-prefix", "moe-float"):
                    base[f"{shape[0]}x{shape[1]}/{c}"] = run_case(c, None)
        meshes = _collect(procs[2], d2)
        meshes.update(_collect(procs[4], d4))
    return base, meshes


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


# ---------------------------------------------------------------------------
# the grouped dispatch and the expert-parallel apply
# ---------------------------------------------------------------------------

def _moe_inputs(arch: str):
    """A reduced arch's first MoE layer (the reference's seeded init,
    carried across) with its router scaled up 40x, and 2 x 64 seeded
    tokens shifted along expert 0's router column, so routing is skewed and
    capacity drops pairs in every group."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro_torch.bridge import from_jax_params
    jcfg = jget_config(arch).reduced()
    jp = jax.tree_util.tree_map(
        lambda t: np.asarray(t[0]),
        jbuild_model(jcfg).init(jax.random.PRNGKey(0))["layers"]["moe"])
    jp["router"] = jp["router"] * 40.0
    col = jp["router"][:, 0] / np.linalg.norm(jp["router"][:, 0])
    x = (np.random.default_rng(3).standard_normal((2, 64, jcfg.d_model))
         + 3.0 * col).astype(np.float32)
    kw = dict(top_k=jcfg.top_k, capacity_factor=jcfg.capacity_factor,
              act=jcfg.act)
    return jp, from_jax_params(jp), x, kw


@pytest.mark.parametrize("arch", [MOE, "dbrx-132b"])
def test_grouped_dispatch_matches_reference(arch, monkeypatch):
    """g in {1, 2, 4} dispatch groups against the reference's ``apply_moe``
    with ``_num_groups`` patched to g (test-only): expert ids equal,
    outputs within 1e-5 relative; capacity drops pairs, and g 2's output
    differs from g 1's (the group semantics show)."""
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    jp, tp, x, kw = _moe_inputs(arch)
    n, e = x.shape[0] * x.shape[1], tp["router"].shape[-1]
    _, gates, ids = moe.route(tp["router"], T(x).reshape(n, -1), kw["top_k"])
    jprobs = np.asarray(jnp.asarray(x.reshape(n, -1)) @ jp["router"])
    jids = np.argsort(-jprobs, axis=-1, kind="stable")[:, :kw["top_k"]]
    np.testing.assert_array_equal(ids.numpy(), jids)
    outs = {}
    for g in (1, 2, 4):
        monkeypatch.setattr(jmoe, "_num_groups", lambda _n, g=g: g)
        jy = T(np.array(jmoe.apply_moe(jp, jnp.asarray(x), **kw)[0]))
        outs[g] = moe.apply_moe(tp, T(x), groups=g, **kw)[0]
        assert _rel(outs[g], jy) < 1e-5, g
        ng = n // g
        cap = moe.capacity(ng, kw["top_k"], e, kw["capacity_factor"])
        dropped = sum(int((moe._dispatch_group(
            T(x).reshape(n, -1)[i:i + ng], gates[i:i + ng], ids[i:i + ng],
            e, kw["top_k"], cap)[3] < 0).sum()) for i in range(0, n, ng))
        assert dropped, f"no pair dropped at g={g}"
    assert not torch.equal(outs[1], outs[2])


@pytest.mark.parametrize("arch", [MOE, "dbrx-132b"])
def test_expert_parallel_apply_is_the_whole_apply(arch):
    """m in {2, 4} simulated ranks, each with its contiguous E / m experts:
    the zero-filled pair rows of every rank summed give the whole apply's
    output bit for bit, at g 1 and 2."""
    _, tp, x, kw = _moe_inputs(arch)
    e = tp["router"].shape[-1]
    for g in (1, 2):
        whole = moe.apply_moe(tp, T(x), groups=g, **kw)[0]
        for m in (2, 4):
            blk = e // m
            parts = [None] * m

            def keep(rows, r):
                parts[r] = rows
                return rows

            local = [{k: (v if k == "router" else v[r * blk:(r + 1) * blk])
                      for k, v in tp.items()} for r in range(m)]
            for r in range(m):
                moe.apply_moe(local[r], T(x), groups=g, first_expert=r * blk,
                              reduce=lambda rows, r=r: keep(rows, r), **kw)
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            for r in range(m):
                got = moe.apply_moe(local[r], T(x), groups=g,
                                    first_expert=r * blk,
                                    reduce=lambda rows: total, **kw)[0]
                assert torch.equal(got, whole), (g, m, r)


def test_mamba2_cut_reassembles_the_leaves():
    """mamba2's component-aware cut at "model" 2 and 4: each rank's
    ``in_proj``, ``conv_w``, ``conv_b``, per-head leaves and conv state
    hold its heads' z / x / dt with B and C whole; the pieces of every
    rank, component by component, reassemble the whole leaf."""
    from repro_torch.serve.tensor_parallel import TensorParallel
    cfg = get_config("mamba2-1.3b").reduced()
    model = Model(cfg, "cpu")
    leaves = dict(model.init(0)["layers"],
                  conv_state=torch.randn(model.init_cache(2, 16)["conv"]
                                         .shape))
    h, di, gn = cfg.ssm_heads, cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    # (width, cut by heads) of each component, in order
    layout = {"in_proj": ((di, True), (di, True), (gn, False), (gn, False),
                          (h, True)),
              "a_log": ((h, True),)}
    xbc = ((di, True), (gn, False), (gn, False))

    class Rank:                        # a (1, m) mesh's coordinates
        mesh_dim_names = ("data", "model")

        def __init__(self, m, r):
            self.mesh, self.r = torch.empty((1, m)), r

        def get_coordinate(self):
            return [0, self.r]

    for m in (2, 4):
        tp = TensorParallel.__new__(TensorParallel)
        tp.m, tp.rec = m, True
        segs = dict(model.param_cuts(tp)["layers"],
                    conv_state=model.cache_cuts(tp)["conv"])
        for name in ("in_proj", "conv_w", "conv_b", "a_log", "conv_state"):
            whole = leaves[name]
            pieces = [cut_segments(whole, segs[name], Rank(m, r))
                      for r in range(m)]
            rebuilt, at = [], 0
            for width, by_heads in layout.get(name, xbc):
                local = width // m if by_heads else width
                comp = [p[..., at:at + local] for p in pieces]
                if by_heads:
                    rebuilt.append(torch.cat(comp, -1))
                else:
                    assert all(torch.equal(c, comp[0]) for c in comp), name
                    rebuilt.append(comp[0])
                at += local
            assert all(p.shape[-1] == at for p in pieces), name
            assert torch.equal(torch.cat(rebuilt, -1), whole), (name, m)


# ---------------------------------------------------------------------------
# in-process: a 1 x 1 mesh serves every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["moe-float"] + list(FAMILIES))
def test_family_serves_on_mesh(runs, case):
    """qwen3-moe (float), mamba2, recurrentgemma and paligemma (float,
    with its prefix prefill) served through a 1 x 1 in-process mesh: the
    streams and the teacher-forced logits equal mesh=None's bit for bit."""
    base = runs[0][case]
    got = run_case(case, make_serving_mesh(1, 1, device="cpu"))
    assert got["streams"] == base["streams"]
    assert got["statuses"] == base["statuses"]
    for key in ("forced", "prefix"):
        if key in base:
            assert torch.equal(got[key], base[key]), key
    assert got["memory"] == dict(base["memory"], device_count=1)


# ---------------------------------------------------------------------------
# the gloo lane
# ---------------------------------------------------------------------------

def _want(base: dict, shape: str, case: str) -> dict:
    """A mesh's single-device run: unsharded at data 1, else under the
    mesh's dispatch groups."""
    return base[case] if shape.startswith("1x") else base[f"{shape}/{case}"]


@pytest.mark.parametrize("shape", ["1x2", "2x1", "2x2"])
def test_packed_moe_on_mesh_streams_equal(runs, shape):
    """Packed W4A4 MoE: a preempting pool and prefix caching; streams,
    statuses, preemptions and hits equal the single-device run with the
    mesh's dispatch groups; a rank holds E / model experts a layer."""
    base, meshes = runs
    for case in ("moe-tight", "moe-prefix"):
        got, want = meshes[f"{shape}/{case}"], _want(base, shape, case)
        for key in ("streams", "statuses", "preemptions", "hits"):
            assert got[key] == want[key], (case, key)
        assert got["experts"] == want["experts"] // int(shape[-1])
    assert base["moe-tight"]["preemptions"] > 0
    assert meshes[f"{shape}/moe-prefix"]["hits"] >= 1


def test_data_axis_changes_which_tokens_drop(runs):
    """The reference's caveat, shown: the same requests under a "data" axis
    of 2 dispatch in two groups with their own capacity, and the packed
    streams move."""
    base = runs[0]
    assert base["2x1/moe-tight"]["streams"] != base["moe-tight"]["streams"]


@pytest.mark.parametrize("shape", ["1x2", "2x1", "2x2"])
def test_float_moe_on_mesh_within_logit_tolerance(runs, shape):
    base, meshes = runs
    got, want = meshes[f"{shape}/moe-float"], _want(base, shape, "moe-float")
    assert _rel(got["forced"], base["moe-float"]["forced"]) <= FLOAT_TOL
    agree = np.mean(np.array(got["streams"]) == np.array(want["streams"]))
    assert agree >= 0.9, agree


@pytest.mark.parametrize("arch", FAMILIES)
def test_recurrent_and_vlm_on_mesh_within_logit_tolerance(runs, arch):
    """mamba2 (SSD heads over "model"), griffin (rnn channels; its MQA
    attention whole) and the vlm (with its prefix prefill) at (1, 2) and
    (2, 2): teacher-forced logits within 1e-5, greedy streams counted."""
    base, meshes = runs
    for shape in ("1x2", "2x2"):
        got = meshes[f"{shape}/{arch}"]
        for key in ("forced", "prefix"):
            if key in base[arch]:
                assert _rel(got[key], base[arch][key]) <= FLOAT_TOL, (
                    shape, key)
        agree = np.mean(np.array(got["streams"])
                        == np.array(base[arch]["streams"]))
        assert agree >= 0.9, (shape, agree)


def test_per_rank_bytes_shrink_with_model(runs):
    """Every family's rank at "model" 2 holds fewer weight and cache bytes
    than one device; "data" alone replicates the weights."""
    base, meshes = runs
    for case in CASES:
        one, two = base[case]["memory"], meshes[f"1x2/{case}"]["memory"]
        assert two["device_count"] == 2
        assert two["weight_bytes"] < one["weight_bytes"], case
        if case in ("mamba2-1.3b", "recurrentgemma-2b"):
            assert two["kv_bytes"] < one["kv_bytes"], case
    assert meshes["2x1/moe-tight"]["memory"]["weight_bytes"] == \
        base["moe-tight"]["memory"]["weight_bytes"]
