"""Sharded training of the dense trunk in the port: FSDP over "data",
tensor parallelism over "model" and the int8 gradient reduction
(``repro_torch.train.parallel``, ``optim/compression.py``), held against
the reference's unsharded ``repro.train.step.make_train_step`` on the same
numpy params and batches.

The gloo lane runs each world in plain subprocesses (one torch thread a
rank) started with ``torch.distributed.run``'s environment, which join the
group through the launcher's own ``launch.mesh.init_from_env``; each runs
:func:`child_main` of this module, which imports neither jax nor the
reference.  A world of 2 runs (1, 2) and (2, 1), a world of 4 runs (2, 2);
the reference's steps run in this process meanwhile.  Archs: llama-micro,
opt-micro (LayerNorm, qkv biases) and gemma-2b ``reduced(tie_embeddings=
False)``, whose one KV head "model" does not divide (attention on q/k/v
gathered whole, ``wk`` / ``wv`` split inside the head) and whose untied
head splits the vocabulary.

Bounds are ``tests/test_torch_train.py``'s: the first step (lr_scale 0:
the moments carry the gradients) loss and grad norm ``rtol 1e-5``, every
leaf within 1e-5 of its largest magnitude; five steps, each loss within
1e-4 relative and every leaf within 1e-4.  OPT's key bias has a zero
gradient in exact arithmetic (a shift every key shares cancels in the
softmax), so both packages hold rounding noise there: its moments are
held to zero against the tree's largest moment, and after five steps its
params (moved by about lr sign(noise) a step) to within the steps' summed
learning rates.  The same caveat reaches a single element of gemma's
embedding: at (126, 24) its gradient nearly cancels (first moment 2.2e-6
of the leaf's largest, 3.2% apart between the packages), and after five
steps it lies 1.08e-4 of the leaf's largest magnitude from the
reference's, in the unsharded port and on (2, 1) alike (ROADMAP queue 3).
So after five steps a parameter element whose reference first moment is
below 1e-4 of its leaf's largest is held to the learning-rate budget
instead; such elements are counted and must stay under 1e-3 of the
leaves.  Inside the port a 1 x 1 mesh is the unsharded step bit for
bit, replicated leaves are bit-equal on every rank that holds them, and a
killed and resumed mesh run is bit-equal to an uninterrupted one.

The reference's ``make_int8_psum`` does not run under this jax
(``shard_map`` lost ``check_vma``), so the port's is held to a numpy
transcription of its arithmetic (``compression.py:35-48, :57-63``).
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.data import MarkovCorpus, make_batch_fn
from repro_torch.launch.mesh import free_port, make_mesh
from repro_torch.models.init import init_lm
from repro_torch.models.model import build_model
from repro_torch.optim import AdamConfig, adam_init
from repro_torch.optim.compression import int8_codes
from repro_torch.train import checkpoints
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.parallel import MeshTraining
from repro_torch.train.step import TrainState, make_train_step

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("llama-micro", "opt-micro", "gemma-2b")
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
LR, WARMUP, TOTAL, STEPS = 3e-3, 2, 10, 5
BATCH, SEQ = 8, 32
TOL1, TOL5 = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread here, and no world of one left behind by the
    in-process 1 x 1 meshes."""
    import torch.distributed as dist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# shared by both sides (no jax)
# ---------------------------------------------------------------------------

def port_cfg(arch: str, **over):
    cfg = get_config(arch)
    if arch == "gemma-2b":
        cfg = cfg.reduced(tie_embeddings=False)
    return dataclasses.replace(cfg, **over)


def numpy_params(cfg, seed: int = 0) -> dict:
    """Seeded numpy params in the tree both packages train: fan-in
    normal weights, normal(0.02) embeddings and biases, norm scales near
    1 (drawn in sorted-key order, the same bits in every process)."""
    shapes = init_lm(cfg, torch.Generator().manual_seed(0), "meta")
    rng = np.random.default_rng(seed)

    def draw(node, name):
        if isinstance(node, dict):
            return {k: draw(node[k], k) for k in sorted(node)}
        shape = tuple(node.shape)
        z = rng.standard_normal(shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif name == "head" or len(shape) == 3:      # (stacked) weights
            z = z / np.sqrt(shape[-2])
        else:                                        # embeddings, biases
            z = 0.02 * z
        return z.astype(np.float32)
    return draw(shapes, "")


def batches(cfg) -> list:
    fn = make_batch_fn(MarkovCorpus(cfg.vocab_size, branching=4,
                                    buckets=128, seed=0), BATCH, SEQ)
    return [fn(i)["tokens"] for i in range(STEPS + 1)]


def port_state(model, cfg, mesh=None) -> TrainState:
    """The numpy params through the bridge, zero moments; on ``mesh``
    this rank's shards."""
    adam = AdamConfig(lr=LR)
    params = from_jax_params(numpy_params(cfg))
    if mesh is not None:
        params = MeshTraining(model, mesh).shard_params(params)
    return TrainState(params, adam_init(params, adam),
                      torch.tensor(0, dtype=torch.int32))


def flat(state) -> dict:
    return {k: a for k, (a, _) in checkpoints.flatten(state).items()}


def run_steps(model, state, step_fn, toks, n: int) -> tuple:
    """(state after step 1, state after step n, [(loss, grad norm)])."""
    first, hist = None, []
    for i in range(n):
        state, m = step_fn(state, {"tokens": torch.from_numpy(toks[i])})
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            first = state
    return first, state, hist


def spec_keys(mt: MeshTraining) -> dict:
    """{checkpoint key: spec} of a TrainState's leaves."""
    out = {"1||count": (), "2": ()}

    def walk(spec, path):
        if isinstance(spec, dict):
            for k, v in spec.items():
                walk(v, path + (k,))
            return
        for pre in ("0", "1||mu", "1||nu"):
            out["||".join((pre,) + path)] = spec
    walk(mt.specs, ())
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _mesh_runs(rank, shape, out: dict) -> None:
    """Every arch's five steps on ``shape``; rank 0 keeps the whole
    states, every rank its local leaves' bytes and its state bytes."""
    from repro_torch.train.parallel import state_bytes
    mesh = make_mesh(*shape, device="cpu")
    tag = f"{shape[0]}x{shape[1]}"
    for arch in ARCHS:
        cfg = port_cfg(arch)
        model = build_model(cfg, "cpu")
        mt = MeshTraining(model, mesh)
        step = make_train_step(model, AdamConfig(lr=LR), TOTAL, WARMUP,
                               mesh=mesh)
        first, last, hist = run_steps(model, port_state(model, cfg, mesh),
                                      step, batches(cfg), STEPS)
        res = {"hist": hist, "bytes": state_bytes(last),
               "local": {k: a.tobytes() for k, a in flat(last).items()},
               "specs": spec_keys(mt), "coord": mt.coord}
        whole = [flat(mt.unshard(s)) for s in (first, last)]
        if rank == 0:
            res["first"], res["last"] = whole
        out[f"{tag}/{arch}"] = res


def _loop(model, mesh, ckpt: str, total: int):
    """The loop to ``total`` steps from the numpy params, a checkpoint
    every 2 steps into ``ckpt`` (resuming from its latest)."""
    toks = batches(model.cfg)
    sharding = None if mesh is None else MeshTraining(model, mesh)
    step_fn = make_train_step(model, AdamConfig(lr=LR), TOTAL, WARMUP,
                              mesh=mesh)
    return train_loop(port_state(model, model.cfg, mesh), step_fn,
                      lambda i: {"tokens": torch.from_numpy(toks[i])},
                      LoopConfig(total_steps=total, ckpt_every=2,
                                 ckpt_dir=ckpt, keep=5), sharding=sharding)


def _world2_extras(rank: int, out: dict, tmp: str) -> None:
    """(2, 1): kill and resume, the int8 reduction, the masked loss;
    (1, 2): the launcher's --mesh host."""
    import torch.distributed as dist

    from repro_torch.launch import train as launch_train
    from repro_torch.optim.compression import make_int8_psum
    mesh = make_mesh(2, 1, device="cpu")
    cfg = port_cfg("llama-micro")
    model = build_model(cfg, "cpu")
    # a run killed after step 2's checkpoint and launched again unchanged
    _loop(model, mesh, os.path.join(tmp, "run"), 4)
    if rank == 0:
        shutil.copytree(os.path.join(tmp, "run"), os.path.join(tmp, "kill"))
        shutil.rmtree(os.path.join(tmp, "kill", "step_00000004"))
    dist.barrier()
    _loop(model, mesh, os.path.join(tmp, "kill"), 4)
    # the int8 reduction: distinct leaves per rank, then one shared leaf
    compress = make_int8_psum(mesh, axes=("pod", "data"))
    mine = int8_leaves(rank)
    out["int8/distinct"] = {k: v.numpy() for k, v in
                            compress(mine).items()}
    out["int8/shared"] = {k: v.numpy() for k, v in
                          compress(int8_leaves(0)).items()}
    # five steps with the int8 reduction in place of the float mean
    step = make_train_step(model, AdamConfig(lr=LR), TOTAL, WARMUP,
                           compress_grads=compress, mesh=mesh)
    out["int8/hist"] = run_steps(model, port_state(model, cfg, mesh), step,
                                 batches(cfg), STEPS)[2]
    # a mask: each rank's loss and gradient weigh by its share of tokens
    out["mask"] = masked_step(model, cfg, mesh)
    # launch/train --mesh host is the API's (1, 2) run
    args = launch_train.build_parser().parse_args(
        CLI + ["--ckpt-dir", os.path.join(tmp, "cli")])
    got = launch_train.train(args)
    api = api_run(make_mesh(1, 2, device="cpu"))
    out["cli"] = {"cli": flat(got["sharding"].unshard(got["state"])),
                  "api": flat(api), "final": got["final_loss"],
                  "sizes": got["sharding"].sizes}


def _world4_extras(rank: int, out: dict, tmp: str) -> None:
    """(2, 2): microbatches and remat against the plain step; checkpoints
    written on (2, 2) and resumed from (1, 1)."""
    import torch.distributed as dist
    mesh = make_mesh(2, 2, device="cpu")
    cfg = port_cfg("llama-micro")
    toks = batches(cfg)
    adam = AdamConfig(lr=LR)
    model = build_model(cfg, "cpu")
    state = run_steps(model, port_state(model, cfg, mesh), make_train_step(
        model, adam, TOTAL, WARMUP, mesh=mesh), toks, 2)[1]
    probe = {"tokens": torch.from_numpy(toks[2])}
    mt = MeshTraining(model, mesh)
    for tag, over in (("plain", {}), ("micro2", {"microbatches": 2}),
                      ("remat", {"remat": True})):
        other = build_model(port_cfg("llama-micro", **over), "cpu")
        new, m = make_train_step(other, adam, TOTAL, WARMUP, mesh=mesh)(
            state, probe)
        whole = flat(mt.unshard(new))
        if rank == 0:
            out[f"variant/{tag}"] = {"loss": float(m["loss"]),
                                     "state": whole}
    # a "pod" axis: the rows and the reductions over ("pod", "data"),
    # FSDP over "data" alone
    pods = make_mesh(2, 1, pods=2, device="cpu")
    run = run_steps(model, port_state(model, cfg, pods), make_train_step(
        model, adam, TOTAL, WARMUP, mesh=pods), toks, STEPS)
    whole = flat(MeshTraining(model, pods).unshard(run[1]))
    if rank == 0:
        out["pod"] = {"hist": run[2], "last": whole}
    # (2, 2) -> a checkpoint every 2 steps, to step 4
    _loop(model, mesh, os.path.join(tmp, "w22"), 4)
    # (1, 1) -> step 2, resumed on (2, 2) to step 4
    if rank == 0:
        _loop(model, None, os.path.join(tmp, "w11"), 4)
        shutil.copytree(os.path.join(tmp, "w11"), os.path.join(tmp, "r22"))
        shutil.rmtree(os.path.join(tmp, "r22", "step_00000004"))
    dist.barrier()
    _loop(model, mesh, os.path.join(tmp, "r22"), 4)


CLI = ["--arch", "llama-micro", "--device", "cpu", "--steps", "4",
       "--global-batch", "8", "--seq", "16", "--lr", "3e-3",
       "--ckpt-every", "2", "--mesh", "host"]


def api_run(mesh):
    """The launcher's run built from the API on ``mesh``: its corpus,
    seed-0 init and schedule (the whole final state)."""
    from repro_torch.train.step import init_train_state
    cfg = get_config("llama-micro")
    model = build_model(cfg, "cpu")
    adam = AdamConfig(lr=3e-3)
    fn = make_batch_fn(MarkovCorpus(cfg.vocab_size, seed=0), 8, 16)
    state = init_train_state(model, 0, adam, mesh=mesh)
    step = make_train_step(model, adam, 4, 5, mesh=mesh)
    state = train_loop(state, step, lambda i: {"tokens": torch.from_numpy(
        fn(i)["tokens"])}, LoopConfig(total_steps=4, ckpt_dir=""),
        sharding=MeshTraining(model, mesh))
    return MeshTraining(model, mesh).unshard(state)


def masked_step(model, cfg, mesh) -> dict:
    """The first step (lr_scale 0: the moments carry the gradients) with
    a mask that leaves the ranks different token counts; (loss, grad norm,
    whole state)."""
    toks = batches(cfg)[0]
    mask = np.ones((BATCH, SEQ - 1), np.float32)
    mask[:BATCH // 2, SEQ // 3:] = 0.0     # the first data rank's rows
    batch = {"tokens": torch.from_numpy(toks), "mask": torch.from_numpy(mask)}
    step = make_train_step(model, AdamConfig(lr=LR), TOTAL, WARMUP,
                           mesh=mesh)
    new, m = step(port_state(model, cfg, mesh), batch)
    if mesh is not None:
        new = MeshTraining(model, mesh).unshard(new)
    return {"loss": float(m["loss"]), "state": flat(new),
            "grad_norm": float(m["grad_norm"])}


def int8_leaves(rank: int) -> dict:
    """Leaves of one rank for the int8 reduction: gaussian, a row with a
    spike, a zero leaf, and values on code midpoints (round half to
    even)."""
    rng = np.random.default_rng(100 + rank)
    spiky = rng.standard_normal((8, 16)).astype(np.float32)
    spiky[3, 5] = 40.0
    halves = (np.arange(-6, 7, dtype=np.float32) + 0.5) / 127.0
    halves[-1] = 6.5 / 127.0 * (rank + 1)
    return {"gauss": torch.from_numpy(rng.standard_normal((4, 24)).astype(
        np.float32)), "spiky": torch.from_numpy(spiky),
        "zero": torch.zeros(5), "halves": torch.from_numpy(halves)}


def child_main(tmp: str) -> None:
    """One rank: join the world described by the environment, run every
    mesh of the world and its extras, write ``rank<r>.pt``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_from_env
    torch.set_num_threads(1)
    world = init_from_env("cpu")
    rank = dist.get_rank()
    out: dict = {}
    try:
        for shape in MESHES[world]:
            _mesh_runs(rank, shape, out)
        (_world2_extras if world == 2 else _world4_extras)(rank, out, tmp)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


_CHILD = ("import sys; import test_torch_sharded_train as t; "
          "t.child_main(sys.argv[1])")


def _spawn(world: int, tmp: str) -> list:
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(ROOT, "src"), os.path.dirname(__file__)]),
            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
            MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD, tmp], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _collect(procs, tmp: str) -> list:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


# ---------------------------------------------------------------------------
# the reference (this process)
# ---------------------------------------------------------------------------

def reference_runs() -> dict:
    """Each arch's five reference steps on the numpy params: (state after
    step 1, after step 5, [(loss, grad norm)]) as flat numpy trees."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro.optim import adam as jadam
    from repro.train import checkpoints as jckpt
    from repro.train.step import TrainState as JTrainState
    from repro.train.step import make_train_step as jmake_train_step
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch)
        if arch == "gemma-2b":
            jcfg = jcfg.reduced(tie_embeddings=False)
        jc = jadam.AdamConfig(lr=LR)
        step = jax.jit(jmake_train_step(jbuild_model(jcfg), jc, TOTAL,
                                        WARMUP))
        params = jax.tree_util.tree_map(jnp.asarray,
                                        numpy_params(port_cfg(arch)))
        state = JTrainState(params, jadam.adam_init(params, jc),
                            jnp.int32(0))
        hist, first = [], None
        for i, toks in enumerate(batches(port_cfg(arch))[:STEPS]):
            state, m = step(state, {"tokens": jnp.asarray(toks)})
            hist.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                first = {k: np.asarray(v)
                         for k, v in jckpt._flatten(state).items()}
        out[arch] = (first, {k: np.asarray(v) for k, v in
                             jckpt._flatten(state).items()}, hist)
    return out


@pytest.fixture(scope="module")
def runs():
    """The worlds of 2 and 4 ranks started first, the reference's steps
    run meanwhile; {world: every rank's results}, the reference's, and the
    ranks' checkpoint directories."""
    tmp = {w: tempfile.mkdtemp(prefix=f"sharded-train-{w}-") for w in MESHES}
    try:
        procs = {w: _spawn(w, tmp[w]) for w in MESHES}
        ref = reference_runs()
        ranks = {w: _collect(procs[w], tmp[w]) for w in MESHES}
        yield {"ranks": ranks, "ref": ref, "tmp": tmp}
    finally:
        for d in tmp.values():
            shutil.rmtree(d, ignore_errors=True)


def _close(got: dict, want: dict, rel: float, skip=()) -> None:
    """Same keys; each leaf within ``rel`` of its largest magnitude."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if any(k.endswith(s) for s in skip):
            continue
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == w.shape, k
        tol = rel * np.abs(w).max()
        assert np.abs(g - w).max() <= tol, (k, np.abs(g - w).max(), tol)


def _zero_grad_bias(got: dict, want: dict) -> None:
    """OPT's key bias: its moments within 1e-6 of the tree's largest
    moment (noise on both sides)."""
    for kind in ("||mu||", "||nu||"):
        top = max(np.abs(v).max() for k, v in want.items() if kind in k)
        for k in want:
            if kind in k and k.endswith("||bk"):
                assert np.abs(got[k]).max() <= 1e-6 * top, k


def _lr_budget(steps: int) -> float:
    """The largest total an Adam update of about lr sign(g) moves a
    parameter over ``steps`` steps (lr_scale <= 1)."""
    return 2 * LR * steps


# ---------------------------------------------------------------------------
# a world of one, in process
# ---------------------------------------------------------------------------

def test_one_by_one_mesh_is_the_unsharded_step_bit_for_bit():
    mesh = make_mesh(1, 1, device="cpu")
    for arch in ARCHS:
        cfg = port_cfg(arch)
        model = build_model(cfg, "cpu")
        toks = batches(cfg)
        plain = run_steps(model, port_state(model, cfg), make_train_step(
            model, AdamConfig(lr=LR), TOTAL, WARMUP), toks, 3)
        meshed = run_steps(model, port_state(model, cfg, mesh),
                           make_train_step(model, AdamConfig(lr=LR), TOTAL,
                                           WARMUP, mesh=mesh), toks, 3)
        assert plain[2] == meshed[2], arch
        a, b = flat(plain[1]), flat(meshed[1])
        assert all(np.array_equal(a[k], b[k]) for k in a), arch


# ---------------------------------------------------------------------------
# the gloo lane against the reference
# ---------------------------------------------------------------------------

SHAPES = ["1x2", "2x1", "2x2"]


def _rank0(runs, shape: str) -> dict:
    return runs["ranks"][4 if shape == "2x2" else 2][0]


@pytest.mark.parametrize("shape", SHAPES)
def test_first_step_matches_reference(runs, shape):
    for arch in ARCHS:
        got = _rank0(runs, shape)[f"{shape}/{arch}"]
        want_first, _, want_hist = runs["ref"][arch]
        np.testing.assert_allclose(got["hist"][0], want_hist[0], rtol=TOL1,
                                   err_msg=f"{shape} {arch}")
        zero = ("||bk",) if arch == "opt-micro" else ()
        if zero:
            _zero_grad_bias(got["first"], want_first)
        _close(got["first"], want_first, TOL1, skip=zero)


@pytest.mark.parametrize("shape", SHAPES)
def test_five_steps_track_reference(runs, shape):
    for arch in ARCHS:
        got = _rank0(runs, shape)[f"{shape}/{arch}"]
        _, want_last, want_hist = runs["ref"][arch]
        np.testing.assert_allclose([h[0] for h in got["hist"]],
                                   [h[0] for h in want_hist], rtol=TOL5,
                                   err_msg=f"{shape} {arch}")
        zero = ("||bk",) if arch == "opt-micro" else ()
        params = tuple(k for k in want_last if k.startswith("0||"))
        _close(got["last"], want_last, TOL5, skip=zero + params)
        near = 0
        for k in params:
            w = want_last[k].astype(np.float64)
            d = np.abs(got["last"][k].astype(np.float64) - w)
            assert d.max() <= _lr_budget(STEPS), k
            if zero and k.endswith(zero[0]):
                continue
            mu = np.abs(want_last["1||mu||" + k[3:]])
            cancels = mu < 1e-4 * mu.max()
            near += int(np.sum(cancels & (d > TOL5 * np.abs(w).max())))
            assert np.all(d[~cancels] <= TOL5 * np.abs(w).max()), (arch, k)
        size = sum(want_last[k].size for k in params)
        assert near <= 1e-3 * size, (shape, arch, near)


@pytest.mark.parametrize("shape", SHAPES)
def test_replicated_leaves_bit_equal_on_every_rank(runs, shape):
    """After five steps, ranks that hold the same block of a leaf (equal
    coordinates on the axes its spec splits) hold the same bytes."""
    ranks = runs["ranks"][4 if shape == "2x2" else 2]
    checked = 0
    for arch in ARCHS:
        res = [r[f"{shape}/{arch}"] for r in ranks]
        for key, spec in res[0]["specs"].items():
            axes = {a for e in spec if e is not None
                    for a in ((e,) if isinstance(e, str) else e)}
            groups: dict = {}
            for r in res:
                block = tuple(sorted((a, c) for a, c in r["coord"].items()
                                     if a in axes))
                groups.setdefault(block, set()).add(r["local"][key])
            assert all(len(v) == 1 for v in groups.values()), (shape, arch,
                                                               key)
            checked += len(ranks) > len(groups)
    assert checked > 0


def test_per_rank_state_bytes_shrink_with_the_mesh(runs):
    for arch in ARCHS:
        cfg = port_cfg(arch)
        whole = 3 * 4 * sum(a.size for a in _leaves(numpy_params(cfg)))
        b = {s: sum(_rank0(runs, s)[f"{s}/{arch}"]["bytes"].values())
             for s in SHAPES}
        assert b["2x2"] < min(b["1x2"], b["2x1"]) < whole, (arch, b)
        # every leaf but the norm scales (and OPT's biases) is cut by d m
        assert b["2x2"] <= 0.3 * whole, (arch, b, whole)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_microbatches_and_remat_on_2x2_equal_the_plain_step(runs):
    r0 = runs["ranks"][4][0]
    plain = r0["variant/plain"]
    for tag in ("micro2", "remat"):
        got = r0[f"variant/{tag}"]
        assert abs(got["loss"] - plain["loss"]) <= TOL1 * plain["loss"], tag
        _close(got["state"], plain["state"], TOL1)
    # remat recomputes the same collectives: the same bits
    assert r0["variant/remat"]["loss"] == plain["loss"]


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_kill_and_resume_on_2x1_is_bit_equal(runs):
    tmp = runs["tmp"][2]
    a = _npz(os.path.join(tmp, "run", "step_00000004", "arrays.npz"))
    b = _npz(os.path.join(tmp, "kill", "step_00000004", "arrays.npz"))
    assert sorted(a) == sorted(b)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


def test_checkpoints_reshard_between_2x2_and_1x1(runs):
    """A (2, 2) checkpoint resumes on (1, 1), the reference reads it, and
    a (1, 1) checkpoint resumes on (2, 2)."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro.optim import adam as jadam
    from repro.train import checkpoints as jckpt
    from repro.train.step import init_train_state as jinit_train_state
    tmp = runs["tmp"][4]
    src = os.path.join(tmp, "w22")
    dst = os.path.join(tmp, "r11")
    shutil.copytree(src, dst)
    shutil.rmtree(os.path.join(dst, "step_00000004"))
    cfg = port_cfg("llama-micro")
    model = build_model(cfg, "cpu")
    mesh = make_mesh(1, 1, device="cpu")
    _loop(model, mesh, dst, 4)
    want = _npz(os.path.join(src, "step_00000004", "arrays.npz"))
    got = _npz(os.path.join(dst, "step_00000004", "arrays.npz"))
    _close(got, want, TOL5)
    # the reference restores the (2, 2) run's whole TrainState
    jlike = jinit_train_state(jbuild_model(jget_config("llama-micro")),
                              jax.random.PRNGKey(0), jadam.AdamConfig())
    jstate, step = jckpt.restore(src, jlike)
    assert step == 4 and int(jstate.step) == 4
    flat_ref = jckpt._flatten(jstate)
    assert all(np.array_equal(flat_ref[k], v) for k, v in want.items())
    # (1, 1) -> step 2, resumed on (2, 2) to step 4
    want = _npz(os.path.join(tmp, "w11", "step_00000004", "arrays.npz"))
    got = _npz(os.path.join(tmp, "r22", "step_00000004", "arrays.npz"))
    _close(got, want, TOL5)


def test_pod_axis_tracks_reference(runs):
    """(pod 2, data 2, model 1): the rows and the gradient mean over
    ("pod", "data"), FSDP over "data" alone; five steps at the five-step
    bounds."""
    got = runs["ranks"][4][0]["pod"]
    _, want_last, want_hist = runs["ref"]["llama-micro"]
    np.testing.assert_allclose([h[0] for h in got["hist"]],
                               [h[0] for h in want_hist], rtol=TOL5)
    _close(got["last"], want_last, TOL5)


# ---------------------------------------------------------------------------
# the int8 reduction
# ---------------------------------------------------------------------------

def np_codes(g: np.ndarray) -> tuple:
    """``compression.py:35-36`` in numpy: (int8 codes, float32 scale)."""
    scale = np.maximum(np.max(np.abs(g)), np.float32(1e-12)) / \
        np.float32(127.0)
    return np.clip(np.round(g / scale), -127, 127).astype(np.int8), scale


def np_int8_psum(per_rank: list) -> np.ndarray:
    """``compression.py:37-48, :57-63`` in numpy over the ranks' leaves:
    the codes summed in int32, the scales summed, ``total * (s / n)``,
    then ``/ n``."""
    codes = [np_codes(g) for g in per_rank]
    total = sum(q.astype(np.int32) for q, _ in codes)
    s = codes[0][1]
    for _, sc in codes[1:]:
        s = s + sc
    n = np.float32(len(per_rank))
    return (total.astype(np.float32) * (s / n)) / n


def test_int8_codes_are_the_reference_arithmetic():
    leaves = [*int8_leaves(0).values(), *int8_leaves(1).values()]
    leaves.append(torch.linspace(-1.0, 1.0, 255))
    for g in leaves:
        q, s = int8_codes(g)
        wq, ws = np_codes(g.numpy())
        assert q.dtype == torch.int8 and q.numpy().tobytes() == wq.tobytes()
        assert s.dtype == torch.float32 and s.numpy().tobytes() == \
            np.float32(ws).tobytes()
    # round half to even on exact midpoints
    q, _ = int8_codes(torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0]))
    assert q.tolist() == [0, 2, 2, 0, 127]


def test_int8_psum_on_2x1_is_the_transcription(runs):
    r0 = runs["ranks"][2][0]
    per_rank = [{k: v.numpy() for k, v in int8_leaves(r).items()}
                for r in range(2)]
    for k in per_rank[0]:
        want = np_int8_psum([p[k] for p in per_rank])
        assert r0["int8/distinct"][k].tobytes() == want.tobytes(), k
        # one leaf on every rank: that leaf quantized and dequantized
        q, s = np_codes(per_rank[0][k])
        assert r0["int8/shared"][k].tobytes() == \
            (q.astype(np.float32) * s).tobytes(), k


def test_int8_losses_beside_float_on_2x1(runs, capsys):
    r0 = runs["ranks"][2][0]
    comp = [h[0] for h in r0["int8/hist"]]
    plain = [h[0] for h in r0["2x1/llama-micro"]["hist"]]
    with capsys.disabled():
        print(f"\n(2, 1) llama-micro five-step losses, int8 reduction "
              f"{comp} vs float mean {plain}")
    assert all(np.isfinite(comp))
    assert comp[0] == plain[0]          # the loss precedes the reduction
    np.testing.assert_allclose(comp, plain, rtol=1e-2)


# ---------------------------------------------------------------------------
# the mask, the launcher, refusals
# ---------------------------------------------------------------------------

def test_masked_loss_weighs_ranks_by_their_tokens(runs):
    """On (2, 1) the ranks hold 4 x 10 and 4 x 31 valid tokens: the
    mesh's loss and step are the unsharded masked step's."""
    got = runs["ranks"][2][0]["mask"]
    cfg = port_cfg("llama-micro")
    model = build_model(cfg, "cpu")
    want = masked_step(model, cfg, None)
    assert abs(got["loss"] - want["loss"]) <= TOL1 * want["loss"]
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        TOL1 * want["grad_norm"]
    _close(got["state"], want["state"], TOL1)


def test_launch_train_mesh_host_is_the_api_1x2_run(runs):
    cli = runs["ranks"][2][0]["cli"]
    assert cli["sizes"] == {"data": 1, "model": 2}
    assert sorted(cli["cli"]) == sorted(cli["api"])
    assert all(np.array_equal(cli["cli"][k], cli["api"][k])
               for k in cli["api"])
    # rank 0 wrote the whole state in the reference's layout
    ck = _npz(os.path.join(runs["tmp"][2], "cli", "step_00000004",
                           "arrays.npz"))
    assert all(np.array_equal(ck[k], cli["cli"][k]) for k in ck)
    assert np.isfinite(cli["final"])


def test_training_mesh_refusals(tmp_path):
    from repro_torch.launch import train as launch_train
    for arch in ("qwen3-moe-30b-a3b", "mamba2-1.3b", "paligemma-3b"):
        model = build_model(get_config(arch).reduced(), "cpu")
        with pytest.raises(NotImplementedError, match="item 6d"):
            make_train_step(model, AdamConfig(), mesh=(("data", "model"),
                                                       (1, 2)))
    argv = CLI[:-2] + ["--ckpt-dir", str(tmp_path)]
    for mesh, n in (("production", 256), ("multipod", 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            launch_train.main(argv + ["--mesh", mesh])
    assert checkpoints.latest_step(tmp_path) is None
