"""Port parity: training (AdamW, the schedules, the microbatched train
step, remat, the fault-tolerant loop, TrainState checkpoints and the
launcher) against the reference on the same numpy inputs.

Tolerances: the reference runs its step and its update under ``jax.jit``,
where XLA multiplies by reciprocals and sums in its own order (ROADMAP
queue 3's division trap), so nothing float is held to bit equality across
the two packages:
  * ``adam_update`` over three updates: params and moments within 1e-6
    of their leaf's largest magnitude (elementwise, a value that the
    updates bring near zero has no relative precision left, and XLA fuses
    ``b * m + (1 - b) * g`` into one rounding), ``count`` equal; bf16
    moments within one bf16 ulp elementwise;
  * the schedules: within 1e-7 absolute (they lie in [0, 1]);
  * one train step (llama-micro, opt-micro, one and two microbatches):
    loss and grad norm ``rtol 1e-5``, every leaf of the new state within
    1e-5 of that leaf's largest magnitude.  It is the first step, where
    lr_scale is 0: the params stay and the moments carry the gradients.
    After a step that moves the params, Adam's first update is
    ``lr g / (|g| + eps)``, about ``lr sign(g)``, and a gradient element
    that cancels to near zero there differs by a few percent between the
    packages, so the moved params hold only ~1e-4 (one step from step 2 on
    llama-micro: the embedding 1.5e-5 of its largest magnitude);
  * five steps: each loss within 1e-4 relative, every leaf of the state
    within 1e-4 of its largest magnitude.
Inside the port, ``remat=True`` equals ``remat=False`` bit for bit on the
CPU, and a resumed launcher run equals an uninterrupted one bit for bit.

The reference's ``restore`` cannot read a bf16 leaf, its own included:
numpy has no cast from the ``|V2`` records an npz holds to
``ml_dtypes.bfloat16``.  A bf16-moment checkpoint of the port is therefore
held byte for byte against the reference's own, and the port restores the
reference's.
"""
import dataclasses
import json
import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim import adam as jadam
from repro.optim import schedule as jschedule
from repro.train import checkpoints as jckpt
from repro.train.step import TrainState as JTrainState
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.data import MarkovCorpus, make_batch_fn
from repro_torch.launch import calibrate
from repro_torch.launch import train as launch_train
from repro_torch.models.model import build_model
from repro_torch.optim import adam, schedule
from repro_torch.train import checkpoints
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import TrainState, make_train_step
from repro_torch.utils import StepTimer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small shapes: as fast alone,
    and under parallel test workers torch does not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = torch.from_numpy
WARMUP, TOTAL = 2, 10


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf_close(got: dict, want: dict, rel: float) -> None:
    """Same keys; each leaf within ``rel`` of its largest magnitude."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == w.shape, k
        tol = rel * np.abs(w).max()
        assert np.abs(g - w).max() <= tol, (k, np.abs(g - w).max(), tol)


def _port_flat(tree) -> dict:
    return {k: (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
            if dt == "bfloat16" else a
            for k, (a, dt) in checkpoints.flatten(tree).items()}


def _ref_flat(tree) -> dict:
    return {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else v
            for k, v in jckpt._flatten(tree).items()}


# ---------------------------------------------------------------------------
# AdamW and the schedules
# ---------------------------------------------------------------------------

def _adam_trees(rng):
    params = {"layers": {"w": rng.standard_normal((2, 16, 24))},
              "scale": rng.standard_normal((24,))}
    grads = [{"layers": {"w": 3 * rng.standard_normal((2, 16, 24))},
              "scale": rng.standard_normal((24,))} for _ in range(3)]
    cast = lambda t: jax.tree_util.tree_map(lambda a: a.astype(np.float32), t)
    return cast(params), [cast(g) for g in grads]


def _adam_run(state_dtype, **over):
    """Three updates on both sides (lr_scale 0.7); returns both trees."""
    params, grads = _adam_trees(np.random.default_rng(0))
    jc = jadam.AdamConfig(lr=1e-2, state_dtype=state_dtype, **over)
    tc = adam.AdamConfig(lr=1e-2, state_dtype=state_dtype, **over)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = from_jax_params(params)
    js, ts = jadam.adam_init(jp, jc), adam.adam_init(tp, tc)
    upd = jax.jit(lambda p, g, s: jadam.adam_update(p, g, s, jc,
                                                    jnp.float32(0.7)))
    for g in grads:
        jp, js = upd(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        before = {k: a.copy() for k, (a, _) in checkpoints.flatten(tp).items()}
        tp2, ts = adam.adam_update(tp, from_jax_params(g), ts, tc,
                                   torch.tensor(0.7))
        # the update is out of place: its inputs are untouched
        assert all(np.array_equal(before[k], a)
                   for k, (a, _) in checkpoints.flatten(tp).items())
        tp = tp2
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("over", [dict(grad_clip=1.0, weight_decay=0.1),
                                  dict(grad_clip=0.0)],
                         ids=["clip-decay", "noclip"])
def test_adam_update_matches_reference(over):
    (jp, js), (tp, ts) = _adam_run("float32", **over)
    want = _ref_flat({"p": jp, "mu": js["mu"], "nu": js["nu"]})
    got = _port_flat({"p": tp, "mu": ts["mu"], "nu": ts["nu"]})
    assert sorted(got) == sorted(want)
    _leaf_close(got, want, 1e-6)
    assert int(ts["count"]) == int(js["count"]) == 3
    # decay reaches matrices only: the vector moved as without decay
    if over.get("weight_decay"):
        (_, _), (tp0, _) = _adam_run("float32", grad_clip=1.0)
        assert torch.equal(tp["scale"], tp0["scale"])
        assert not torch.equal(tp["layers"]["w"], tp0["layers"]["w"])


def test_adam_bf16_moments_within_one_ulp():
    (jp, js), (tp, ts) = _adam_run("bfloat16")
    assert ts["mu"]["scale"].dtype == torch.bfloat16
    for name in ("mu", "nu"):
        want = _ref_flat(js[name])
        got = _port_flat(ts[name])
        for k in want:
            ulp = np.abs(want[k]) * 2.0 ** -7
            assert np.all(np.abs(got[k] - want[k]) <= ulp), (name, k)
    _leaf_close(_port_flat(tp), _ref_flat(jp), 1e-6)


def test_schedules_match_reference():
    warm, total = 20, 200
    for step in (0, 1, warm, (warm + total) // 2, total - 1, total, 250):
        jcos = jschedule.cosine_schedule(jnp.int32(step), total)
        tcos = schedule.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                        total)
        assert abs(float(tcos) - float(jcos)) <= 1e-7
        jw = jax.jit(lambda s: jschedule.linear_warmup_cosine(s, warm, total))
        tw = schedule.linear_warmup_cosine(
            torch.tensor(step, dtype=torch.int32), warm, total)
        assert tw.dtype == torch.float32
        assert abs(float(tw) - float(jw(jnp.int32(step)))) <= 1e-7
    assert float(schedule.linear_warmup_cosine(torch.tensor(0), 5, 50)) == 0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

_REF_STEPS: dict = {}


def _setup(arch: str, micro: int):
    """(reference model, jitted reference step, port model, port step,
    reference params, port params, batch_fn); the reference's jitted step
    is built once per (arch, microbatches)."""
    key = (arch, micro)
    if key not in _REF_STEPS:
        jcfg = dataclasses.replace(jget_config(arch), microbatches=micro)
        tcfg = dataclasses.replace(get_config(arch), microbatches=micro)
        jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg, "cpu")
        jc, tc = jadam.AdamConfig(lr=3e-3), adam.AdamConfig(lr=3e-3)
        jstep = jax.jit(jmake_train_step(jmodel, jc, TOTAL, WARMUP))
        tstep = make_train_step(tmodel, tc, TOTAL, WARMUP)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        corpus = MarkovCorpus(vocab=tcfg.vocab_size, branching=4,
                              buckets=128, seed=0)
        _REF_STEPS[key] = (jstep, tstep, jparams, jc, tc,
                           make_batch_fn(corpus, 8, 32))
    return _REF_STEPS[key]


def _states(jparams, jc, tc, step: int):
    jstate = JTrainState(jparams, jadam.adam_init(jparams, jc),
                         jnp.int32(step))
    tparams = from_jax_params(_np_tree(jparams))
    return jstate, TrainState(tparams, adam.adam_init(tparams, tc),
                              torch.tensor(step, dtype=torch.int32))


@pytest.mark.parametrize("micro", [1, 2], ids=["mb1", "mb2"])
@pytest.mark.parametrize("arch", ["llama-micro", "opt-micro"])
def test_train_step_matches_reference(arch, micro):
    """The first step: lr_scale is 0 there, so the params stay and the
    moments are the gradients, (1 - b1) g and (1 - b2) g^2."""
    jstep, tstep, jparams, jc, tc, batch_fn = _setup(arch, micro)
    jstate, tstate = _states(jparams, jc, tc, 0)
    batch = batch_fn(0)
    jnew, jm = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
    tnew, tm = tstep(tstate, {"tokens": T(batch["tokens"])})
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, err_msg=name)
    assert float(tm["lr_scale"]) == float(jm["lr_scale"]) == 0.0
    assert int(tnew.step) == 1 and int(tnew.opt["count"]) == 1
    got, want = _port_flat(tnew), _ref_flat(jnew)
    for k, v in checkpoints.flatten(tstate.params).items():
        assert np.array_equal(got["0||" + k], v[0])
    # OPT's key bias has a zero gradient in exact arithmetic (a shift that
    # every key shares cancels in the softmax): both sides hold rounding
    # noise there, held to zero against the largest moment of the tree
    zero = [k for k in want if k.endswith("||bk")]
    for kind in ("||mu||", "||nu||"):
        top = max(np.abs(v).max() for k, v in want.items() if kind in k)
        for k in zero:
            if kind in k:
                assert np.abs(got[k]).max() <= 1e-6 * top, k
    _leaf_close({k: v for k, v in got.items() if k not in zero},
                {k: v for k, v in want.items() if k not in zero}, 1e-5)


def test_remat_equals_no_remat_bit_for_bit():
    cfg = get_config("llama-micro")
    assert cfg.remat is False
    states, metrics = [], []
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat), "cpu")
        params = model.init(0)
        tc = adam.AdamConfig(lr=3e-3)
        state = TrainState(params, adam.adam_init(params, tc),
                           torch.tensor(WARMUP, dtype=torch.int32))
        tokens = T(MarkovCorpus(cfg.vocab_size, seed=0).sample(4, 32, 1))
        new, m = make_train_step(model, tc, TOTAL, WARMUP)(
            state, {"tokens": tokens})
        states.append(checkpoints.flatten(new))
        metrics.append(m)
    assert torch.equal(metrics[0]["loss"], metrics[1]["loss"])
    assert torch.equal(metrics[0]["grad_norm"], metrics[1]["grad_norm"])
    assert all(np.array_equal(states[0][k][0], states[1][k][0])
               for k in states[0])


def test_five_steps_track_reference_losses():
    jstep, tstep, jparams, jc, tc, batch_fn = _setup("llama-micro", 1)
    jstate, tstate = _states(jparams, jc, tc, 0)
    jl, tl = [], []
    for i in range(5):
        toks = batch_fn(i)["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": T(toks)})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    _leaf_close(_port_flat(tstate), _ref_flat(jstate), 1e-4)


# ---------------------------------------------------------------------------
# the loop (every case of tests/test_train_loop.py)
# ---------------------------------------------------------------------------

def _tiny_state(v=0.0):
    return TrainState(params={"w": torch.tensor(v)},
                      opt={"m": torch.tensor(0.0)},
                      step=torch.tensor(0, dtype=torch.int32))


def _plus_one(state, loss=0.5):
    return (TrainState({"w": state.params["w"] + 1}, state.opt,
                       state.step + 1),
            {"loss": torch.tensor(loss), "grad_norm": torch.tensor(1.0)})


def test_nan_steps_skipped_and_counted(tmp_path):
    calls = []

    def step(state, batch):
        calls.append(len(calls))
        return _plus_one(state, float("nan") if calls[-1] in (1, 2) else 1.0)

    seen = []
    final = train_loop(_tiny_state(), step, lambda s: {}, LoopConfig(
        total_steps=5, ckpt_every=100, ckpt_dir=str(tmp_path)),
        on_metrics=lambda s, m, dt: seen.append(s))
    # steps 1, 2 skipped => only 3 updates applied
    assert float(final.params["w"]) == 3.0
    assert seen == [0, 3, 4]


def test_divergence_aborts(tmp_path):
    def step(state, batch):
        return state, {"loss": torch.tensor(float("nan")),
                       "grad_norm": torch.tensor(1.0)}

    with pytest.raises(RuntimeError, match="training diverged"):
        train_loop(_tiny_state(), step, lambda s: {}, LoopConfig(
            total_steps=20, max_bad_steps=3, ckpt_every=100,
            ckpt_dir=str(tmp_path)))


def test_resume_from_checkpoint(tmp_path):
    cfg = LoopConfig(total_steps=4, ckpt_every=2, ckpt_dir=str(tmp_path))
    train_loop(_tiny_state(), lambda s, b: _plus_one(s), lambda s: {}, cfg)
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json")
                          .read_text())
    assert manifest["extra"] == {"stragglers": 0}
    assert sorted(manifest["leaves"]) == ["0||w", "1||m", "2"]
    # second run continues to 8
    cfg2 = LoopConfig(total_steps=8, ckpt_every=2, ckpt_dir=str(tmp_path))
    final = train_loop(_tiny_state(), lambda s, b: _plus_one(s),
                       lambda s: {}, cfg2)
    assert float(final.params["w"]) == 8.0
    assert int(final.step) == 8


def test_straggler_detector_fake_clock():
    times = iter([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0,
                  11.0, 12.0, 13.0, 14.0, 15.0,
                  16.0, 30.0])  # step 9: 14s -> straggler
    t = StepTimer(clock=lambda: next(times))
    flagged = []
    for _ in range(9):
        t.start()
        dt = t.stop()
        flagged.append(t.is_straggler(dt, factor=2.0, min_samples=8))
    assert flagged[-1] is True
    assert not any(flagged[:-1])


# ---------------------------------------------------------------------------
# TrainState checkpoints, both directions
# ---------------------------------------------------------------------------

def _both_states(state_dtype):
    rng = np.random.default_rng(5)
    params = {"embed": rng.standard_normal((16, 8)).astype(np.float32),
              "layers": {"wq": rng.standard_normal((2, 8, 8))
                         .astype(np.float32)},
              "ln_f": {"scale": np.ones((8,), np.float32)}}
    jdt = jnp.dtype(state_dtype)
    mom = lambda: jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jdt), params)
    jstate = JTrainState(jax.tree_util.tree_map(jnp.asarray, params),
                         {"mu": mom(), "nu": mom(),
                          "count": jnp.int32(3)}, jnp.int32(3))
    return jstate, TrainState(*from_jax_params(_np_tree(
        [jstate.params, jstate.opt, jstate.step])))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_train_state_checkpoints_both_ways(tmp_path, state_dtype):
    jstate, tstate = _both_states(state_dtype)
    assert tstate.opt["mu"]["embed"].dtype == getattr(torch, state_dtype)
    jckpt.save(tmp_path / "ref", 3, jstate)
    checkpoints.save(tmp_path / "port", 3, tstate)
    # the same manifest leaves and the same npz bytes
    man = [json.loads((tmp_path / w / "step_00000003" / "manifest.json")
                      .read_text())["leaves"] for w in ("ref", "port")]
    assert man[0] == man[1]
    assert "1||mu||layers||wq" in man[0] and "2" in man[0]
    with np.load(tmp_path / "ref/step_00000003/arrays.npz") as a, \
            np.load(tmp_path / "port/step_00000003/arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
    # the port restores the reference's checkpoint into a zeroed like tree
    like = TrainState(*[jax.tree_util.tree_map(torch.zeros_like, t) if
                        isinstance(t, dict) else torch.zeros_like(t)
                        for t in (tstate.params, tstate.opt, tstate.step)])
    back, step = checkpoints.restore(tmp_path / "ref", like)
    assert step == 3 and isinstance(back, TrainState)
    assert back.opt["nu"]["embed"].dtype == getattr(torch, state_dtype)
    want = checkpoints.flatten(tstate)
    assert all(np.array_equal(a, want[k][0])
               for k, (a, _) in checkpoints.flatten(back).items())
    if state_dtype == "float32":
        # the reference restores the port's checkpoint
        jback, jstep = jckpt.restore(tmp_path / "port", jstate)
        assert jstep == 3
        got = jckpt._flatten(jback)
        assert all(np.array_equal(got[k], a) for k, (a, _) in want.items())


def test_restore_rejects_missing_and_misshaped_leaves(tmp_path):
    _, tstate = _both_states("float32")
    checkpoints.save(tmp_path, 1, tstate)
    extra = TrainState(dict(tstate.params, head=torch.zeros(8, 16)),
                       tstate.opt, tstate.step)
    with pytest.raises(KeyError, match="0||head"):
        checkpoints.restore(tmp_path, extra)
    wrong = TrainState(dict(tstate.params, embed=torch.zeros(8, 8)),
                       tstate.opt, tstate.step)
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoints.restore(tmp_path, wrong)
    with pytest.raises(FileNotFoundError):
        checkpoints.restore(tmp_path / "none", tstate)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _argv(ckpt_dir):
    return ["--arch", "llama-micro", "--device", "cpu", "--steps", "4",
            "--ckpt-every", "2", "--global-batch", "4", "--seq", "16",
            "--lr", "3e-3", "--ckpt-dir", str(ckpt_dir)]


def test_cli_resumes_and_hands_off_to_calibrate(tmp_path, capsys, caplog):
    run, resumed = tmp_path / "run", tmp_path / "resumed"
    assert launch_train.main(_argv(run)) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    floor = MarkovCorpus(512, seed=0).entropy_floor()
    assert "final loss" in last and f"corpus entropy floor {floor:.4f}" \
        in last
    assert checkpoints.latest_step(run) == 4
    # a run stopped after step 2, launched again unchanged, resumes there
    shutil.copytree(run, resumed)
    shutil.rmtree(resumed / "step_00000004")
    with caplog.at_level(logging.INFO, logger="repro_torch"):
        assert launch_train.main(_argv(resumed)) == 0
    assert "restored checkpoint at step 2" in caplog.text
    with np.load(run / "step_00000004/arrays.npz") as a, \
            np.load(resumed / "step_00000004/arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)
    # the reference restores the launcher's TrainState
    jcfg = jget_config("llama-micro")
    jlike = jinit_train_state(jbuild_model(jcfg), jax.random.PRNGKey(0),
                              jadam.AdamConfig())
    jstate, step = jckpt.restore(run, jlike)
    assert step == 4 and int(jstate.step) == 4
    # launch/calibrate --ckpt reads its params: the same fp perplexity
    out = tmp_path / "q"
    assert calibrate.main(["--arch", "llama-micro", "--device", "cpu",
                           "--ckpt", str(run), "--method", "rtn",
                           "--wbits", "4", "--group", "32",
                           "--calib-samples", "2", "--calib-seq", "16",
                           "--out", str(out)]) == 0
    report = json.loads((out / "llama-micro-rtn-w4a16g32kv16.json").read_text())
    cfg = get_config("llama-micro")
    model = build_model(cfg, "cpu")
    params = from_jax_params(_np_tree(jstate.params))
    test = T(MarkovCorpus(cfg.vocab_size, seed=0).sample(16, 16, seed=999))
    assert report["fp_ppl"] == calibrate.eval_ppl(model, params, test)


def test_cli_refuses_mesh_and_absent_card(tmp_path):
    with pytest.raises(ValueError, match="needs 256 ranks"):
        launch_train.main(_argv(tmp_path) + ["--mesh", "production"])
    if not torch.cuda.is_available():
        argv = [a for a in _argv(tmp_path) if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(argv)
    assert checkpoints.latest_step(tmp_path) is None
