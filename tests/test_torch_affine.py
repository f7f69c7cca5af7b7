"""Port parity: the gradual mask, the affine transforms, their inverses and
merges, and the diagonal-dominance margin against the reference on the
same numpy inputs.

Tolerances: masks, diagonal inverses and transforms, the norm merges and
the margins of diagonal matrices are elementwise IEEE operations in the
same order, so they are equal bit for bit.  A solve and a matmul sum in
another order than XLA: within rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import affine as jaf
from repro.core import equivalence as jeq
from repro.core import gradual_mask as jgm
from repro_torch.core import affine as af
from repro_torch.core import equivalence as eq
from repro_torch.core import gradual_mask as gm


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


def _sdd(rng, n, heads=None):
    """A strictly diagonally dominant matrix (or stack), as calibration
    keeps its transforms."""
    shape = (n, n) if heads is None else (heads, n, n)
    a = 0.3 / n * rng.standard_normal(shape).astype(np.float32)
    return a + np.eye(n, dtype=np.float32) * (1.0 + rng.random(n)).astype(
        np.float32)


@pytest.mark.parametrize("hidden,total", [(96, 3), (128, 20), (4096, 3),
                                          (7, 6)])
def test_gradual_masks_equal_every_epoch(hidden, total):
    """Both kinds, every epoch (96 / 3 and 4096 / 3 put a band edge where a
    float64 quotient would round the other way)."""
    for epoch in range(total + 1):
        assert float(gm.band_width(epoch, total, hidden)) == float(
            jgm.band_width(epoch, total, hidden))
        if hidden > 128:
            continue
        np.testing.assert_array_equal(
            gm.gradual_mask(hidden, epoch, total, 0.1).numpy(),
            np.asarray(jgm.gradual_mask(hidden, epoch, total, 0.1)))
        heads = 4 if hidden % 4 == 0 else 7
        np.testing.assert_array_equal(
            gm.gradual_mask_headwise(hidden, heads, epoch, total, 0.1).numpy(),
            np.asarray(jgm.gradual_mask_headwise(hidden, heads, epoch, total,
                                                 0.1)))


def _spec(kind, n=64, heads=4, shift=True):
    dim = n // heads if kind == "headwise" else n
    kw = dict(num_heads=heads) if kind == "headwise" else {}
    return (jaf.AffineSpec("s", kind, dim, with_shift=shift, **kw),
            af.AffineSpec("s", kind, dim, with_shift=shift, **kw))


def _matrix(rng, kind, n=64, heads=4):
    if kind == "diagonal":
        return (1.0 + rng.random(n)).astype(np.float32)
    if kind == "headwise":
        return _sdd(rng, n // heads, heads)
    return _sdd(rng, n)


@pytest.mark.parametrize("kind", ["diagonal", "full", "headwise"])
def test_invert_and_transforms(kind):
    rng = np.random.default_rng(0)
    jspec, tspec = _spec(kind)
    a = _matrix(rng, kind)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    shift = rng.standard_normal(64).astype(np.float32)
    exact = kind == "diagonal"

    def check(got, want):
        got, want = got.numpy(), np.asarray(want)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    ja_inv = jaf.invert(jspec, jnp.asarray(a))
    ta_inv = af.invert(tspec, T(a))
    check(ta_inv, ja_inv)
    check(af.transform_weight(tspec, T(a), T(w)),
          jaf.transform_weight(jspec, jnp.asarray(a), jnp.asarray(w)))
    # the activation side on the same inverse, so only the transform differs
    inv = np.array(ja_inv)
    check(af.transform_activation(tspec, T(inv), T(x), T(shift)),
          jaf.transform_activation(jspec, jnp.asarray(inv), jnp.asarray(x),
                                   jnp.asarray(shift)))
    np.testing.assert_allclose(
        af.shift_bias_correction(T(shift), T(w), T(w[0])).numpy(),
        np.asarray(jaf.shift_bias_correction(
            jnp.asarray(shift), jnp.asarray(w), jnp.asarray(w[0]))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["diagonal", "full", "headwise"])
def test_init_params_and_smoothquant_diag(kind):
    rng = np.random.default_rng(1)
    jspec, tspec = _spec(kind)
    act = (rng.random(64) * 5).astype(np.float32)
    wmax = (rng.random(64) * 0.1).astype(np.float32)
    want = jaf.smoothquant_diag(jnp.asarray(act), jnp.asarray(wmax))
    got = af.smoothquant_diag(T(act), T(wmax))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    init = None if kind == "headwise" else np.array(want)
    jp = jaf.init_params(jspec, None if init is None else jnp.asarray(init))
    tp = af.init_params(tspec, None if init is None else T(init))
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_norm_and_weight_merges():
    rng = np.random.default_rng(2)
    d, n_out = 64, 48
    g = (rng.random(d) + 0.5).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    a = (rng.random(d) + 0.5).astype(np.float32)
    shift = rng.standard_normal(d).astype(np.float32)
    w = rng.standard_normal((d, n_out)).astype(np.float32)
    for bias in (None, beta):
        for sh in (None, shift):
            tg, tb = eq.merge_diag_into_norm(
                T(g), None if bias is None else T(bias), T(a),
                None if sh is None else T(sh))
            jg, jb = jeq.merge_diag_into_norm(
                jnp.asarray(g), None if bias is None else jnp.asarray(bias),
                jnp.asarray(a), None if sh is None else jnp.asarray(sh))
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
            assert (tb is None) == (jb is None)
            if tb is not None:
                np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        eq.merge_diag_into_weight(T(w), T(a)).numpy(),
        np.asarray(jeq.merge_diag_into_weight(jnp.asarray(w), jnp.asarray(a))))
    full = _sdd(rng, d)
    inv = np.linalg.inv(full).astype(np.float32)
    close = lambda got, want: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    close(eq.merge_full_into_weight(T(w), T(full)),
          jeq.merge_full_into_weight(jnp.asarray(w), jnp.asarray(full)))
    close(eq.fuse_effective_weight(T(w), T(inv)),
          jeq.fuse_effective_weight(jnp.asarray(w), jnp.asarray(inv)))
    wp = rng.standard_normal((32, d)).astype(np.float32)
    for bias in (None, beta):
        tw, tb = eq.merge_inv_into_producer(
            T(wp), None if bias is None else T(bias), T(inv), T(shift))
        jw, jb = jeq.merge_inv_into_producer(
            jnp.asarray(wp), None if bias is None else jnp.asarray(bias),
            jnp.asarray(inv), jnp.asarray(shift))
        close(tw, jw)
        close(tb, jb)


@pytest.mark.parametrize("kv_heads,q_heads", [(4, 4), (2, 4)])
def test_headwise_v_o_merge(kv_heads, q_heads):
    rng = np.random.default_rng(3)
    hd, d = 16, 64
    a = _sdd(rng, hd, kv_heads)
    a_inv = np.linalg.inv(a).astype(np.float32)
    wv = rng.standard_normal((d, kv_heads * hd)).astype(np.float32)
    wo = rng.standard_normal((q_heads * hd, d)).astype(np.float32)
    got = eq.merge_headwise_into_v_o(T(wv), T(wo), T(a), T(a_inv), kv_heads,
                                     q_heads)
    want = jeq.merge_headwise_into_v_o(jnp.asarray(wv), jnp.asarray(wo),
                                       jnp.asarray(a), jnp.asarray(a_inv),
                                       kv_heads, q_heads)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("solve_dtype", ["float32", "float64"])
def test_merge_error(solve_dtype):
    """The round-off of inverse + merge alone; float64 (numpy's solve as
    the reference, the reference needing jax's x64 mode) is orders
    smaller than float32."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    a = _sdd(rng, 64)
    got = float(eq.merge_error(T(x), T(w), T(a),
                               getattr(torch, solve_dtype)))
    if solve_dtype == "float32":
        want = float(jeq.merge_error(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(a)))
        assert got == pytest.approx(want, rel=0.5)
        assert 0 < got < 1e-8
    else:
        x6, w6, a6 = (v.astype(np.float64) for v in (x, w, a))
        y = (x6 @ np.linalg.solve(a6, np.eye(64))) @ (a6 @ w6) - x6 @ w6
        assert got == pytest.approx(np.mean(y * y), rel=0.5, abs=1e-28)
        assert got < 1e-20


@pytest.mark.parametrize("kind", ["diagonal", "full", "headwise"])
def test_dominance_margin(kind):
    rng = np.random.default_rng(5)
    a = _matrix(rng, kind) if kind != "diagonal" else np.diag(
        _matrix(rng, kind))
    stack = a if a.ndim == 3 else a[None]
    want = min(float(jgm.dominance_margin(jnp.asarray(m))) for m in stack)
    got = float(gm.dominance_margin(T(a)))
    if kind == "diagonal":
        assert got == want
    else:
        assert got == pytest.approx(want, rel=1e-5)
    assert got > 0 and gm.is_strictly_diagonally_dominant(T(a))
    bad = a.copy()
    bad[..., 0, 1] = 10.0
    assert float(gm.dominance_margin(T(bad))) < 0
    assert not gm.is_strictly_diagonally_dominant(T(bad))
