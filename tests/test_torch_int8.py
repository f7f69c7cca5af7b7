"""Port parity: the int8 x int8 matmuls' plain versions against the
reference's oracles (``ref.int8_matmul_ref``, ``ref.w8a8_dynamic_ref``) and
its Pallas bodies in interpret mode, on the same numpy inputs.

Tolerance: rtol 1e-6 of the output's max magnitude.  The integer dot is
exact on both sides and the float32 epilogue is the same two multiplies in
the same order, so the results are equal but for what XLA may reorder.
The activation scale is the reference's whole-row one: the Pallas
``w8a8_matmul`` is compared with one K slab (``bk = K``), where its
per-slab scale is that scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.int8_matmul import int8_matmul as pallas_int8_matmul
from repro.kernels.int8_matmul import w8a8_matmul as pallas_w8a8_matmul
from repro_torch.kernels import ops
from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_plain,
                                             w8a8_dynamic_plain, w8a8_matmul)


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
RTOL = 1e-6


def _close(got, want):
    want = np.asarray(want)
    err = np.max(np.abs(np.asarray(got) - want))
    assert err <= RTOL * max(1.0, np.max(np.abs(want))), err


def _int8_inputs(rng, m, k, n):
    x_q = rng.integers(-128, 128, (m, k)).astype(np.int8)
    x_scale = (rng.random((m, 1)) * 0.05 + 0.01).astype(np.float32)
    w_q = rng.integers(-128, 128, (k, n)).astype(np.int8)
    w_scale = (rng.random(n) * 0.05 + 0.01).astype(np.float32)
    return x_q, x_scale, w_q, w_scale


def _w8a8_inputs(rng, m, k, n):
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q = rng.integers(-128, 128, (k, n)).astype(np.int8)
    w_scale = (rng.random(n) * 0.05 + 0.01).astype(np.float32)
    return x, w_q, w_scale


@pytest.mark.parametrize("m", [1, 5, 37])
def test_int8_matmul_plain_matches_ref(m):
    rng = np.random.default_rng(m)
    x_q, x_scale, w_q, w_scale = _int8_inputs(rng, m, 512, 128)
    want = ref.int8_matmul_ref(*(jnp.asarray(a) for a in
                                 (x_q, w_q, x_scale, w_scale)))
    got = int8_matmul_plain(T(x_q), T(x_scale), T(w_q), T(w_scale))
    _close(got, want)
    # the wrapper runs the plain version for CPU tensors
    assert torch.equal(int8_matmul(T(x_q), T(x_scale), T(w_q), T(w_scale)),
                       got)


def test_int8_matmul_plain_rounds_large_accumulators_like_ref():
    """|acc| above 2^24, where float32(acc) rounds: K = 2048 codes near
    +-127 with both signs aligned (K = 512 cannot pass 2^24: 512 * 128^2 is
    2^23), plus odd perturbations so the rounding is exercised."""
    rng = np.random.default_rng(11)
    m, k, n = 5, 2048, 16
    sign = np.where(rng.random(k) < 0.5, -1, 1)
    x_q = (sign * rng.integers(120, 128, (m, k))).astype(np.int8)
    w_q = (sign[:, None] * rng.integers(120, 128, (k, n))).astype(np.int8)
    x_scale = (rng.random((m, 1)) * 0.05 + 0.01).astype(np.float32)
    w_scale = (rng.random(n) * 0.05 + 0.01).astype(np.float32)
    acc = x_q.astype(np.int64) @ w_q.astype(np.int64)
    assert acc.min() > 2 ** 24 and (acc % 2 == 1).any()
    want = ref.int8_matmul_ref(*(jnp.asarray(a) for a in
                                 (x_q, w_q, x_scale, w_scale)))
    got = int8_matmul_plain(T(x_q), T(x_scale), T(w_q), T(w_scale))
    _close(got, want)


def test_int8_matmul_plain_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    m, k, n = 16, 256, 64
    x_q, x_scale, w_q, w_scale = _int8_inputs(rng, m, k, n)
    want = pallas_int8_matmul(*(jnp.asarray(a) for a in
                                (x_q, x_scale, w_q, w_scale)),
                              bm=m, bn=n, bk=128, interpret=True)
    _close(int8_matmul_plain(T(x_q), T(x_scale), T(w_q), T(w_scale)), want)


@pytest.mark.parametrize("m", [1, 5, 37])
def test_w8a8_dynamic_plain_matches_ref(m):
    """Includes an all-zero row: its bound clamps to 1e-8 and it returns
    zeros."""
    rng = np.random.default_rng(20 + m)
    x, w_q, w_scale = _w8a8_inputs(rng, m, 512, 128)
    x[m // 2] = 0.0
    want = ref.w8a8_dynamic_ref(jnp.asarray(x), jnp.asarray(w_q),
                                jnp.asarray(w_scale))
    got = w8a8_dynamic_plain(T(x), T(w_q), T(w_scale))
    _close(got, want)
    assert not got[m // 2].any()
    assert torch.equal(w8a8_matmul(T(x), T(w_q), T(w_scale)), got)


def test_w8a8_dynamic_plain_matches_pallas_single_slab():
    """The Pallas body with bk = K: one slab, so its per-slab activation
    scale is the whole-row one the port computes."""
    rng = np.random.default_rng(30)
    m, k, n = 16, 384, 64
    x, w_q, w_scale = _w8a8_inputs(rng, m, k, n)
    want = pallas_w8a8_matmul(jnp.asarray(x), jnp.asarray(w_q),
                              jnp.asarray(w_scale), bm=m, bn=n, bk=k,
                              interpret=True)
    _close(w8a8_dynamic_plain(T(x), T(w_q), T(w_scale)), want)


def test_ops_w8a8_matmul_shapes_and_modes():
    rng = np.random.default_rng(40)
    x, w_q, w_scale = _w8a8_inputs(rng, 3 * 37, 128, 48)
    x3 = T(x).reshape(3, 37, 128)
    got = ops.w8a8_matmul(x3, T(w_q), T(w_scale))
    assert got.shape == (3, 37, 48)
    want = ref.w8a8_dynamic_ref(jnp.asarray(x), jnp.asarray(w_q),
                                jnp.asarray(w_scale))
    _close(got.reshape(-1, 48), want)
    plain = ops.w8a8_matmul(x3, T(w_q), T(w_scale), mode="plain")
    assert torch.equal(got, plain)
    empty = ops.w8a8_matmul(x3[:, :0], T(w_q), T(w_scale))
    assert empty.shape == (3, 0, 48) and empty.dtype == x3.dtype
    assert not empty.any()
    with pytest.raises(ValueError):
        ops.w8a8_matmul(x3, T(w_q), T(w_scale), mode="kernel")
