"""ops.knn (chunked exact k-NN, f32 matmuls) against NumPy brute force."""

import jax.numpy as jnp
import numpy as np
import pytest

from msf_loam_tpu.ops import knn

RNG = np.random.default_rng(41)


def _bruteforce(q, r, rmask, k):
    d = ((q[:, None, :].astype(np.float64) - r[None, :, :]) ** 2).sum(-1)
    d[:, ~rmask] = np.inf
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    dd = np.take_along_axis(d, idx, axis=1)
    return dd, np.where(np.isinf(dd), -1, idx)


def _run(q, r, rmask, k, chunk):
    d2, idx = knn.knn(jnp.asarray(q), jnp.ones(len(q), bool), jnp.asarray(r),
                      jnp.asarray(rmask), k=k, chunk=chunk)
    return np.asarray(d2), np.asarray(idx)


@pytest.mark.parametrize("Q,M,k", [(64, 300, 5), (100, 2500, 8), (17, 33, 3)])
def test_knn_matches_bruteforce(Q, M, k):
    q = RNG.uniform(-5, 5, size=(Q, 3)).astype(np.float32)
    r = RNG.uniform(-5, 5, size=(M, 3)).astype(np.float32)
    rmask = RNG.uniform(size=M) > 0.1
    d2, idx = _run(q, r, rmask, k, chunk=128)
    want_d, want_i = _bruteforce(q, r, rmask, k)
    np.testing.assert_allclose(d2, want_d, rtol=1e-4, atol=1e-4)
    # indices point at valid refs at the wanted distance (ties allowed)
    assert ((idx >= 0) == (want_i >= 0)).all()
    got = np.where(idx >= 0, idx, 0)
    assert rmask[got][idx >= 0].all()
    d_of_idx = ((q[:, None, :] - r[got]) ** 2).sum(-1)
    np.testing.assert_allclose(d_of_idx[idx >= 0], want_d[idx >= 0],
                               rtol=1e-4, atol=1e-4)


def test_knn_no_duplicate_indices():
    q = RNG.uniform(-2, 2, size=(16, 3)).astype(np.float32)
    r = RNG.uniform(-2, 2, size=(64, 3)).astype(np.float32)
    _, idx = _run(q, r, np.ones(64, bool), k=5, chunk=32)
    for row in idx:
        valid = row[row >= 0]
        assert len(valid) == 5 and len(np.unique(valid)) == 5, row


def test_knn_ascending_distances():
    q = RNG.uniform(-2, 2, size=(8, 3)).astype(np.float32)
    r = RNG.uniform(-2, 2, size=(128, 3)).astype(np.float32)
    d2, _ = _run(q, r, np.ones(128, bool), k=5, chunk=64)
    assert (np.diff(d2, axis=1) >= 0).all()


def test_knn_far_from_origin_keeps_f32_accuracy():
    """|q|^2 + |r|^2 - 2 q.r cancels catastrophically 50 m out: with f32
    matmuls the nearest neighbour is still found among refs spaced 5 cm
    apart (a reduced-precision product would scramble them)."""
    base = np.array([50.0, -30.0, 2.0], np.float32)
    r = base + np.stack([np.arange(40) * 0.05, np.zeros(40), np.zeros(40)],
                        axis=1).astype(np.float32)
    q = (r[::4] + np.array([0.01, 0.0, 0.0], np.float32)).astype(np.float32)
    _, idx = _run(q, r, np.ones(40, bool), k=1, chunk=16)
    np.testing.assert_array_equal(idx[:, 0], np.arange(0, 40, 4))
