"""The scan-to-map selection and fits (voxel_map.select_knn_weights +
fitting.fit_*_weighted) against NumPy references built on np.linalg.eigh."""

import jax.numpy as jnp
import numpy as np
import pytest

from msf_loam_tpu.ops import fitting
from msf_loam_tpu.slam import voxel_map

CELL = 2.0
K = 5
TOL, COND = 0.2, 0.05


def _slab(seed, Q=48, C=64, kind="plane", outliers=0.15, basis=False):
    """Candidate slabs around each query: points on a plane or a line
    (with 1 cm noise) plus scattered outliers; ~20% empty slots."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-20, 20, size=(Q, 3)).astype(np.float32)
    u = rng.normal(size=(Q, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(u, rng.normal(size=(Q, 3)))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    a = rng.uniform(-0.9, 0.9, size=(Q, C, 1))
    b = rng.uniform(-0.9, 0.9, size=(Q, C, 1))
    pts = q[:, None, :] + a * u[:, None, :]
    if kind == "plane":
        pts = pts + b * v[:, None, :]
    pts = pts + rng.normal(scale=0.01, size=pts.shape)
    out = rng.uniform(size=(Q, C)) < outliers
    pts = np.where(out[..., None], q[:, None, :]
                   + rng.uniform(-1.5, 1.5, size=pts.shape), pts)
    valid = rng.uniform(size=(Q, C)) > 0.2
    pts = np.where(valid[..., None], pts, voxel_map.EMPTY_COORD)
    if basis:
        return q, pts.astype(np.float32), valid, u
    return q, pts.astype(np.float32), valid


def _np_select(q, cand, valid, k):
    """k smallest in-radius distances; weight 1 on every in-radius
    candidate no farther than the k-th (all of them when fewer than k)."""
    d2 = ((cand.astype(np.float64) - q[:, None, :]) ** 2).sum(-1)
    keep = valid & (d2 <= (CELL * 0.5) ** 2)
    ds = np.where(keep, d2, np.inf)
    top = np.sort(ds, axis=1)[:, :k]
    w = (keep & (ds <= top[:, k - 1:k])).astype(np.float32)
    wide = valid & (d2 <= CELL ** 2)
    return top, w, wide


def _np_moments(cand, w):
    cnt = w.sum(-1)
    center = (w[..., None] * cand).sum(-2) / np.maximum(cnt, 1.0)[..., None]
    c = cand - center[..., None, :]
    scatter = np.einsum("qc,qci,qcj->qij", w, c, c)
    evals, evecs = np.linalg.eigh(scatter)          # ascending
    return cnt, center, evals, evecs


def _np_plane(cand, w, min_count):
    cnt, center, ev, V = _np_moments(cand, w)
    normal = V[..., :, 0]
    resid = np.abs(np.einsum("qi,qci->qc", normal,
                             cand - center[..., None, :])) * w
    valid = ((cnt >= min_count) & (resid.max(-1) <= TOL)
             & (ev[..., 1] > COND * ev[..., 2]))
    return center, normal, valid, resid


def _aligned(a, b):
    """|cos| between unit vectors, per row."""
    return np.abs((a * b).sum(-1))


def _run_select(q, cand, valid):
    d2, w, wide = voxel_map.select_knn_weights(
        jnp.asarray(cand), jnp.asarray(valid), jnp.asarray(q),
        jnp.float32(CELL), k=K)
    return np.asarray(d2), np.asarray(w), np.asarray(wide)


@pytest.mark.parametrize("seed", [0, 1])
def test_select_knn_weights_matches_numpy(seed):
    q, cand, valid = _slab(seed)
    d2, w, wide = _run_select(q, cand, valid)
    want_d, want_w, want_wide = _np_select(q, cand, valid, K)
    found = np.isfinite(want_d)
    np.testing.assert_allclose(d2[found], want_d[found], rtol=1e-4,
                               atol=1e-5)
    assert (d2[~found] > 1e37).all()
    np.testing.assert_array_equal(w, want_w)
    np.testing.assert_array_equal(wide, want_wide.astype(np.float32))


def test_fit_lines_weighted_matches_eigh():
    q, cand, valid = _slab(2, kind="line")
    _, w, _ = _run_select(q, cand, valid)
    fit = fitting.fit_lines_weighted(jnp.asarray(cand), jnp.asarray(w), K,
                                     3.0)
    cnt, center, ev, V = _np_moments(cand.astype(np.float64), w)
    want_valid = (cnt >= K) & (ev[..., 2] > 3.0 * ev[..., 1])
    np.testing.assert_array_equal(np.asarray(fit.valid), want_valid)
    assert want_valid.sum() > len(q) // 2
    ok = want_valid
    np.testing.assert_allclose(np.asarray(fit.center)[ok], center[ok],
                               atol=1e-4)
    assert (_aligned(np.asarray(fit.direction)[ok], V[ok, :, 2])
            > 1 - 1e-4).all()


def test_fit_planes_weighted_matches_eigh():
    q, cand, valid = _slab(3, kind="plane")
    _, w, _ = _run_select(q, cand, valid)
    fit = fitting.fit_planes_weighted(jnp.asarray(cand), jnp.asarray(w), K,
                                      TOL, COND)
    center, normal, want_valid, _ = _np_plane(cand.astype(np.float64), w, K)
    np.testing.assert_array_equal(np.asarray(fit.valid), want_valid)
    assert want_valid.sum() > len(q) // 2
    ok = want_valid
    np.testing.assert_allclose(np.asarray(fit.center)[ok], center[ok],
                               atol=1e-4)
    assert (_aligned(np.asarray(fit.normal)[ok], normal[ok]) > 1 - 1e-3).all()


def test_fit_planes_two_scale_weighted_matches_eigh():
    """plane2: where the strict k-NN fit fails (here: forced collinear by
    keeping only a line of near points), the wide in-radius moments fit
    takes over if it is planar and the near points lie on it."""
    q, cand, valid, u = _slab(4, kind="plane", outliers=0.0, basis=True)
    _, w, wide = _run_select(q, cand, valid)
    # rows 0::2: a collinear near set ON the plane -> the strict fit fails
    # its spread gate and the wide fit must take over
    w_near, wide = w.copy(), wide.copy()
    rows = np.arange(0, len(q), 2)
    cand[rows, :K] = (q[rows, None, :] + np.linspace(-0.3, 0.3, K)[None, :,
                                                                    None]
                      * u[rows, None, :]).astype(np.float32)
    cand64 = cand.astype(np.float64)
    w_near[rows] = 0.0
    w_near[rows, :K] = 1.0
    wide[rows, :K] = 1.0
    fit = fitting.fit_planes_two_scale_weighted(
        jnp.asarray(cand), jnp.asarray(w_near), jnp.asarray(wide), K, TOL,
        COND, min_wide=K)
    n_center, n_normal, n_valid, _ = _np_plane(cand64, w_near, K)
    w_center, w_normal, w_valid, w_res = _np_plane(cand64, wide, K)
    near_res_on_wide = (np.abs(np.einsum(
        "qi,qci->qc", w_normal, cand64 - w_center[..., None, :]))
        * w_near).max(-1)
    use_fb = ~n_valid & w_valid & (near_res_on_wide <= TOL)
    want_valid = n_valid | use_fb
    np.testing.assert_array_equal(np.asarray(fit.valid), want_valid)
    assert use_fb.sum() > 0 and n_valid.sum() > 0
    want_normal = np.where(use_fb[:, None], w_normal, n_normal)
    want_center = np.where(use_fb[:, None], w_center, n_center)
    ok = want_valid
    np.testing.assert_allclose(np.asarray(fit.center)[ok], want_center[ok],
                               atol=1e-4)
    assert (_aligned(np.asarray(fit.normal)[ok], want_normal[ok])
            > 1 - 1e-3).all()


def test_empty_and_padded_rows_are_invalid_and_finite():
    """Rows with no occupied candidate (padded queries, empty slabs) and
    rows with fewer than k in radius: no fit, no NaN."""
    q, cand, valid = _slab(5)
    valid[:8] = False                               # empty slab
    cand[:8] = voxel_map.EMPTY_COORD
    cand[8:16] = q[8:16, None, :] + 5.0             # all out of radius
    valid[16:24] = False
    valid[16:24, :3] = True                         # only 3 candidates
    d2, w, wide = _run_select(q, cand, valid)
    for fit in (fitting.fit_lines_weighted(jnp.asarray(cand),
                                           jnp.asarray(w), K),
                fitting.fit_planes_weighted(jnp.asarray(cand),
                                            jnp.asarray(w), K),
                fitting.fit_planes_two_scale_weighted(
                    jnp.asarray(cand), jnp.asarray(w), jnp.asarray(wide), K,
                    min_wide=K)):
        assert not np.asarray(fit.valid)[:24].any()
        for leaf in fit[:2]:
            assert np.isfinite(np.asarray(leaf)[:24]).all()
    assert (d2[:16] > 1e37).all() and (w[:16] == 0).all()
    assert (w[16:24].sum(-1) <= 3).all()
