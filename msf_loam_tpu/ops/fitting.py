"""Batched geometric fitting: 3x3 symmetric eigendecomposition for line
features and least-squares plane fits.

Replaces the reference's per-point Eigen calls in the mapping matcher:
``SelfAdjointEigenSolver`` line test (``mapping_scan_matcher.cc:128-152``)
and ``colPivHouseholderQr`` plane fit (``mapping_scan_matcher.cc:195-220``).
Both are closed-form here (trigonometric eigensolver, 3x3 Cramer solve) so
thousands of fits run as pure VPU element-wise math — no LAPACK loops.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


def eigh3x3(A: Array) -> Tuple[Array, Array]:
    """Eigenvalues (descending) + eigenvectors of symmetric 3x3 matrices.

    Trigonometric (Cardano) method; batched over leading dims.
    Returns (w (..., 3) descending, V (..., 3, 3) with V[..., :, i] the
    eigenvector of w[..., i]).
    """
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))

    eye = jnp.eye(3, dtype=A.dtype)
    B = (A - q[..., None, None] * eye) / p[..., None, None]
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0

    w0 = q + 2.0 * p * jnp.cos(phi)                      # largest
    w2 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest
    w1 = 3.0 * q - w0 - w2

    # near-diagonal matrices: p1 ~ 0 -> eigenvalues are the diagonal (sorted)
    diag_sorted = -jnp.sort(-jnp.stack([a00, a11, a22], axis=-1), axis=-1)
    is_diag = p1 < 1e-12
    w = jnp.where(is_diag[..., None], diag_sorted,
                  jnp.stack([w0, w1, w2], axis=-1))

    # eigenvector for w_i: dominant column of prod of (A - w_j I), j != i
    def eigvec(wi, wj, wk):
        M = (A - wj[..., None, None] * eye) @ (A - wk[..., None, None] * eye)
        norms = jnp.sum(M * M, axis=-2)  # column squared norms (..., 3)
        col = jnp.argmax(norms, axis=-1)
        v = jnp.take_along_axis(M, col[..., None, None], axis=-1)[..., 0]
        n = jnp.linalg.norm(v, axis=-1, keepdims=True)
        # degenerate (repeated eigenvalue): fall back to e_x; downstream
        # validity gates (eig-ratio tests) reject these fits anyway.
        fallback = jnp.broadcast_to(eye[0], v.shape)
        return jnp.where(n > 1e-20, v / jnp.maximum(n, 1e-30), fallback)

    # Compute the two EXTREME eigenvectors directly and derive the middle
    # one by cross product. (Deriving v2 = v0 x v1 instead is unsound: a
    # plane patch with isotropic in-plane spread has w0 ~ w1, both direct
    # solves degenerate to the e_x fallback, and the cross product returns
    # a ZERO normal whose plane residuals are trivially zero — a fit that
    # passes every downstream gate. The extreme pair is safe: w0 ~ w1
    # still leaves (A - w0)(A - w1) rank-1 toward v2, and w1 ~ w2 — the
    # collinear case where v2 is genuinely ambiguous — is rejected by the
    # spread/eig-ratio gates.)
    v0 = eigvec(w[..., 0], w[..., 1], w[..., 2])
    v2 = eigvec(w[..., 2], w[..., 0], w[..., 1])
    v1 = jnp.cross(v2, v0)
    v1 = v1 / jnp.maximum(jnp.linalg.norm(v1, axis=-1, keepdims=True), 1e-30)
    V = jnp.stack([v0, v1, v2], axis=-1)
    return w, V


class LineFit(NamedTuple):
    center: Array     # (..., 3) centroid of neighbors
    direction: Array  # (..., 3) unit direction (largest eigenvector)
    valid: Array      # (...,) bool — passed the eigenvalue-ratio test


def fit_lines(neighbors: Array, neighbor_valid: Array,
              eig_ratio: float = 3.0) -> LineFit:
    """Fit a 3D line through each K-neighborhood.

    Mirrors the corner-feature covariance + ``lambda_max > 3 * lambda_mid``
    acceptance of ``mapping_scan_matcher.cc:130-152``.

    Args:
      neighbors: (..., K, 3); neighbor_valid: (..., K) bool.
    """
    m = neighbor_valid[..., None].astype(neighbors.dtype)
    cnt = jnp.maximum(jnp.sum(m, axis=-2), 1.0)
    center = jnp.sum(neighbors * m, axis=-2) / cnt
    d = (neighbors - center[..., None, :]) * m
    cov = jnp.einsum("...ki,...kj->...ij", d, d)
    w, V = eigh3x3(cov)
    direction = V[..., :, 0]
    all_valid = jnp.all(neighbor_valid, axis=-1)
    valid = all_valid & (w[..., 0] > eig_ratio * w[..., 1])
    return LineFit(center, direction, valid)


class PlaneFit(NamedTuple):
    center: Array  # (..., 3)
    normal: Array  # (..., 3) unit
    valid: Array   # (...,) bool — all K points within fit tolerance


def fit_planes(neighbors: Array, neighbor_valid: Array,
               tol: float = 0.2, cond_frac: float = 0.05) -> PlaneFit:
    """Fit a plane n.x = -1 per K-neighborhood via normal equations.

    Mirrors ``mapping_scan_matcher.cc:198-220``: solve A n = -1, normalize,
    then require every neighbor within ``tol`` of the plane.

    Additionally requires the centered scatter to genuinely span 2D:
    lambda_mid > ``cond_frac`` * lambda_max. A near-collinear cluster (one
    lidar ring grazing the ground at range) fits a zero-residual "plane"
    whose normal is arbitrary — those tilted ground normals injected large
    spurious along-track gradients into the mapping solve. The reference's
    QR fit + 0.2 residual check (mapping_scan_matcher.cc:216) has the same
    blind spot; this gate closes it.
    """
    m = neighbor_valid[..., None].astype(neighbors.dtype)
    cnt = jnp.maximum(jnp.sum(m, axis=-2), 1.0)
    center = jnp.sum(neighbors * m, axis=-2) / cnt
    # Total-least-squares on CENTERED coordinates: normal = eigenvector of
    # the smallest scatter eigenvalue. The reference's n.x = -1 normal-
    # equation solve on absolute coordinates (mapping_scan_matcher.cc:
    # 198-214) is float64-safe under Ceres but catastrophically ill-
    # conditioned in float32 for tight clusters far from the origin
    # (cond(AtA) ~ (range/spread)^2 squared again by the adjugate solve):
    # at 30 m it produced arbitrary tilted ground normals that injected
    # spurious along-track gradients into the mapping GN.
    centered = (neighbors - center[..., None, :]) * m
    scatter = jnp.einsum("...ki,...kj->...ij", centered, centered)
    w, V = eigh3x3(scatter)
    normal = V[..., :, 2]  # smallest-eigenvalue direction
    resid = jnp.abs(
        jnp.einsum("...i,...ki->...k", normal, neighbors - center[..., None, :])
    )
    resid = jnp.where(neighbor_valid, resid, 0.0)
    spread_ok = w[..., 1] > cond_frac * w[..., 0]
    all_valid = jnp.all(neighbor_valid, axis=-1)
    valid = all_valid & jnp.all(resid <= tol, axis=-1) & spread_ok
    return PlaneFit(center, normal, valid)


def fit_planes_two_scale(near: Array, near_valid: Array,
                         wide: Array, wide_valid: Array,
                         tol: float = 0.2, cond_frac: float = 0.05,
                         min_wide: int = 5) -> PlaneFit:
    """Strict 5-NN plane fit with a wide-neighborhood TLS fallback.

    Where the strict fit fails (typically the spread gate: the 5-NN
    neighborhood is a single collinear ring arc — floor/ceiling grazed
    along the scan ring), refit on the wide candidate set (more points,
    larger radius, spanning adjacent ring arcs). The fallback is accepted
    only if (a) it has >= ``min_wide`` points and passes the same
    tol/spread gates, and (b) every valid NEAR neighbor also lies within
    ``tol`` of the fallback plane — the local arc must be ON the plane,
    which rejects planes polluted by hash-collision aliens or unrelated
    surfaces in the wide set.
    """
    near_fit = fit_planes(near, near_valid, tol, cond_frac)

    m = wide_valid[..., None].astype(wide.dtype)
    cnt = jnp.sum(m, axis=-2)
    center = jnp.sum(wide * m, axis=-2) / jnp.maximum(cnt, 1.0)
    centered = (wide - center[..., None, :]) * m
    scatter = jnp.einsum("...ki,...kj->...ij", centered, centered)
    w, V = eigh3x3(scatter)
    normal = V[..., :, 2]
    resid_w = jnp.abs(jnp.einsum(
        "...i,...ki->...k", normal, wide - center[..., None, :]))
    resid_w = jnp.where(wide_valid, resid_w, 0.0)
    resid_near = jnp.abs(jnp.einsum(
        "...i,...ki->...k", normal, near - center[..., None, :]))
    resid_near = jnp.where(near_valid, resid_near, 0.0)
    fb_ok = ((cnt[..., 0] >= min_wide)
             & (w[..., 1] > cond_frac * w[..., 0])
             & jnp.all(resid_w <= tol, axis=-1)
             & jnp.all(resid_near <= tol, axis=-1))

    use_fb = ~near_fit.valid & fb_ok
    return PlaneFit(
        center=jnp.where(use_fb[..., None], center, near_fit.center),
        normal=jnp.where(use_fb[..., None], normal, near_fit.normal),
        valid=near_fit.valid | use_fb,
    )


def _weighted_scatter(cand: Array, w: Array) -> Tuple[Array, Array, Array]:
    """(count, center, centered scatter matrix) of ``cand`` rows weighted
    by 0/1 mask ``w`` — the sufficient statistics for line/plane fits,
    computed WITHOUT materializing a gathered neighbor list: einsums over
    the candidate slab replace a per-query top-k gather."""
    wf = w.astype(cand.dtype)
    cnt = jnp.sum(wf, axis=-1)
    center = jnp.einsum("...c,...ci->...i", wf, cand) \
        / jnp.maximum(cnt, 1.0)[..., None]
    centered = cand - center[..., None, :]
    scatter = jnp.einsum("...c,...ci,...cj->...ij", wf, centered, centered)
    return cnt, center, scatter


def fit_lines_weighted(cand: Array, w: Array, min_count: int,
                       eig_ratio: float = 3.0) -> LineFit:
    """``fit_lines`` from a 0/1 candidate weighting (mask of the k nearest
    within radius): direction = largest eigenvector of the weighted
    centered scatter; valid iff >= min_count points and lambda_max >
    eig_ratio * lambda_mid (mapping_scan_matcher.cc:147)."""
    cnt, center, scatter = _weighted_scatter(cand, w)
    wv, V = eigh3x3(scatter)
    direction = V[..., :, 0]
    valid = (cnt >= min_count) & (wv[..., 0] > eig_ratio * wv[..., 1])
    return LineFit(center, direction, valid)


def fit_planes_weighted(cand: Array, w: Array, min_count: int,
                        tol: float = 0.2, cond_frac: float = 0.05
                        ) -> PlaneFit:
    """``fit_planes`` (centered TLS + spread gate + residual tolerance)
    from a 0/1 candidate weighting, gather-free."""
    cnt, center, scatter = _weighted_scatter(cand, w)
    wv, V = eigh3x3(scatter)
    normal = V[..., :, 2]
    resid = jnp.abs(jnp.einsum(
        "...i,...ci->...c", normal, cand - center[..., None, :]))
    resid = resid * w.astype(resid.dtype)
    valid = ((cnt >= min_count)
             & (jnp.max(resid, axis=-1) <= tol)
             & (wv[..., 1] > cond_frac * wv[..., 0]))
    return PlaneFit(center, normal, valid)


def fit_planes_two_scale_weighted(cand: Array, w_near: Array,
                                  wide_mask: Array, min_near: int,
                                  tol: float = 0.2, cond_frac: float = 0.05,
                                  min_wide: int = 5) -> PlaneFit:
    """Gather-free two-scale plane fit: strict fit from the k-NN weight
    mask, wide moments fallback over all in-radius candidates, with the
    near-neighborhood-on-plane admission check done as a masked max."""
    near_fit = fit_planes_weighted(cand, w_near, min_near, tol, cond_frac)

    cnt, center, scatter = _weighted_scatter(cand, wide_mask)
    wv, V = eigh3x3(scatter)
    normal = V[..., :, 2]
    resid = jnp.abs(jnp.einsum(
        "...i,...ci->...c", normal, cand - center[..., None, :]))
    resid_w = jnp.max(resid * wide_mask.astype(resid.dtype), axis=-1)
    resid_n = jnp.max(resid * w_near.astype(resid.dtype), axis=-1)
    fb_ok = ((cnt >= min_wide)
             & (wv[..., 1] > cond_frac * wv[..., 0])
             & (resid_w <= tol) & (resid_n <= tol))

    use_fb = ~near_fit.valid & fb_ok
    return PlaneFit(
        center=jnp.where(use_fb[..., None], center, near_fit.center),
        normal=jnp.where(use_fb[..., None], normal, near_fit.normal),
        valid=near_fit.valid | use_fb,
    )


def fit_planes_two_scale_masked(near: Array, near_valid: Array,
                                cand: Array, wide_mask: Array,
                                tol: float = 0.2, cond_frac: float = 0.05,
                                min_wide: int = 5) -> PlaneFit:
    """``fit_planes_two_scale`` with the wide fit computed from masked
    MOMENTS over the full candidate set instead of a top-k2 subset.

    The wide fallback only needs the centered scatter matrix of the
    in-radius candidates — not a sorted neighbor list — so the top-k and
    its take_along_axis gather (Q*k2 rows) are replaced
    by two masked einsums. Uses ALL in-radius candidates (<= the full
    octant gather), which also makes the fallback fit better-conditioned
    than any 16-point subset.
    """
    near_fit = fit_planes(near, near_valid, tol, cond_frac)

    m = wide_mask[..., None].astype(cand.dtype)
    cnt = jnp.sum(m, axis=-2)
    center = jnp.sum(cand * m, axis=-2) / jnp.maximum(cnt, 1.0)
    centered = (cand - center[..., None, :]) * m
    scatter = jnp.einsum("...ki,...kj->...ij", centered, centered)
    w, V = eigh3x3(scatter)
    normal = V[..., :, 2]
    resid_w = jnp.abs(jnp.einsum(
        "...i,...ki->...k", normal, cand - center[..., None, :]))
    resid_w = jnp.where(wide_mask, resid_w, 0.0)
    resid_near = jnp.abs(jnp.einsum(
        "...i,...ki->...k", normal, near - center[..., None, :]))
    resid_near = jnp.where(near_valid, resid_near, 0.0)
    fb_ok = ((cnt[..., 0] >= min_wide)
             & (w[..., 1] > cond_frac * w[..., 0])
             & (jnp.max(resid_w, axis=-1) <= tol)
             & (jnp.max(resid_near, axis=-1) <= tol))

    use_fb = ~near_fit.valid & fb_ok
    return PlaneFit(
        center=jnp.where(use_fb[..., None], center, near_fit.center),
        normal=jnp.where(use_fb[..., None], normal, near_fit.normal),
        valid=near_fit.valid | use_fb,
    )


def _solve3x3(A: Array, b: Array) -> Tuple[Array, Array]:
    """Batched 3x3 linear solve via adjugate; returns (x, det)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = jnp.where(jnp.abs(det) > 1e-30, 1.0 / det, 0.0)
    adj = jnp.stack(
        [
            c00, a02 * a21 - a01 * a22, a01 * a12 - a02 * a11,
            c01, a00 * a22 - a02 * a20, a02 * a10 - a00 * a12,
            c02, a01 * a20 - a00 * a21, a00 * a11 - a01 * a10,
        ],
        axis=-1,
    ).reshape(A.shape)
    x = jnp.einsum("...ij,...j->...i", adj, b) * inv_det[..., None]
    return x, det
