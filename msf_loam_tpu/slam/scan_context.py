"""Scan-context place recognition for loop-closure detection.

The reference lists "Loop closure by scancontext" as an unimplemented TODO
(its ``README.md:70-72``); this module implements it as batched array
work:

* descriptor — the classic scan-context image: an (R rings x S sectors)
  polar grid around the sensor, each bin holding the max point height.
  Built as one masked ``segment_max`` scatter per scan; batched over
  keyframes with ``vmap``.
* matching — column-shift-minimized cosine distance. Rotating the sensor
  permutes descriptor COLUMNS, so scoring all S cyclic shifts makes the
  match yaw-invariant, and the argmin shift is a yaw initial guess for the
  scan matcher. All N^2 x S comparisons are a couple of batched matmuls
  (f32 matmuls), not a loop.

Unlike position-proximity detection (loop_closure.detect_loops), this
recognizes revisits by APPEARANCE, so it keeps working when odometry drift
has moved the trajectory estimate arbitrarily far from the truth.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def compute_descriptor(xyz: Array, mask: Array, n_rings: int = 16,
                       n_sectors: int = 60, max_radius: float = 20.0,
                       min_z: float = -2.0) -> Array:
    """Scan-context descriptor of one scan: (n_rings, n_sectors) max-height
    image over a polar partition of the sensor's surroundings.

    xyz: (N, 3) sensor-frame points, mask: (N,) validity. Heights are
    offset by ``min_z`` so "empty bin" (0) sorts below any observed point.
    """
    r = jnp.sqrt(xyz[:, 0] ** 2 + xyz[:, 1] ** 2)
    theta = jnp.arctan2(xyz[:, 1], xyz[:, 0])          # [-pi, pi)
    ring = jnp.clip((r / max_radius * n_rings).astype(jnp.int32),
                    0, n_rings - 1)
    sector = jnp.clip(((theta + jnp.pi) / (2 * jnp.pi) * n_sectors)
                      .astype(jnp.int32), 0, n_sectors - 1)
    flat_bin = ring * n_sectors + sector
    ok = mask & (r < max_radius)
    # invalid points route to a trash bin
    flat_bin = jnp.where(ok, flat_bin, n_rings * n_sectors)
    z = jnp.where(ok, xyz[:, 2] - min_z, -jnp.inf)
    img = jax.ops.segment_max(z, flat_bin,
                              num_segments=n_rings * n_sectors + 1)
    img = jnp.maximum(img[:-1], 0.0)                   # empty bins -> 0
    return img.reshape(n_rings, n_sectors)


def shifted_distances(desc_a: Array, descs_b: Array) -> Tuple[Array, Array]:
    """Distance of one descriptor against a batch, minimized over all
    column shifts.

    desc_a: (R, S); descs_b: (M, R, S). Returns (dist (M,), shift (M,)).
    Distance is the scan-context cosine distance: 1 - mean over sectors of
    the per-column cosine similarity, at the best cyclic shift. The per-
    shift score for ALL shifts at once is an (S,RS) x (RS,M) matmul of
    rolled, column-normalized descriptors.
    """
    S = desc_a.shape[1]

    def norm_cols(d):  # (..., R, S) column-normalize
        n = jnp.linalg.norm(d, axis=-2, keepdims=True)
        return d / jnp.maximum(n, 1e-6)

    a = norm_cols(desc_a)
    b = norm_cols(descs_b)
    # rolled copies of a: (S, R, S)
    rolled = jax.vmap(lambda s: jnp.roll(a, s, axis=1))(jnp.arange(S))
    # cosine similarity summed over rings and sectors, per (shift, item)
    sims = jnp.einsum("krs,mrs->km", rolled, b) / S    # (S, M)
    best = jnp.argmax(sims, axis=0)                    # (M,)
    return 1.0 - jnp.max(sims, axis=0), best


@jax.jit
def pairwise_min_distances(descs: Array) -> Tuple[Array, Array]:
    """All-pairs shift-minimized distances: (N, R, S) -> dist (N, N),
    argmin shift (N, N)."""
    return jax.vmap(lambda d: shifted_distances(d, descs))(descs)


def _prescreened_distances(descs: Array, k: int, min_index_gap: int):
    """Two-stage pairwise distances: L1 ring-key ranking picks the k best
    candidates per query; only those pairs get exact shifted scoring.
    Non-candidates are reported as +inf (never detected).

    Pairs the detector can never accept — j < i + min_index_gap, i.e.
    temporally adjacent keyframes (near-identical ring keys) and j<=i
    duplicates — are masked out BEFORE top_k so the whole k budget goes to
    admissible revisit candidates instead of being eaten by neighbors."""
    n = descs.shape[0]
    keys = ring_key(descs)                                   # (N, R)
    kd = jnp.sum(jnp.abs(keys[:, None, :] - keys[None, :, :]), axis=-1)
    ii = jnp.arange(n)
    inadmissible = (ii[None, :] - ii[:, None]) < min_index_gap   # j-i < gap
    kd = jnp.where(inadmissible, jnp.inf, kd)
    _, cand = jax.lax.top_k(-kd, k)                          # (N, k)
    cd = descs[cand.reshape(-1)].reshape((n, k) + descs.shape[1:])
    d_sub, s_sub = jax.vmap(shifted_distances)(descs, cd)    # (N, k) x2
    cand_np = np.asarray(jax.device_get(cand))
    d = np.full((n, n), np.inf, np.float32)
    shift = np.zeros((n, n), np.int64)
    rows = np.arange(n)[:, None]
    d[rows, cand_np] = np.asarray(jax.device_get(d_sub))
    shift[rows, cand_np] = np.asarray(jax.device_get(s_sub))
    return d, shift


def ring_key(descs: Array) -> Array:
    """Rotation-invariant ring occupancy vector: (..., R, S) -> (..., R).

    Rotating the sensor permutes sectors WITHIN each ring, so the per-ring
    occupancy ratio is shift-invariant — the classic scan-context fast
    prescreen key."""
    return (descs > 0).mean(axis=-1)


def detect_loops_scan_context(descs: np.ndarray, min_index_gap: int = 20,
                              max_dist: float = 0.25, max_loops: int = 8,
                              suppress_gap: int = 10, prescreen: int = 0
                              ) -> List[Tuple[int, int, float]]:
    """Appearance-based loop candidates.

    descs: (N, R, S) stacked keyframe descriptors. Returns (i, j,
    yaw_guess) triples, closest-first with non-max suppression; yaw_guess
    (radians) comes from the best column shift and seeds the scan matcher.

    ``prescreen > 0`` enables the two-stage search: rotation-invariant
    ring keys rank all pairs cheaply (N^2 x R instead of N^2 x R x S^2),
    and only the best ``prescreen``-per-query pairs get full shifted
    scoring. Exact scoring for the surviving pairs; at KITTI-scale
    keyframe counts this cuts the detect cost ~S-fold.
    """
    descs = jnp.asarray(descs, jnp.float32)
    n, _, n_sectors = descs.shape
    if n < 2:
        return []
    if prescreen and n > prescreen:
        d, shift = _prescreened_distances(descs, prescreen, min_index_gap)
    else:
        d, shift = jax.device_get(pairwise_min_distances(descs))
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    cand = (jj - ii >= min_index_gap) & (d < max_dist)
    order = np.argsort(d[cand])
    ci, cj = ii[cand][order], jj[cand][order]
    picked: List[Tuple[int, int, float]] = []
    for i, j in zip(ci, cj):
        if len(picked) >= max_loops:
            break
        if any(abs(i - pi) < suppress_gap and abs(j - pj) < suppress_gap
               for pi, pj, _ in picked):
            continue
        # best shift k: rolling i's columns by k matches j, i.e. frame j is
        # rotated by -k sectors relative to frame i (sign checked in tests)
        yaw = -float(shift[i, j]) / n_sectors * 2.0 * np.pi
        if yaw <= -np.pi:
            yaw += 2.0 * np.pi
        picked.append((int(i), int(j), yaw))
    return picked
