"""Voxel-grid downsampling as segment reductions.

Batched replacement for ``pcl::VoxelGrid`` as used by the reference for
less-flat thinning (leaf 0.2, ``msf_loam_node.cc:113-126``), the mapping
feature filters (leaf 0.2/0.4, ``laser_mapping.cc:67-68``) and the per-cell
map re-filter (``hybrid_grid.cc:503-521``). PCL keeps voxel centroids; we
keep one representative point per occupied voxel (deterministic, index-
preserving — the reference itself switches to index-copying via
``getIndices`` to preserve ring/time fields, msf_loam_node.cc:123-125).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

# Large prime multipliers for 3D -> 1D voxel key hashing (open addressing).
# NumPy scalars: importing this module must not initialise a JAX backend.
_P1 = np.uint32(73856093)
_P2 = np.uint32(19349663)
_P3 = np.uint32(83492791)


def voxel_keys(xyz: Array, leaf: float, origin: float = 4096.0) -> Array:
    """Quantize points to voxel grid coordinates and pack into int32 keys.

    ``origin`` shifts coordinates positive so packing is collision-free for
    |x| < origin (16 bits per axis would overflow; we hash instead)."""
    ijk = jnp.floor((xyz + origin) / leaf).astype(jnp.uint32)
    key = (ijk[..., 0] * _P1) ^ (ijk[..., 1] * _P2) ^ (ijk[..., 2] * _P3)
    return key.astype(jnp.int32)


def voxel_downsample_masked(xyz: Array, mask: Array, leaf: float,
                            salt: Array | None = None) -> Array:
    """Return a boolean keep-mask with one representative per occupied voxel.

    Deterministic: keeps the lowest-index valid point in each voxel.
    Fixed-shape: output mask has the same length as the input.
    ``salt`` (optional per-point int32) partitions the filter — points with
    different salts never share a voxel. With salt=ring this reproduces the
    reference's per-ring less-flat filtering (one pcl::VoxelGrid per scan
    line, concatenated — msf_loam_node.cc:347-348).
    """
    n = xyz.shape[0]
    key = voxel_keys(xyz, leaf)
    if salt is not None:
        key = key ^ (salt.astype(jnp.int32) * jnp.int32(40503))
    # invalid points get a unique sentinel key so they never collide
    key = jnp.where(mask, key, jnp.arange(n, dtype=jnp.int32) | jnp.int32(-2147483648))
    order = jnp.argsort(key, stable=True)
    sorted_key = key[order]
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_key[1:] != sorted_key[:-1]]
    )
    keep_sorted = first
    keep = jnp.zeros((n,), bool).at[order].set(keep_sorted)
    return keep & mask


def voxel_downsample_compact_idx(xyz: Array, mask: Array, leaf: float,
                                 capacity: int,
                                 salt: Array | None = None):
    """Voxel dedup + front-compaction in ONE sort pass.

    Returns (idx (capacity,) int32, valid (capacity,) bool): indices of one
    representative (lowest original index) per occupied voxel, in voxel-key
    order, padded with 0 where fewer than ``capacity`` voxels are occupied.
    Equivalent to ``voxel_downsample_masked`` followed by a stable
    compaction, but skips the second full-length argsort (over R*W=131k
    elements at 64-ring scale).
    """
    n = xyz.shape[0]
    # lax.top_k below requires capacity <= n (the scatter-based compaction
    # this replaced tolerated any capacity); callers may legitimately set a
    # budget above the input size, and >n slots could never fill anyway
    capacity = min(capacity, n)
    key = voxel_keys(xyz, leaf)
    if salt is not None:
        key = key ^ (salt.astype(jnp.int32) * jnp.int32(40503))
    iota = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(mask, key, iota | jnp.int32(-2147483648))
    # Multi-operand sort carries the permutation AND the mask through in
    # one pass instead of two `key[order]` / `mask[order]` random gathers.
    ks, order, mask_s = jax.lax.sort(
        [key, iota, mask.astype(jnp.int32)], num_keys=1, is_stable=True)
    first = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    keep = first & (mask_s == 1)
    # compact by rank WITHOUT a scatter: the kept positions are already in
    # output order, so the first `capacity` of them are exactly the
    # `capacity` smallest sorted-array positions among `keep` — one top_k
    # instead of a 131k-update scatter.
    posval = jnp.where(keep, iota, jnp.int32(2**30))
    neg_p, _ = jax.lax.top_k(-posval, capacity)
    p = -neg_p                                   # ascending kept positions
    valid = p < jnp.int32(2**30)
    idx = order[jnp.minimum(p, n - 1)].astype(jnp.int32)
    return jnp.where(valid, idx, 0), valid


def voxel_downsample_centroid(xyz: Array, mask: Array, leaf: float,
                              capacity: int):
    """Centroid-style voxel filter (closer to pcl::VoxelGrid semantics).

    Returns (points (capacity,3), valid (capacity,)) — per-voxel centroids,
    compacted to the front. Used where ring/time need not survive.
    """
    n = xyz.shape[0]
    key = voxel_keys(xyz, leaf)
    key = jnp.where(mask, key, jnp.arange(n, dtype=jnp.int32) | jnp.int32(-2147483648))
    order = jnp.argsort(key, stable=True)
    k_sorted = key[order]
    x_sorted = jnp.where(mask[order, None], xyz[order], 0.0)
    m_sorted = mask[order]
    seg_start = jnp.concatenate([jnp.ones((1,), bool), k_sorted[1:] != k_sorted[:-1]])
    seg_id = jnp.cumsum(seg_start.astype(jnp.int32)) - 1
    sums = jax.ops.segment_sum(x_sorted, seg_id, num_segments=capacity)
    cnts = jax.ops.segment_sum(m_sorted.astype(jnp.float32), seg_id,
                               num_segments=capacity)
    valid = cnts > 0
    pts = sums / jnp.maximum(cnts, 1.0)[:, None]
    return pts, valid
