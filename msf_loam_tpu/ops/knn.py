"""Batched exact k-nearest-neighbor search.

Replaces the reference's per-point ``pcl::KdTreeFLANN`` queries
(``odometry_scan_matcher.cc:57-61,84,169``; ``mapping_scan_matcher.cc:66-73,
125,195``) with dense blockwise distance computation: the Q x M distance
matrix is built chunk-by-chunk as ``|q|^2 + |r|^2 - 2 q.r^T`` so the inner
product is one matmul (pinned to f32 precision — the expansion cancels
catastrophically otherwise), and a running top-k is merged per chunk. No
trees, no pointers — O(Q*M) dense work instead of tree construction +
traversal.

``knn_hashgrid`` (the production mapping path) lives in ``slam/voxel_map.py``
because it is fused with the map data structure.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from msf_loam_tpu.core.precision import f32_matmuls

Array = jax.Array

# NumPy scalar: importing this module must not initialise a JAX backend
_INF = np.float32(3.0e38)


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
@f32_matmuls
def knn(query: Array, query_mask: Array, ref: Array, ref_mask: Array,
        k: int = 5, chunk: int = 8192) -> Tuple[Array, Array]:
    """Exact k-NN from each query point into the reference set.

    Args:
      query: (Q, 3) float32; query_mask: (Q,) bool.
      ref:   (M, 3) float32; ref_mask:   (M,) bool.
      k:     neighbors per query.
      chunk: reference points per block (trades memory for steps).

    Returns:
      (d2, idx): (Q, k) squared distances (ascending) and reference indices.
      Invalid refs never appear; queries keep masked rows too (caller gates
      on query_mask). Slots beyond the number of valid refs get d2=+inf,
      idx=-1.
    """
    q = query.astype(jnp.float32)
    m = ref.shape[0]
    pad = (-m) % chunk
    ref_p = jnp.pad(ref.astype(jnp.float32), ((0, pad), (0, 0)))
    mask_p = jnp.pad(ref_mask, (0, pad))
    n_chunks = ref_p.shape[0] // chunk
    ref_c = ref_p.reshape(n_chunks, chunk, 3)
    mask_c = mask_p.reshape(n_chunks, chunk)

    q_norm = jnp.sum(q * q, axis=-1, keepdims=True)  # (Q, 1)

    def body(carry, inp):
        best_d, best_i = carry
        r, rm, base = inp
        r_norm = jnp.sum(r * r, axis=-1)  # (C,)
        d2 = q_norm + r_norm[None, :] - 2.0 * (q @ r.T)  # (Q, C)
        d2 = jnp.where(rm[None, :], jnp.maximum(d2, 0.0), _INF)
        idx = base + jnp.arange(chunk, dtype=jnp.int32)[None, :]
        cat_d = jnp.concatenate([best_d, d2], axis=1)
        cat_i = jnp.concatenate([best_i, jnp.broadcast_to(idx, d2.shape)], axis=1)
        neg_top, arg = jax.lax.top_k(-cat_d, k)
        new_d = -neg_top
        new_i = jnp.take_along_axis(cat_i, arg, axis=1)
        return (new_d, new_i), None

    init = (
        jnp.full((q.shape[0], k), _INF, jnp.float32),
        jnp.full((q.shape[0], k), -1, jnp.int32),
    )
    bases = (jnp.arange(n_chunks, dtype=jnp.int32) * chunk)
    (d2, idx), _ = jax.lax.scan(body, init, (ref_c, mask_c, bases))
    idx = jnp.where(d2 >= _INF, -1, idx)
    return d2, idx


def gather_neighbors(ref: Array, idx: Array) -> Array:
    """Gather neighbor coordinates: (M,3) x (Q,k) -> (Q,k,3); idx=-1 -> 0."""
    safe = jnp.maximum(idx, 0)
    out = ref[safe]
    return jnp.where((idx >= 0)[..., None], out, 0.0)
