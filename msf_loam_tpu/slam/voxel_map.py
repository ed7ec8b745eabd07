"""Fixed-capacity spatial-hash voxel map.

Batched replacement for the reference's Cartographer-style HybridGrid
(``/root/reference/src/slam/map/hybrid_grid.cc:462-534``): per-cell point
clouds, voxel-deduplicated on insert (the ``InsertScan`` re-filter at
hybrid_grid.cc:503-521), queried by gathering a 27-cell neighborhood around
each scan point (``GetSurroundedCloud``'s +/-1 dilation, hybrid_grid.cc:
474-481). The dynamic pointer grid becomes a flat hash table of fixed-size
point slabs so insert/query are pure gather/scatter with static shapes:

* ``points``   (H, P, 3)  — slab of up to P points per hash slot
* ``leaf_key`` (H, P)     — packed leaf-voxel id per stored point, giving
                            one-point-per-leaf-voxel dedup on insert
* ``count``    (H,)       — occupancy per slot

Cells hash into slots without collision resolution; a collision only mixes
far-apart cells into one candidate slab, and the kNN distance gate
(d^2 < 1.0, mapping_scan_matcher.cc:128) rejects the aliens. The whole map
is a pytree, threaded through the jitted frame step with buffer donation.
Sharding story: shard the H axis across devices; each device owns a slot
range, inserts locally, answers queries over its shard, and top-k results
merge with an all-gather (see parallel/sharded_map.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

# Module constants are NumPy, not device arrays: importing this module must
# not initialise a JAX backend (see ops/features.py).
_P1 = np.uint32(73856093)
_P2 = np.uint32(19349663)
_P3 = np.uint32(83492791)


def _hash_cells(cells: Array, table_size: int) -> Array:
    """(..., 3) int32 cell coords -> slot index in [0, table_size)."""
    c = cells.astype(jnp.uint32)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return (h % jnp.uint32(table_size)).astype(jnp.int32)


class VoxelHashMap(NamedTuple):
    points: Array     # (H, P, 3) float32 — running per-leaf-voxel centroids
    leaf_key: Array   # (H, P) int32
    count: Array      # (H,) int32
    n_obs: Array      # (H, P) float32 — observations per stored point
    cell_size: Array  # () float32
    leaf: Array       # () float32

    @property
    def table_size(self) -> int:
        return self.points.shape[0]

    @property
    def slab_capacity(self) -> int:
        return self.points.shape[1]

    def total_points(self) -> Array:
        return jnp.sum(self.count)


# Unoccupied slab entries hold this coordinate in every component — an
# INVARIANT maintained by create_map/insert_at_slots/evict_far: a slab
# entry past the count can never pass a radius gate (sentinel coords give
# d2 ~ 3e18; 3 * EMPTY_COORD^2 stays < f32 max).
EMPTY_COORD = 1.0e9


def create_map(table_size: int, slab_capacity: int, cell_size: float,
               leaf: float) -> VoxelHashMap:
    return VoxelHashMap(
        points=jnp.full((table_size, slab_capacity, 3), EMPTY_COORD,
                        jnp.float32),
        leaf_key=jnp.full((table_size, slab_capacity), -1, jnp.int32),
        count=jnp.zeros((table_size,), jnp.int32),
        n_obs=jnp.zeros((table_size, slab_capacity), jnp.float32),
        cell_size=jnp.float32(cell_size),
        leaf=jnp.float32(leaf),
    )


@functools.partial(jax.jit, static_argnames=("centroid_updates",))
def insert(vmap: VoxelHashMap, xyz: Array, mask: Array,
           centroid_updates: bool = False) -> VoxelHashMap:
    """Insert world-frame points, one representative per leaf voxel.

    Semantics follow HybridGridImpl::InsertScan (hybrid_grid.cc:503-521):
    bin by cell, then keep per-cell clouds thinned at leaf resolution.
    The first observation of a leaf voxel is kept; with
    ``centroid_updates=True`` later observations fold into a running
    centroid instead (pcl::VoxelGrid-like — measured to SMEAR the map with
    misregistered points and worsen ATE, hence off by default). Full slabs
    drop overflow (the reference's grid is unbounded; our slabs bound it —
    size them for the leaf/cell ratio).
    """
    H = vmap.table_size
    cells = jnp.floor(xyz / vmap.cell_size).astype(jnp.int32)
    slot = _hash_cells(cells, H)
    return insert_at_slots(vmap, xyz, mask, slot, centroid_updates)


@jax.named_scope("map_insert")
def insert_at_slots(vmap: VoxelHashMap, xyz: Array, mask: Array,
                    slot: Array, centroid_updates: bool = False,
                    leaf_salt: Array = None) -> VoxelHashMap:
    """Insert with caller-provided slot ids (the sharded map passes
    shard-local slots; `insert` passes the global hash).

    ``leaf_salt`` (per-point int32) separates leaf-voxel namespaces when
    logically-distinct maps share one table (the fused batch pipeline salts
    by sequence id — without it a point from one sequence would suppress
    another sequence's insert in the same world voxel)."""
    H, P = vmap.table_size, vmap.slab_capacity
    n = xyz.shape[0]

    rep = _dedup_batch(xyz, mask, vmap.leaf, salt=leaf_salt)
    lkey = _leaf_key_dyn(xyz, vmap.leaf)
    if leaf_salt is not None:
        lkey = lkey ^ (leaf_salt * jnp.int32(40503))
    slot = jnp.clip(slot, 0, H - 1)
    slot = jnp.where(mask, slot, H - 1)

    # representatives whose leaf voxel already exists fold into the stored
    # running centroid (pcl::VoxelGrid keeps centroids; first-point-only
    # stored a noisier map) instead of being dropped
    slab_keys = vmap.leaf_key[slot]                     # (n, P)
    occup = jnp.arange(P)[None, :] < vmap.count[slot][:, None]
    match = (slab_keys == lkey[:, None]) & occup
    dup = jnp.any(match, axis=1)
    dup_pos = jnp.argmax(match, axis=1)                 # first matching slot
    keep = rep & ~dup
    # at most one fold per (slot, pos) per batch -> exact running mean
    if centroid_updates:
        upd = rep & dup
        u_slot = jnp.where(upd, slot, H)
        u_pos = jnp.where(upd, dup_pos, 0)
        n_obs = vmap.n_obs.at[u_slot, u_pos].add(
            upd.astype(jnp.float32), mode="drop")
        denom = jnp.maximum(n_obs[jnp.clip(u_slot, 0, H - 1), u_pos], 1.0)
        delta = (xyz - vmap.points[jnp.clip(u_slot, 0, H - 1), u_pos]) \
            / denom[:, None]
        new_points = vmap.points.at[u_slot, u_pos].add(
            jnp.where(upd[:, None], delta, 0.0), mode="drop")
    else:
        # default path: duplicates are dropped, not folded — skip the two
        # full-table no-op scatters (each would copy the (H,P,*) buffers)
        n_obs = vmap.n_obs
        new_points = vmap.points

    # rank new points within their slot (stable) to get write offsets
    sent = jnp.int32(H)
    key = jnp.where(keep, slot, sent)
    order = jnp.argsort(key, stable=True)
    ks = key[order]
    pos = jnp.arange(n)
    is_start = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    seg_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_start, pos, 0))
    rank_sorted = pos - seg_start
    rank = jnp.zeros((n,), jnp.int32).at[order].set(rank_sorted.astype(jnp.int32))

    dest = vmap.count[slot] + rank
    ok = keep & (dest < P)
    w_slot = jnp.where(ok, slot, H)   # out-of-bounds => dropped by mode="drop"
    w_dest = jnp.where(ok, dest, 0)

    new_points = new_points.at[w_slot, w_dest].set(xyz, mode="drop")
    new_keys = vmap.leaf_key.at[w_slot, w_dest].set(lkey, mode="drop")
    n_obs = n_obs.at[w_slot, w_dest].set(
        jnp.ones((n,), jnp.float32), mode="drop")
    new_count = vmap.count.at[w_slot].add(ok.astype(jnp.int32), mode="drop")
    new_count = jnp.minimum(new_count, P)
    return vmap._replace(points=new_points, leaf_key=new_keys,
                         count=new_count, n_obs=n_obs)


@jax.jit
def evict_far(vmap: VoxelHashMap, center: Array, radius: float = 100.0
              ) -> VoxelHashMap:
    """Drop stored points farther than ``radius`` from center.

    The reference keeps an unbounded grid but only queries a 60 m surround
    (hybrid_grid.cc:474,532); a fixed-size hash table instead needs
    eviction so km-scale trajectories don't exhaust slots via collisions.
    Eviction is per stored POINT, not per slot: hash collisions mix
    far-apart cells into one slab, so a slot-level anchor test would evict
    (or wrongly retain) live near cells that share a slot with stale far
    ones. Each slab is compacted with a stable keep-first argsort —
    O(H * P log P) elementwise/sort work, run every few frames.
    """
    H, P = vmap.table_size, vmap.slab_capacity
    occup = jnp.arange(P)[None, :] < vmap.count[:, None]         # (H, P)
    # center: (3,) single anchor, or (H, 3) per-slot anchors (the fused
    # multi-sequence table evicts each lane around ITS trajectory)
    c = center[None, None, :] if center.ndim == 1 else center[:, None, :]
    d2 = jnp.sum((vmap.points - c) ** 2, axis=-1)
    keep = occup & (d2 <= radius * radius)
    order = jnp.argsort(~keep, axis=1, stable=True)              # kept first
    new_points = jnp.take_along_axis(vmap.points, order[..., None], axis=1)
    new_keys = jnp.take_along_axis(vmap.leaf_key, order, axis=1)
    new_nobs = jnp.take_along_axis(vmap.n_obs, order, axis=1)
    new_count = jnp.sum(keep, axis=1).astype(jnp.int32)
    live = jnp.arange(P)[None, :] < new_count[:, None]
    new_keys = jnp.where(live, new_keys, -1)
    # maintain the EMPTY_COORD tail invariant (evicted entries would
    # otherwise keep their real coords past the count boundary)
    new_points = jnp.where(live[..., None], new_points, EMPTY_COORD)
    return vmap._replace(points=new_points, leaf_key=new_keys,
                         count=new_count, n_obs=new_nobs)


def _dedup_batch(xyz: Array, mask: Array, leaf: Array,
                 salt: Array = None) -> Array:
    """One representative per (salted) leaf voxel within the incoming batch."""
    n = xyz.shape[0]
    key = _leaf_key_dyn(xyz, leaf)
    if salt is not None:
        key = key ^ (salt * jnp.int32(40503))
    key = jnp.where(mask, key, jnp.arange(n, dtype=jnp.int32) | jnp.int32(-2147483648))
    order = jnp.argsort(key, stable=True)
    ks = key[order]
    first = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    keep = jnp.zeros((n,), bool).at[order].set(first)
    return keep & mask


def _leaf_key_dyn(xyz: Array, leaf: Array, origin: float = 8192.0) -> Array:
    ijk = jnp.floor((xyz + origin) / leaf).astype(jnp.uint32)
    k = (ijk[..., 0] * _P1) ^ (ijk[..., 1] * _P2) ^ (ijk[..., 2] * _P3)
    return k.astype(jnp.int32)


# corner offsets of a 2x2x2 cell block, shaped (8, 3)
_OFFSETS8 = np.stack(np.meshgrid(
    np.arange(2), np.arange(2), np.arange(2),
    indexing="ij"), axis=-1).reshape(-1, 3).astype(np.int32)


def neighbor_cells8(q: Array, cell_size: Array) -> Array:
    """The 8 cells that can contain any point within cell_size/2 of q.

    For a search radius r <= cell_size/2, the ball around q intersects at
    most 2 cells per axis — the cell of q plus the neighbor on the side of
    q's octant. A 3.4x candidate reduction vs the naive 27-neighborhood.
    Returns (Q, 8, 3) int32 cell coords.
    """
    cf = q / cell_size
    base = jnp.floor(cf)
    frac = cf - base
    low = base.astype(jnp.int32) + jnp.where(frac < 0.5, -1, 0)  # (Q, 3)
    return low[:, None, :] + _OFFSETS8[None, :, :]


@functools.partial(jax.jit, static_argnames=("k",))
def query_knn(vmap: VoxelHashMap, query: Array, query_mask: Array,
              k: int = 5) -> Tuple[Array, Array, Array]:
    """k nearest map points (within cell_size/2) for each query.

    Gathers the 8-cell octant neighborhood slabs around each query point
    and top-k's by distance — the batched analog of GetSurroundedCloud +
    5-NN KD-tree search (hybrid_grid.cc:470-501 + mapping_scan_matcher.cc:
    125). Complete out to radius cell_size/2, which must cover the
    downstream distance gate (knn_dist_sq_max <= (cell_size/2)^2 — the
    reference gates at d^2 < 1.0 with our default 2.0 m cells).

    Returns (d2 (Q,k), xyz (Q,k,3), valid (Q,k)).
    """
    H, P = vmap.table_size, vmap.slab_capacity
    q = query.astype(jnp.float32)
    ncells = neighbor_cells8(q, vmap.cell_size)                  # (Q, 8, 3)
    slots = _hash_cells(ncells, H)                               # (Q, 8)

    cand = vmap.points[slots]                                    # (Q, 8, P, 3)
    occup = jnp.arange(P)[None, None, :] < vmap.count[slots][:, :, None]
    diff = cand - q[:, None, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    # enforce the completeness radius so results are order-identical to an
    # exact kNN truncated at cell_size/2
    radius_sq = (vmap.cell_size * 0.5) ** 2
    keep = occup & (d2 <= radius_sq)
    d2 = jnp.where(keep, d2, jnp.float32(3e38)).reshape(q.shape[0], -1)

    neg_top, arg = jax.lax.top_k(-d2, k)
    top_d2 = -neg_top
    top_xyz = jnp.take_along_axis(
        cand.reshape(q.shape[0], -1, 3), arg[..., None], axis=1)
    valid = (top_d2 < 1e37) & query_mask[:, None]
    return top_d2, top_xyz, valid


def gather_candidates(vmap: VoxelHashMap, query: Array, query_mask: Array
                      ) -> Tuple[Array, Array]:
    """One 8-cell octant gather, selection deferred: (Q, 8P, 3) candidate
    coordinates + (Q, 8P) occupancy.

    The gather is the costly half, so the scan-to-map matcher gathers ONCE
    per frame and re-runs only the cheap distance/top-k selection
    (``select_knn`` / ``select_knn_2r``) against the updated pose each
    re-association round. Coverage: complete
    for any ball of radius <= cell_size/2 around the GATHER positions;
    with the default gate radius == cell_size/2 a pose update of d meters
    between rounds can only lose candidates in the outer d-shell of the
    gate ball (GN steps from an odometry warm start are centimeters vs a
    1 m gate — ATE-checked in the golden evals).
    """
    H, P = vmap.table_size, vmap.slab_capacity
    q = query.astype(jnp.float32)
    ncells = neighbor_cells8(q, vmap.cell_size)                  # (Q, 8, 3)
    slots = _hash_cells(ncells, H)                               # (Q, 8)
    cand = vmap.points[slots]                                    # (Q, 8, P, 3)
    occup = jnp.arange(P)[None, None, :] < vmap.count[slots][:, :, None]
    occup = occup & query_mask[:, None, None]
    return (cand.reshape(q.shape[0], -1, 3),
            occup.reshape(q.shape[0], -1))


@functools.partial(jax.jit, static_argnames=("k",))
def select_knn(cand: Array, cand_valid: Array, query: Array,
               cell_size: Array, k: int = 5
               ) -> Tuple[Array, Array, Array]:
    """Strict top-k (radius cell_size/2) from a gathered candidate set —
    the selection half of ``query_knn`` (same result when the candidates
    were gathered at these query positions)."""
    q = query.astype(jnp.float32)
    diff = cand - q[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    keep = cand_valid & (d2 <= (cell_size * 0.5) ** 2)
    d2 = jnp.where(keep, d2, jnp.float32(3e38))
    neg_top, arg = jax.lax.top_k(-d2, k)
    top_d2 = -neg_top
    top_xyz = jnp.take_along_axis(cand, arg[..., None], axis=1)
    valid = top_d2 < 1e37
    return top_d2, top_xyz, valid


@functools.partial(jax.jit, static_argnames=("k",))
def select_knn_wide_mask(cand: Array, cand_valid: Array, query: Array,
                         cell_size: Array, k: int = 5
                         ) -> Tuple[Array, Array, Array, Array]:
    """Strict top-k plus the wide in-radius MASK over the candidates, one
    distance pass. The mask form feeds the moments-based fallback plane
    fit (fitting.fit_planes_two_scale_masked) without a second top-k or
    its take_along_axis gather."""
    q = query.astype(jnp.float32)
    diff = cand - q[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    keep = cand_valid & (d2 <= (cell_size * 0.5) ** 2)
    wide = cand_valid & (d2 <= cell_size ** 2)
    d2s = jnp.where(keep, d2, jnp.float32(3e38))
    neg_top, arg = jax.lax.top_k(-d2s, k)
    top_d2 = -neg_top
    top_xyz = jnp.take_along_axis(cand, arg[..., None], axis=1)
    return top_d2, top_xyz, top_d2 < 1e37, wide


@functools.partial(jax.jit, static_argnames=("k",))
def select_knn_weights(cand: Array, cand_valid: Array, query: Array,
                       cell_size: Array, k: int = 5
                       ) -> Tuple[Array, Array, Array]:
    """Strict k-NN as a 0/1 WEIGHT over the candidate slab — no neighbor
    gather at all (downstream fits consume weighted moments,
    fitting.fit_*_weighted). Returns (d2 (Q,k) ascending, w_near (Q,C)
    f32 0/1, wide (Q,C) f32 0/1). Ties at the kth distance may admit >k
    candidates (measure-zero with leaf-deduped float32 maps; fits are
    unaffected).

    The k smallest distances come from k sequential masked mins (values
    only) rather than a sort-based lax.top_k, so no index operand is
    carried."""
    q = query.astype(jnp.float32)
    diff = cand - q[..., None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    keep = cand_valid & (d2 <= (cell_size * 0.5) ** 2)
    wide = cand_valid & (d2 <= cell_size ** 2)
    d2s = jnp.where(keep, d2, jnp.float32(3e38))
    vals = []
    cur = d2s
    for _ in range(k):
        v = jnp.min(cur, axis=-1, keepdims=True)
        vals.append(v)
        cur = jnp.where(cur <= v, jnp.float32(3e38), cur)
    top_d2 = jnp.concatenate(vals, axis=-1)
    w_near = jnp.where(keep & (d2s <= top_d2[..., k - 1:k]), 1.0, 0.0)
    return top_d2, w_near, wide.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("k", "k2"))
def select_knn_2r(cand: Array, cand_valid: Array, query: Array,
                  cell_size: Array, k: int = 5, k2: int = 16
                  ) -> Tuple[Array, Array, Array, Array, Array, Array]:
    """Two-radius selection from a gathered candidate set — the selection
    half of ``query_knn_2r``."""
    q = query.astype(jnp.float32)
    diff = cand - q[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    keep = cand_valid & (d2 <= (cell_size * 0.5) ** 2)
    keep_w = cand_valid & (d2 <= cell_size ** 2)
    d2s = jnp.where(keep, d2, jnp.float32(3e38))
    d2w = jnp.where(keep_w, d2, jnp.float32(3e38))

    neg_top, arg = jax.lax.top_k(-d2s, k)
    top_d2 = -neg_top
    top_xyz = jnp.take_along_axis(cand, arg[..., None], axis=1)
    valid = top_d2 < 1e37

    neg_w, arg_w = jax.lax.top_k(-d2w, k2)
    top_d2w = -neg_w
    top_xyzw = jnp.take_along_axis(cand, arg_w[..., None], axis=1)
    valid_w = top_d2w < 1e37
    return top_d2, top_xyz, valid, top_d2w, top_xyzw, valid_w


@functools.partial(jax.jit, static_argnames=("k", "k2"))
def query_knn_2r(vmap: VoxelHashMap, query: Array, query_mask: Array,
                 k: int = 5, k2: int = 16
                 ) -> Tuple[Array, Array, Array, Array, Array, Array]:
    """Two-radius kNN from ONE 8-cell gather: the strict top-k within
    cell_size/2 (identical to ``query_knn``) plus a top-k2 within the full
    gathered neighborhood (radius up to cell_size on the octant side).

    The wide set exists because a tight k-NN is blind to anisotropic
    density: on a surface grazed along the scan ring (floor/ceiling at
    VLP-16 geometry) the same-ring spacing is centimeters while the nearest
    cross-ring point is over a meter away — outside the strict radius — so
    5-NN plane fits degenerate to collinear arcs with arbitrary normals
    (the reference's 5-NN + 0.2 residual check, mapping_scan_matcher.cc:
    198-220, has the same blind spot). The wide set feeds a fallback TLS
    plane fit only where the strict fit fails its spread gate. Coverage
    beyond cell_size/2 is best-effort (whatever the 8 gathered slabs hold),
    which is fine for an enrichment set — completeness still only claimed
    for the strict radius.

    Returns (d2 (Q,k), xyz, valid, d2w (Q,k2), xyzw, validw).
    """
    H, P = vmap.table_size, vmap.slab_capacity
    q = query.astype(jnp.float32)
    ncells = neighbor_cells8(q, vmap.cell_size)                  # (Q, 8, 3)
    slots = _hash_cells(ncells, H)                               # (Q, 8)

    cand = vmap.points[slots]                                    # (Q, 8, P, 3)
    occup = jnp.arange(P)[None, None, :] < vmap.count[slots][:, :, None]
    diff = cand - q[:, None, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    radius_sq = (vmap.cell_size * 0.5) ** 2
    keep = occup & (d2 <= radius_sq)
    keep_w = occup & (d2 <= vmap.cell_size ** 2)
    flat = cand.reshape(q.shape[0], -1, 3)
    d2s = jnp.where(keep, d2, jnp.float32(3e38)).reshape(q.shape[0], -1)
    d2w = jnp.where(keep_w, d2, jnp.float32(3e38)).reshape(q.shape[0], -1)

    neg_top, arg = jax.lax.top_k(-d2s, k)
    top_d2 = -neg_top
    top_xyz = jnp.take_along_axis(flat, arg[..., None], axis=1)
    valid = (top_d2 < 1e37) & query_mask[:, None]

    neg_w, arg_w = jax.lax.top_k(-d2w, k2)
    top_d2w = -neg_w
    top_xyzw = jnp.take_along_axis(flat, arg_w[..., None], axis=1)
    valid_w = (top_d2w < 1e37) & query_mask[:, None]
    return top_d2, top_xyz, valid, top_d2w, top_xyzw, valid_w
