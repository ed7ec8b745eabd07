"""Multi-sequence batched SLAM: one device program, B trajectories.

The within-frame math of a single trajectory cannot parallelize across
frames (frame t needs the map built from frames <t — SURVEY.md §7.3), but a
chip can run MANY trajectories at once: this is how KITTI 00-10 runs as a
batch and how a serving deployment packs many robots per chip.

Key design: the B per-sequence hash maps FUSE into one table of B*H slots
(sequence b owns [b*H, (b+1)*H)), so map gathers and scatters are single
flat operations with the single-stream access pattern at B-fold width
instead of B vmapped gathers/scatters. Everything else (features,
odometry, GN solves) vmaps cleanly (dense math).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from msf_loam_tpu.config import MsfLoamConfig
from msf_loam_tpu.core.pointcloud import RingImage, ScanFeatures
from msf_loam_tpu.core.precision import f32_matmuls
from msf_loam_tpu.core.se3 import Pose
from msf_loam_tpu.ops import features as feat_mod
from msf_loam_tpu.ops import fitting
from msf_loam_tpu.ops import gauss_newton as gn
from msf_loam_tpu.ops import icp_residuals as icp
from msf_loam_tpu.slam import odometry, voxel_map
from msf_loam_tpu.slam.pipeline import downsample_features
from msf_loam_tpu.slam.voxel_map import (VoxelHashMap, _hash_cells,
                                         insert_at_slots, neighbor_cells8)

Array = jax.Array


class BatchState(NamedTuple):
    corner_map: VoxelHashMap     # fused table: (B*H, P, 3)
    surf_map: VoxelHashMap
    prev_feats: ScanFeatures     # leading batch axis
    pose_c2l: Pose               # (B,) poses
    pose_odom: Pose
    pose_o2m: Pose
    frame_idx: Array             # () int32


def init_batch_state(cfg: MsfLoamConfig, batch: int, n_rings: int) -> BatchState:
    mc = cfg.mapping
    fused_c = voxel_map.create_map(batch * mc.map_table_size,
                                   mc.map_cell_capacity, mc.map_cell_size,
                                   mc.line_resolution)
    fused_s = voxel_map.create_map(batch * mc.map_table_size,
                                   mc.map_cell_capacity, mc.map_cell_size,
                                   mc.plane_resolution)

    fc = cfg.features
    dummy = RingImage(
        xyz=jnp.zeros((n_rings, fc.max_points_per_ring, 3)),
        rel_time=jnp.zeros((n_rings, fc.max_points_per_ring)),
        mask=jnp.zeros((n_rings, fc.max_points_per_ring), bool))
    feats0 = feat_mod.extract_features(dummy, jnp.float32(0.0), fc)
    tile = lambda tree: jax.tree.map(
        lambda a: jnp.broadcast_to(a, (batch,) + a.shape).copy()
        if jnp.ndim(a) > 0 else jnp.broadcast_to(a, (batch,)).copy(), tree)

    return BatchState(
        corner_map=fused_c,
        surf_map=fused_s,
        prev_feats=tile(feats0.strip_full()),
        pose_c2l=Pose.identity((batch,)),
        pose_odom=Pose.identity((batch,)),
        pose_o2m=Pose.identity((batch,)),
        frame_idx=jnp.int32(0),
    )


def _fused_query(vmap_state: VoxelHashMap, H: int, query: Array,
                 query_mask: Array, k: int):
    """k-NN against the fused table: query (B, Q, 3) -> flat gather.

    Sequence b's cells hash into [b*H, (b+1)*H) — one gather of B*Q*8 rows,
    structurally identical to the single-sequence path.
    """
    B, Q, _ = query.shape
    P = vmap_state.slab_capacity
    q = query.reshape(B * Q, 3)
    ncells = neighbor_cells8(q, vmap_state.cell_size)            # (BQ, 8, 3)
    slots = _hash_cells(ncells, H)                               # (BQ, 8)
    offset = jnp.repeat(jnp.arange(B, dtype=jnp.int32) * H, Q)
    slots = slots + offset[:, None]

    cand = vmap_state.points[slots]                              # (BQ, 8, P, 3)
    occup = jnp.arange(P)[None, None, :] < vmap_state.count[slots][:, :, None]
    diff = cand - q[:, None, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    radius_sq = (vmap_state.cell_size * 0.5) ** 2
    keep = occup & (d2 <= radius_sq)
    d2 = jnp.where(keep, d2, jnp.float32(3e38)).reshape(B * Q, -1)
    neg_top, arg = jax.lax.top_k(-d2, k)
    top_d2 = -neg_top
    top_xyz = jnp.take_along_axis(cand.reshape(B * Q, -1, 3),
                                  arg[..., None], axis=1)
    valid = (top_d2 < 1e37) & query_mask.reshape(-1)[:, None]
    return (top_d2.reshape(B, Q, k), top_xyz.reshape(B, Q, k, 3),
            valid.reshape(B, Q, k))


def _fused_query_2r(vmap_state: VoxelHashMap, H: int, query: Array,
                    query_mask: Array, k: int, k2: int):
    """Two-radius twin of ``_fused_query`` (voxel_map.query_knn_2r
    semantics): strict top-k within cell/2 plus wide top-k2 within the
    full gathered octant, one gather."""
    B, Q, _ = query.shape
    P = vmap_state.slab_capacity
    q = query.reshape(B * Q, 3)
    ncells = neighbor_cells8(q, vmap_state.cell_size)
    slots = _hash_cells(ncells, H)
    offset = jnp.repeat(jnp.arange(B, dtype=jnp.int32) * H, Q)
    slots = slots + offset[:, None]

    cand = vmap_state.points[slots]
    occup = jnp.arange(P)[None, None, :] < vmap_state.count[slots][:, :, None]
    diff = cand - q[:, None, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    keep = occup & (d2 <= (vmap_state.cell_size * 0.5) ** 2)
    keep_w = occup & (d2 <= vmap_state.cell_size ** 2)
    flat = cand.reshape(B * Q, -1, 3)
    d2s = jnp.where(keep, d2, jnp.float32(3e38)).reshape(B * Q, -1)
    d2w = jnp.where(keep_w, d2, jnp.float32(3e38)).reshape(B * Q, -1)
    qm = query_mask.reshape(-1)[:, None]

    def top(dd, kk):
        neg, arg = jax.lax.top_k(-dd, kk)
        xyz = jnp.take_along_axis(flat, arg[..., None], axis=1)
        return (-neg.reshape(B, Q, kk), xyz.reshape(B, Q, kk, 3),
                ((-neg < 1e37) & qm).reshape(B, Q, kk))

    return top(d2s, k) + top(d2w, k2)


def _fused_insert(vmap_state: VoxelHashMap, H: int, xyz: Array,
                  mask: Array) -> VoxelHashMap:
    """Insert (B, N, 3) world points into the fused table (flat scatter).

    Leaf keys are salted per sequence so one sequence's point can never
    suppress another's insert in the same world voxel."""
    B, N, _ = xyz.shape
    flat = xyz.reshape(B * N, 3)
    cells = jnp.floor(flat / vmap_state.cell_size).astype(jnp.int32)
    slots = _hash_cells(cells, H)
    seq_id = jnp.repeat(jnp.arange(B, dtype=jnp.int32), N)
    return insert_at_slots(vmap_state, flat, mask.reshape(-1),
                           slots + seq_id * H, leaf_salt=seq_id)


def _fused_evict_far(vmap_state: VoxelHashMap, H: int, centers: Array,
                     radius: float) -> VoxelHashMap:
    """Per-lane far-point eviction over the fused table: slot b*H+h evicts
    around lane b's current pose (the batched analog of
    SlamPipeline._maybe_evict — without it per-lane 4096-slot tables fill
    monotonically on long scenes and collisions degrade kNN; ADVICE r3)."""
    per_slot = jnp.repeat(centers, H, axis=0)            # (B*H, 3)
    return voxel_map.evict_far(vmap_state, per_slot, radius)


@jax.named_scope("map_gather")
def _fused_gather_candidates(vmap_state: VoxelHashMap, H: int, query: Array,
                             query_mask: Array) -> Tuple[Array, Array]:
    """Octant gather over the fused table, selection deferred (the batched
    analog of voxel_map.gather_candidates): (B, Q, 8P, 3) + occupancy."""
    B, Q, _ = query.shape
    P = vmap_state.slab_capacity
    q = query.reshape(B * Q, 3)
    ncells = neighbor_cells8(q, vmap_state.cell_size)
    slots = _hash_cells(ncells, H)
    offset = jnp.repeat(jnp.arange(B, dtype=jnp.int32) * H, Q)
    slots = slots + offset[:, None]
    cand = vmap_state.points[slots]                       # (BQ, 8, P, 3)
    occup = jnp.arange(P)[None, None, :] < vmap_state.count[slots][:, :, None]
    occup = occup & query_mask.reshape(-1)[:, None, None]
    return (cand.reshape(B, Q, 8 * P, 3), occup.reshape(B, Q, 8 * P))


@jax.named_scope("select_fit")
def _batched_select_fit(cand_c, val_c, cand_s, val_s, cw, sw, cell_c, cell_s,
                        corner_ds, surf_ds, mc):
    """One round's k-NN selection + weighted line/plane fits for all lanes
    (the batched twin of mapping._CandidateCache.associate)."""
    d2c, w_c, _ = voxel_map.select_knn_weights(cand_c, val_c, cw, cell_c,
                                               k=mc.knn)
    gate_c = (d2c[..., mc.knn - 1] < mc.knn_dist_sq_max) & corner_ds.mask
    lines = fitting.fit_lines_weighted(cand_c, w_c, mc.knn,
                                       mc.line_eig_ratio)
    edge_valid = gate_c & lines.valid
    d2s, w_s, wide = voxel_map.select_knn_weights(cand_s, val_s, sw, cell_s,
                                                  k=mc.knn)
    if mc.plane_fallback:
        planes = fitting.fit_planes_two_scale_weighted(
            cand_s, w_s, wide, mc.knn, mc.plane_fit_tol, min_wide=mc.knn)
    else:
        planes = fitting.fit_planes_weighted(cand_s, w_s, mc.knn,
                                             mc.plane_fit_tol)
    gate_s = (d2s[..., mc.knn - 1] < mc.knn_dist_sq_max) & surf_ds.mask
    plane_valid = gate_s & planes.valid
    return (edge_valid, lines.center, lines.direction, plane_valid,
            planes.center, planes.normal)


def _batched_map_match(corner_map, surf_map, H, corner_ds, surf_ds, poses,
                       cfg) -> Tuple[Pose, Array]:
    """2 re-association rounds x 6-iter GN for all B sequences. Candidate
    octants gather ONCE per frame over the fused table (B*Q*8 slab rows);
    each round only re-runs selection + weighted fits against the updated
    poses."""
    mc = cfg.mapping
    B = poses.t.shape[0]
    map_ok = jnp.ones((B,), bool)  # per-sequence gates handled by counts below
    pose = poses

    apply_b = jax.vmap(lambda p, x: p.apply(x))

    cand_c, val_c = _fused_gather_candidates(
        corner_map, H, apply_b(pose, corner_ds.xyz), corner_ds.mask)
    cand_s, val_s = _fused_gather_candidates(
        surf_map, H, apply_b(pose, surf_ds.xyz), surf_ds.mask)

    for _ in range(mc.outer_rounds):
        cw = apply_b(pose, corner_ds.xyz)        # (B, Qc, 3)
        sw = apply_b(pose, surf_ds.xyz)
        (edge_valid, line_c, line_n, plane_valid, plane_c,
         plane_n) = _batched_select_fit(cand_c, val_c, cand_s, val_s, cw, sw,
                                        corner_map.cell_size,
                                        surf_map.cell_size, corner_ds,
                                        surf_ds, mc)
        n_corr = (jnp.sum(edge_valid, axis=1) + jnp.sum(plane_valid, axis=1))

        def solve_one(p0, e_pts, e_c, e_n, e_v, s_pts, s_c, s_n, s_v):
            def build(p, v):
                eb = icp.edge_residuals(p, e_pts, e_c, e_n, e_v)
                pb = icp.plane_residuals(p, s_pts, s_c, s_n, s_v)
                return [eb, pb], [gn.huber_weights(eb, mc.huber_delta),
                                  gn.huber_weights(pb, mc.huber_delta)]
            out = gn.gauss_newton(build, p0, jnp.zeros(3, jnp.float32),
                                  n_iters=mc.gn_iterations)
            return out.pose

        new_pose = jax.vmap(solve_one)(
            pose, corner_ds.xyz, line_c, line_n, edge_valid,
            surf_ds.xyz, plane_c, plane_n, plane_valid)
        ok_round = (n_corr >= 10)
        pose = jax.tree.map(
            lambda n, o: jnp.where(ok_round.reshape((B,) + (1,) * (n.ndim - 1)),
                                   n, o), new_pose, pose)
    return pose, (n_corr >= 10)


def _frame_fn(cfg: MsfLoamConfig, H: int, state: BatchState,
              imgs: RingImage, is_first) -> Tuple[BatchState, Pose]:
    fc, oc, mc = cfg.features, cfg.odometry, cfg.mapping
    B = state.pose_odom.t.shape[0]

    # vmapped per-lane extraction (not the flatten-lanes form,
    # feat_mod.extract_features_batched, whose (B*R, W) <-> (B, ...)
    # relayouts land on the scan-carried feature clouds)
    feats = jax.vmap(lambda im: feat_mod.extract_features(
        im, jnp.float32(0.0), fc))(imgs)

    odo = jax.vmap(lambda a, b, p: odometry.match_scan2scan(a, b, p, oc))(
        state.prev_feats, feats, state.pose_c2l)
    use = odo.ok & ~is_first
    pose_c2l = jax.tree.map(
        lambda n, o: jnp.where(use.reshape((B,) + (1,) * (n.ndim - 1)), n, o),
        odo.pose_curr2last, state.pose_c2l)
    step_pose = jax.tree.map(
        lambda i, p: jnp.where(is_first, jnp.broadcast_to(i, p.shape), p),
        Pose.identity(), pose_c2l)
    pose_odom = state.pose_odom.compose(step_pose)

    guess = state.pose_o2m.compose(pose_odom)
    ds = jax.vmap(lambda pb: downsample_features(
        pb, mc.line_resolution, mc.corner_query_points))
    corner_ds = ds(feats.corner_less_sharp)
    surf_ds = jax.vmap(lambda pb: downsample_features(
        pb, mc.plane_resolution, mc.max_query_points))(feats.surf_less_flat)
    if oc.motion_deskew:
        # dense-path parity (slam.pipeline._frame_core): constant-velocity
        # reprojection from each lane's feedback-free odometry step
        from msf_loam_tpu.imu import deskew as deskew_mod

        dt = fc.scan_period
        dk = jax.vmap(lambda pb, p: deskew_mod.undistort_from_motion(
            pb, p, dt))
        corner_ds = dk(corner_ds, step_pose)
        surf_ds = dk(surf_ds, step_pose)

    pose_map, ok = _batched_map_match(
        state.corner_map, state.surf_map, H, corner_ds, surf_ds, guess, cfg)
    pose_map = jax.tree.map(
        lambda n, o: jnp.where(ok.reshape((B,) + (1,) * (n.ndim - 1)), n, o),
        pose_map, guess)
    pose_o2m = pose_map.compose(pose_odom.inverse())

    apply_b = jax.vmap(lambda p, x: p.apply(x))
    cw = apply_b(pose_map, corner_ds.xyz)
    sw = apply_b(pose_map, surf_ds.xyz)
    c_mask, s_mask = corner_ds.mask, surf_ds.mask
    if oc.motion_deskew:
        # frame 0 has no motion prior: a raw distorted insert would poison
        # every lane's map (leaf dedup keeps it) — start maps at frame 1
        c_mask = c_mask & ~is_first
        s_mask = s_mask & ~is_first
    corner_map = _fused_insert(state.corner_map, H, cw, c_mask)
    surf_map = _fused_insert(state.surf_map, H, sw, s_mask)

    if mc.map_evict_period > 0:
        # same cadence as SlamPipeline._maybe_evict; lax.cond so the
        # H*P sort only runs on eviction frames
        do_evict = (state.frame_idx + 1) % mc.map_evict_period == 0
        corner_map, surf_map = jax.lax.cond(
            do_evict,
            lambda ms: (_fused_evict_far(ms[0], H, pose_map.t,
                                         mc.map_evict_radius),
                        _fused_evict_far(ms[1], H, pose_map.t,
                                         mc.map_evict_radius)),
            lambda ms: ms,
            (corner_map, surf_map))

    new_state = BatchState(
        corner_map=corner_map, surf_map=surf_map,
        prev_feats=feats.strip_full(),
        pose_c2l=pose_c2l, pose_odom=pose_odom, pose_o2m=pose_o2m,
        frame_idx=state.frame_idx + 1)
    return new_state, pose_map


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(1,))
@f32_matmuls
def run_batch(cfg: MsfLoamConfig, state: BatchState,
              ring_images: RingImage) -> Tuple[BatchState, Pose]:
    """Process T frames for all B sequences.

    ring_images leaves are (T, B, R, W, ...). Returns (final state,
    per-frame mapped poses with leaves (T, B, ...)).
    """
    H = cfg.mapping.map_table_size

    def scan_step(st, img_t):
        new_state, pose_map = _frame_fn(cfg, H, st, img_t,
                                        st.frame_idx == 0)
        return new_state, pose_map

    state, poses = jax.lax.scan(scan_step, state, ring_images)
    return state, poses
