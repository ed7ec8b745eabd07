"""Scan-to-map registration against the voxel hash map.

Batched redesign of ``MappingScanMatcher::MatchScan2Map``
(``/root/reference/src/slam/local/scan_matching/mapping_scan_matcher.cc:19-278``):
per-point 5-NN KD-tree queries become one batched hash-grid gather
(``slam.voxel_map.query_knn``), the per-point eigensolve/QR fits become the
closed-form batched fits of ``ops.fitting``, and the 2x(6-iter) Ceres
schedule becomes re-association rounds around a batched GN — one jit.

The deskew-aware tightly-coupled variant (per-point IMU delta + velocity
state, mapping_scan_matcher.cc:119-124,153-172) is ``match_scan2map_deskew``
and activates once the estimator is initialized.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from msf_loam_tpu.config import MappingConfig
from msf_loam_tpu.core.pointcloud import PointBatch
from msf_loam_tpu.core.se3 import Pose
from msf_loam_tpu.ops import fitting
from msf_loam_tpu.ops import gauss_newton as gn
from msf_loam_tpu.ops import icp_residuals as icp
from msf_loam_tpu.slam import voxel_map as voxel_map_mod
from msf_loam_tpu.slam.voxel_map import VoxelHashMap, query_knn

Array = jax.Array


class MapCorrespondences(NamedTuple):
    edge_points: Array; edge_c: Array; edge_n: Array; edge_valid: Array
    plane_points: Array; plane_c: Array; plane_n: Array; plane_valid: Array


def _associate(corner_map: VoxelHashMap, surf_map: VoxelHashMap,
               corner: PointBatch, surf: PointBatch, pose: Pose,
               cfg: MappingConfig,
               corner_world: Optional[Array] = None,
               surf_world: Optional[Array] = None,
               query_fn=None, query2_fn=None,
               query_pair_fn=None) -> MapCorrespondences:
    """Find line/plane correspondences for all scan features at once.

    corner_world/surf_world override the query positions (used by the
    deskew path where per-point IMU compensation shifts the query).
    ``query_fn(map, xyz, mask, k)`` overrides the kNN backend (the sharded
    pipeline passes the all-gather-merged multi-device query);
    ``query2_fn(map, xyz, mask, k, k2)`` is its two-radius twin for the
    wide plane-fallback set (see voxel_map.query_knn_2r).
    ``query_pair_fn(cmap, smap, cw, cmask, sw, smask)`` answers BOTH
    feature types in one call (the sharded pipeline's packed-collective
    round: one all-gather instead of six) and takes precedence; it always
    returns the two-radius surf form, so it requires cfg.plane_fallback.
    """
    if query_fn is None:
        query_fn = query_knn
    if query2_fn is None:
        query2_fn = voxel_map_mod.query_knn_2r
    cw = corner_world if corner_world is not None else pose.apply(corner.xyz)
    sw = surf_world if surf_world is not None else pose.apply(surf.xyz)

    if query_pair_fn is not None and cfg.plane_fallback:
        sel_c, sel_s = query_pair_fn(corner_map, surf_map, cw, corner.mask,
                                     sw, surf.mask)
        return _correspondences_from_selection(corner, surf, sel_c, sel_s,
                                               cfg)

    # two independent queries rather than one gather over a stacked table:
    # the concat would copy both tables and defeat buffer donation

    # corners: 5-NN, gate on the 5th distance, line fit + eigen-ratio test
    sel_c = query_fn(corner_map, cw, corner.mask, k=cfg.knn)

    # surfs: 5-NN plane fit, with a wide-set TLS fallback where the strict
    # neighborhood is a degenerate ring arc (MappingConfig.plane_fallback)
    if cfg.plane_fallback:
        sel_s = query2_fn(surf_map, sw, surf.mask, k=cfg.knn,
                          k2=cfg.knn_wide)
    else:
        sel_s = query_fn(surf_map, sw, surf.mask, k=cfg.knn)
    return _correspondences_from_selection(corner, surf, sel_c, sel_s, cfg)


def _correspondences_from_selection(corner: PointBatch, surf: PointBatch,
                                    sel_c, sel_s,
                                    cfg: MappingConfig) -> MapCorrespondences:
    """Gates + line/plane fits over kNN selections (shared by the
    per-round-query and cached-candidate association paths)."""
    d2c, nc_xyz, nc_valid = sel_c
    gate_c = (d2c[:, cfg.knn - 1] < cfg.knn_dist_sq_max) & corner.mask
    lines = fitting.fit_lines(nc_xyz, nc_valid, cfg.line_eig_ratio)
    edge_valid = gate_c & lines.valid

    if cfg.plane_fallback:
        d2s, ns_xyz, ns_valid, _, nw_xyz, nw_valid = sel_s
        planes = fitting.fit_planes_two_scale(
            ns_xyz, ns_valid, nw_xyz, nw_valid, cfg.plane_fit_tol,
            min_wide=cfg.knn)
    else:
        d2s, ns_xyz, ns_valid = sel_s
        planes = fitting.fit_planes(ns_xyz, ns_valid, cfg.plane_fit_tol)
    gate_s = (d2s[:, cfg.knn - 1] < cfg.knn_dist_sq_max) & surf.mask
    plane_valid = gate_s & planes.valid

    return MapCorrespondences(
        edge_points=corner.xyz, edge_c=lines.center, edge_n=lines.direction,
        edge_valid=edge_valid,
        plane_points=surf.xyz, plane_c=planes.center, plane_n=planes.normal,
        plane_valid=plane_valid,
    )


class _CandidateCache:
    """Per-frame octant gathers for both maps (voxel_map.gather_candidates):
    the gathers run once per frame and each re-association round only
    re-runs distance/top-k selection against the updated pose. Valid while
    inter-round pose updates stay well under cell_size/2 (see
    gather_candidates docstring)."""

    @jax.named_scope("map_gather")
    def __init__(self, corner_map, surf_map, corner: PointBatch,
                 surf: PointBatch, cw0: Array, sw0: Array):
        self.cand_c, self.val_c = voxel_map_mod.gather_candidates(
            corner_map, cw0, corner.mask)
        self.cand_s, self.val_s = voxel_map_mod.gather_candidates(
            surf_map, sw0, surf.mask)
        self.cell_c = corner_map.cell_size
        self.cell_s = surf_map.cell_size

    @jax.named_scope("select_fit")
    def associate(self, corner: PointBatch, surf: PointBatch, cw: Array,
                  sw: Array, cfg: MappingConfig) -> MapCorrespondences:
        d2c, w_c, _ = voxel_map_mod.select_knn_weights(
            self.cand_c, self.val_c, cw, self.cell_c, k=cfg.knn)
        gate_c = (d2c[:, cfg.knn - 1] < cfg.knn_dist_sq_max) & corner.mask
        lines = fitting.fit_lines_weighted(self.cand_c, w_c, cfg.knn,
                                           cfg.line_eig_ratio)
        edge_valid = gate_c & lines.valid

        d2s, w_s, wide = voxel_map_mod.select_knn_weights(
            self.cand_s, self.val_s, sw, self.cell_s, k=cfg.knn)
        if cfg.plane_fallback:
            planes = fitting.fit_planes_two_scale_weighted(
                self.cand_s, w_s, wide, cfg.knn, cfg.plane_fit_tol,
                min_wide=cfg.knn)
        else:
            planes = fitting.fit_planes_weighted(self.cand_s, w_s, cfg.knn,
                                                 cfg.plane_fit_tol)
        gate_s = (d2s[:, cfg.knn - 1] < cfg.knn_dist_sq_max) & surf.mask
        plane_valid = gate_s & planes.valid

        return MapCorrespondences(
            edge_points=corner.xyz, edge_c=lines.center,
            edge_n=lines.direction, edge_valid=edge_valid,
            plane_points=surf.xyz, plane_c=planes.center,
            plane_n=planes.normal, plane_valid=plane_valid,
        )


class MappingResult(NamedTuple):
    pose: Pose
    velocity: Array
    n_edge: Array
    n_plane: Array
    ok: Array
    cost: Array


@functools.partial(jax.jit, static_argnames=("cfg",))
def match_scan2map(corner_map: VoxelHashMap, surf_map: VoxelHashMap,
                   scan_corner: PointBatch, scan_surf: PointBatch,
                   pose0: Pose, cfg: MappingConfig) -> MappingResult:
    """Loosely-coupled scan-to-map GN (pre-IMU-init path,
    mapping_scan_matcher.cc:95-97,122-123)."""
    return match_scan2map_core(corner_map, surf_map, scan_corner, scan_surf,
                               pose0, cfg)


def match_scan2map_core(corner_map: VoxelHashMap, surf_map: VoxelHashMap,
                        scan_corner: PointBatch, scan_surf: PointBatch,
                        pose0: Pose, cfg: MappingConfig,
                        query_fn=None, query2_fn=None,
                        query_pair_fn=None) -> MappingResult:
    """Unjitted matcher core; ``query_fn``/``query2_fn`` swap the kNN
    backend (the sharded pipeline passes the multi-device queries)."""
    pose = pose0
    n_edge = jnp.float32(0.0)
    n_plane = jnp.float32(0.0)
    cost = jnp.float32(0.0)

    map_ok = (corner_map.total_points() > cfg.min_map_corner) & \
             (surf_map.total_points() > cfg.min_map_surf)

    cache = None
    if cfg.reuse_candidates and query_fn is None \
            and query2_fn is None and query_pair_fn is None:
        cache = _CandidateCache(corner_map, surf_map, scan_corner, scan_surf,
                                pose.apply(scan_corner.xyz),
                                pose.apply(scan_surf.xyz))

    for _ in range(cfg.outer_rounds):
        if cache is not None:
            corr = cache.associate(scan_corner, scan_surf,
                                   pose.apply(scan_corner.xyz),
                                   pose.apply(scan_surf.xyz), cfg)
        else:
            corr = _associate(corner_map, surf_map, scan_corner, scan_surf,
                              pose, cfg, query_fn=query_fn,
                              query2_fn=query2_fn,
                              query_pair_fn=query_pair_fn)
        n_edge = jnp.sum(corr.edge_valid.astype(jnp.float32))
        n_plane = jnp.sum(corr.plane_valid.astype(jnp.float32))

        def build(p, v):
            eb = icp.edge_residuals(p, corr.edge_points, corr.edge_c,
                                    corr.edge_n, corr.edge_valid)
            pb = icp.plane_residuals(p, corr.plane_points, corr.plane_c,
                                     corr.plane_n, corr.plane_valid)
            return [eb, pb], [gn.huber_weights(eb, cfg.huber_delta),
                              gn.huber_weights(pb, cfg.huber_delta)]

        out = gn.gauss_newton(build, pose, jnp.zeros(3, jnp.float32),
                              n_iters=cfg.gn_iterations)
        ok_round = map_ok & ((n_edge + n_plane) >= 10)
        pose = jax.tree.map(lambda new, old: jnp.where(ok_round, new, old),
                            out.pose, pose)
        cost = out.cost

    return MappingResult(pose=pose, velocity=jnp.zeros(3, jnp.float32),
                         n_edge=n_edge, n_plane=n_plane,
                         ok=map_ok & ((n_edge + n_plane) >= 10), cost=cost)


@functools.partial(jax.jit, static_argnames=("cfg",))
def match_scan2map_deskew(corner_map: VoxelHashMap, surf_map: VoxelHashMap,
                          scan_corner: PointBatch, scan_surf: PointBatch,
                          pose0: Pose, velocity0: Array, gravity: Array,
                          corner_dk: icp.DeskewTerms, surf_dk: icp.DeskewTerms,
                          cfg: MappingConfig) -> MappingResult:
    return match_scan2map_deskew_core(corner_map, surf_map, scan_corner,
                                      scan_surf, pose0, velocity0, gravity,
                                      corner_dk, surf_dk, cfg)


def match_scan2map_deskew_core(corner_map, surf_map,
                               scan_corner: PointBatch, scan_surf: PointBatch,
                               pose0: Pose, velocity0: Array, gravity: Array,
                               corner_dk: icp.DeskewTerms,
                               surf_dk: icp.DeskewTerms,
                               cfg: MappingConfig,
                               query_fn=None, query2_fn=None,
                               query_pair_fn=None) -> MappingResult:
    """Tightly-coupled scan-to-map GN over [pose, velocity] with per-point
    IMU deskew terms (mapping_scan_matcher.cc:109-246 initialized branch).

    Query positions use the deskew-compensated world points
    (mapping_scan_matcher.cc:119-124): for a point with rel-time dt,
      p_world = R (dq p + dp) + v dt - 0.5 g dt^2 + t.
    The velocity state is held constant in the solve, matching the
    reference's SetParameterBlockConstant(bias_j) (mapping_scan_matcher.cc:94),
    but stays a state so the IMU-factor pre-solve path can free it.
    """
    from msf_loam_tpu.core.se3 import quat_rotate, quat_to_matrix

    pose = pose0
    vel = velocity0
    n_edge = jnp.float32(0.0)
    n_plane = jnp.float32(0.0)
    cost = jnp.float32(0.0)

    map_ok = (corner_map.total_points() > cfg.min_map_corner) & \
             (surf_map.total_points() > cfg.min_map_surf)

    def deskewed_world(pb: PointBatch, dk: icp.DeskewTerms, p: Pose, v: Array):
        R = quat_to_matrix(p.q)
        local = quat_rotate(dk.delta_q, pb.xyz) + dk.delta_p
        dt = dk.dt[:, None]
        return local @ R.T + v[None, :] * dt - 0.5 * gravity[None, :] * dt * dt + p.t

    cache = None
    if cfg.reuse_candidates and query_fn is None \
            and query2_fn is None and query_pair_fn is None:
        cache = _CandidateCache(
            corner_map, surf_map, scan_corner, scan_surf,
            deskewed_world(scan_corner, corner_dk, pose, vel),
            deskewed_world(scan_surf, surf_dk, pose, vel))

    for _ in range(cfg.outer_rounds):
        cw = deskewed_world(scan_corner, corner_dk, pose, vel)
        sw = deskewed_world(scan_surf, surf_dk, pose, vel)
        if cache is not None:
            corr = cache.associate(scan_corner, scan_surf, cw, sw, cfg)
        else:
            corr = _associate(corner_map, surf_map, scan_corner, scan_surf,
                              pose, cfg, corner_world=cw, surf_world=sw,
                              query_fn=query_fn, query2_fn=query2_fn,
                              query_pair_fn=query_pair_fn)
        n_edge = jnp.sum(corr.edge_valid.astype(jnp.float32))
        n_plane = jnp.sum(corr.plane_valid.astype(jnp.float32))

        def build(p, v):
            eb = icp.edge_residuals_deskew(p, v, corr.edge_points, corr.edge_c,
                                           corr.edge_n, corr.edge_valid, corner_dk)
            pb = icp.plane_residuals_deskew(p, v, corr.plane_points, corr.plane_c,
                                            corr.plane_n, corr.plane_valid, surf_dk)
            # velocity held constant: zero its Jacobian columns
            eb = eb._replace(J=eb.J.at[..., 6:9].set(0.0))
            pb = pb._replace(J=pb.J.at[..., 6:9].set(0.0))
            return [eb, pb], [gn.huber_weights(eb, cfg.huber_delta),
                              gn.huber_weights(pb, cfg.huber_delta)]

        out = gn.gauss_newton(build, pose, vel, n_iters=cfg.gn_iterations,
                              state_dim=9)
        ok_round = map_ok & ((n_edge + n_plane) >= 10)
        pose = jax.tree.map(lambda new, old: jnp.where(ok_round, new, old),
                            out.pose, pose)
        cost = out.cost

    return MappingResult(pose=pose, velocity=vel, n_edge=n_edge,
                         n_plane=n_plane,
                         ok=map_ok & ((n_edge + n_plane) >= 10), cost=cost)


@functools.partial(jax.jit, static_argnames=("cfg", "imu_weight"))
def match_scan2map_tight(corner_map: VoxelHashMap, surf_map: VoxelHashMap,
                         scan_corner: PointBatch, scan_surf: PointBatch,
                         pose0: Pose, velocity0: Array, gravity: Array,
                         corner_dk: icp.DeskewTerms, surf_dk: icp.DeskewTerms,
                         pre_pair, prev_state, cfg: MappingConfig,
                         imu_weight: float = 1.0) -> MappingResult:
    return match_scan2map_tight_core(corner_map, surf_map, scan_corner,
                                     scan_surf, pose0, velocity0, gravity,
                                     corner_dk, surf_dk, pre_pair, prev_state,
                                     cfg, imu_weight)


def match_scan2map_tight_core(corner_map, surf_map,
                              scan_corner: PointBatch, scan_surf: PointBatch,
                              pose0: Pose, velocity0: Array, gravity: Array,
                              corner_dk: icp.DeskewTerms,
                              surf_dk: icp.DeskewTerms,
                              pre_pair, prev_state, cfg: MappingConfig,
                              imu_weight: float = 1.0,
                              query_fn=None, query2_fn=None,
                              query_pair_fn=None) -> MappingResult:
    """Tightly-coupled scan-to-map GN with the IMU preintegration factor IN
    the solve and velocity FREE.

    The reference holds velocity constant during the lidar solve and notes
    the consequence ("todo: drift if not constant",
    mapping_scan_matcher.cc:93) because Ceres would need the full VINS
    window machinery to constrain it. Here the exact 15-dim factor between
    the previous mapped state and the current one
    (imu.imu_factor.imu_factor_blocks, Jacobians wrt [dpose_j, dv_j]) joins
    the lidar residuals in one 9-dim GN, so v_j is observable (IMU rows)
    while the lidar rows pin the pose — the measured A/B for the
    reference's todo.
    """
    from msf_loam_tpu.core.se3 import quat_rotate, quat_to_matrix
    from msf_loam_tpu.imu import imu_factor as imu_factor_mod
    from msf_loam_tpu.imu.preintegration import sqrt_information

    pose = pose0
    vel = velocity0
    n_edge = jnp.float32(0.0)
    n_plane = jnp.float32(0.0)
    cost = jnp.float32(0.0)
    # hoisted: depends only on the window, not the GN state — inside the
    # scan it would re-run the 15x15 inverse+Cholesky every iteration; the
    # WHOLE state_j-independent half of the factor hoists (imu_factor_prep)
    sq_info = sqrt_information(pre_pair)
    imu_prep = imu_factor_mod.imu_factor_prep(pre_pair, prev_state,
                                              gravity, sqrt_info=sq_info)

    map_ok = (corner_map.total_points() > cfg.min_map_corner) & \
             (surf_map.total_points() > cfg.min_map_surf)

    def deskewed_world(pb: PointBatch, dk: icp.DeskewTerms, p: Pose, v: Array):
        R = quat_to_matrix(p.q)
        local = quat_rotate(dk.delta_q, pb.xyz) + dk.delta_p
        dt = dk.dt[:, None]
        return local @ R.T + v[None, :] * dt - 0.5 * gravity[None, :] * dt * dt + p.t

    cache = None
    if cfg.reuse_candidates and query_fn is None \
            and query2_fn is None and query_pair_fn is None:
        cache = _CandidateCache(
            corner_map, surf_map, scan_corner, scan_surf,
            deskewed_world(scan_corner, corner_dk, pose, vel),
            deskewed_world(scan_surf, surf_dk, pose, vel))

    for _ in range(cfg.outer_rounds):
        cw = deskewed_world(scan_corner, corner_dk, pose, vel)
        sw = deskewed_world(scan_surf, surf_dk, pose, vel)
        if cache is not None:
            corr = cache.associate(scan_corner, scan_surf, cw, sw, cfg)
        else:
            corr = _associate(corner_map, surf_map, scan_corner, scan_surf,
                              pose, cfg, corner_world=cw, surf_world=sw,
                              query_fn=query_fn, query2_fn=query2_fn,
                              query_pair_fn=query_pair_fn)
        n_edge = jnp.sum(corr.edge_valid.astype(jnp.float32))
        n_plane = jnp.sum(corr.plane_valid.astype(jnp.float32))

        def build(p, v):
            eb = icp.edge_residuals_deskew(p, v, corr.edge_points, corr.edge_c,
                                           corr.edge_n, corr.edge_valid,
                                           corner_dk)
            pb = icp.plane_residuals_deskew(p, v, corr.plane_points,
                                            corr.plane_c, corr.plane_n,
                                            corr.plane_valid, surf_dk)
            ib = imu_factor_mod.imu_factor_blocks_from_prep(imu_prep, p, v)
            return [eb, pb, ib], [gn.huber_weights(eb, cfg.huber_delta),
                                  gn.huber_weights(pb, cfg.huber_delta),
                                  jnp.full((1,), imu_weight, jnp.float32)]

        out = gn.gauss_newton(build, pose, vel, n_iters=cfg.gn_iterations,
                              state_dim=9)
        ok_round = map_ok & ((n_edge + n_plane) >= 10)
        pose = jax.tree.map(lambda new, old: jnp.where(ok_round, new, old),
                            out.pose, pose)
        vel = jnp.where(ok_round, out.velocity, vel)
        cost = out.cost

    return MappingResult(pose=pose, velocity=vel, n_edge=n_edge,
                         n_plane=n_plane,
                         ok=map_ok & ((n_edge + n_plane) >= 10), cost=cost)
