"""Scan-to-scan odometry matching (the LOAM frontend).

Batched redesign of ``OdometryScanMatcher::MatchScan2Scan``
(``/root/reference/src/slam/local/scan_matching/odometry_scan_matcher.cc:43-285``):
the per-point KD-tree + ring-window searches become one exact (N, M)
distance matrix (a single f32 matmul) with ring-masked argmins — the
different-ring/same-ring candidate rules applied over ALL reference points,
exactly like the reference's ordered scan-line walk — and the 2x(6-iter)
Ceres schedule becomes 2 re-association rounds around a 6-iteration batched
Gauss-Newton (``ops.gauss_newton``) — all inside one jit.

Correspondence rules mirror the reference:
* edge: nearest less-sharp point a (gate d^2 < 25), plus nearest point b on
  a DIFFERENT ring within +/-2.5 rings (odometry_scan_matcher.cc:86-141);
  factor is point-to-line through (a, normalize(a-b));
* plane: nearest less-flat point a, nearest b on the SAME ring, nearest c
  on a different nearby ring (odometry_scan_matcher.cc:172-232); factor is
  point-to-plane through the (a,b,c) triangle.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from msf_loam_tpu.config import OdometryConfig
from msf_loam_tpu.core.pointcloud import PointBatch, ScanFeatures
from msf_loam_tpu.core.se3 import Pose
from msf_loam_tpu.ops import gauss_newton as gn
from msf_loam_tpu.ops import icp_residuals as icp

Array = jax.Array

def _corr_d2(q_world: Array, query_mask: Array, ref: PointBatch) -> Array:
    """Exact (N, M) squared query-to-reference distances; invalid pairs +inf.

    One (N,3)x(3,M) matmul plus rank-1 norms, no top-k cap. The matmul must
    run at f32 precision (core.precision): with reduced-precision inputs
    the expansion flips picks between near-equidistant candidates.
    A capped kNN is NOT equivalent here: on surfaces grazed along the ring
    (floor/ceiling) same-ring neighbors are ~2-3 cm apart while the nearest
    different-ring point is ~1 m away, so any small-K candidate list fills
    up with same-ring points and the reference's different-ring b/c search
    (odometry_scan_matcher.cc:95-141,186-232, explicit scan-line walk) finds
    matches a top-8 never surfaces — measured as an unobservable z axis on
    corridor/street scenes."""
    rx = ref.masked_xyz()
    qn = jnp.sum(q_world * q_world, axis=-1, keepdims=True)
    rn = jnp.sum(rx * rx, axis=-1)[None, :]
    d2 = qn + rn - 2.0 * (q_world @ rx.T)
    bad = ~(query_mask[:, None] & ref.mask[None, :])
    return jnp.where(bad, jnp.inf, jnp.maximum(d2, 0.0))


class EdgeCorrespondences(NamedTuple):
    points: Array   # (N, 3) sensor-frame query points
    line_c: Array   # (N, 3)
    line_n: Array   # (N, 3)
    valid: Array    # (N,)


class PlaneCorrespondences(NamedTuple):
    points: Array
    plane_c: Array
    plane_n: Array
    valid: Array


def find_edge_correspondences(query: PointBatch, ref: PointBatch, pose: Pose,
                              cfg: OdometryConfig,
                              gate_scale: float = 1.0) -> EdgeCorrespondences:
    q_world = pose.apply(query.xyz)

    d2 = _corr_d2(q_world, query.mask, ref)                      # (N, M)
    a_sel = jnp.argmin(d2, axis=1)
    a_ok = (jnp.min(d2, axis=1) < cfg.dist_sq_threshold) & query.mask
    ring_a = ref.ring[a_sel]

    # b: nearest on a different, nearby ring (exact over all of ref)
    dr = jnp.abs(ref.ring[None, :] - ring_a[:, None]).astype(jnp.float32)
    b_d2 = jnp.where((dr > 0) & (dr <= cfg.nearby_scan), d2, jnp.inf)
    b_sel = jnp.argmin(b_d2, axis=1)
    b_ok = jnp.min(b_d2, axis=1) < cfg.dist_sq_threshold

    a_xyz = ref.xyz[a_sel]
    b_xyz = ref.xyz[b_sel]
    direction = a_xyz - b_xyz
    nrm = jnp.linalg.norm(direction, axis=-1, keepdims=True)
    line_n = direction / jnp.maximum(nrm, 1e-12)
    valid = a_ok & b_ok & (nrm[:, 0] > 1e-6)
    if cfg.corr_max_resid > 0:
        # residual gate at the live estimate (see the plane variant): kills
        # newly-revealed edge points matched to unrelated structures
        d_line = jnp.linalg.norm(
            jnp.cross(line_n, q_world - a_xyz), axis=-1)
        valid = valid & (d_line < gate_scale * cfg.corr_max_resid)
    return EdgeCorrespondences(query.xyz, a_xyz, line_n, valid)


def find_plane_correspondences(query: PointBatch, ref: PointBatch, pose: Pose,
                               cfg: OdometryConfig,
                               gate_scale: float = 1.0
                               ) -> PlaneCorrespondences:
    del gate_scale  # reference-parity construction: no residual gate
    q_world = pose.apply(query.xyz)
    d2 = _corr_d2(q_world, query.mask, ref)                      # (N, M)

    a_sel = jnp.argmin(d2, axis=1)
    a_ok = (jnp.min(d2, axis=1) < cfg.dist_sq_threshold) & query.mask
    ring_a = ref.ring[a_sel]
    same_ring = ref.ring[None, :] == ring_a[:, None]
    not_a = jnp.arange(d2.shape[1])[None, :] != a_sel[:, None]

    # b: next-nearest on the SAME ring
    b_d2 = jnp.where(same_ring & not_a, d2, jnp.inf)
    b_sel = jnp.argmin(b_d2, axis=1)
    b_ok = jnp.min(b_d2, axis=1) < cfg.dist_sq_threshold

    # c: nearest on a different nearby ring
    dr = jnp.abs(ref.ring[None, :] - ring_a[:, None]).astype(jnp.float32)
    c_d2 = jnp.where((dr > 0) & (dr <= cfg.nearby_scan), d2, jnp.inf)
    c_sel = jnp.argmin(c_d2, axis=1)
    c_ok = jnp.min(c_d2, axis=1) < cfg.dist_sq_threshold

    a_xyz = ref.xyz[a_sel]
    b_xyz = ref.xyz[b_sel]
    c_xyz = ref.xyz[c_sel]
    center = (a_xyz + b_xyz + c_xyz) / 3.0
    nvec = jnp.cross(a_xyz - b_xyz, a_xyz - c_xyz)
    nrm = jnp.linalg.norm(nvec, axis=-1, keepdims=True)
    normal = nvec / jnp.maximum(nrm, 1e-12)
    valid = a_ok & b_ok & c_ok & (nrm[:, 0] > 1e-9)
    return PlaneCorrespondences(query.xyz, center, normal, valid)


def find_plane_correspondences_fit(query: PointBatch, ref: PointBatch,
                                   pose: Pose, cfg: OdometryConfig,
                                   gate_scale: float = 1.0
                                   ) -> PlaneCorrespondences:
    """Plane correspondence via a 5-point structured support + TLS fit.

    The reference's 3-point triangle (a; b same ring; c different ring,
    odometry_scan_matcher.cc:172-232) spans the surface with a ~3.5 cm
    same-ring baseline — at 1 cm range noise the triangle normal is noise-
    dominated, and measured on the street world the noisy normals couple
    into a systematic body-frame pull (diag_odometry.py: plane-class
    gradient at the TRUE pose [3.6, 1.0, 2.3 | 35, -19, 13] — a
    -2 cm/frame forward and -0.06/-0.03 deg/frame roll/yaw bias in the
    odometry chain). This variant keeps the same structured ring-aware
    selection but widens the support to 5 points (a + 2 nearest same-ring
    + 2 nearest different-ring) and fits a total-least-squares plane with
    the mapping stage's planarity tolerance — averaging the noise AND
    rejecting supports that straddle depth-jittered facade segments
    (non-planar -> fit invalid) instead of letting Huber merely cap their
    signed pull."""
    q_world = pose.apply(query.xyz)
    K = 16

    d2 = _corr_d2(q_world, query.mask, ref)                      # (N, M)
    a_min = jnp.min(d2, axis=1)
    a_sel = jnp.argmin(d2, axis=1)
    a_ok = (a_min < cfg.dist_sq_threshold) & query.mask
    ring_a = ref.ring[a_sel]
    dr = jnp.abs(ref.ring[None, :] - ring_a[:, None]).astype(jnp.float32)
    diff_ring = (dr > 0) & (dr <= cfg.nearby_scan)

    # c: nearest DIFFERENT-ring point, exact over the full row. This is
    # the completeness guarantee a small candidate list cannot give: on
    # surfaces grazed along the ring the K nearest are ALL same-ring
    # (voxel-leaf spacing ~0.2 m vs multi-meter ring spacing at range) and
    # the cross-ring span — the only z-observability on far ground — never
    # surfaces (same lesson as the edge b-search, _corr_d2 docstring).
    c_d2 = jnp.where(diff_ring, d2, jnp.inf)
    c_min = jnp.min(c_d2, axis=1)
    c_sel = jnp.argmin(c_d2, axis=1)
    c_ok = c_min < cfg.dist_sq_threshold

    # everything else selects from ONE K-candidate pass instead of one
    # masked top_k per support class. approx_min_k lowers to an exact
    # top-k on the GPU and the CPU; a binned backend could miss a
    # candidate, which only narrows a plane support by one point.
    cand_d2, cand_idx = jax.lax.approx_min_k(d2, K)              # (N, K)
    ring_cand = ref.ring[cand_idx]
    cand_ok = cand_d2 < cfg.dist_sq_threshold
    is_a = cand_idx == a_sel[:, None]
    same_c = (ring_cand == ring_a[:, None]) & ~is_a & cand_ok
    drc = jnp.abs(ring_cand - ring_a[:, None]).astype(jnp.float32)
    near_c = (drc <= cfg.nearby_scan) & cand_ok

    def pick(mask, k):
        vals, pos = jax.lax.top_k(jnp.where(mask, -cand_d2, -jnp.inf), k)
        idx = jnp.take_along_axis(cand_idx, pos, axis=1)
        return idx, vals > -jnp.inf * 0.5

    b_idx, b_ok = pick(same_c, 2)                # 2 nearest same-ring
    sup_idx = jnp.concatenate([a_sel[:, None], b_idx, c_sel[:, None]], axis=1)
    sup_ok = jnp.concatenate([a_ok[:, None], b_ok, c_ok[:, None]], axis=1)
    if cfg.plane_support_extra > 0:
        # widen with the nearest nearby-ring candidates (may duplicate the
        # structured picks — a duplicate merely double-weights a true
        # measurement). Near-field ground supports otherwise span only
        # ~2 voxel leaves; with 1 cm range noise the TLS normal tilts by
        # several percent and the residual couples tilt x query-offset
        # into a systematic roll pull (scripts/diag_odometry.py probe).
        e_idx, e_ok = pick(near_c, cfg.plane_support_extra)
        sup_idx = jnp.concatenate([sup_idx, e_idx], axis=1)
        sup_ok = jnp.concatenate([sup_ok, e_ok], axis=1)

    from msf_loam_tpu.ops import fitting

    neighbors = ref.xyz[sup_idx]                                 # (N, 5, 3)
    fit = fitting.fit_planes(neighbors, sup_ok, cfg.plane_fit_tol)
    valid = a_ok & fit.valid
    if cfg.corr_max_resid > 0:
        # residual gate at the live estimate: newly-REVEALED surface points
        # (occlusion boundary sweeping as the sensor advances) have no true
        # counterpart in the last scan; their nearest neighbors are wrong
        # surfaces within the reference's loose 5 m NN gate (e.g. facade
        # bottoms matched to ground 2 m below) and their pull is
        # systematically signed — Huber caps it but never zeroes it
        # (measured: a persistent left-side +0.08 m mean plane residual on
        # street drives, scripts/diag_odometry.py). The reference's
        # RefineByRejectOutliersWithThreshold is exactly this gate, shipped
        # commented out (scan_matcher.cc:13-38).
        resid = jnp.abs(jnp.sum(fit.normal * (q_world - fit.center), axis=-1))
        valid = valid & (resid < gate_scale * cfg.corr_max_resid)
    return PlaneCorrespondences(query.xyz, fit.center, fit.normal, valid)


class OdometryResult(NamedTuple):
    pose_curr2last: Pose
    n_correspondences: Array  # ()
    ok: Array                 # () bool — enough correspondences found
    cost: Array


@functools.partial(jax.jit, static_argnames=("cfg",))
def match_scan2scan(scan_last: ScanFeatures, scan_curr: ScanFeatures,
                    pose0: Pose, cfg: OdometryConfig) -> OdometryResult:
    """Estimate pose_curr2last by matching curr's sharp/flat features
    against last's less-sharp/less-flat clouds (see match_clouds)."""
    return match_clouds(scan_last.corner_less_sharp,
                        scan_last.surf_less_flat,
                        scan_curr.corner_sharp, scan_curr.surf_flat,
                        pose0, cfg)


def match_clouds(ref_corner: PointBatch, ref_surf: PointBatch,
                 q_corner0: PointBatch, q_surf0: PointBatch,
                 pose0: Pose, cfg: OdometryConfig,
                 axis_name=None) -> OdometryResult:
    """Scan-to-scan matcher core over explicit feature clouds.

    ``axis_name``: when called inside a shard_map with the QUERY clouds
    sharded over that mesh axis (reference clouds replicated), the
    correspondence counts and GN normal equations psum across shards —
    the point-axis data parallelism of SURVEY §2.9
    (parallel.sharded_odometry wraps this).

    With ``cfg.deskew`` (the A-LOAM DISTORTION=1 TransformToStart the
    reference ships disabled): both scans are motion-distorted; per
    re-association round the CURRENT scan's features reproject to its
    scan start with the LIVE pose estimate (refreshed each round — Picard
    iteration on the deskew), while the reference scan reprojects once
    with the warm-start step (the best estimate of ITS within-scan
    motion under constant velocity). The estimated transform is then the
    true scan-start-to-scan-start step rather than the effective-center
    displacement rigid matching recovers."""
    if cfg.deskew:
        from msf_loam_tpu.imu.deskew import undistort_from_motion

        ref_corner = undistort_from_motion(ref_corner, pose0, cfg.scan_period)
        ref_surf = undistort_from_motion(ref_surf, pose0, cfg.scan_period)

    pose = pose0
    n_corr = jnp.float32(0.0)
    cost = jnp.float32(0.0)
    for rnd in range(cfg.outer_rounds):
        # residual-gate schedule: relaxed on early rounds (the warm start
        # can be decimeters off at turn onset — a tight gate there starves
        # the far correspondences that observe rotation), tight on the
        # final round where the estimate has converged
        gate_scale = (cfg.corr_gate_relax
                      if rnd < cfg.outer_rounds - 1 else 1.0)
        q_corner = q_corner0
        q_surf = q_surf0
        if cfg.deskew:
            q_corner = undistort_from_motion(q_corner, pose, cfg.scan_period)
            q_surf = undistort_from_motion(q_surf, pose, cfg.scan_period)
        with jax.named_scope("odo_correspondences"):
            edges = find_edge_correspondences(q_corner, ref_corner, pose,
                                              cfg, gate_scale)
            find_planes = (find_plane_correspondences_fit
                           if cfg.plane_corr == "fit"
                           else find_plane_correspondences)
            planes = find_planes(q_surf, ref_surf, pose, cfg, gate_scale)
        n_corr = (jnp.sum(edges.valid.astype(jnp.float32))
                  + jnp.sum(planes.valid.astype(jnp.float32)))
        if axis_name is not None:
            n_corr = jax.lax.psum(n_corr, axis_name)

        def build(p, v):
            eb = icp.edge_residuals(p, edges.points, edges.line_c, edges.line_n,
                                    edges.valid)
            pb = icp.plane_residuals(p, planes.points, planes.plane_c,
                                     planes.plane_n, planes.valid)
            return [eb, pb], [gn.huber_weights(eb, cfg.huber_delta),
                              gn.huber_weights(pb, cfg.huber_delta)]

        out = gn.gauss_newton(build, pose, jnp.zeros(3, jnp.float32),
                              n_iters=cfg.gn_iterations,
                              axis_name=axis_name)
        # keep the previous estimate if this round found too few matches
        ok_round = n_corr >= cfg.min_correspondences
        pose = jax.tree.map(lambda new, old: jnp.where(ok_round, new, old),
                            out.pose, pose)
        cost = out.cost

    return OdometryResult(
        pose_curr2last=pose,
        n_correspondences=n_corr,
        ok=n_corr >= cfg.min_correspondences,
        cost=cost,
    )
