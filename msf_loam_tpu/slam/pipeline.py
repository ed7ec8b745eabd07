"""The per-frame SLAM pipeline: odometry -> mapping -> map insert.

Host-side orchestration of the jitted stages, mirroring the reference's
``LaserOdometry`` (``laser_odometry.cc:69-95``) and ``LaserMapping::Run``
(``laser_mapping.cc:138-258``) including the odom->map transform
bookkeeping (``TransformAssociateToMap``/``TransformUpdate``,
``laser_mapping.h:55-61``). Where the reference pipelines odometry and
mapping across two threads with a queue, this build runs them as
sequential device programs per frame (the queue becomes program order; the
real-time drop policy is handled by the caller).

The IMU-coupled paths (deskew, estimator, gravity init) are wired in via
``imu_state`` once an ``ImuBuffer`` is provided — see msf_loam_tpu/imu/.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from msf_loam_tpu.config import MsfLoamConfig
from msf_loam_tpu.core.pointcloud import PointBatch, ScanFeatures
from msf_loam_tpu.core.precision import f32_matmuls
from msf_loam_tpu.core.se3 import Pose
from msf_loam_tpu.core.timing import StageTimers
from msf_loam_tpu.imu import deskew as deskew_mod
from msf_loam_tpu.imu import gravity_init
from msf_loam_tpu.imu import imu_factor as imu_factor_mod
from msf_loam_tpu.imu import preintegration as preint_mod
from msf_loam_tpu.imu.buffer import ImuBuffer
from msf_loam_tpu.ops.voxel import voxel_downsample_compact_idx
from msf_loam_tpu.slam import mapping, odometry, voxel_map

Array = jax.Array


@functools.partial(jax.jit, static_argnames=("capacity",))
def downsample_features(pb: PointBatch, leaf: float, capacity: int) -> PointBatch:
    """Voxel-thin a feature cloud and compact to a fixed query budget
    (FilterLessFlatLessCornerFeature, laser_mapping.cc:340-364).

    The budget never exceeds the input capacity — a padded-out query set
    makes the map gather do work for masked rows. Dedup + compaction in
    ONE sort pass (voxel_downsample_compact_idx). Output rows land in
    voxel-key order rather than scan order — matching is order-invariant
    (every consumer gates on ``mask``)."""
    capacity = min(capacity, pb.xyz.shape[0])
    idx, valid = voxel_downsample_compact_idx(pb.xyz, pb.mask, leaf,
                                              capacity)
    return PointBatch(
        xyz=pb.xyz[idx], rel_time=pb.rel_time[idx],
        ring=pb.ring[idx], mask=valid,
    )


def pose_is_finite(pose: Pose):
    """Traced scalar: True iff every pose component is finite. The solve
    watchdog gates on this — the reference aborts on glog CHECKs when a
    degenerate solve produces NaN; a production pipeline must degrade to
    the prior instead (SURVEY.md §5)."""
    return jnp.all(jnp.isfinite(pose.t)) & jnp.all(jnp.isfinite(pose.q))


def finite_point_mask(mask, xyz):
    """Insert-side last line of defense: never let a non-finite point into
    the map (a NaN coordinate hashes to a garbage cell and the leaf-dedup
    keeps it forever)."""
    return mask & jnp.all(jnp.isfinite(xyz), axis=-1)


@dataclasses.dataclass
class FrameResult:
    time: float
    odom_pose: Pose    # odometry-frame pose (pose_scan2world_)
    map_pose: Pose     # mapping-frame pose (pose_map_scan2world_)
    n_correspondences: float
    ok: bool


@functools.partial(jax.jit, static_argnames=("cfg",),
                   donate_argnames=("corner_map", "surf_map"))
def fused_frame_step_from_image(cfg: MsfLoamConfig, corner_map, surf_map,
                                prev_scan: ScanFeatures, ring_image,
                                scan_time, pose_c2l: Pose, pose_odom: Pose,
                                pose_o2m: Pose, is_first):
    """Like fused_frame_step but starting from the raw RingImage: feature
    extraction fuses into the same device program (one dispatch per frame
    from raw points to updated map)."""
    from msf_loam_tpu.ops import features as feat_mod

    scan = feat_mod.extract_features(ring_image, scan_time, cfg.features)
    out = _frame_core(cfg, corner_map, surf_map, prev_scan, scan,
                      pose_c2l, pose_odom, pose_o2m, is_first)
    return out + (scan,)


@functools.partial(jax.jit, static_argnames=("cfg",),
                   donate_argnames=("corner_map", "surf_map"))
def fused_frame_step(cfg: MsfLoamConfig, corner_map, surf_map,
                     prev_scan: ScanFeatures, scan: ScanFeatures,
                     pose_c2l: Pose, pose_odom: Pose, pose_o2m: Pose,
                     is_first):
    """The whole lidar-only frame as ONE device program (odometry GN +
    downsample + scan-to-map GN + map insert). The host pipeline issues a
    single dispatch per frame."""
    return _frame_core(cfg, corner_map, surf_map, prev_scan, scan,
                       pose_c2l, pose_odom, pose_o2m, is_first)


@f32_matmuls
def _frame_core(cfg: MsfLoamConfig, corner_map, surf_map,
                prev_scan: ScanFeatures, scan: ScanFeatures,
                pose_c2l: Pose, pose_odom: Pose, pose_o2m: Pose, is_first,
                query_fn=None, query2_fn=None, query_pair_fn=None,
                insert_fn=None, odometry_fn=None):
    """Lidar-only frame body. The ``*_fn`` hooks swap the map backend —
    the sharded pipeline injects multi-device packed queries and
    owner-routed inserts so the SAME frame program runs dense or
    distributed (parallel/sharded_pipeline.py)."""
    from msf_loam_tpu.slam import mapping as mapping_mod
    from msf_loam_tpu.slam import odometry as odometry_mod
    from msf_loam_tpu.slam import voxel_map as vm

    oc, mc = cfg.odometry, cfg.mapping
    if odometry_fn is None:
        odo = odometry_mod.match_scan2scan(prev_scan, scan, pose_c2l, oc)
    else:
        # point-axis-sharded matcher (parallel.sharded_odometry)
        odo = odometry_fn(prev_scan, scan, pose_c2l, oc)
    use = odo.ok & ~is_first & pose_is_finite(odo.pose_curr2last)
    pose_c2l = jax.tree.map(lambda n, o: jnp.where(use, n, o),
                            odo.pose_curr2last, pose_c2l)
    step_pose = jax.tree.map(lambda i, p: jnp.where(is_first, i, p),
                             Pose.identity(), pose_c2l)
    pose_odom = pose_odom.compose(step_pose)

    guess = pose_o2m.compose(pose_odom)
    corner_ds = downsample_features(scan.corner_less_sharp,
                                    mc.line_resolution,
                                    mc.corner_query_points)
    surf_ds = downsample_features(scan.surf_less_flat, mc.plane_resolution,
                                  mc.max_query_points)
    if oc.motion_deskew:
        # constant-velocity reprojection to scan start, prior = the
        # in-frame scan-to-scan odometry step. Two properties matter
        # (both measured the hard way):
        #  * the prior must be FEEDBACK-FREE: a map-anchored prior (last
        #    mapped-pose delta) closes an unstable loop — an over-
        #    correction shifts the mapped pose, sign-flips into the next
        #    prior, and alternates divergently. The odometry step never
        #    reads the map, so no loop.
        #  * step_pose is identity on the first frame, so that scan
        #    cannot be deskewed — and a RAW first insert poisons every
        #    later match (clean scan vs smeared map is worse than
        #    distorted vs distorted, which self-cancels); hence the
        #    first-frame insert skip below.
        dt = cfg.features.scan_period
        corner_ds = deskew_mod.undistort_from_motion(corner_ds, step_pose, dt)
        surf_ds = deskew_mod.undistort_from_motion(surf_ds, step_pose, dt)

    mres = mapping_mod.match_scan2map_core(
        corner_map, surf_map, corner_ds, surf_ds, guess, mc,
        query_fn=query_fn, query2_fn=query2_fn,
        query_pair_fn=query_pair_fn)
    # watchdog: a non-finite solve (degenerate geometry) falls back to the
    # odometry guess instead of poisoning the map (the reference aborts on
    # CHECKs; a production pipeline must degrade instead — SURVEY.md §5)
    pose_map = jax.tree.map(
        lambda n, o: jnp.where(mres.ok & pose_is_finite(mres.pose), n, o),
        mres.pose, guess)
    pose_o2m = pose_map.compose(pose_odom.inverse())

    cw = corner_ds.transform(pose_map)
    sw = surf_ds.transform(pose_map)
    c_mask, s_mask = cw.mask, sw.mask
    if oc.motion_deskew:
        # the first frame has no motion prior, so its scan cannot be
        # deskewed — and inserting it raw poisons the map (voxel-leaf
        # dedup keeps the smeared points forever). Start the map at
        # frame 1 instead; frame 1 then matches an empty map and falls
        # back to the odometry pose, which is the right degradation.
        c_mask = c_mask & ~is_first
        s_mask = s_mask & ~is_first
    if insert_fn is None:
        insert_fn = vm.insert
    corner_map = insert_fn(corner_map, cw.xyz,
                           finite_point_mask(c_mask, cw.xyz))
    surf_map = insert_fn(surf_map, sw.xyz,
                         finite_point_mask(s_mask, sw.xyz))
    return (corner_map, surf_map, pose_c2l, pose_odom, pose_o2m, pose_map,
            odo.n_correspondences, odo.ok | is_first)


@functools.partial(jax.jit, static_argnames=("cfg",),
                   donate_argnames=("corner_map", "surf_map"))
def fused_lio_frame(cfg: MsfLoamConfig, corner_map, surf_map,
                    prev_scan: ScanFeatures, ring_image, scan_time,
                    pose_c2l: Pose, pose_odom: Pose, pose_o2m: Pose,
                    is_first,
                    pair_dts, pair_accs, pair_gyrs, pair_valid,
                    scan_dts, scan_accs, scan_gyrs, scan_valid,
                    prev_p, prev_q, prev_v, gravity,
                    ba=None, bg=None):
    return lio_frame_core(cfg, corner_map, surf_map, prev_scan, ring_image,
                          scan_time, pose_c2l, pose_odom, pose_o2m, is_first,
                          pair_dts, pair_accs, pair_gyrs, pair_valid,
                          scan_dts, scan_accs, scan_gyrs, scan_valid,
                          prev_p, prev_q, prev_v, gravity, ba=ba, bg=bg)


@f32_matmuls
def lio_frame_core(cfg: MsfLoamConfig, corner_map, surf_map,
                   prev_scan: ScanFeatures, ring_image, scan_time,
                   pose_c2l: Pose, pose_odom: Pose, pose_o2m: Pose,
                   is_first,
                   pair_dts, pair_accs, pair_gyrs, pair_valid,
                   scan_dts, scan_accs, scan_gyrs, scan_valid,
                   prev_p, prev_q, prev_v, gravity,
                   ba=None, bg=None,
                   query_fn=None, query2_fn=None, query_pair_fn=None,
                   insert_fn=None, odometry_fn=None):
    """The tightly-coupled (post-init) frame as ONE device program:
    extraction + scan-to-scan GN + pair/scan preintegration + IMU pre-solve
    + deskew-aware scan-to-map GN + full deskew + insert. The host only
    slices IMU windows (imu/buffer.py) between dispatches."""
    from msf_loam_tpu.ops import features as feat_mod

    oc, mc, ic = cfg.odometry, cfg.mapping, cfg.imu
    scan = feat_mod.extract_features(ring_image, scan_time, cfg.features)

    if odometry_fn is None:
        odo = odometry.match_scan2scan(prev_scan, scan, pose_c2l, oc)
    else:
        odo = odometry_fn(prev_scan, scan, pose_c2l, oc)
    use = odo.ok & ~is_first & pose_is_finite(odo.pose_curr2last)
    pose_c2l = jax.tree.map(lambda n, o: jnp.where(use, n, o),
                            odo.pose_curr2last, pose_c2l)
    step_pose = jax.tree.map(lambda i, p: jnp.where(is_first, i, p),
                             Pose.identity(), pose_c2l)
    pose_odom = pose_odom.compose(step_pose)

    # IMU prediction of this frame's state from the previous mapped state.
    # Biases linearize the preintegration at the online estimate
    # (imu/bias_estimator.py) — rebuilt-from-raw-samples each frame, i.e.
    # repropagation at frame granularity (integration_base.cc:36-50).
    ba = jnp.zeros(3) if ba is None else ba
    bg = jnp.zeros(3) if bg is None else bg
    pre_pair = preint_mod.preintegrate(
        pair_dts, pair_accs, pair_gyrs, pair_valid, ba, bg, ic)
    prev_state = imu_factor_mod.ImuState(
        pose=Pose(prev_p, prev_q), v=prev_v, ba=ba, bg=bg)
    pred = imu_factor_mod.imu_presolve(pre_pair, prev_state, gravity,
                                       info_scale=ic.sqrt_info_scale)
    pre_scan = preint_mod.preintegrate(
        scan_dts, scan_accs, scan_gyrs, scan_valid, ba, bg, ic)

    corner_ds = downsample_features(scan.corner_less_sharp,
                                    mc.line_resolution,
                                    mc.corner_query_points)
    surf_ds = downsample_features(scan.surf_less_flat, mc.plane_resolution,
                                  mc.max_query_points)

    # per-point deskew terms for the compacted query batches
    corner_dk = deskew_mod.deskew_terms(pre_scan, corner_ds.rel_time, gravity)
    surf_dk = deskew_mod.deskew_terms(pre_scan, surf_ds.rel_time, gravity)

    if ic.tight_coupling:
        mres = mapping.match_scan2map_tight_core(
            corner_map, surf_map, corner_ds, surf_ds, pred.pose, pred.v,
            gravity, corner_dk, surf_dk, pre_pair, prev_state, mc,
            imu_weight=ic.imu_factor_weight,
            query_fn=query_fn, query2_fn=query2_fn,
            query_pair_fn=query_pair_fn)
    else:
        mres = mapping.match_scan2map_deskew_core(
            corner_map, surf_map, corner_ds, surf_ds, pred.pose, pred.v,
            gravity, corner_dk, surf_dk, mc,
            query_fn=query_fn, query2_fn=query2_fn,
            query_pair_fn=query_pair_fn)
    guess = pose_o2m.compose(pose_odom)
    # watchdog (SURVEY.md §5): a non-finite tight/deskew solve — NaN IMU
    # sample, degenerate map geometry — must not leak into the pose chain
    solve_ok = mres.ok & pose_is_finite(mres.pose)
    pose_map = jax.tree.map(lambda n, o: jnp.where(solve_ok, n, o),
                            mres.pose, guess)
    pose_o2m = pose_map.compose(pose_odom.inverse())
    # velocity fallback chain: solved -> IMU-predicted -> previous frame's
    # (a NaN preintegration window poisons pred.v too)
    if ic.tight_coupling:
        vel = jnp.where(solve_ok & jnp.all(jnp.isfinite(mres.velocity)),
                        mres.velocity, pred.v)
    else:
        vel = pred.v
    vel = jnp.where(jnp.all(jnp.isfinite(vel)), vel, prev_v)

    # full deskew (velocity+gravity) before insertion (laser_mapping.cc:197-211)
    corner_fix = deskew_mod.undistort_full(corner_ds, pre_scan, pose_map,
                                           vel, gravity)
    surf_fix = deskew_mod.undistort_full(surf_ds, pre_scan, pose_map,
                                         vel, gravity)
    cw = corner_fix.transform(pose_map)
    sw = surf_fix.transform(pose_map)
    if insert_fn is None:
        insert_fn = voxel_map.insert
    corner_map = insert_fn(corner_map, cw.xyz, finite_point_mask(cw.mask,
                                                                 cw.xyz))
    surf_map = insert_fn(surf_map, sw.xyz, finite_point_mask(sw.mask,
                                                             sw.xyz))

    return (corner_map, surf_map, pose_c2l, pose_odom, pose_o2m, pose_map,
            vel, odo.n_correspondences, odo.ok | is_first, scan)


class SlamPipeline:
    """Stateful frame-by-frame SLAM driver (single trajectory)."""

    def __init__(self, config: MsfLoamConfig, timers: Optional[StageTimers] = None):
        self.cfg = config
        self.timers = timers or StageTimers()
        mc = config.mapping
        self.corner_map = voxel_map.create_map(
            mc.map_table_size, mc.map_cell_capacity, mc.map_cell_size,
            mc.line_resolution)
        self.surf_map = voxel_map.create_map(
            mc.map_table_size, mc.map_cell_capacity, mc.map_cell_size,
            mc.plane_resolution)
        self.pose_odom = Pose.identity()       # pose_scan2world_ (odometry frame)
        self.pose_curr2last = Pose.identity()  # warm start (constant velocity)
        self.pose_odom2map = Pose.identity()   # pose_odom2map_
        self.pose_map = Pose.identity()        # pose_map_scan2world_
        self.prev_scan: Optional[ScanFeatures] = None
        self.results: List[FrameResult] = []
        self.frame_idx = 0
        # --- IMU / estimator state (Estimator, estimator.h:21-62) ---
        self.imu_buffer = ImuBuffer()
        self.velocity = jnp.zeros(3, jnp.float32)
        self.gravity = jnp.asarray(config.imu.gravity, dtype=jnp.float32)
        self.bias_acc = jnp.zeros(3, jnp.float32)
        self.bias_gyr = jnp.zeros(3, jnp.float32)
        self.is_initialized = False            # estimator is_initialized_
        self._states: List[dict] = []          # RobotState window for init
        self._prev_state_time: Optional[float] = None

    # ------------------------------------------------------------------
    def add_imu(self, t: float, acc, gyr) -> None:
        """Feed one IMU sample (AddImu path, laser_mapping.cc:403-416)."""
        self.imu_buffer.add(t, acc, gyr)

    @property
    def has_imu(self) -> bool:
        """IMU warm-up gate (>100 msgs before lidar is used,
        msf_loam_node.cc:380-389)."""
        return len(self.imu_buffer) > self.cfg.imu.warmup_msgs

    def _preintegrate_window(self, start: float, end: float):
        w = self.imu_buffer.window(start, end, self.cfg.imu.max_imu_samples,
                                   self.cfg.imu.max_lidar_imu_offset)
        return preint_mod.preintegrate(
            jnp.asarray(w.dts), jnp.asarray(w.accs), jnp.asarray(w.gyrs),
            jnp.asarray(w.valid), self.bias_acc, self.bias_gyr,
            self.cfg.imu)

    def _estimator_add(self, time: float, pose: Pose, velocity) -> None:
        """Estimator::AddData (estimator.cc:56-111): collect states; at
        init_frames run the gravity/velocity solve."""
        icfg = self.cfg.imu
        st = dict(time=time, p=np.asarray(pose.t, np.float32),
                  q=np.asarray(pose.q, np.float32),
                  v=np.asarray(velocity, np.float32),
                  delta_p=None, delta_v=None)
        if self._states:
            prev = self._states[-1]
            pre = self._preintegrate_window(prev["time"], time)
            prev["delta_p"] = np.asarray(pre.delta_p)
            prev["delta_v"] = np.asarray(pre.delta_v)
            prev["pre"] = pre  # full pytree for the bias window solve
        self._states.append(st)
        if len(self._states) == icfg.init_frames and not self.is_initialized:
            out = self._solve_gravity_window(self._states)
            if self._grav_out_finite(out):
                self.gravity = out.gravity
                self.velocity = out.velocities[-1]
                for i, s in enumerate(self._states):
                    s["v"] = np.asarray(out.velocities[i])
            self.is_initialized = True
        elif (self.is_initialized and icfg.grav_refine_period > 0
              and len(self._states) >= 2 * icfg.init_frames
              and len(self._states) % icfg.grav_refine_period == 0):
            # continuous gravity refinement over the freshest init_frames
            # mapped states (same solve, same compiled shape). The init-era
            # gravity inherits the rotation-only-deskew pose errors of the
            # warm-up frames; a 1.4 deg tilt error injects ~0.24 m/s^2 of
            # phantom acceleration that the velocity feedback integrates
            # (measured: 0.28 m/s lag after 10 street frames). The
            # reference keeps gravity frozen after init (estimator.cc);
            # refining from post-init poses removes that floor.
            out = self._solve_gravity_window(
                self._states[-icfg.init_frames:])
            if self._grav_out_finite(out):
                self.gravity = out.gravity
                self.velocity = out.velocities[-1]
                self._states[-1]["v"] = np.asarray(out.velocities[-1])
        if (self.is_initialized and icfg.bias_period > 0
                and len(self._states) >= icfg.bias_window + 1
                and len(self._states) % icfg.bias_period == 0):
            self._solve_bias()

    @staticmethod
    def _grav_out_finite(out) -> bool:
        """Watchdog: never commit a non-finite gravity/velocity solution
        (a NaN IMU window with all pairs rejected leaves the LS singular)."""
        return bool(np.isfinite(np.asarray(out.gravity)).all()
                    and np.isfinite(np.asarray(out.velocities)).all())

    def _solve_bias(self) -> None:
        """Windowed shared-bias GN over mapped-pose-anchored IMU factors
        (imu/bias_estimator.py). The reference pins biases to zero
        (mapping_scan_matcher.cc:46); this exercises its dormant bias
        machinery online."""
        import jax

        from msf_loam_tpu.imu import bias_estimator

        icfg = self.cfg.imu
        W = icfg.bias_window
        sts = self._states[-(W + 1):]
        if any(s.get("pre") is None for s in sts[:-1]):
            return
        pres = jax.tree.map(lambda *xs: jnp.stack(xs),
                            *[s["pre"] for s in sts[:-1]])
        poses_t = jnp.asarray(np.stack([s["p"] for s in sts]))
        poses_q = jnp.asarray(np.stack([s["q"] for s in sts]))
        vels0 = jnp.asarray(np.stack([s["v"] for s in sts]))
        pair_valid = (pres.sum_dt > 1e-6) \
            & jnp.isfinite(pres.delta_p).all(-1) \
            & jnp.isfinite(pres.delta_v).all(-1)
        out = bias_estimator.solve_bias_window(
            poses_t, poses_q, vels0, pres, pair_valid, self.gravity,
            self.bias_acc, self.bias_gyr, icfg)
        if not (np.isfinite(np.asarray(out.ba)).all()
                and np.isfinite(np.asarray(out.bg)).all()
                and np.isfinite(np.asarray(out.velocities[-1])).all()):
            return
        a = icfg.bias_ema
        self.bias_acc = a * self.bias_acc + (1 - a) * out.ba
        self.bias_gyr = a * self.bias_gyr + (1 - a) * out.bg
        self.velocity = out.velocities[-1]
        self._states[-1]["v"] = np.asarray(out.velocities[-1])

    def _solve_gravity_window(self, states) -> "gravity_init.GravityInitResult":
        """Gravity/velocity LS over consecutive mapped states (the
        Estimator init solve, estimator.cc:56-111), reusable post-init."""
        icfg = self.cfg.imu
        N = len(states)
        p = np.asarray([s["p"] for s in states], np.float32)
        q = np.asarray([s["q"] for s in states], np.float32)
        dt = np.asarray([states[i + 1]["time"] - states[i]["time"]
                         for i in range(N - 1)], np.float32)
        dps = np.asarray([states[i]["delta_p"] for i in range(N - 1)],
                         np.float32)
        dvs = np.asarray([states[i]["delta_v"] for i in range(N - 1)],
                         np.float32)
        ok = np.isfinite(dps).all(axis=1) & (dt > 1e-6)
        return gravity_init.solve_gravity_velocity(
            jnp.asarray(p), jnp.asarray(q), jnp.asarray(dt),
            jnp.asarray(dps), jnp.asarray(dvs), jnp.asarray(ok),
            self.gravity, n_frames=N,
            reject_frac=icfg.init_reject_frac)

    # ------------------------------------------------------------------
    # process_scan / process_ring_image are the frame entry points: every
    # program they trace and dispatch (including the pre-init modular path
    # and the estimator solves) runs with f32 matmuls (core.precision)
    @f32_matmuls
    def process_scan(self, scan: ScanFeatures) -> FrameResult:
        cfg = self.cfg
        scan_time = float(scan.time)
        use_imu = self.has_imu

        if not use_imu:
            # pure-lidar frames run as one fused device program
            return self._process_scan_fused(scan)

        # pre-init rotation-only deskew (laser_mapping.cc:171-177)
        if use_imu and not self.is_initialized:
            pre_scan = self._preintegrate_window(
                scan_time, scan_time + cfg.features.scan_period)
            if int(pre_scan.n_samples) > 0:
                scan = deskew_mod.undistort_scan_rotation_only(scan, pre_scan)

        with self.timers.stage("ODO", "scan-to-scan"):
            if self.prev_scan is None:
                odom_ok = True
                n_corr = 0.0
            else:
                out = odometry.match_scan2scan(
                    self.prev_scan, scan, self.pose_curr2last, cfg.odometry)
                odom_ok = bool(out.ok)
                n_corr = float(out.n_correspondences)
                if odom_ok:
                    self.pose_curr2last = out.pose_curr2last
                self.pose_odom = self.pose_odom.compose(self.pose_curr2last)

        with self.timers.stage("MAP", "downsample"):
            corner_ds = downsample_features(
                scan.corner_less_sharp, cfg.mapping.line_resolution,
                cfg.mapping.corner_query_points)
            surf_ds = downsample_features(
                scan.surf_less_flat, cfg.mapping.plane_resolution,
                cfg.mapping.max_query_points)

        if (use_imu and not self.is_initialized and odom_ok
                and self.prev_scan is not None and cfg.odometry.motion_deskew):
            # pre-init translation deskew from the in-frame odometry step
            # (rotation already removed by the gyro-only deskew above;
            # the odometry prior is feedback-free — see _frame_core).
            # Without this, every init-window pose is biased by ~0.5 v T,
            # the bias grows with the launch speed ramp, and the gravity
            # solve misreads it as tilt (measured: 1.3 deg -> 0.23 m/s^2
            # phantom lateral acceleration integrated into velocity).
            dt = cfg.features.scan_period
            corner_ds = deskew_mod.undistort_from_motion(
                corner_ds, self.pose_curr2last, dt, translation_only=True)
            surf_ds = deskew_mod.undistort_from_motion(
                surf_ds, self.pose_curr2last, dt, translation_only=True)

        with self.timers.stage("MAP", "scan-to-map"):
            # TransformAssociateToMap (laser_mapping.h:55)
            pose_guess = self.pose_odom2map.compose(self.pose_odom)
            pre_scan = None
            if use_imu and self.is_initialized and self._states:
                # tightly-coupled branch (mapping_scan_matcher.cc:35-61,
                # 109-246): IMU-only pre-solve from the previous mapped
                # state, then deskew-aware lidar GN.
                prev = self._states[-1]
                pre_pair = self._preintegrate_window(prev["time"], scan_time)
                prev_state = imu_factor_mod.ImuState(
                    pose=Pose(jnp.asarray(prev["p"]), jnp.asarray(prev["q"])),
                    v=jnp.asarray(prev["v"]), ba=self.bias_acc,
                    bg=self.bias_gyr)
                pred = imu_factor_mod.imu_presolve(
                    pre_pair, prev_state, self.gravity,
                    info_scale=cfg.imu.sqrt_info_scale)
                if bool(jnp.all(jnp.isfinite(pred.v))):
                    self.velocity = pred.v
                pre_scan = self._preintegrate_window(
                    scan_time, scan_time + cfg.features.scan_period)
                corner_dk = deskew_mod.deskew_terms(
                    pre_scan, corner_ds.rel_time, self.gravity)
                surf_dk = deskew_mod.deskew_terms(
                    pre_scan, surf_ds.rel_time, self.gravity)
                if cfg.imu.tight_coupling:
                    mres = mapping.match_scan2map_tight(
                        self.corner_map, self.surf_map, corner_ds, surf_ds,
                        pred.pose, self.velocity, self.gravity,
                        corner_dk, surf_dk, pre_pair, prev_state,
                        cfg.mapping, imu_weight=cfg.imu.imu_factor_weight)
                    if bool(mres.ok) and \
                            bool(jnp.all(jnp.isfinite(mres.velocity))):
                        self.velocity = mres.velocity
                else:
                    mres = mapping.match_scan2map_deskew(
                        self.corner_map, self.surf_map, corner_ds, surf_ds,
                        pred.pose, self.velocity, self.gravity,
                        corner_dk, surf_dk, cfg.mapping)
            else:
                mres = mapping.match_scan2map(
                    self.corner_map, self.surf_map, corner_ds, surf_ds,
                    pose_guess, cfg.mapping)
            # watchdog: gate on finiteness as well as ok (a degenerate
            # solve must fall back to the guess, not poison the chain)
            self.pose_map = mres.pose if (
                bool(mres.ok) and bool(pose_is_finite(mres.pose))
            ) else pose_guess
            # TransformUpdate (laser_mapping.h:59)
            self.pose_odom2map = self.pose_map.compose(self.pose_odom.inverse())

        skip_insert = (cfg.odometry.motion_deskew and use_imu
                       and not self.is_initialized and self.prev_scan is None)
        with self.timers.stage("MAP", "insert"):
            if skip_insert:
                # first frame with motion deskew on: no motion prior exists
                # yet, and a raw distorted insert would poison the map
                # (see _frame_core) — start the map at frame 1
                corner_ds = corner_ds._replace(
                    mask=jnp.zeros_like(corner_ds.mask))
                surf_ds = surf_ds._replace(mask=jnp.zeros_like(surf_ds.mask))
            if use_imu and self.is_initialized and pre_scan is not None:
                # full deskew before insertion (laser_mapping.cc:197-211)
                corner_ds = deskew_mod.undistort_full(
                    corner_ds, pre_scan, self.pose_map, self.velocity,
                    self.gravity)
                surf_ds = deskew_mod.undistort_full(
                    surf_ds, pre_scan, self.pose_map, self.velocity,
                    self.gravity)
            corner_w = corner_ds.transform(self.pose_map)
            surf_w = surf_ds.transform(self.pose_map)
            self.corner_map = voxel_map.insert(
                self.corner_map, corner_w.xyz,
                finite_point_mask(corner_w.mask, corner_w.xyz))
            self.surf_map = voxel_map.insert(
                self.surf_map, surf_w.xyz,
                finite_point_mask(surf_w.mask, surf_w.xyz))

        if use_imu:
            with self.timers.stage("EST", "add-data"):
                self._estimator_add(scan_time, self.pose_map, self.velocity)

        self.prev_scan = scan
        self.frame_idx += 1
        self._maybe_evict()
        res = FrameResult(
            time=float(scan.time), odom_pose=self.pose_odom,
            map_pose=self.pose_map, n_correspondences=n_corr, ok=odom_ok)
        self.results.append(res)
        return res

    # ------------------------------------------------------------------
    @f32_matmuls
    def process_ring_image(self, ring_image, scan_time: float) -> FrameResult:
        """Raw RingImage -> one fused device dispatch per frame (feature
        extraction included). Initialized-LIO frames run the tightly-coupled
        fused program; pre-init IMU frames fall back to the modular path
        (rotation-only deskew + estimator warm-up)."""
        import jax.numpy as jnp

        if self.has_imu and self.is_initialized and self._states \
                and self.prev_scan is not None:
            return self._process_lio_fused(ring_image, scan_time)
        if self.has_imu:
            from msf_loam_tpu.ops import features as feat_mod
            feats = feat_mod.extract_features(
                ring_image, jnp.float32(scan_time), self.cfg.features)
            return self.process_scan(feats._replace(time=jnp.float32(scan_time)))

        is_first = self.prev_scan is None
        with self.timers.stage("SLAM", "fused-frame"):
            if is_first:
                from msf_loam_tpu.ops import features as feat_mod
                prev = feat_mod.extract_features(
                    ring_image, jnp.float32(scan_time), self.cfg.features)
            else:
                prev = self.prev_scan
            (self.corner_map, self.surf_map, self.pose_curr2last,
             self.pose_odom, self.pose_odom2map, self.pose_map,
             n_corr, ok, scan) = fused_frame_step_from_image(
                self.cfg, self.corner_map, self.surf_map, prev, ring_image,
                jnp.float32(scan_time), self.pose_curr2last, self.pose_odom,
                self.pose_odom2map, jnp.bool_(is_first))
        self.prev_scan = scan
        self.frame_idx += 1
        self._maybe_evict()
        res = FrameResult(
            time=scan_time, odom_pose=self.pose_odom, map_pose=self.pose_map,
            n_correspondences=float(n_corr), ok=bool(ok))
        self.results.append(res)
        return res

    def _maybe_evict(self) -> None:
        """Bound hash-table occupancy on long trajectories: periodically
        release cells far from the current pose (60 m horizon analog)."""
        mc = self.cfg.mapping
        if mc.map_evict_period > 0 and self.frame_idx % mc.map_evict_period == 0:
            self.corner_map = voxel_map.evict_far(
                self.corner_map, self.pose_map.t, mc.map_evict_radius)
            self.surf_map = voxel_map.evict_far(
                self.surf_map, self.pose_map.t, mc.map_evict_radius)

    # ------------------------------------------------------------------
    def _process_lio_fused(self, ring_image, scan_time: float) -> FrameResult:
        import jax.numpy as jnp

        cfg = self.cfg
        prev = self._states[-1]
        wp = self.imu_buffer.window(prev["time"], scan_time,
                                    cfg.imu.max_imu_samples,
                                    cfg.imu.max_lidar_imu_offset)
        ws = self.imu_buffer.window(scan_time,
                                    scan_time + cfg.features.scan_period,
                                    cfg.imu.max_imu_samples,
                                    cfg.imu.max_lidar_imu_offset)
        with self.timers.stage("SLAM", "fused-lio-frame"):
            (self.corner_map, self.surf_map, self.pose_curr2last,
             self.pose_odom, self.pose_odom2map, self.pose_map,
             self.velocity, n_corr, ok, scan) = fused_lio_frame(
                cfg, self.corner_map, self.surf_map, self.prev_scan,
                ring_image, jnp.float32(scan_time),
                self.pose_curr2last, self.pose_odom, self.pose_odom2map,
                jnp.bool_(False),
                jnp.asarray(wp.dts), jnp.asarray(wp.accs),
                jnp.asarray(wp.gyrs), jnp.asarray(wp.valid),
                jnp.asarray(ws.dts), jnp.asarray(ws.accs),
                jnp.asarray(ws.gyrs), jnp.asarray(ws.valid),
                jnp.asarray(prev["p"]), jnp.asarray(prev["q"]),
                jnp.asarray(prev["v"]), self.gravity,
                ba=self.bias_acc, bg=self.bias_gyr)
        with self.timers.stage("EST", "add-data"):
            self._estimator_add(scan_time, self.pose_map, self.velocity)
        self.prev_scan = scan
        self.frame_idx += 1
        self._maybe_evict()
        res = FrameResult(
            time=scan_time, odom_pose=self.pose_odom, map_pose=self.pose_map,
            n_correspondences=float(n_corr), ok=bool(ok))
        self.results.append(res)
        return res

    # ------------------------------------------------------------------
    def _process_scan_fused(self, scan: ScanFeatures) -> FrameResult:
        import jax.numpy as jnp

        is_first = self.prev_scan is None
        prev = scan if is_first else self.prev_scan
        with self.timers.stage("SLAM", "fused-frame"):
            (self.corner_map, self.surf_map, self.pose_curr2last,
             self.pose_odom, self.pose_odom2map, self.pose_map,
             n_corr, ok) = fused_frame_step(
                self.cfg, self.corner_map, self.surf_map, prev, scan,
                self.pose_curr2last, self.pose_odom, self.pose_odom2map,
                jnp.bool_(is_first))
        self.prev_scan = scan
        self.frame_idx += 1
        self._maybe_evict()
        res = FrameResult(
            time=float(scan.time), odom_pose=self.pose_odom,
            map_pose=self.pose_map,
            n_correspondences=float(n_corr), ok=bool(ok))
        self.results.append(res)
        return res

    # ------------------------------------------------------------------
    def metrics(self) -> dict:
        """Run-level observability snapshot (frames, map occupancy, stage
        timings) — the LOG_STEP_TIME/topic-stats analog, JSON-friendly."""
        occ_c = int(self.corner_map.total_points())
        occ_s = int(self.surf_map.total_points())
        slots_c = int((np.asarray(self.corner_map.count) > 0).sum())
        return {
            "frames": self.frame_idx,
            "imu_samples": len(self.imu_buffer),
            "imu_initialized": self.is_initialized,
            "map_points": {"corner": occ_c, "surf": occ_s},
            "map_slots_used": slots_c,
            "map_table_size": self.corner_map.table_size,
            "stages": self.timers.summary(),
        }

    # ------------------------------------------------------------------
    def trajectory(self) -> np.ndarray:
        """(N, 8) array [time, t(3), q(wxyz)] of mapping-frame poses."""
        rows = []
        for r in self.results:
            rows.append(np.concatenate([
                [r.time], np.asarray(r.map_pose.t), np.asarray(r.map_pose.q)]))
        return np.asarray(rows)


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE after optional SE(3) Umeyama alignment
    (the standard KITTI/TUM ATE metric used for the BASELINE.json targets)."""
    assert est_t.shape == gt_t.shape
    if align:
        mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
        E, G = est_t - mu_e, gt_t - mu_g
        W = G.T @ E
        U, _, Vt = np.linalg.svd(W)
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        t = mu_g - R @ mu_e
        est_t = est_t @ R.T + t
    err = est_t - gt_t
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
