"""Diagnose the scan-to-scan odometry yaw bias on the street world.

Matches consecutive scan pairs with a GROUND-TRUTH warm start (no chaining),
so the per-frame error distribution isolates the matcher's own bias from
error feedback in the odometry chain. Reports mean/std of the rotation error
components (sensor-frame rotvec of inv(gt_step) o est_step) and of the
translation error expressed in the sensor frame (forward/lateral/up).

  env JAX_PLATFORMS=cpu \
    python scripts/odo_bias_probe.py --frames 120
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--skip", type=int, default=20,
                    help="skip the launch ramp (accelerating frames)")
    ap.add_argument("--rings", type=int, default=64)
    ap.add_argument("--pts", type=int, default=1800)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--route", default="tour")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--distorted", action="store_true")
    ap.add_argument("--feature_overrides", default=None)
    ap.add_argument("--odometry_overrides", default=None)
    ap.add_argument("--factors", default="both", choices=["both", "edge", "plane"],
                    help="ablate one correspondence family (diagnosis)")
    ap.add_argument("--cache_dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".cache", "kitti_sim"))
    ap.add_argument("--sim_workers", type=int, default=4)
    args = ap.parse_args()
    args.json = None

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import kitti_eval

    args.world = "street"
    args.speed, args.accel, _, args.fov_up, args.fov_down, _ = \
        kitti_eval.WORLDS[args.world]
    args.sway = False

    cache, st, _path = kitti_eval.simulate_cached(args)

    import jax.numpy as jnp

    from msf_loam_tpu.config import FeatureConfig, OdometryConfig
    from msf_loam_tpu.core.se3 import Pose, matrix_to_quat, quat_log
    from msf_loam_tpu.dataio import preprocess
    from msf_loam_tpu.ops import features as feat_mod
    from msf_loam_tpu.slam import odometry

    fkw = dict(max_points_per_ring=2048, max_less_flat=8192)
    if args.feature_overrides:
        fkw.update(json.loads(args.feature_overrides))
    fcfg = FeatureConfig(**fkw)
    okw = dict(deskew=args.distorted)
    if args.odometry_overrides:
        okw.update(json.loads(args.odometry_overrides))
    ocfg = OdometryConfig(**okw)

    if args.factors != "both":
        def _disable(fn):
            def wrapped(query, ref, pose, cfg):
                out = fn(query, ref, pose, cfg)
                return out._replace(valid=out.valid & False)
            return wrapped
        if args.factors == "plane":
            odometry.find_edge_correspondences = _disable(
                odometry.find_edge_correspondences)
        else:
            odometry.find_plane_correspondences = _disable(
                odometry.find_plane_correspondences)

    n = args.frames
    rot_errs, t_errs, gt_yaws = [], [], []
    prev = None
    t0 = time.perf_counter()
    for i in range(n):
        xyz, ring = kitti_eval.load_frame(cache, i)
        img = preprocess.preprocess_scan(xyz, ring, fcfg, num_rings=args.rings)
        feats = feat_mod.extract_features(img, jnp.float32(kitti_eval.DT * i),
                                          fcfg)
        if prev is not None and i > args.skip:
            R_l, p_l = st["R"][i - 1], st["p"][i - 1]
            R_c, p_c = st["R"][i], st["p"][i]
            R_gt = R_l.T @ R_c
            t_gt = R_l.T @ (p_c - p_l)
            gt = Pose(t=jnp.asarray(t_gt, jnp.float32),
                      q=matrix_to_quat(jnp.asarray(R_gt, jnp.float32)))
            out = odometry.match_scan2scan(prev, feats, gt, ocfg)
            est = out.pose_curr2last
            err = gt.inverse().compose(est)
            rot_errs.append(np.asarray(quat_log(err.q)))   # sensor-frame rotvec
            t_errs.append(np.asarray(err.t))
            gt_yaws.append(np.asarray(quat_log(gt.q))[2])
            if len(rot_errs) % 40 == 0:
                print(f"  {i}/{n} ({time.perf_counter() - t0:.0f}s)",
                      flush=True)
        prev = feats

    rot = np.degrees(np.asarray(rot_errs))
    t = np.asarray(t_errs)
    yaw_gt = np.degrees(np.asarray(gt_yaws))
    turning = np.abs(yaw_gt) > 0.2
    print(f"pairs: {len(rot)}  (turning: {int(turning.sum())})")
    for name, arr in (("rot deg [x,y,z(yaw)]", rot), ("trans m [x,y,z]", t)):
        print(f"{name}: bias {np.mean(arr, 0).round(5).tolist()} "
              f" std {np.std(arr, 0).round(5).tolist()}")
    if turning.any() and (~turning).any():
        print("straight yaw bias deg:",
              round(float(np.mean(rot[~turning, 2])), 5),
              " turning yaw bias deg:",
              round(float(np.mean(rot[turning, 2])), 5))
    print("|rot| p50/p95 deg:",
          np.percentile(np.linalg.norm(rot, axis=1), [50, 95]).round(4).tolist(),
          " |t| p50/p95 m:",
          np.percentile(np.linalg.norm(t, axis=1), [50, 95]).round(4).tolist())


if __name__ == "__main__":
    main()
