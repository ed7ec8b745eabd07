"""Diagnose the scan-to-scan odometry yaw bias (VERDICT r2 item 1).

Runs match_scan2scan on consecutive cached street-world frames with the
GROUND-TRUTH step as warm start, so per-pair estimator error is isolated
from chain compounding. Reports, over all pairs:

* step error decomposed in the body frame (dx/dy/dz, droll/dpitch/dyaw),
  mean +/- std  — the mean IS the systematic bias;
* the normal-equation gradient at the TRUE pose per factor class
  (edges vs planes) — a nonzero mean gradient at truth means the
  correspondences themselves are biased, not the solver;
* optional ablations (edges-only / planes-only solves, extra rounds).

Usage:
  env JAX_PLATFORMS=cpu python scripts/diag_odometry.py \
      --frames 200 [--pairs 100] [--ablate]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def rot_to_rpy(R):
    """Body-frame axis-angle components of a small rotation matrix."""
    # log map, small-angle safe
    tr = np.trace(R)
    c = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-9:
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]]) / 2.0
    else:
        w = th / (2 * np.sin(th)) * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w  # radians, [x=roll, y=pitch, z=yaw]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--pairs", type=int, default=200)
    ap.add_argument("--start", type=int, default=30,
                    help="skip the launch ramp")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--cache_dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".cache", "kitti_sim"))
    ap.add_argument("--chain", action="store_true",
                    help="use the chained estimate as warm start (the real "
                         "odometry configuration) instead of GT")
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--plane_corr", default="triangle",
                    choices=["triangle", "fit"])
    args = ap.parse_args()

    # locate the cache the same way kitti_eval does
    import hashlib
    params = dict(seed=0, n_blocks=5, frames=args.frames, rings=64, pts=1800,
                  route="tour", speed=10.0, accel=2.0, noise=args.noise,
                  distorted=False)
    key = hashlib.sha1(json.dumps(params, sort_keys=True).encode()).hexdigest()[:12]
    cache = os.path.join(args.cache_dir, key)
    if not os.path.exists(os.path.join(cache, "states.npz")):
        raise SystemExit(f"no sim cache at {cache}; run kitti_eval --sim_only")

    import jax
    import jax.numpy as jnp

    from msf_loam_tpu.core.cache import enable_compilation_cache
    enable_compilation_cache()
    from msf_loam_tpu.config import FeatureConfig, OdometryConfig
    from msf_loam_tpu.core.se3 import Pose, quat_to_matrix
    from msf_loam_tpu.dataio import preprocess
    from msf_loam_tpu.ops import features as feat_mod
    from msf_loam_tpu.ops import gauss_newton as gn
    from msf_loam_tpu.ops import icp_residuals as icp
    from msf_loam_tpu.slam import odometry

    fcfg = FeatureConfig(max_points_per_ring=2048, max_less_flat=8192)
    ocfg = OdometryConfig(plane_corr=args.plane_corr)
    st = np.load(os.path.join(cache, "states.npz"))
    p, R = st["p"], st["R"]

    def load(i):
        blob = np.load(os.path.join(cache, f"frame_{i:05d}.npz"))
        return blob["xyz"], blob["ring"].astype(np.int32)

    @jax.jit
    def grad_at_truth(scan_last, scan_curr, pose_gt):
        """Normal-equation gradient at the TRUE pose, per factor class."""
        edges = odometry.find_edge_correspondences(
            scan_curr.corner_sharp, scan_last.corner_less_sharp, pose_gt, ocfg)
        find_planes = (odometry.find_plane_correspondences_fit
                       if ocfg.plane_corr == "fit"
                       else odometry.find_plane_correspondences)
        planes = find_planes(
            scan_curr.surf_flat, scan_last.surf_less_flat, pose_gt, ocfg)
        eb = icp.edge_residuals(pose_gt, edges.points, edges.line_c,
                                edges.line_n, edges.valid)
        pb = icp.plane_residuals(pose_gt, planes.points, planes.plane_c,
                                 planes.plane_n, planes.valid)
        we = gn.huber_weights(eb, ocfg.huber_delta)
        wp = gn.huber_weights(pb, ocfg.huber_delta)
        ge = jnp.einsum("nri,nr->i", eb.J * we[:, None, None], eb.r)
        # per-correspondence plane gradient, attributed by surface class
        gp_n = jnp.einsum("nri,nr->ni", pb.J * wp[:, None, None], pb.r)
        rng = jnp.linalg.norm(planes.points, axis=-1)
        ground = jnp.abs(planes.plane_n[:, 2]) > 0.7
        classes = {
            "ground_near": ground & (rng < 15),
            "ground_far": ground & (rng >= 15),
            "facade_near": ~ground & (rng < 15),
            "facade_far": ~ground & (rng >= 15),
        }
        out = {k: (jnp.sum(jnp.where(m[:, None], gp_n, 0.0), axis=0),
                   jnp.sum(m & (wp > 0)))
               for k, m in classes.items()}
        # quadrant-resolved signed residual for ground correspondences:
        # r>0 means the query sits ABOVE the matched plane
        r1 = pb.r[:, 0]
        for qname, qm in (("q_FL", (planes.points[:, 0] > 0) & (planes.points[:, 1] > 0)),
                          ("q_FR", (planes.points[:, 0] > 0) & (planes.points[:, 1] <= 0)),
                          ("q_BL", (planes.points[:, 0] <= 0) & (planes.points[:, 1] > 0)),
                          ("q_BR", (planes.points[:, 0] <= 0) & (planes.points[:, 1] <= 0))):
            m = ground & qm & pb.valid
            cnt = jnp.maximum(jnp.sum(m), 1)
            out[qname] = (jnp.stack([jnp.sum(jnp.where(m, r1, 0.0)) / cnt,
                                     jnp.zeros(()), jnp.zeros(()),
                                     jnp.zeros(()), jnp.zeros(()),
                                     jnp.zeros(())]),
                          jnp.sum(m))
        gp = jnp.sum(gp_n, axis=0)
        ne = jnp.sum(we > 0)
        np_ = jnp.sum(wp > 0)
        return ge, gp, ne, np_, out

    feats_prev = None
    errs, grads_e, grads_p = [], [], []
    ns = []
    class_grads = {}
    c2l_chain = Pose.identity()
    n_pairs = min(args.pairs, args.frames - args.start - 1)
    for k in range(n_pairs + 1):
        i = args.start + k
        xyz, ring = load(i)
        img = preprocess.preprocess_scan(xyz, ring, fcfg, num_rings=64)
        feats = feat_mod.extract_features(img, jnp.float32(0.1 * i), fcfg)
        if feats_prev is not None:
            # GT step: pose_curr2last maps curr sensor frame -> last sensor
            Rl, pl = R[i - 1], p[i - 1]
            Rc, pc = R[i], p[i]
            R_gt = Rl.T @ Rc
            t_gt = Rl.T @ (pc - pl)
            pose_gt = Pose(t=jnp.asarray(t_gt, jnp.float32),
                           q=jnp.asarray(_mat_to_quat(R_gt), jnp.float32))
            warm = c2l_chain if args.chain else pose_gt
            out = odometry.match_scan2scan(feats_prev, feats, warm, ocfg)
            c2l_chain = out.pose_curr2last
            R_est = np.asarray(quat_to_matrix(out.pose_curr2last.q))
            t_est = np.asarray(out.pose_curr2last.t)
            # error transform: gt^-1 * est
            R_err = R_gt.T @ R_est
            t_err = R_gt.T @ (t_est - t_gt)
            errs.append(np.concatenate([t_err, rot_to_rpy(R_err)]))

            ge, gp, ne, np_, by_class = grad_at_truth(feats_prev, feats,
                                                      pose_gt)
            grads_e.append(np.asarray(ge))
            grads_p.append(np.asarray(gp))
            ns.append((int(ne), int(np_)))
            for kk, (gv, cnt) in by_class.items():
                class_grads.setdefault(kk, []).append(
                    (np.asarray(gv), int(cnt)))
        feats_prev = feats
        if k % 50 == 0:
            print(f"  pair {k}/{n_pairs}", flush=True)

    errs = np.asarray(errs)
    ge = np.asarray(grads_e)
    gp = np.asarray(grads_p)
    deg = 180 / np.pi
    print(f"\n=== step error vs GT over {len(errs)} pairs "
          f"({'chain' if args.chain else 'GT'} warm start) ===")
    labels = ["dx(m)", "dy(m)", "dz(m)", "roll(deg)", "pitch(deg)", "yaw(deg)"]
    scale = [1, 1, 1, deg, deg, deg]
    for j, (lab, s) in enumerate(zip(labels, scale)):
        m, sd = errs[:, j].mean() * s, errs[:, j].std() * s
        print(f"  {lab:>11}: mean {m:+.5f}  std {sd:.5f}  "
              f"(bias/std {abs(m)/max(sd,1e-12):.2f})")
    print(f"\n=== gradient at TRUE pose (mean over pairs; state "
          f"[dt(3), dtheta(3)]) ===")
    print(f"  edges : {np.array2string(ge.mean(0), precision=4)}  "
          f"(n={np.mean([a for a,_ in ns]):.0f})")
    print(f"  planes: {np.array2string(gp.mean(0), precision=4)}  "
          f"(n={np.mean([b for _,b in ns]):.0f})")
    print(f"  edges  grad_yaw mean {ge[:, 5].mean():+.5f} std {ge[:, 5].std():.5f}")
    print(f"  planes grad_yaw mean {gp[:, 5].mean():+.5f} std {gp[:, 5].std():.5f}")
    print("\n=== plane gradient by class (mean over pairs) ===")
    for kk, lst in class_grads.items():
        gv = np.asarray([a for a, _ in lst])
        cnt = np.mean([c for _, c in lst])
        print(f"  {kk:>12} (n={cnt:5.0f}): "
              f"{np.array2string(gv.mean(0), precision=3)}")
    if "q_FL" in class_grads:
        series = np.asarray([a[0] for a, _ in class_grads["q_FL"]])
        print("\nq_FL mean-residual series (per pair):")
        print(np.array2string(series, precision=3, max_line_width=100))


def _mat_to_quat(R):
    """wxyz quaternion from rotation matrix (numpy, robust branch)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = np.argmax(np.diag(R))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


if __name__ == "__main__":
    main()
