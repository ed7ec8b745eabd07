"""Golden evaluation: long synthetic trajectories across all configs.

Produces the measured baseline BASELINE.md calls for (the reference
publishes none): ATE RMSE for (1) scan-to-scan only, (2) scan-to-map,
(3) +GPS pose graph, (4) LIO with motion-distorted scans — on a long
synthetic trajectory with exact ground truth. Runs on the CPU or the GPU.

  python scripts/golden_eval.py [--frames 60] [--json out.json]
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
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--json", default=None)
    ap.add_argument("--imu_frames", type=int, default=40)
    ap.add_argument("--loop_frames", type=int, default=60,
                    help="frames for the loop-closure section (smaller "
                         "fits tight compile windows)")
    ap.add_argument("--only", choices=["odo", "map", "gps", "lio", "loop"],
                    default=None,
                    help="run a single section (compile-budget splitting "
                         "for cold-cache first runs)")
    args = ap.parse_args()

    def enabled(name):
        return args.only is None or args.only == name

    import jax.numpy as jnp

    from msf_loam_tpu.core.cache import enable_compilation_cache
    enable_compilation_cache()

    from msf_loam_tpu.config import (FeatureConfig, ImuConfig, MappingConfig,
                                     MsfLoamConfig)
    from msf_loam_tpu.core.se3 import Pose
    from msf_loam_tpu.dataio import preprocess, synthetic
    from msf_loam_tpu.ops import features as feat_mod
    from msf_loam_tpu.slam import odometry, posegraph
    from msf_loam_tpu.slam.pipeline import SlamPipeline, ate_rmse

    fcfg = FeatureConfig(max_points_per_ring=2048, max_less_flat=8192)
    cfg = MsfLoamConfig(
        features=fcfg,
        mapping=MappingConfig(map_table_size=1 << 14, max_query_points=4096))
    world = synthetic.World.corridor(seed=0, size=25.0, n_poles=60)
    n = args.frames

    def pose_at(i):
        # loop-ish trajectory covering the room
        t = 0.1 * i
        yaw = 0.15 * t
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        p = np.array([10 * np.sin(0.12 * t), 8 * (1 - np.cos(0.12 * t)),
                      0.2 * np.sin(0.3 * t)])
        return p, R

    print(f"simulating {n} frames ...", flush=True)
    imgs, gt = [], []
    for i in range(n):
        p, R = pose_at(i)
        xyz, ring = synthetic.simulate_scan(world, p, R, n_rings=16,
                                            pts_per_ring=1800, noise=0.005,
                                            seed=i)
        imgs.append(preprocess.preprocess_scan(xyz, ring, fcfg, 16))
        gt.append(p)
    gt = np.asarray(gt)

    results = {}

    # (1) scan-to-scan only
    if enabled("odo"):
        t0 = time.perf_counter()
        pose_w = Pose.identity()
        c2l = Pose.identity()
        feats = [feat_mod.extract_features(im, jnp.float32(0.1 * i), fcfg)
                 for i, im in enumerate(imgs)]
        odo_t = [np.zeros(3)]
        for i in range(1, n):
            out = odometry.match_scan2scan(feats[i - 1], feats[i], c2l,
                                           cfg.odometry)
            c2l = out.pose_curr2last
            pose_w = pose_w.compose(c2l)
            odo_t.append(np.asarray(pose_w.t))
        results["odometry_only"] = {
            "ate_rmse_m": round(ate_rmse(np.asarray(odo_t), gt, align=False), 4),
            "elapsed_s": round(time.perf_counter() - t0, 1)}
        print("odometry_only:", results["odometry_only"], flush=True)

    # (2) full scan-to-map (also feeds (3))
    if enabled("map") or enabled("gps"):
        t0 = time.perf_counter()
        pipe = SlamPipeline(cfg)
        for i, im in enumerate(imgs):
            pipe.process_ring_image(im, 0.1 * i)
        traj = pipe.trajectory()
        results["scan_to_map"] = {
            "ate_rmse_m": round(ate_rmse(traj[:, 1:4], gt, align=False), 4),
            "elapsed_s": round(time.perf_counter() - t0, 1)}
        print("scan_to_map:", results["scan_to_map"], flush=True)

    # (3) + GPS pose graph (1 Hz, 5 cm noise)
    if enabled("gps"):
        rng = np.random.default_rng(0)
        sel = np.arange(0, n, 10)
        gps_xyz = gt[sel] + rng.uniform(-0.05, 0.05, size=(len(sel), 3))
        poses = Pose(t=jnp.asarray(traj[:, 1:4], dtype=jnp.float32),
                     q=jnp.asarray(traj[:, 4:8], dtype=jnp.float32))
        data = posegraph.build_graph_data(
            jnp.asarray(traj[:, 0], dtype=jnp.float32), poses,
            jnp.asarray(traj[sel, 0], dtype=jnp.float32),
            jnp.asarray(gps_xyz, dtype=jnp.float32),
            jnp.ones(len(sel), bool))
        out = posegraph.optimize(poses, data, cfg.posegraph, n_iters=10)
        results["with_gps_graph"] = {
            "ate_rmse_m": round(ate_rmse(np.asarray(out.poses.t), gt,
                                         align=False), 4)}
        print("with_gps_graph:", results["with_gps_graph"], flush=True)

    # (3b) loop closure under forced drift: aggressive map eviction makes
    # the out-and-back selftest drift; loop edges recover part of it.
    # Runs the real CLI end-to-end (subprocess) so the whole detect ->
    # match -> Woodbury-solve path is exercised as a user would.
    if enabled("loop"):
        import subprocess
        import tempfile
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as td:
            cfg_path = os.path.join(td, "evict.json")
            with open(cfg_path, "w") as f:
                json.dump({"mapping": {"map_evict_radius": 4.0,
                                       "map_evict_period": 5}}, f)
            base = [sys.executable, "-m", "msf_loam_tpu.apps.run_slam",
                    "--selftest", "--selftest_path", "loop",
                    "--selftest_frames", str(args.loop_frames),
                    "--config", cfg_path, "--eval", "--quiet"]
            def run(extra, outdir):
                out = subprocess.run(
                    base + extra + ["--output_dir", outdir],
                    capture_output=True, text=True, timeout=900, check=True)
                return json.loads(out.stdout.strip().splitlines()[-1])
            plain = run([], os.path.join(td, "a"))
            closed = run(["--loop_closure"], os.path.join(td, "b"))
        results["loop_closure"] = {
            "ate_drifted_m": plain["ate_rmse_m"],
            "ate_closed_m": closed["ate_rmse_m"],
            "loop_edges": closed["loop_edges"],
            "elapsed_s": round(time.perf_counter() - t0, 1)}
        print("loop_closure:", results["loop_closure"], flush=True)

    # (4) LIO on motion-distorted scans
    if not enabled("lio"):
        import jax
        results["platform"] = jax.devices()[0].platform
        results["frames"] = n
        print(json.dumps(results))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=1)
        return
    t0 = time.perf_counter()
    n_imu = args.imu_frames
    lio_cfg = MsfLoamConfig(
        features=fcfg,
        mapping=MappingConfig(map_table_size=1 << 14, max_query_points=4096),
        imu=ImuConfig(init_frames=8, warmup_msgs=10))
    V0 = np.array([1.0, 0.3, 0.0])
    YR = 0.2
    G = np.array([0.0, 0.0, 9.81])

    def lio_pose(tt):
        yaw = YR * tt
        c, s = np.cos(yaw), np.sin(yaw)
        return V0 * tt, np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])

    pipe = SlamPipeline(lio_cfg)
    tt = 0.5
    while tt < 1.0 + n_imu * 0.1 + 0.2:
        _, R = lio_pose(tt)
        pipe.add_imu(tt, R.T @ G, np.array([0, 0, YR]))
        tt += 1 / 400
    p0, R0 = lio_pose(1.0)
    gt_lio = []
    for i in range(n_imu):
        ts = 1.0 + 0.1 * i
        p, R = lio_pose(ts)
        gt_lio.append(R0.T @ (p - p0))
        xyz, ring = synthetic.simulate_scan(
            world, p, R, n_rings=16, pts_per_ring=1800, noise=0.005,
            seed=100 + i, linear_vel=V0, yaw_rate=YR)
        img = preprocess.preprocess_scan(xyz, ring, fcfg, 16)
        pipe.process_ring_image(img, ts)
    traj = pipe.trajectory()
    results["lio_distorted"] = {
        "ate_rmse_m": round(ate_rmse(traj[:, 1:4], np.asarray(gt_lio),
                                     align=False), 4),
        "initialized": pipe.is_initialized,
        "gravity": [round(float(x), 3) for x in np.asarray(pipe.gravity)],
        "elapsed_s": round(time.perf_counter() - t0, 1)}
    print("lio_distorted:", results["lio_distorted"], flush=True)

    import jax
    results["platform"] = jax.devices()[0].platform
    results["frames"] = n
    print(json.dumps(results))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
