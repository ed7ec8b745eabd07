"""Offline SLAM runner — the ``msf_loam_node`` CLI analog.

Replaces the reference's node main + rosbag replay loop
(``/root/reference/src/msf_loam_node.cc:412-482``): reads a KITTI-format
sequence directory (or a synthetic self-test world), pushes scans (and
optionally synthesized IMU) through the SlamPipeline, fuses 'GPS'
(ground-truth-derived fixes, the _SIM_GPS path, laser_mapping.cc:450-465)
in a final pose-graph solve, and writes the PLY map + trajectory artifacts.

Usage:
  python -m msf_loam_tpu.apps.run_slam --kitti_root DIR --sequence 00 \
      [--config FILE] [--max_frames N] [--sim_gps] [--output_dir DIR]
  python -m msf_loam_tpu.apps.run_slam --selftest  # synthetic world
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Optional

import numpy as np

logger = logging.getLogger("msf_loam_tpu")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kitti_root", help="KITTI odometry root (sequences/, poses/)")
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--bag", help="npz bag file (scan+imu+odom streams)")
    ap.add_argument("--online", action="store_true",
                    help="replay the bag on the wall clock and DROP scans "
                         "when processing falls behind (the reference's "
                         "real-time mode, laser_mapping.cc:159-165)")
    ap.add_argument("--online_speed", type=float, default=1.0)
    ap.add_argument("--listen",
                    help="consume a LIVE scan/IMU stream from another "
                         "process at this address ('host:port' or "
                         "'unix:/path'; dataio/stream.py protocol) with "
                         "backlog shedding — the live-topics online mode "
                         "(msf_loam_node.cc:464-477 analog). Producer: "
                         "scripts/stream_producer.py")
    ap.add_argument("--config", help="config JSON (native or reference proto-JSON)")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--n_rings", type=int, default=64)
    ap.add_argument("--sim_gps", action="store_true",
                    help="simulate 1 Hz GPS from GT + noise (_SIM_GPS)")
    ap.add_argument("--loop_closure", action="store_true",
                    help="detect revisits, scan-match loop edges, and fold "
                         "them into the final pose-graph solve")
    ap.add_argument("--loop_detector", choices=("proximity", "scan_context"),
                    default="proximity",
                    help="revisit detection: trajectory proximity, or "
                         "appearance (scan-context descriptors — drift-"
                         "proof, yaw seeded from the descriptor shift)")
    ap.add_argument("--loop_edge_matcher", choices=("scan", "submap"),
                    default="scan",
                    help="loop edge measurement: scan-to-scan, or scan-to-"
                         "submap (register against keyframe i's "
                         "neighborhood — tighter under viewpoint change)")
    ap.add_argument("--posegraph", action="store_true",
                    help="run the GPS/odometry pose-graph fusion at shutdown")
    ap.add_argument("--output_dir", default=".")
    ap.add_argument("--selftest", action="store_true",
                    help="run on a synthetic corridor world (no dataset)")
    ap.add_argument("--selftest_frames", type=int, default=12)
    ap.add_argument("--selftest_path", choices=("line", "loop"),
                    default="line",
                    help="selftest trajectory shape: 'loop' drives "
                         "out-and-back so --loop_closure has a revisit")
    ap.add_argument("--eval", action="store_true", help="print ATE vs GT")
    ap.add_argument("--save_map", action="store_true")
    ap.add_argument("--pbstream", action="store_true",
                    help="also write reference-format trajectory.pbstream")
    ap.add_argument("--profile_dir",
                    help="capture a jax.profiler trace into this directory")
    ap.add_argument("--viz_stream",
                    help="publish live state (trajectory + sampled map) "
                         "into this directory for apps/viz_stream's "
                         "polling HTML viewer (the rviz-topics analog)")
    ap.add_argument("--viz_period", type=int, default=20,
                    help="frames between --viz_stream publishes")
    ap.add_argument("--map_shards", type=int, default=0,
                    help="shard the voxel map over N devices "
                         "(config-5 distributed mapping; lidar-only)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def _make_pipeline(cfg, args):
    """SlamPipeline, or the sharded-map variant when --map_shards is set."""
    from msf_loam_tpu.slam.pipeline import SlamPipeline

    if args.map_shards and args.map_shards > 1:
        from msf_loam_tpu.parallel import mesh as mesh_mod
        from msf_loam_tpu.parallel.runtime import initialize
        from msf_loam_tpu.parallel.sharded_pipeline import ShardedSlamPipeline
        initialize()
        mesh = mesh_mod.make_mesh(n_map=args.map_shards, n_data=1)
        return ShardedSlamPipeline(cfg, mesh)
    return SlamPipeline(cfg)


def _close_loops(cfg, poses, data, traj, keyframes, logger,
                 detector="proximity", edge_matcher="scan"):
    """Detect revisits among the keyframe snapshots, scan-match each
    candidate pair into a loop edge, and solve the pose graph with the
    edges folded in (loop_closure module docstring has the design)."""
    import jax
    import jax.numpy as jnp

    from msf_loam_tpu.core.se3 import Pose, quat_exp
    from msf_loam_tpu.slam import posegraph
    from msf_loam_tpu.slam.loop_closure import (LoopEdge, SparsePoseGraph,
                                                detect_loops, match_loop_pair,
                                                match_loop_pair_submap)

    pg = cfg.posegraph
    kf_idx = sorted(keyframes)
    stride = max(1, pg.loop_keyframe_stride)
    gap_kf = max(1, pg.loop_min_index_gap // stride)
    guesses = {}
    if detector == "scan_context":
        from msf_loam_tpu.slam import scan_context as sc
        descs = np.stack([np.asarray(sc.compute_descriptor(
            jnp.asarray(keyframes[k].full.xyz),
            jnp.asarray(keyframes[k].full.mask))) for k in kf_idx])
        triples = sc.detect_loops_scan_context(
            descs, min_index_gap=gap_kf, max_dist=pg.loop_sc_max_dist,
            max_loops=pg.loop_max_count, suppress_gap=max(1, gap_kf // 2),
            # ring-key prescreen pays off once the full N^2 x S shifted
            # scoring dominates (KITTI-scale keyframe sets)
            prescreen=0 if len(kf_idx) < 100 else 25)
        pairs = [(a, b) for a, b, _ in triples]
        for a, b, yaw in triples:
            # appearance seed: same place, heading differs by the
            # descriptor's column shift (valid under arbitrary drift)
            guesses[(a, b)] = Pose(
                t=jnp.zeros(3),
                q=quat_exp(jnp.asarray([0.0, 0.0, yaw], jnp.float32)))
    else:
        pairs = detect_loops(
            traj[kf_idx, 1:4], max_dist=pg.loop_max_dist,
            min_index_gap=gap_kf, max_loops=pg.loop_max_count,
            suppress_gap=max(1, gap_kf // 2))

    graph = SparsePoseGraph(pad_loops=pg.loop_max_count)
    for a, b in pairs:
        fi, fj = kf_idx[a], kf_idx[b]
        pose_i = Pose(t=jnp.asarray(traj[fi, 1:4], jnp.float32),
                      q=jnp.asarray(traj[fi, 4:8], jnp.float32))
        pose_j = Pose(t=jnp.asarray(traj[fj, 1:4], jnp.float32),
                      q=jnp.asarray(traj[fj, 4:8], jnp.float32))
        if edge_matcher == "submap":
            guess = guesses.get((a, b))
            if guess is None:
                guess = pose_i.inverse().compose(pose_j)
            neighbors = []
            for fn_ in (fi - stride, fi, fi + stride):
                if fn_ in keyframes:
                    pose_n = Pose(t=jnp.asarray(traj[fn_, 1:4], jnp.float32),
                                  q=jnp.asarray(traj[fn_, 4:8], jnp.float32))
                    neighbors.append((jax.device_put(keyframes[fn_]),
                                      pose_i.inverse().compose(pose_n)))
            rel, ok = match_loop_pair_submap(
                neighbors, jax.device_put(keyframes[fj]), guess, cfg)
        else:
            rel, ok = match_loop_pair(
                jax.device_put(keyframes[fi]), jax.device_put(keyframes[fj]),
                pose_i, pose_j, cfg, guess=guesses.get((a, b)))
        if bool(ok):
            graph.add_edge(LoopEdge(fi, fj, np.asarray(rel.t),
                                    np.asarray(rel.q)))
            logger.info("loop edge %d <-> %d", fi, fj)
        else:
            logger.info("loop candidate %d <-> %d rejected by matcher",
                        fi, fj)
    out = graph.optimize(poses, data, pg, n_iters=pg.iterations)
    return out, len(graph.edges)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.WARNING if args.quiet else logging.INFO,
        format="%(levelname).1s %(asctime)s %(name)s] %(message)s")

    import jax.numpy as jnp

    from msf_loam_tpu.core.cache import enable_compilation_cache
    enable_compilation_cache()

    from msf_loam_tpu.config import MsfLoamConfig
    from msf_loam_tpu.dataio import artifacts, preprocess
    from msf_loam_tpu.slam.pipeline import SlamPipeline, ate_rmse

    if args.config:
        cfg = MsfLoamConfig.from_json(args.config)
    else:
        cfg = MsfLoamConfig()

    t_start = time.perf_counter()
    gt_t = []
    gps_times, gps_xyz = [], []
    rng = np.random.default_rng(0)

    keyframes = {}  # frame index -> host-side ScanFeatures snapshot

    viz = None
    if args.viz_stream:
        from msf_loam_tpu.apps.viz_stream import VizStreamWriter
        viz = VizStreamWriter(args.viz_stream, period=args.viz_period)

    def maybe_keyframe(pipe):
        """Per-frame host hooks: loop-closure keyframe snapshots every
        loop_keyframe_stride frames, live-viz publish every viz_period."""
        if viz is not None:
            viz.add_frame(pipe)
        if not args.loop_closure or pipe.prev_scan is None:
            return
        idx = len(pipe.results) - 1
        if idx % cfg.posegraph.loop_keyframe_stride == 0:
            import jax
            keyframes[idx] = jax.device_get(pipe.prev_scan)

    profiler_ctx = None
    if args.profile_dir:
        # device-level tracing (TicToc/LOG_STEP_TIME analog at kernel depth;
        # SURVEY.md §5 tracing plank) — view with tensorboard or perfetto
        import jax
        profiler_ctx = jax.profiler.trace(args.profile_dir)
        profiler_ctx.__enter__()

    if args.selftest:
        from msf_loam_tpu.dataio import synthetic
        n_rings = 16
        fcfg = dataclasses.replace(cfg.features, max_points_per_ring=2048)
        cfg = dataclasses.replace(cfg, features=fcfg)
        pipe = _make_pipeline(cfg, args)
        world = synthetic.World.corridor(seed=0, size=12.0)
        n = args.selftest_frames
        for i in range(n):
            if args.selftest_path == "loop":
                # out-and-back (no turn): the tail revisits the head
                fwd = i if i < n // 2 else (n - 1 - i)
                t = np.array([0.25 * fwd, 0.0, 0.0])
                yaw = 0.0
            else:
                t = np.array([0.25 * i, 0.1 * np.sin(0.2 * i), 0.0])
                yaw = 0.02 * i
            c, s = np.cos(yaw), np.sin(yaw)
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
            xyz, ring = synthetic.simulate_scan(world, t, R, n_rings=n_rings,
                                                pts_per_ring=1800,
                                                noise=0.004, seed=i)
            img = preprocess.preprocess_scan(xyz, ring, cfg.features, n_rings)
            res = pipe.process_ring_image(img, 0.1 * i)
            maybe_keyframe(pipe)
            gt_t.append(t)
            if args.sim_gps and i % cfg.posegraph.sim_gps_period == 0:
                gps_times.append(0.1 * i)
                gps_xyz.append(t + rng.uniform(-cfg.posegraph.sim_gps_noise,
                                               cfg.posegraph.sim_gps_noise, 3))
            logger.info("frame %d: t=%s ok=%s", i,
                        np.round(np.asarray(res.map_pose.t), 3), res.ok)
    elif args.bag or args.listen:
        # bag replay (the reference's offline rosbag loop,
        # msf_loam_node.cc:448-459) or live stream ingest (--listen: the
        # live-topics mode, msf_loam_node.cc:464-477) — same message loop,
        # same shedding policy
        from msf_loam_tpu.dataio.npz_bag import Bag, ImuMsg, OdomMsg, ScanMsg
        bag_path = args.bag
        is_rosbag = False
        if bag_path:
            with open(bag_path, "rb") as _f:
                is_rosbag = _f.read(13) == b"#ROSBAG V2.0\n"
        if is_rosbag:
            # real ROS1 bag: convert via the pure-Python reader
            # (dataio/rosbag.py), cached next to the outputs
            from msf_loam_tpu.dataio.rosbag import bag_to_npz
            os.makedirs(args.output_dir, exist_ok=True)
            conv = os.path.join(
                args.output_dir,
                os.path.splitext(os.path.basename(bag_path))[0]
                + ".converted.npz")
            if not os.path.exists(conv):
                counts = bag_to_npz(bag_path, conv)
                logger.info("converted ROS bag %s -> %s (%s)", bag_path,
                            conv, counts)
            bag_path = conv
        pipe = _make_pipeline(cfg, args)
        counter = 0
        n_scans = 0
        n_dropped = 0
        gt_stamped = []
        busy_holder = [0.0]
        server = None
        if args.listen:
            from msf_loam_tpu.dataio.stream import StreamServer
            server = StreamServer(args.listen)
            logger.info("listening for scan/IMU stream on %s",
                        server.address)
            messages = server.messages
        else:
            bag = Bag(bag_path)
            if args.online:
                # online mode: wall-clock replay with backlog shedding
                stream = bag.replay_realtime(
                    speed=args.online_speed,
                    busy_until=lambda: busy_holder[0])

                def messages():
                    for msg, dropped in stream:
                        yield msg, dropped
            else:
                def messages():
                    for msg in bag.replay():
                        yield msg, False
        def do_scan(msg):
            nonlocal n_scans
            if args.max_frames and n_scans >= args.max_frames:
                return
            t_proc0 = time.perf_counter()
            img = preprocess.preprocess_scan(
                msg.xyz, msg.ring, cfg.features, args.n_rings)
            res = pipe.process_ring_image(img, msg.time)
            maybe_keyframe(pipe)
            if args.online:
                busy_holder[0] = time.perf_counter() + \
                    0.5 * (time.perf_counter() - t_proc0)
            n_scans += 1
            logger.info("scan @%.2f: t=%s", msg.time,
                        np.round(np.asarray(res.map_pose.t), 2))

        # IMU/scan sync (the reference's buffer handoff,
        # msf_loam_node.cc:380-410): a scan's deskew window spans
        # [t, t+scan_period], so with an active IMU stream each scan is
        # HELD until IMU coverage through its window end has arrived —
        # messages replay in timestamp order, so processing a scan the
        # moment it appears would always find an empty window.
        pending_scans = []
        last_scan_t = [-np.inf]

        def flush_scans(force=False):
            while pending_scans:
                deadline = pending_scans[0].time + cfg.features.scan_period
                if not force and len(pipe.imu_buffer) and \
                        pipe.imu_buffer.times[-1] < deadline:
                    break
                do_scan(pending_scans.pop(0))

        for msg, dropped in messages():
            if isinstance(msg, ImuMsg):
                pipe.add_imu(msg.time, msg.acc, msg.gyr)
                flush_scans()
            elif isinstance(msg, OdomMsg):
                gt_stamped.append((msg.time, msg.t))
                counter += 1
                if args.sim_gps and counter % cfg.posegraph.sim_gps_period == 0:
                    gps_times.append(msg.time)
                    gps_xyz.append(msg.t + rng.uniform(
                        -cfg.posegraph.sim_gps_noise,
                        cfg.posegraph.sim_gps_noise, 3))
            elif isinstance(msg, ScanMsg):
                if dropped:
                    n_dropped += 1
                    logger.warning("[MAP] drop lidar frame @%.2f for real "
                                   "time performance", msg.time)
                    continue
                if msg.time <= last_scan_t[0]:
                    # out-of-order arrival (network reordering on --listen;
                    # an unsorted bag heals at npz conversion, but a live
                    # stream cannot be re-sorted): a backward time step
                    # would corrupt the IMU window slicing, so drop it
                    n_dropped += 1
                    logger.warning("[MAP] drop out-of-order lidar frame "
                                   "@%.2f (<= %.2f)", msg.time,
                                   last_scan_t[0])
                    continue
                last_scan_t[0] = msg.time
                if args.max_frames and n_scans >= args.max_frames:
                    continue
                if len(pipe.imu_buffer):
                    pending_scans.append(msg)
                    flush_scans()
                else:
                    do_scan(msg)           # lidar-only bag: no sync needed
        flush_scans(force=True)
        if server is not None:
            server.close()
        # align gt with the scans actually PROCESSED (nearest timestamp):
        # under online/stream shedding the prefix pairing is wrong — a
        # dropped scan must drop its gt row too
        if gt_stamped and pipe.results:
            g_times = np.asarray([g[0] for g in gt_stamped])
            g_pos = np.asarray([g[1] for g in gt_stamped])
            for r in pipe.results:
                gt_t.append(g_pos[int(np.argmin(np.abs(g_times - r.time)))])
    else:
        if not args.kitti_root:
            print("error: --kitti_root, --bag or --selftest required",
                  file=sys.stderr)
            return 2
        from msf_loam_tpu.dataio.kitti import KittiSequence
        seq = KittiSequence(args.kitti_root, args.sequence,
                            n_rings=args.n_rings)
        pipe = _make_pipeline(cfg, args)
        end = args.max_frames or len(seq)
        counter = 0
        # native C++ prefetcher feeds preprocessed ring images when built
        for index, t_scan, img in seq.ring_images(
                cfg.features.max_points_per_ring, cfg.features.min_range,
                cfg.features.scan_period, end=end):
            res = pipe.process_ring_image(img, t_scan)
            maybe_keyframe(pipe)
            if seq.gt_poses is not None:
                gt_pose = seq.gt_poses[index]
                gt_t.append(gt_pose[:3, 3])
                counter += 1
                if args.sim_gps and counter % cfg.posegraph.sim_gps_period == 0:
                    gps_times.append(t_scan)
                    gps_xyz.append(gt_pose[:3, 3] + rng.uniform(
                        -cfg.posegraph.sim_gps_noise,
                        cfg.posegraph.sim_gps_noise, 3))
            logger.info("frame %d: t=%s corr=%d", index,
                        np.round(np.asarray(res.map_pose.t), 2),
                        int(res.n_correspondences))

    if profiler_ctx is not None:
        profiler_ctx.__exit__(None, None, None)

    if viz is not None:
        viz.publish(pipe, done=True)

    traj = pipe.trajectory()
    elapsed = time.perf_counter() - t_start
    n_frames = len(traj)
    summary = {
        "frames": n_frames,
        "elapsed_s": round(elapsed, 2),
        "scans_per_sec": round(n_frames / elapsed, 2),
    }
    if (args.bag and args.online) or args.listen:
        summary["dropped_scans"] = n_dropped

    # shutdown-time pose-graph fusion (~LaserMapping dtor, laser_mapping.cc:92)
    run_pg = args.posegraph and len(gps_times) >= 2
    run_lc = args.loop_closure and len(keyframes) >= 2
    if run_pg or run_lc:
        from msf_loam_tpu.core.se3 import Pose
        from msf_loam_tpu.slam import posegraph
        poses = Pose(t=jnp.asarray(traj[:, 1:4], dtype=jnp.float32),
                     q=jnp.asarray(traj[:, 4:8], dtype=jnp.float32))
        if run_pg:
            g_times = jnp.asarray(np.asarray(gps_times), dtype=jnp.float32)
            g_xyz = jnp.asarray(np.asarray(gps_xyz), dtype=jnp.float32)
            g_valid = jnp.ones(len(gps_times), bool)
        else:  # placeholder row; invalid, so inert
            g_times = jnp.zeros(1, jnp.float32)
            g_xyz = jnp.zeros((1, 3), jnp.float32)
            g_valid = jnp.zeros(1, bool)
        data = posegraph.build_graph_data(
            jnp.asarray(traj[:, 0], dtype=jnp.float32), poses,
            g_times, g_xyz, g_valid)
        # pad to a size class so repeated runs reuse the compiled program
        n_real = len(traj)
        poses, data = posegraph.pad_graph(
            poses, data, posegraph.next_bucket(n_real))
        if run_lc:
            out, n_edges = _close_loops(cfg, poses, data, traj, keyframes,
                                        logger, detector=args.loop_detector,
                                        edge_matcher=args.loop_edge_matcher)
            summary["loop_edges"] = n_edges
        else:
            out = posegraph.optimize(poses, data, cfg.posegraph,
                                     n_iters=cfg.posegraph.iterations)
        traj[:, 1:4] = np.asarray(out.poses.t[:n_real])
        traj[:, 4:8] = np.asarray(out.poses.q[:n_real])
        summary["posegraph_cost"] = [float(out.initial_cost),
                                     float(out.final_cost)]

    os.makedirs(args.output_dir, exist_ok=True)
    artifacts.save_trajectory(
        os.path.join(args.output_dir, cfg.runtime.trajectory_output),
        traj[:, 0], traj[:, 1:4], traj[:, 4:8])
    if args.pbstream:
        # reference-wire-format record (trajectory.pbstream analog)
        from msf_loam_tpu import proto as pbcodec
        if pbcodec.available():
            imu_rec = None
            if len(pipe.imu_buffer):
                imu_rec = {
                    "times": pipe.imu_buffer.times,
                    "angular_velocity": pipe.imu_buffer._gyr[:len(pipe.imu_buffer)],
                    "linear_acceleration": pipe.imu_buffer._acc[:len(pipe.imu_buffer)],
                }
            pbcodec.write_pbstream(
                os.path.join(args.output_dir, "trajectory.pbstream"),
                traj[:, 0], traj[:, 1:4], traj[:, 4:8], imu_rec)
            summary["pbstream"] = True

    if args.save_map:
        stored = np.asarray(pipe.surf_map.points).reshape(-1, 3)
        occ = (np.arange(pipe.surf_map.slab_capacity)[None, :]
               < np.asarray(pipe.surf_map.count)[:, None]).reshape(-1)
        cloud = stored[occ]
        if pipe.is_initialized:
            cloud = artifacts.gravity_align(cloud, np.asarray(pipe.gravity))
        artifacts.save_ply(os.path.join(args.output_dir,
                                        cfg.runtime.map_output), cloud)
        summary["map_points"] = int(occ.sum())

    if args.eval and gt_t:
        gt = np.asarray(gt_t)
        gt_rel = gt - gt[0]
        summary["ate_rmse_m"] = round(ate_rmse(traj[:, 1:4], gt_rel), 4)
        summary["ate_rmse_aligned_m"] = round(
            ate_rmse(traj[:, 1:4], gt_rel, align=True), 4)

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
