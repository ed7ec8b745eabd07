"""Smoke run of the SLAM frame path on one GPU: does the shipping code start,
compile and give the right answer on the card?

    python chip_smoke.py             # phases 1-5 on one GPU
    python chip_smoke.py --four      # only the sharded-map path on 4 GPUs
    python chip_smoke.py --trace DIR # phases 1-5, plus a profiler trace of
                                     # a steady window of each phase and
                                     # its device time per frame stage

Phases (one card):
  1. device   — the JAX backend must be a GPU; prints the card's name and
                power limit (nvidia-smi). No CPU fallback.
  2. lidar64  — ``SlamPipeline`` (what ``run_slam`` builds) over 40
                distinct 64-ring x 1800-point (HDL-64 class) scans along
                the bench drive, bench-scale tables. Checks finite poses,
                ATE against the synthetic ground truth, and the first 10
                frames against the same frames run on the CPU device.
  3. lio64    — the same drive, motion-distorted, with a 400 Hz IMU
                through the tightly coupled LIO path (``lio_frame_core``),
                with the same checks.
  4. batched  — ``batch_pipeline.run_batch`` with B=8 lanes at 16 rings;
                every lane must match the single-stream pipeline.
  5. numbers  — compile seconds, steady frames/s and peak device memory of
                each phase, printed beside the card's name and power
                limit. They are smoke timings, not the benchmark.

All data is generated from ``--seed``; no dataset is read. Any failed
check raises, the script exits non-zero and prints no result line. The
last line of a passing run is exactly
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# The bench drive (bench.py: 1.5 m/s, 0.2 rad/s yaw, 10 Hz) in closed form
# so that a consistent IMU stream can be derived from it.
SPEED, YAW_RATE, FRAME_DT, IMU_HZ = 1.5, 0.2, 0.1, 400.0
GRAVITY = np.array([0.0, 0.0, 9.81])

N_FRAMES = 40        # distinct frames per 64-ring phase
N_CPU_FRAMES = 10    # frames re-run on the CPU device for comparison
ATE_LIDAR = 0.05     # m; the CPU golden bound (tests/test_pipeline.py)
ATE_LIO = 0.12       # m; the distorted-scan LIO bound (test_lio_pipeline.py)
# GPU vs CPU, frame by frame: both run the same f32 program with f32
# matmuls (core.precision), but reductions sum in another order and a
# point that lands within float rounding of a voxel-leaf or cell boundary
# can go either way, which moves a pose by a fraction of a millimetre and
# compounds over frames. 1 cm / 0.05 deg bounds ten frames of that; TF32
# matmuls (~3 digits) or a wrong kernel exceed it.
TOL_CPU_T, TOL_CPU_DEG = 0.01, 0.05
BATCH_LANES, BATCH_FRAMES, BATCH_RINGS = 8, 20, 16
TOL_BATCH = 0.02     # m; tests/test_batch_pipeline.py batch vs single
TOL_SHARDED = 5e-3   # m; tests/test_parallel.py sharded vs dense
FOUR_FRAMES = 20     # frames of the sharded-vs-dense comparison


def drive_pose(t):
    """(position, rotation, world velocity) of the bench drive at time t."""
    yaw = YAW_RATE * t
    c, s = np.cos(yaw), np.sin(yaw)
    p = SPEED / YAW_RATE * np.array([s, 1.0 - c, 0.0])
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return p, R, SPEED * np.array([c, s, 0.0])


def imu_sample(t):
    """Body-frame specific force and rate of the drive (circular arc)."""
    _, R, _ = drive_pose(t)
    yaw = YAW_RATE * t
    a_world = SPEED * YAW_RATE * np.array([-np.sin(yaw), np.cos(yaw), 0.0])
    return R.T @ (a_world + GRAVITY), np.array([0.0, 0.0, YAW_RATE])


def make_images(cfg, n_frames, n_rings, seed, distort=False, world_seed=0):
    """Ring images of the drive at 10 Hz (1800 points per ring)."""
    from msf_loam_tpu.dataio import preprocess, synthetic

    world = synthetic.World.corridor(seed=world_seed, size=14.0)
    imgs = []
    for i in range(n_frames):
        p, R, v = drive_pose(i * FRAME_DT)
        kw = dict(linear_vel=v, yaw_rate=YAW_RATE) if distort else {}
        xyz, ring = synthetic.simulate_scan(
            world, p, R, n_rings=n_rings, pts_per_ring=1800, noise=0.004,
            seed=seed + i, **kw)
        imgs.append(preprocess.preprocess_scan(xyz, ring, cfg.features,
                                               num_rings=n_rings))
    return imgs


def lidar_config(n_rings):
    """bench.py's single-stream configuration at this ring count."""
    from msf_loam_tpu.config import FeatureConfig, MappingConfig, MsfLoamConfig

    return MsfLoamConfig(
        features=FeatureConfig(max_points_per_ring=2048, max_less_flat=8192),
        mapping=MappingConfig(map_table_size=1 << 15, map_cell_capacity=32,
                              max_query_points=4096,
                              max_corner_query_points=1024 if n_rings <= 32
                              else 2048))


def lio_config():
    import dataclasses

    from msf_loam_tpu.config import ImuConfig

    # init after 6 frames (as tests/test_lio_pipeline.py) so that most of
    # the drive, and frames 6-9 of the CPU comparison, run lio_frame_core
    return dataclasses.replace(lidar_config(64), imu=ImuConfig(
        tight_coupling=True, init_frames=6))


def feed_imu(pipe, t_end):
    t = -0.5                     # warm-up before the first scan
    while t < t_end:
        acc, gyr = imu_sample(t)
        pipe.add_imu(t, acc, gyr)
        t += 1.0 / IMU_HZ


def run_pipeline(pipe, imgs, stats=None, trace_window=None):
    """Frame-by-frame through the pipeline; returns (N, 8) trajectory.

    ``stats`` collects per-frame wall seconds (each frame ends in a host
    read of its outputs, so it includes the device time)."""
    import jax

    if trace_window is not None:
        first, trace_dir = trace_window
        last = min(first + TRACE_FRAMES, len(imgs)) - 1
    for i, img in enumerate(imgs):
        t0 = time.perf_counter()
        if trace_window is not None and i == first:
            jax.profiler.start_trace(trace_dir)
        pipe.process_ring_image(img, i * FRAME_DT)
        jax.block_until_ready(pipe.pose_map)
        if trace_window is not None and i == last:
            jax.profiler.stop_trace()
        if stats is not None:
            stats.append(time.perf_counter() - t0)
    return pipe.trajectory()


def quat_angle_deg(qa, qb):
    dot = np.abs(np.sum(qa * qb, axis=-1) /
                 (np.linalg.norm(qa, axis=-1) * np.linalg.norm(qb, axis=-1)))
    return np.degrees(2.0 * np.arccos(np.clip(dot, 0.0, 1.0)))


def check_trajectory(name, traj, gt, ate_bound):
    from msf_loam_tpu.slam.pipeline import ate_rmse

    if not np.isfinite(traj).all():
        raise AssertionError(f"{name}: non-finite poses")
    ate = ate_rmse(traj[:, 1:4], gt, align=False)
    print(f"[{name}] ATE {ate:.4f} m over {len(traj)} frames "
          f"(bound {ate_bound} m)")
    if not ate < ate_bound:
        raise AssertionError(f"{name}: ATE {ate:.4f} m >= {ate_bound} m")
    return ate


def check_against_cpu(name, traj_dev, traj_cpu):
    dt = np.linalg.norm(traj_dev[:, 1:4] - traj_cpu[:, 1:4], axis=1)
    dr = quat_angle_deg(traj_dev[:, 4:8], traj_cpu[:, 4:8])
    print(f"[{name}] vs CPU over {len(dt)} frames: max |dt| {dt.max():.2e} m,"
          f" max rot {dr.max():.2e} deg (bounds {TOL_CPU_T} m, "
          f"{TOL_CPU_DEG} deg)")
    if not (dt.max() <= TOL_CPU_T and dr.max() <= TOL_CPU_DEG):
        raise AssertionError(f"{name}: GPU and CPU runs differ "
                             f"(per frame dt {dt}, rot {dr})")


def timing_line(name, card, compile_s, fps, unit="frames/s"):
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    print(f"[{name}] smoke timing (not the benchmark): first call incl. "
          f"compile {compile_s:.1f} s, steady {fps:.1f} {unit}, "
          f"peak_bytes_in_use {peak} (process so far); card {card}")


def steady_fps(frame_s):
    """Frames/s from the median per-frame time after the first two frames
    (frame 0 compiles; occasional later compiles, e.g. the first eviction,
    stay out of the median)."""
    return 1.0 / float(np.median(frame_s[2:]))


def phase_single_stream(name, card, args, trace):
    """lidar64 or lio64: one SlamPipeline over the drive, then the first
    frames again on the CPU device."""
    import jax

    from msf_loam_tpu.slam.pipeline import SlamPipeline

    lio = name == "lio64"
    cfg = lio_config() if lio else lidar_config(64)
    imgs = make_images(cfg, N_FRAMES, 64, args.seed + (1000 if lio else 0),
                       distort=lio)
    gt = np.stack([drive_pose(i * FRAME_DT)[0] for i in range(N_FRAMES)])

    def pipeline():
        pipe = SlamPipeline(cfg)
        if lio:
            feed_imu(pipe, N_FRAMES * FRAME_DT + 0.2)
        return pipe

    frame_s = []
    pipe = pipeline()
    traj = run_pipeline(pipe, imgs, frame_s, trace_window=trace(name))
    if lio and not pipe.is_initialized:
        raise AssertionError("lio64: the estimator never initialized")
    check_trajectory(name, traj, gt, ATE_LIO if lio else ATE_LIDAR)
    if not args.trace:
        with jax.default_device(jax.devices("cpu")[0]):
            traj_cpu = run_pipeline(pipeline(), imgs[:N_CPU_FRAMES])
        check_against_cpu(name, traj[:N_CPU_FRAMES], traj_cpu)
    timing_line(name, card, frame_s[0], steady_fps(frame_s))


def phase_batched(card, args, trace):
    import jax

    from msf_loam_tpu.config import FeatureConfig, MappingConfig, MsfLoamConfig
    from msf_loam_tpu.core.pointcloud import RingImage
    from msf_loam_tpu.slam import batch_pipeline
    from msf_loam_tpu.slam.pipeline import SlamPipeline

    B, T, R = BATCH_LANES, BATCH_FRAMES, BATCH_RINGS
    # bench.py's batched configuration: the fused table is B * H = 32768
    cfg = MsfLoamConfig(
        features=FeatureConfig(max_points_per_ring=2048, max_less_flat=8192),
        mapping=MappingConfig(map_table_size=(1 << 15) // B,
                              map_cell_capacity=32, max_query_points=4096,
                              max_corner_query_points=1024,
                              map_evict_period=0))
    lanes = [make_images(cfg, T, R, args.seed + 2000 + 100 * b, world_seed=b)
             for b in range(B)]
    stack = lambda f: np.stack([np.stack([f(lanes[b][t]) for b in range(B)])
                                for t in range(T)])
    ring_images = RingImage(xyz=stack(lambda im: im.xyz),
                            rel_time=stack(lambda im: im.rel_time),
                            mask=stack(lambda im: im.mask))
    ring_images = jax.device_put(ring_images)

    t0 = time.perf_counter()
    state = batch_pipeline.init_batch_state(cfg, B, n_rings=R)
    _, poses = batch_pipeline.run_batch(cfg, state, ring_images)
    poses = jax.device_get(poses)
    compile_s = time.perf_counter() - t0
    window = trace("batched")
    if window is not None:
        jax.profiler.start_trace(window[1])
    t0 = time.perf_counter()
    state2 = batch_pipeline.init_batch_state(cfg, B, n_rings=R)
    _, poses2 = batch_pipeline.run_batch(cfg, state2, ring_images)
    jax.block_until_ready(poses2)
    steady_s = time.perf_counter() - t0
    if window is not None:
        jax.profiler.stop_trace()

    est = np.asarray(poses.t)                           # (T, B, 3)
    if not (np.isfinite(est).all() and np.isfinite(np.asarray(poses.q)).all()):
        raise AssertionError("batched: non-finite poses")
    worst = 0.0
    for b in range(B):
        single = run_pipeline(SlamPipeline(cfg), lanes[b])
        err = np.abs(est[:, b] - single[:, 1:4]).max()
        worst = max(worst, float(err))
        if not err <= TOL_BATCH:
            raise AssertionError(f"batched: lane {b} differs from single-"
                                 f"stream by {err:.4f} m > {TOL_BATCH} m")
    print(f"[batched] B={B} x {T} frames at {R} rings: worst lane vs "
          f"single-stream {worst:.2e} m (bound {TOL_BATCH} m)")
    timing_line("batched", card, compile_s, B * T / steady_s,
                unit="scans/s over all lanes")


def phase_four(card, args):
    """The sharded-map pipeline on four cards against the single-device
    pipeline, over the same 64-ring frames; then one sharded LIO frame
    against the dense LIO frame from the same state."""
    import jax
    import jax.numpy as jnp

    from msf_loam_tpu.parallel import mesh as mesh_mod
    from msf_loam_tpu.parallel.sharded_pipeline import (ShardedSlamPipeline,
                                                        sharded_lio_frame)
    from msf_loam_tpu.slam.pipeline import SlamPipeline, fused_lio_frame

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 GPUs; JAX sees {len(jax.devices())}")
    import dataclasses

    # the sharded map answers every association round with a fresh
    # (exact, all-gathered) query; give the dense pipeline the same
    # per-round queries instead of its once-per-frame candidate cache so
    # the two run the same matcher
    cfg = lidar_config(64)
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, reuse_candidates=False))
    n = FOUR_FRAMES
    imgs = make_images(cfg, n + 1, 64, args.seed)
    mesh = mesh_mod.make_mesh(n_map=4, n_data=1)
    sharded, dense = ShardedSlamPipeline(cfg, mesh), SlamPipeline(cfg)
    frame_s = []
    traj_s = run_pipeline(sharded, imgs[:n], frame_s)
    traj_d = run_pipeline(dense, imgs[:n])
    gt = np.stack([drive_pose(i * FRAME_DT)[0] for i in range(n)])
    check_trajectory("four", traj_s, gt, ATE_LIDAR)
    per_frame = np.abs(traj_s[:, 1:4] - traj_d[:, 1:4]).max(axis=1)
    diff = per_frame.max()
    print(f"[four] sharded ({len(mesh.devices.flat)} devices) vs dense over "
          f"{n} frames: max |dt| {diff:.2e} m (bound {TOL_SHARDED} m)")
    if not diff <= TOL_SHARDED:
        raise AssertionError(f"four: sharded differs from dense, per frame "
                             f"{per_frame}")

    # one tightly coupled LIO frame (frame n) from each pipeline's state
    ic = cfg.imu
    t_prev, t_scan = (n - 1) * FRAME_DT, n * FRAME_DT
    imu = [(t, *imu_sample(t))
           for t in np.arange(t_prev - 0.05, t_scan + 0.15, 1.0 / IMU_HZ)]

    def window(start, end):
        from msf_loam_tpu.imu.buffer import ImuBuffer

        buf = ImuBuffer()
        for t, a, g in imu:
            buf.add(t, a, g)
        w = buf.window(start, end, ic.max_imu_samples, ic.max_lidar_imu_offset)
        return [jnp.asarray(x) for x in (w.dts, w.accs, w.gyrs, w.valid)]

    wp = window(t_prev, t_scan)
    ws = window(t_scan, t_scan + FRAME_DT)
    v_prev = jnp.asarray(drive_pose(t_prev)[2], jnp.float32)
    g = jnp.asarray(GRAVITY, jnp.float32)

    def lio_args(pipe):
        return (pipe.prev_scan, imgs[n], jnp.float32(t_scan),
                pipe.pose_curr2last, pipe.pose_odom, pipe.pose_odom2map,
                jnp.bool_(False), *wp, *ws, pipe.pose_map.t, pipe.pose_map.q,
                v_prev, g)

    out_s = sharded_lio_frame(mesh, cfg, sharded.corner_map, sharded.surf_map,
                              *lio_args(sharded))
    out_d = fused_lio_frame(cfg, dense.corner_map, dense.surf_map,
                            *lio_args(dense))
    ps, pd = np.asarray(out_s[5].t), np.asarray(out_d[5].t)
    if not (np.isfinite(ps).all() and np.isfinite(pd).all()):
        raise AssertionError("four: non-finite LIO frame")
    dl = float(np.abs(ps - pd).max())
    print(f"[four] sharded LIO frame vs dense: |dt| {dl:.2e} m "
          f"(bound {TOL_SHARDED} m)")
    if not dl <= TOL_SHARDED:
        raise AssertionError(f"four: sharded LIO frame differs by {dl}")
    timing_line("four", card, frame_s[0], steady_fps(frame_s))


# ---- profiler trace -> device time per frame stage ----------------------
TRACE_FRAMES = 5     # frames in each traced single-stream window
# the jitted programs a frame dispatches (XLA dumps only these modules)
TRACED_PROGRAMS = ("jit_(fused|run_batch|match|insert|extract|downsample"
                   "|preintegrate|evict|undistort|solve).*")
# (substring of an op's name-scope path, stage), first match wins; the
# scopes are set in ops/features.py, slam/odometry.py, ops/gauss_newton.py,
# slam/mapping.py, slam/batch_pipeline.py and slam/voxel_map.py
STAGES = (("pick_rounds", "extract: pick rounds"),
          ("extract_features", "extract: other"),
          ("odo_correspondences", "odometry: correspondences"),
          ("match_scan2scan", "odometry: GN"),
          ("downsample_features", "downsample"),
          ("map_gather", "map: octant gather"),
          ("select_fit", "map: select/fit"),
          ("gauss_newton", "map: GN"),
          ("map_insert", "map: insert"),
          ("evict", "map: evict"),
          ("preintegrat", "imu: preintegration"),
          ("imu", "imu: other"))


def hlo_op_names(hlo_dir):
    """{(module id or name, instruction): op_name scope path} from the
    optimized HLO that XLA dumped (--xla_dump_to, as text)."""
    import glob
    import re

    inst = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
    names = {}
    for path in glob.glob(os.path.join(hlo_dir, "*after_optimizations.txt")):
        base = os.path.basename(path)
        mid = re.match(r"module_(\d+)\.", base)
        mname = base.split(".")[1] if base.count(".") > 1 else None
        with open(path) as f:
            for line in f:
                m = inst.match(line)
                if m:
                    for key in (mid and int(mid.group(1)), mname):
                        if key is not None:
                            names.setdefault((key, m.group(1)), m.group(2))
    return names


def stage_of(scope_path):
    for key, stage in STAGES:
        if key in scope_path:
            return stage
    return "other"


def device_events(trace_dir):
    """(hlo_op, module keys, start_ns, duration_ns) of every op the device
    ran in the newest trace under ``trace_dir``. Prefers the per-op line
    ("XLA Ops") of a device plane; falls back to all of its lines. A CPU
    backend has no device plane: there, the host events that carry an
    ``hlo_op`` are the ops."""
    import glob

    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise AssertionError(f"no trace under {trace_dir}")
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    planes = list(pd.planes)
    on_device = any(p.name.startswith("/device:") for p in planes)
    out = []
    for plane in planes:
        if on_device and not plane.name.startswith("/device:"):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or lines
        for ln in ops:
            for ev in ln.events:
                st = dict(ev.stats)
                if not on_device and "hlo_op" not in st:
                    continue
                op = str(st.get("hlo_op", ev.name))
                keys = [k for k in (st.get("program_id"), st.get("hlo_module"))
                        if k is not None]
                keys = [int(k) if str(k).isdigit() else str(k) for k in keys]
                out.append((op, keys, ev.start_ns, ev.duration_ns))
    return out


def stage_times(trace_dir, hlo_dir, n_frames):
    """Device ms per frame by stage, the device's busy and idle share over
    the traced span, and the top ops."""
    names = hlo_op_names(hlo_dir)
    evs = device_events(trace_dir)
    if not evs:
        raise AssertionError(f"{trace_dir}: no device ops in the trace")
    per_stage, per_op = {}, {}
    for op, keys, _, dur in evs:
        path = next((names[(k, op)] for k in keys if (k, op) in names), op)
        st = stage_of(path)
        per_stage[st] = per_stage.get(st, 0.0) + dur
        per_op[(st, op)] = per_op.get((st, op), 0.0) + dur
    iv = sorted((s, s + d) for _, _, s, d in evs)
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = iv[-1][1] - iv[0][0]
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:12]
    return {"frames": n_frames,
            "device_busy_ms_per_frame": busy / 1e6 / n_frames,
            "idle_share_of_span": 1.0 - busy / span if span else None,
            "stage_ms_per_frame": {k: v / 1e6 / n_frames for k, v in
                                   sorted(per_stage.items(),
                                          key=lambda kv: -kv[1])},
            "top_ops_ms_per_frame": [[st, op, v / 1e6 / n_frames]
                                     for (st, op), v in top]}


def print_stage_times(phase, st, card):
    print(f"[{phase}] device trace, {st['frames']} frames: busy "
          f"{st['device_busy_ms_per_frame']:.3f} ms/frame, idle share of "
          f"span {st['idle_share_of_span']:.3f}; card {card}")
    for stage, ms in st["stage_ms_per_frame"].items():
        print(f"[{phase}]   {stage:28s} {ms:8.3f} ms/frame")


def card_name_and_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    if not out:
        raise SystemExit("nvidia-smi reported no card")
    return out


def result_line(devices):
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded-map path on 4 GPUs")
    ap.add_argument("--trace", metavar="DIR",
                    help="also trace a steady window of each phase and "
                         "print its device time per frame stage")
    args = ap.parse_args(argv)
    if args.trace:
        # optimized HLO (with each op's name scope) to attribute kernels,
        # and no CUDA-graph command buffers: inside one, the trace shows a
        # single event for many ops
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") +
            f" --xla_dump_to={args.trace}/hlo --xla_dump_hlo_as_text"
            " --xla_dump_hlo_module_re=" + TRACED_PROGRAMS +
            " --xla_gpu_enable_command_buffer=").strip()

    import msf_loam_tpu  # noqa: F401  (fails outside a checkout)
    import jax

    # phase 1: a GPU, or nothing
    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is "
                         f"{jax.default_backend()!r}, not 'gpu'")
    devices = jax.devices()
    card = card_name_and_limit()
    print(f"[device] {devices[0].device_kind} x {len(devices)}; "
          f"nvidia-smi name, power.limit: {card}")

    from msf_loam_tpu.core.cache import enable_compilation_cache
    enable_compilation_cache()

    def trace(phase):
        """(first frame, output dir) of the traced window, or None."""
        return ((30, os.path.join(args.trace, phase)) if args.trace
                else None)

    if args.four:
        phase_four(card, args)
    else:
        phase_single_stream("lidar64", card, args, trace)
        phase_single_stream("lio64", card, args, trace)
        phase_batched(card, args, trace)
        if args.trace:
            summary = {phase: stage_times(os.path.join(args.trace, phase),
                                          os.path.join(args.trace, "hlo"),
                                          frames)
                       for phase, frames in (("lidar64", TRACE_FRAMES),
                                             ("lio64", TRACE_FRAMES),
                                             ("batched", BATCH_FRAMES))}
            summary["card"] = card
            with open(os.path.join(args.trace, "stage_times.json"), "w") as f:
                json.dump(summary, f, indent=1)
            for phase, st in summary.items():
                if phase != "card":
                    print_stage_times(phase, st, card)
    print(result_line(jax.devices()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
