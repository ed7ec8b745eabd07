"""Virtual-mesh strong-scaling measurement -> docs/scaling_r5.json.

Runs the FULL sharded pipeline (map sharding + packed pair queries +
point-axis-sharded odometry, parallel/sharded_pipeline.py) over n = 1, 2,
4, 8 virtual CPU devices and reports steady-state frames/s plus the DP-GN
microbench, mirroring the r3/r4 artifacts (docs/scaling_r{3,4}.json).

Interpretation on ONE host: the virtual devices share a single CPU, so a
fully-replicated program does ~n times the work and strong efficiency
collapses toward 1/n (r4 measured 0.047 at n=8). Sharding the dominant
replicated stage (odometry, 91% of the CPU frame) keeps total work
roughly constant, so efficiency should hold near its collective-overhead
bound instead. Every child process re-execs with its own
--xla_force_host_platform_device_count (the device count pins at
interpreter start).

Run:  python scripts/bench_scaling.py        (re-execs itself per n)
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_FRAMES = 12
N_STEADY = 8          # frames counted (skip compile + warmup)


def child(n: int):
    import time

    import numpy as np
    import jax
    import jax.numpy as jnp

    from msf_loam_tpu.config import FeatureConfig, MappingConfig, MsfLoamConfig
    from msf_loam_tpu.dataio import preprocess, synthetic
    from msf_loam_tpu.ops import features as feat_mod
    from msf_loam_tpu.parallel import data_parallel, mesh as mesh_mod
    from msf_loam_tpu.parallel.sharded_pipeline import ShardedSlamPipeline
    from msf_loam_tpu.core.se3 import Pose

    assert jax.device_count() == n, (jax.device_count(), n)
    fcfg = FeatureConfig(max_points_per_ring=1024, max_less_flat=4096)
    cfg = MsfLoamConfig(
        features=fcfg,
        mapping=MappingConfig(map_table_size=1 << 13, map_cell_capacity=16,
                              max_query_points=2048))
    world = synthetic.World.corridor(seed=0, size=12.0)
    scans = []
    for i in range(N_FRAMES):
        t = np.array([0.25 * i, 0.0, 0.0])
        xyz, ring = synthetic.simulate_scan(world, t, np.eye(3), n_rings=16,
                                            pts_per_ring=900, noise=0.004,
                                            seed=i)
        img = preprocess.preprocess_scan(xyz, ring, fcfg, 16)
        scans.append(feat_mod.extract_features(img, jnp.float32(0.1 * i),
                                               fcfg))

    mesh = mesh_mod.make_mesh(n_map=n, n_data=1)
    sp = ShardedSlamPipeline(cfg, mesh)
    for s in scans[: N_FRAMES - N_STEADY]:      # compile + warm the map
        sp.process_scan(s)
    t0 = time.perf_counter()
    for s in scans[N_FRAMES - N_STEADY:]:
        sp.process_scan(s)
    fps = N_STEADY / (time.perf_counter() - t0)

    # DP-GN microbench (continuity with the r3/r4 steps/s row)
    rng = np.random.default_rng(0)
    npts = 1 << 15
    pts = jnp.asarray(rng.uniform(-10, 10, (npts, 3)).astype(np.float32))
    nrm = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (npts, 1))
    c = pts * jnp.asarray([[1.0, 1.0, 0.0]], jnp.float32)
    valid = jnp.ones((npts,), bool)
    dmesh = mesh_mod.make_mesh(n_map=1, n_data=n)
    p0 = Pose.identity()
    out = data_parallel.dp_gauss_newton_plane(dmesh, p0, pts, c, nrm, valid,
                                              n_iters=6)
    jax.block_until_ready(out.t)
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        out = data_parallel.dp_gauss_newton_plane(dmesh, p0, pts, c, nrm,
                                                  valid, n_iters=6)
    jax.block_until_ready(out.t)
    sps = reps / (time.perf_counter() - t0)
    print(json.dumps({"n": n, "pipeline_fps": round(fps, 3),
                      "dp_gn_steps_per_sec": round(sps, 2)}))


def main():
    if len(sys.argv) > 1 and sys.argv[1].startswith("--child"):
        child(int(sys.argv[1].split("=")[1]))
        return

    results = {}
    for n in (1, 2, 4, 8):
        env = {**os.environ,
               "XLA_FLAGS": f"--xla_force_host_platform_device_count={n}",
               "JAX_PLATFORMS": "cpu"}
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), f"--child={n}"],
            env=env, capture_output=True, text=True, cwd=ROOT, timeout=2400)
        line = [l for l in out.stdout.splitlines() if l.startswith("{")]
        assert line, (out.stdout, out.stderr[-2000:])
        results[str(n)] = json.loads(line[-1])
        print(results[str(n)], flush=True)

    fps1 = results["1"]["pipeline_fps"]
    sps1 = results["1"]["dp_gn_steps_per_sec"]
    doc = {
        "platform": "cpu",
        "note": ("virtual 1-host mesh: all devices share one CPU, so "
                 "perfect sharding of a fixed-size frame holds efficiency "
                 "~1.0 and replicated compute decays as 1/n. r4 (fully "
                 "replicated frame compute) measured 0.047 at n=8; r5 "
                 "shards odometry over the point axis."),
        "steps_per_sec": {k: v["dp_gn_steps_per_sec"]
                          for k, v in results.items()},
        "scaling_efficiency": {
            k: round(v["dp_gn_steps_per_sec"] / sps1, 3)
            for k, v in results.items()},
        "pipeline_frames_per_sec": {k: v["pipeline_fps"]
                                    for k, v in results.items()},
        "pipeline_strong_efficiency": {
            k: round(v["pipeline_fps"] / fps1, 3)
            for k, v in results.items()},
    }
    path = os.path.join(ROOT, "docs", "scaling_r5.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
