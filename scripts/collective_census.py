"""Collective census of the sharded pipeline's per-frame programs.

Counts the collective ops (all-gather / all-reduce / collective-permute /
all-to-all) and their payload bytes in the compiled HLO of one sharded
frame — the number that bounds multi-chip strong scaling (VERDICT r3 weak
#4: "BASELINE's >=80% target will not survive dozens of small per-frame
collectives"). Reports both the packed fused-frame program (one dispatch,
pair-packed queries) and the legacy split path (separate matcher with
per-tensor query merges) for comparison.

Run:  python scripts/collective_census.py
"""

import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# force the 8-virtual-device CPU backend regardless of ambient env: re-exec
# with the corrected environment (XLA reads XLA_FLAGS once, at backend
# start, and a 1-device run would census a collective-free program)
_WANT = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
         "JAX_PLATFORMS": "cpu"}
if any(os.environ.get(k) != v for k, v in _WANT.items()):
    os.execve(sys.executable, [sys.executable] + sys.argv,
              {**os.environ, **_WANT})

import numpy as np

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
                "s64": 8, "u64": 8, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1}
_COLLECTIVES = ("all-gather", "all-reduce", "collective-permute",
                "all-to-all", "reduce-scatter")


def census(hlo_text: str) -> dict:
    """Count collective ops + payload bytes in optimized HLO text."""
    out = {name: {"count": 0, "bytes": 0} for name in _COLLECTIVES}
    # lines look like:  %ag = f32[8,1024,5]{...} all-gather(...)
    pat = re.compile(
        r"=\s*(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^ ]*)\s+(" +
        "|".join(_COLLECTIVES) + r")[-.(]")
    for line in hlo_text.splitlines():
        m = pat.search(line)
        if not m:
            continue
        op = m.group(4)
        nbytes = 0
        if m.group(1) is not None:   # tuple shape
            for part in m.group(1).split(","):
                sm = re.match(r"\s*(\w+)\[([\d,]*)\]", part)
                if sm:
                    n = int(np.prod([int(x) for x in
                                     sm.group(2).split(",") if x] or [1]))
                    nbytes += n * _DTYPE_BYTES.get(sm.group(1), 4)
        else:
            dims = [int(x) for x in m.group(3).split(",") if x] or [1]
            nbytes = int(np.prod(dims)) * _DTYPE_BYTES.get(m.group(2), 4)
        out[op]["count"] += 1
        out[op]["bytes"] += nbytes
    out["total"] = {
        "count": sum(v["count"] for k, v in out.items() if k != "total"),
        "bytes": sum(v["bytes"] for k, v in out.items() if k != "total"),
    }
    return out


def main():
    import jax
    import jax.numpy as jnp

    from msf_loam_tpu.config import (FeatureConfig, MappingConfig,
                                     MsfLoamConfig)
    from msf_loam_tpu.core.se3 import Pose
    from msf_loam_tpu.dataio import preprocess, synthetic
    from msf_loam_tpu.ops import features as feat_mod
    from msf_loam_tpu.parallel import mesh as mesh_mod, sharded_map
    from msf_loam_tpu.parallel.sharded_pipeline import (_sharded_frame_program,
                                                        _sharded_matcher)
    from msf_loam_tpu.slam.pipeline import downsample_features

    n_dev = len(jax.devices())
    mesh = mesh_mod.make_mesh(n_map=n_dev, n_data=1)
    # tiny shapes: the census counts OPS, which are shape-independent —
    # small programs keep the CPU compile fast
    cfg = MsfLoamConfig(
        features=FeatureConfig(max_points_per_ring=1024, max_less_flat=1024),
        mapping=MappingConfig(map_table_size=1 << 11, max_query_points=512))
    mc = cfg.mapping

    world = synthetic.World.corridor(seed=0, size=14.0)
    xyz, ring = synthetic.simulate_scan(world, np.zeros(3), np.eye(3),
                                        n_rings=16, pts_per_ring=900,
                                        noise=0.004, seed=0)
    img = preprocess.preprocess_scan(xyz, ring, cfg.features, num_rings=16)
    scan = feat_mod.extract_features(img, jnp.float32(0.0), cfg.features)
    cmap = sharded_map.create_sharded_map(mesh, mc.map_table_size,
                                          mc.map_cell_capacity,
                                          mc.map_cell_size, mc.line_resolution)
    smap = sharded_map.create_sharded_map(mesh, mc.map_table_size,
                                          mc.map_cell_capacity,
                                          mc.map_cell_size, mc.plane_resolution)

    # --- fused frame program (the production path) ---
    prog = _sharded_frame_program(mesh, cfg)
    lowered = prog.lower(cmap, smap, scan, scan, Pose.identity(),
                         Pose.identity(), Pose.identity(), jnp.bool_(False))
    hlo_fused = lowered.compile().as_text()
    fused = census(hlo_fused)

    # --- legacy split path: matcher + 2 inserts as separate programs ---
    corner_ds = downsample_features(scan.corner_less_sharp,
                                    mc.line_resolution,
                                    mc.corner_query_points)
    surf_ds = downsample_features(scan.surf_less_flat, mc.plane_resolution,
                                  mc.max_query_points)

    def query_fn(m, xyz_, mask, k):
        return sharded_map.sharded_query_knn(mesh, m, xyz_, mask, k=k)

    def query2_fn(m, xyz_, mask, k, k2):
        return sharded_map.sharded_query_knn_2r(mesh, m, xyz_, mask, k=k,
                                                k2=k2)

    from msf_loam_tpu.slam import mapping as mapping_mod

    @jax.jit
    def legacy_matcher(cm, sm, c, s, p):
        return mapping_mod.match_scan2map_core(
            cm, sm, c, s, p, mc, query_fn=query_fn, query2_fn=query2_fn)

    hlo_legacy = legacy_matcher.lower(
        cmap, smap, corner_ds, surf_ds, Pose.identity()).compile().as_text()
    legacy = census(hlo_legacy)

    report = {
        "n_devices": n_dev,
        "platform": jax.devices()[0].platform,
        "fused_frame_program": fused,
        "legacy_split_matcher_only": legacy,
        "note": "fused = whole frame (odometry+matcher+insert) in one "
                "program with pair-packed queries; legacy = the split "
                "matcher alone (odometry/insert dispatches excluded), "
                "per-tensor query merges",
    }
    print(json.dumps(report, indent=1))
    out_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "collective_census.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"# wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
