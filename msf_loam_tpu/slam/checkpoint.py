"""Mid-run checkpoint / resume of the SLAM pipeline state.

The reference has NO mid-run checkpointing — only terminal artifacts (PLY +
pbstream at shutdown, laser_mapping.cc:89-120; SURVEY.md §5). For a
production deployment we snapshot the full pipeline state — voxel map
shards, pose chain, estimator window, IMU-derived gravity/velocity — so a
run can resume exactly where it stopped (elastic restart / preemption).

Format: one compressed .npz per snapshot (atomic rename on save).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import TYPE_CHECKING

import jax.numpy as jnp
import numpy as np

from msf_loam_tpu.core.se3 import Pose

if TYPE_CHECKING:
    from msf_loam_tpu.slam.pipeline import SlamPipeline


def save_checkpoint(pipe: "SlamPipeline", path: str) -> None:
    payload = {
        "frame_idx": np.int64(pipe.frame_idx),
        "pose_odom_t": np.asarray(pipe.pose_odom.t),
        "pose_odom_q": np.asarray(pipe.pose_odom.q),
        "pose_c2l_t": np.asarray(pipe.pose_curr2last.t),
        "pose_c2l_q": np.asarray(pipe.pose_curr2last.q),
        "pose_o2m_t": np.asarray(pipe.pose_odom2map.t),
        "pose_o2m_q": np.asarray(pipe.pose_odom2map.q),
        "pose_map_t": np.asarray(pipe.pose_map.t),
        "pose_map_q": np.asarray(pipe.pose_map.q),
        "velocity": np.asarray(pipe.velocity),
        "gravity": np.asarray(pipe.gravity),
        "bias_acc": np.asarray(pipe.bias_acc),
        "bias_gyr": np.asarray(pipe.bias_gyr),
        "is_initialized": np.bool_(pipe.is_initialized),
        # voxel maps
        "cmap_points": np.asarray(pipe.corner_map.points),
        "cmap_keys": np.asarray(pipe.corner_map.leaf_key),
        "cmap_count": np.asarray(pipe.corner_map.count),
        "cmap_nobs": np.asarray(pipe.corner_map.n_obs),
        "smap_points": np.asarray(pipe.surf_map.points),
        "smap_keys": np.asarray(pipe.surf_map.leaf_key),
        "smap_count": np.asarray(pipe.surf_map.count),
        "smap_nobs": np.asarray(pipe.surf_map.n_obs),
        # trajectory so far
        "traj": pipe.trajectory() if pipe.results else np.zeros((0, 8)),
        # estimator window (JSON-encoded; small). The "pre" preintegration
        # pytrees are NOT serialized — they exist only to feed the bias
        # window solve, which skips until the window refills post-resume.
        "states_json": np.frombuffer(json.dumps([
            {k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in s.items() if k != "pre"} for s in pipe._states
        ]).encode(), dtype=np.uint8),
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    # note: np.savez appends ".npz" unless the name already ends with it,
    # so the temp name must keep the suffix for the atomic rename to work
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


_MAP_FIELDS = ("points", "leaf_key", "count", "n_obs")


def _atomic_savez(path: str, payload: dict) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_sharded_checkpoint(pipe, path: str) -> None:
    """Snapshot a ShardedSlamPipeline: each process writes the map shards
    it can address (keyed by their global slot offset) plus the replicated
    pose chain. In a multi-process run every rank writes
    ``<path>.proc<rank>``; single-process writes ``path`` directly. Resume
    requires the same mesh shape (device count): the device topology is
    fixed per job."""
    import jax

    payload = {
        "frame_idx": np.int64(pipe.frame_idx),
        "pose_odom_t": np.asarray(pipe.pose_odom.t),
        "pose_odom_q": np.asarray(pipe.pose_odom.q),
        "pose_c2l_t": np.asarray(pipe.pose_curr2last.t),
        "pose_c2l_q": np.asarray(pipe.pose_curr2last.q),
        "pose_o2m_t": np.asarray(pipe.pose_odom2map.t),
        "pose_o2m_q": np.asarray(pipe.pose_odom2map.q),
        "pose_map_t": np.asarray(pipe.pose_map.t),
        "pose_map_q": np.asarray(pipe.pose_map.q),
        "traj": pipe.trajectory() if pipe.results else np.zeros((0, 8)),
    }
    for pref, m in (("cmap", pipe.corner_map), ("smap", pipe.surf_map)):
        for field in _MAP_FIELDS:
            arr = getattr(m, field)
            for sh in arr.addressable_shards:
                start = sh.index[0].start or 0
                payload[f"{pref}_{field}@{start}"] = np.asarray(sh.data)
    if jax.process_count() > 1:
        path = f"{path}.proc{jax.process_index()}"
    _atomic_savez(path, payload)


def load_sharded_checkpoint(pipe, path: str) -> None:
    """Restore a ShardedSlamPipeline in place. The pipeline must be
    freshly constructed with the same config and mesh; map shards are
    re-placed onto the devices that own their slot ranges via
    ``jax.make_array_from_callback`` (each process only needs — and only
    reads — the shards it can address)."""
    import jax

    from msf_loam_tpu.slam.pipeline import FrameResult

    if jax.process_count() > 1:
        path = f"{path}.proc{jax.process_index()}"
    with np.load(path) as z:
        pipe.frame_idx = int(z["frame_idx"])
        pipe.pose_odom = Pose(jnp.asarray(z["pose_odom_t"]),
                              jnp.asarray(z["pose_odom_q"]))
        pipe.pose_curr2last = Pose(jnp.asarray(z["pose_c2l_t"]),
                                   jnp.asarray(z["pose_c2l_q"]))
        pipe.pose_odom2map = Pose(jnp.asarray(z["pose_o2m_t"]),
                                  jnp.asarray(z["pose_o2m_q"]))
        pipe.pose_map = Pose(jnp.asarray(z["pose_map_t"]),
                             jnp.asarray(z["pose_map_q"]))
        blobs = {k: z[k] for k in z.files if "@" in k}
        for pref in ("cmap", "smap"):
            m = pipe.corner_map if pref == "cmap" else pipe.surf_map
            new_fields = {}
            for field in _MAP_FIELDS:
                arr = getattr(m, field)

                def cb(index, _pref=pref, _field=field):
                    start = index[0].start or 0
                    return blobs[f"{_pref}_{_field}@{start}"]

                new_fields[field] = jax.make_array_from_callback(
                    arr.shape, arr.sharding, cb)
            m = m._replace(**new_fields)
            if pref == "cmap":
                pipe.corner_map = m
            else:
                pipe.surf_map = m
        traj = z["traj"]
        pipe.results = [
            FrameResult(time=float(r[0]),
                        odom_pose=Pose(jnp.asarray(r[1:4], dtype=jnp.float32),
                                       jnp.asarray(r[4:8], dtype=jnp.float32)),
                        map_pose=Pose(jnp.asarray(r[1:4], dtype=jnp.float32),
                                      jnp.asarray(r[4:8], dtype=jnp.float32)),
                        n_correspondences=0.0, ok=True)
            for r in traj]


def load_checkpoint(pipe: "SlamPipeline", path: str) -> None:
    """Restore state in place (maps/poses/estimator; results get the saved
    trajectory as (time, odom==map) rows)."""
    from msf_loam_tpu.slam.pipeline import FrameResult

    with np.load(path) as z:
        pipe.frame_idx = int(z["frame_idx"])
        pipe.pose_odom = Pose(jnp.asarray(z["pose_odom_t"]), jnp.asarray(z["pose_odom_q"]))
        pipe.pose_curr2last = Pose(jnp.asarray(z["pose_c2l_t"]), jnp.asarray(z["pose_c2l_q"]))
        pipe.pose_odom2map = Pose(jnp.asarray(z["pose_o2m_t"]), jnp.asarray(z["pose_o2m_q"]))
        pipe.pose_map = Pose(jnp.asarray(z["pose_map_t"]), jnp.asarray(z["pose_map_q"]))
        pipe.velocity = jnp.asarray(z["velocity"])
        pipe.gravity = jnp.asarray(z["gravity"])
        if "bias_acc" in z.files:
            pipe.bias_acc = jnp.asarray(z["bias_acc"])
            pipe.bias_gyr = jnp.asarray(z["bias_gyr"])
        pipe.is_initialized = bool(z["is_initialized"])
        def _sanitize(points, count):
            # restore the EMPTY_COORD tail invariant (snapshots written
            # before the invariant existed carry zeros past count)
            from msf_loam_tpu.slam.voxel_map import EMPTY_COORD
            p = jnp.asarray(points)
            occ = jnp.arange(p.shape[1])[None, :] < jnp.asarray(count)[:, None]
            return jnp.where(occ[..., None], p, EMPTY_COORD)

        pipe.corner_map = pipe.corner_map._replace(
            points=_sanitize(z["cmap_points"], z["cmap_count"]),
            leaf_key=jnp.asarray(z["cmap_keys"]),
            count=jnp.asarray(z["cmap_count"]),
            n_obs=jnp.asarray(z["cmap_nobs"]))
        pipe.surf_map = pipe.surf_map._replace(
            points=_sanitize(z["smap_points"], z["smap_count"]),
            leaf_key=jnp.asarray(z["smap_keys"]),
            count=jnp.asarray(z["smap_count"]),
            n_obs=jnp.asarray(z["smap_nobs"]))
        states = json.loads(bytes(z["states_json"]).decode() or "[]")
        pipe._states = [
            {k: (np.asarray(v, np.float32) if isinstance(v, list) else v)
             for k, v in s.items()} for s in states]
        traj = z["traj"]
        pipe.results = [
            FrameResult(time=float(r[0]),
                        odom_pose=Pose(jnp.asarray(r[1:4], dtype=jnp.float32),
                                       jnp.asarray(r[4:8], dtype=jnp.float32)),
                        map_pose=Pose(jnp.asarray(r[1:4], dtype=jnp.float32),
                                      jnp.asarray(r[4:8], dtype=jnp.float32)),
                        n_correspondences=0.0, ok=True)
            for r in traj]
