"""Fixed-shape point-cloud containers.

Batched replacement for the reference's PCL cloud types and the
inter-stage ``TimestampedPointCloud`` payload
(``/root/reference/src/common/timestamped_pointcloud.h:11-48``). Pointer-y
dynamic clouds become ``(N_max, ...)`` arrays with validity masks so every
shape is static under ``jax.jit``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from msf_loam_tpu.core.se3 import Pose

Array = jax.Array


class PointBatch(NamedTuple):
    """A masked batch of LiDAR points.

    Fields mirror PointXYZIRT (``common.h:52-62``): position + ring +
    per-point relative time (the reference stashes rel-time into
    ``intensity``; we keep an honest ``rel_time`` column).
    """

    xyz: Array        # (N, 3) float32
    rel_time: Array   # (N,)  float32, seconds within scan [0, scan_period)
    ring: Array       # (N,)  int32
    mask: Array       # (N,)  bool — True for valid points

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> Array:
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)

    @staticmethod
    def zeros(n: int, dtype=jnp.float32) -> "PointBatch":
        return PointBatch(
            xyz=jnp.zeros((n, 3), dtype),
            rel_time=jnp.zeros((n,), dtype),
            ring=jnp.zeros((n,), jnp.int32),
            mask=jnp.zeros((n,), bool),
        )

    @staticmethod
    def from_numpy(xyz: np.ndarray, rel_time=None, ring=None,
                   capacity: Optional[int] = None) -> "PointBatch":
        n = xyz.shape[0]
        cap = capacity or n
        out_xyz = np.zeros((cap, 3), np.float32)
        out_t = np.zeros((cap,), np.float32)
        out_r = np.zeros((cap,), np.int32)
        out_m = np.zeros((cap,), bool)
        k = min(n, cap)
        out_xyz[:k] = xyz[:k]
        if rel_time is not None:
            out_t[:k] = rel_time[:k]
        if ring is not None:
            out_r[:k] = ring[:k]
        out_m[:k] = True
        return PointBatch(jnp.asarray(out_xyz), jnp.asarray(out_t),
                          jnp.asarray(out_r), jnp.asarray(out_m))

    def transform(self, pose: Pose) -> "PointBatch":
        return self._replace(xyz=pose.apply(self.xyz))

    def masked_xyz(self, fill: float = 1e6) -> Array:
        """xyz with invalid rows pushed far away (so kNN ignores them)."""
        return jnp.where(self.mask[..., None], self.xyz, fill)


class ScanFeatures(NamedTuple):
    """The five-cloud product of scan registration — the
    ``TimestampedPointCloud`` analog handed from feature extraction to
    odometry and mapping (``timestamped_pointcloud.h:24-36``)."""

    time: Array                  # () float64 scan timestamp, seconds
    full: PointBatch             # cloud_full_res
    corner_sharp: PointBatch     # cloud_corner_sharp
    corner_less_sharp: PointBatch
    surf_flat: PointBatch        # cloud_surf_flat
    surf_less_flat: PointBatch   # cloud_surf_less_flat

    def strip_full(self) -> "ScanFeatures":
        """Drop the full-resolution cloud (keep a 0-capacity stub).

        The scan-to-scan matcher only reads the less-sharp / less-flat
        clouds of the previous scan; threading the (R*W)-point full cloud
        through a ``lax.scan`` carry costs a multi-MB copy per frame. Use
        this for on-device frame loops; keep ``full`` where deskewed artifacts /
        loop keyframes are consumed (run_slam, imu.deskew). Slices the
        point axis to zero so leading (batch) axes survive; idempotent."""
        pb = self.full
        return self._replace(full=PointBatch(
            xyz=pb.xyz[..., :0, :], rel_time=pb.rel_time[..., :0],
            ring=pb.ring[..., :0], mask=pb.mask[..., :0]))

    def transform(self, pose: Pose) -> "ScanFeatures":
        return self._replace(
            full=self.full.transform(pose),
            corner_sharp=self.corner_sharp.transform(pose),
            corner_less_sharp=self.corner_less_sharp.transform(pose),
            surf_flat=self.surf_flat.transform(pose),
            surf_less_flat=self.surf_less_flat.transform(pose),
        )


class RingImage(NamedTuple):
    """Range-image organized scan: points grouped per ring, azimuth-ordered.

    The dense, fixed-shape intermediate for feature extraction, replacing the
    reference's per-ring ``std::vector`` grouping (msf_loam_node.cc:176-195).
    """

    xyz: Array       # (R, W, 3)
    rel_time: Array  # (R, W)
    mask: Array      # (R, W) bool
