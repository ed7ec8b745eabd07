"""Verify every composition of the distributed loop-closure solve agrees
with the single-device solver: eager per-iteration, one jitted program, and
the production lax.scan path must all land on the same trajectory.

(Round 1 shipped an eager-only workaround here; the root cause — scatter
assembly mispartitioned when feeding the shard_map solve — is fixed by the
scatter-free `_assemble_chain`, and `scripts/xla_scatter_shardmap_repro.py`
preserves a reproduction of the original defect.)

Run: env JAX_PLATFORMS=cpu \
     XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python scripts/check_distributed_solve.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np

from msf_loam_tpu.config import PoseGraphConfig
from msf_loam_tpu.core.se3 import Pose, quat_multiply, quat_rotate
from msf_loam_tpu.parallel import mesh as mesh_mod
from msf_loam_tpu.slam import posegraph


def build_problem(N=40):
    from tests.test_loop_closure import _drift_loop_problem

    gt, poses0, data = _drift_loop_problem(N=N)
    qi_inv = posegraph.quat_conjugate(gt.q[0])
    meas = Pose(
        t=quat_rotate(qi_inv, gt.t[N - 1] - gt.t[0])[None],
        q=posegraph.quat_normalize(quat_multiply(qi_inv, gt.q[N - 1]))[None])
    loops = posegraph.LoopFactors.pad(
        np.array([0]), np.array([N - 1]), meas, to_l=4)
    data = data._replace(gps_xyz=gt.t[:1], gps_valid=jnp.ones(1, bool))
    return poses0, data, loops, PoseGraphConfig()


def main():
    mesh = mesh_mod.make_mesh(n_map=1, n_data=8)
    poses0, data, loops, cfg = build_problem()

    ref = posegraph.optimize_with_loops(poses0, data, loops, cfg, n_iters=6)

    # production path: lax.scan over GN iterations, distributed solve inside
    scanned = posegraph.optimize_with_loops_distributed(
        mesh, poses0, data, loops, cfg, n_iters=6)
    err_scan = float(jnp.max(jnp.abs(scanned.poses.t - ref.poses.t)))

    # the whole optimization wrapped in one explicit jit
    jitted = jax.jit(
        lambda p, d, l: posegraph.optimize_with_loops_distributed(
            mesh, p, d, l, cfg, 6))(poses0, data, loops)
    err_jit = float(jnp.max(jnp.abs(jitted.poses.t - ref.poses.t)))

    print(f"max|t - single_device|  scan={err_scan:.3e}  jit={err_jit:.3e}")
    assert err_scan < 5e-3 and err_jit < 5e-3, "distributed solve diverged"
    print("all compositions agree with the single-device solver")


if __name__ == "__main__":
    main()
