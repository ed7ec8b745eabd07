"""Batched on-manifold Gauss-Newton / Levenberg-Marquardt.

The batched replacement for ``ceres::Solve`` over analytic SE(3) factors
(``odometry_scan_matcher.cc:269-274``, ``mapping_scan_matcher.cc:250-259``):
all residual blocks are evaluated at once, the normal equations are dense
reductions (J^T W J / J^T W r, f32 matmuls), the D-dim solve happens on
device, and the update is a manifold retraction (t += dt, q *= exp(dtheta)
— ``pose_local_parameterization.cc:6-21``).

Robustness mirrors the reference:
* Huber loss -> IRLS block weights w = min(1, delta/||r_block||)
  (HuberLoss(0.1), odometry_scan_matcher.cc:67);
* "reject worst fraction" (scan_matcher.cc:40-76) -> weight zeroing above a
  residual quantile (quantile_inlier_weights).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from msf_loam_tpu.core.se3 import Pose
from msf_loam_tpu.ops.icp_residuals import ResidualBlocks

Array = jax.Array


def huber_weights(blocks: ResidualBlocks, delta: float) -> Array:
    """IRLS weights for Ceres HuberLoss on the block norm: w = min(1, d/|r|)."""
    nrm = jnp.sqrt(jnp.sum(blocks.r * blocks.r, axis=-1) + 1e-30)
    w = jnp.minimum(1.0, delta / nrm)
    return jnp.where(blocks.valid, w, 0.0)


def threshold_inlier_weights(blocks: ResidualBlocks,
                             threshold: float = None) -> Array:
    """Reject residual blocks above an absolute norm threshold.

    Parity note: the reference's RefineByRejectOutliersWithThreshold is
    called after every matcher solve but its body is COMMENTED OUT — a
    no-op (scan_matcher.cc:13-38, odometry_scan_matcher.cc:276,
    mapping_scan_matcher.cc:256). We mirror that: with threshold=None
    (the default, matching the reference behavior) every valid block keeps
    weight 1; pass a float to enable the documented intent.
    """
    w = blocks.valid.astype(jnp.float32)
    if threshold is None:
        return w
    nrm = jnp.sqrt(jnp.sum(blocks.r * blocks.r, axis=-1))
    return jnp.where(nrm <= threshold, w, 0.0)


def quantile_inlier_weights(blocks: ResidualBlocks, keep_frac: float) -> Array:
    """Zero out the worst (1-keep_frac) residual blocks by norm.

    The reduction analog of ScanMatcher::RefineByRejectOutliersWithFrac
    (scan_matcher.cc:40-76), which sorts blocks by cost and removes the
    worst fraction before a re-solve.
    """
    nrm = jnp.sqrt(jnp.sum(blocks.r * blocks.r, axis=-1))
    nrm = jnp.where(blocks.valid, nrm, -1.0)  # invalid never counted
    n_valid = jnp.sum(blocks.valid)
    thresh = _masked_quantile(nrm, blocks.valid, keep_frac)
    keep = blocks.valid & (nrm <= thresh)
    return keep.astype(nrm.dtype)


def _masked_quantile(x: Array, mask: Array, q: float) -> Array:
    """q-quantile of x over masked entries (static-shape friendly)."""
    big = jnp.float32(3e38)
    xs = jnp.sort(jnp.where(mask, x, big))
    n = jnp.sum(mask.astype(jnp.int32))
    idx = jnp.clip((q * n.astype(jnp.float32)).astype(jnp.int32), 0,
                   x.shape[0] - 1)
    return xs[idx]


def accumulate_normal_eqs(blocks_list: Sequence[ResidualBlocks],
                          weights_list: Sequence[Array],
                          dim: int) -> Tuple[Array, Array, Array, Array]:
    """Sum weighted normal equations over heterogeneous residual blocks.

    Returns (H (dim,dim), g (dim,), cost, n_inliers). This is the reduction
    that becomes a ``psum`` across shards in the distributed solver.
    """
    H = jnp.zeros((dim, dim), jnp.float32)
    g = jnp.zeros((dim,), jnp.float32)
    cost = jnp.float32(0.0)
    n_in = jnp.float32(0.0)
    for blocks, w in zip(blocks_list, weights_list):
        Jw = blocks.J * w[:, None, None]
        H = H + jnp.einsum("nri,nrj->ij", Jw, blocks.J)
        g = g + jnp.einsum("nri,nr->i", Jw, blocks.r)
        cost = cost + jnp.sum(w * jnp.sum(blocks.r * blocks.r, axis=-1))
        # count residual ROWS (a single 15-dim IMU block fully constrains)
        n_in = n_in + jnp.sum((w > 0).astype(jnp.float32)) * blocks.r.shape[-1]
    return H, g, cost, n_in


class GNState(NamedTuple):
    pose: Pose
    velocity: Array      # (3,) — used by the 9-dim deskew state; else zeros
    cost: Array
    n_inliers: Array


def gauss_newton(build_blocks: Callable[[Pose, Array], Tuple[Sequence[ResidualBlocks], Sequence[Array]]],
                 pose0: Pose,
                 velocity0: Array,
                 n_iters: int,
                 state_dim: int = 6,
                 damping: float = 1e-4,
                 step_clip: float = 1.0,
                 axis_name=None) -> GNState:
    """Fixed-iteration damped Gauss-Newton on (pose[, velocity]).

    ``build_blocks(pose, velocity)`` returns (blocks_list, weights_list)
    with everything already masked. Solve uses LM-style diagonal damping;
    fixed iteration count keeps the loop jit-compilable (the reference also
    runs a fixed budget: 6 Ceres iterations).

    ``axis_name``: when running inside a shard_map with residual blocks
    sharded over that mesh axis, the normal equations psum across shards
    before the (replicated, identical) dense solve — the SURVEY §2.9
    data-parallel Hessian-block reduction.
    """

    @jax.named_scope("gauss_newton")
    def step(carry, _):
        pose, vel = carry
        blocks, weights = build_blocks(pose, vel)
        H, g, cost, n_in = accumulate_normal_eqs(blocks, weights, state_dim)
        if axis_name is not None:
            H, g, cost, n_in = jax.lax.psum((H, g, cost, n_in), axis_name)
        H = H + damping * jnp.diag(jnp.maximum(jnp.diag(H), 1.0))
        dx = -_solve_psd(H, g)
        dx = jnp.clip(dx, -step_clip, step_clip)
        # no-op update if the system is degenerate (too few inliers)
        ok = n_in >= 3.0
        dx = jnp.where(ok, dx, 0.0)
        new_pose = pose.retract(dx[:6])
        new_vel = vel + (dx[6:9] if state_dim > 6 else 0.0)
        return (new_pose, new_vel), (cost, n_in)

    # full unroll: iterations are few (<=6) and the per-iteration work is
    # ~100 small fused ops — unrolling lets XLA fuse/pipeline across
    # iterations and CSE state-independent subexpressions instead of
    # round-tripping the carry each step (same lesson as the pick rounds)
    (pose, vel), (costs, n_ins) = jax.lax.scan(
        step, (pose0, velocity0), None, length=n_iters, unroll=True)
    return GNState(pose=pose, velocity=vel, cost=costs[-1], n_inliers=n_ins[-1])


def _solve_psd(H: Array, g: Array) -> Array:
    """Small dense PSD solve via Cholesky; safe fallback to pinv-free
    damped identity when factorization fails (degenerate geometry)."""
    L, low = jax.scipy.linalg.cho_factor(H, lower=True)
    x = jax.scipy.linalg.cho_solve((L, low), g)
    finite = jnp.all(jnp.isfinite(x))
    return jnp.where(finite, x, 0.0)
