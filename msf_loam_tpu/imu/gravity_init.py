"""Gravity-direction + per-frame velocity initialization.

Batched redesign of ``Estimator::AddData``'s 50-frame init solve
(``/root/reference/src/slam/estimator/estimator.cc:56-111``): the
``VelocityGravityInitFactor`` residuals (estimator.cc:9-52) are LINEAR in
(g, v_0..v_{N-1}), so instead of iterating Ceres we assemble one dense
least-squares system and solve it on device, then project g back to the
gravity sphere (the reference's HomogeneousVectorParameterization keeps
|g| fixed) and re-solve the velocities. Outlier handling mirrors
``RefineByRejectOutliersWithFrac(problem, 6, 0.15)`` (estimator.cc:102):
drop the worst 15% residual blocks and solve once more.

Residuals per consecutive frame pair (i, j):
  r_p = q_i^-1 (p_i - p_j + v_i dt - 0.5 g dt^2) + delta_p_ij
  r_v = dt * (q_i^-1 (v_i - v_j - g dt) + delta_v_ij)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from msf_loam_tpu.core.se3 import quat_conjugate, quat_to_matrix

Array = jax.Array


class GravityInitResult(NamedTuple):
    gravity: Array      # (3,) |g| = g_norm
    velocities: Array   # (N, 3)
    residual_rms: Array


def _assemble(p: Array, q: Array, dt: Array, delta_p: Array, delta_v: Array,
              valid_pair: Array, n_frames: int):
    """Rows of the linear system in x = [g(3), v_0..v_{N-1}]."""
    N = n_frames
    M = N - 1
    Ri_inv = quat_to_matrix(quat_conjugate(q[:-1]))  # (M, 3, 3)
    dt_ = dt[:, None, None]

    # r_p rows: coefficient of g: -0.5 dt^2 R_i^T ; of v_i: dt R_i^T
    # constant: R_i^T (p_i - p_j) + delta_p
    A_p_g = -0.5 * dt_ * dt_ * Ri_inv
    A_p_vi = dt_ * Ri_inv
    b_p = jnp.einsum("mij,mj->mi", Ri_inv, p[:-1] - p[1:]) + delta_p

    # r_v rows (scaled by dt): g: -dt^2 R_i^T ; v_i: dt R_i^T ; v_j: -dt R_i^T
    A_v_g = -dt_ * dt_ * Ri_inv
    A_v_vi = dt_ * Ri_inv
    A_v_vj = -dt_ * Ri_inv
    b_v = dt[:, None] * delta_v

    D = 3 + 3 * N
    A = jnp.zeros((M, 6, D))
    A = A.at[:, 0:3, 0:3].set(A_p_g)
    A = A.at[:, 3:6, 0:3].set(A_v_g)
    rows = jnp.arange(M)
    for k in range(3):
        for l in range(3):
            A = A.at[rows, 0 + k, 3 + 3 * rows + l].set(A_p_vi[:, k, l])
            A = A.at[rows, 3 + k, 3 + 3 * rows + l].set(A_v_vi[:, k, l])
            A = A.at[rows, 3 + k, 6 + 3 * rows + l].set(A_v_vj[:, k, l])
    b = jnp.concatenate([b_p, b_v], axis=1)  # (M, 6); residual = A x + b
    w = valid_pair.astype(jnp.float32)
    return A, b, w


def _weighted_solve(A: Array, b: Array, w: Array, g_fixed: Array | None,
                    x_prior: Array | None = None,
                    damping: float = 1e-6) -> Array:
    """Solve min || w (A x + b) ||; optionally constrain g = g_fixed by
    eliminating the g columns. The damping pulls toward ``x_prior`` (not 0)
    so parameters left unconstrained by outlier rejection keep their
    previous estimate — matching Ceres' behavior of leaving untouched
    parameters at their seed (estimator.cc:100-103)."""
    M, R, D = A.shape
    Af = (A * w[:, None, None]).reshape(M * R, D)
    bf = (b * w[:, None]).reshape(M * R)
    if g_fixed is not None:
        bf = bf + Af[:, 0:3] @ g_fixed
        Af = Af.at[:, 0:3].set(0.0)
    # min ||A x + b||^2 + damping ||x - x_prior||^2
    # => (A^T A + damping I) x = -A^T b + damping x_prior
    H = Af.T @ Af + damping * jnp.eye(D)
    rhs = -Af.T @ bf
    if x_prior is not None:
        rhs = rhs + damping * x_prior
    x = jnp.linalg.solve(H, rhs)
    if g_fixed is not None:
        x = x.at[0:3].set(g_fixed)
    return x


@functools.partial(jax.jit, static_argnames=("n_frames",))
def solve_gravity_velocity(p: Array, q: Array, dt: Array, delta_p: Array,
                           delta_v: Array, valid_pair: Array,
                           g0: Array, n_frames: int,
                           reject_frac: float = 0.15) -> GravityInitResult:
    """Run the init solve.

    Args:
      p: (N, 3) mapped positions; q: (N, 4) wxyz orientations.
      dt: (N-1,) pair time gaps; delta_p/delta_v: (N-1, 3) preintegrated.
      valid_pair: (N-1,) bool.
      g0: (3,) initial gravity (sets the fixed norm).
    """
    g_norm = jnp.linalg.norm(g0)
    A, b, w = _assemble(p, q, dt, delta_p, delta_v, valid_pair, n_frames)

    # pass 1: unconstrained linear solve
    x = _weighted_solve(A, b, w, None)
    g = x[0:3]
    g = g / jnp.maximum(jnp.linalg.norm(g), 1e-9) * g_norm
    # re-solve velocities with g projected onto the gravity sphere
    x = _weighted_solve(A, b, w, g, x_prior=x)

    # outlier rejection: drop worst reject_frac blocks, re-solve
    r = jnp.einsum("mrd,d->mr", A, x) + b
    block_norm = jnp.linalg.norm(r, axis=1)
    block_norm = jnp.where(w > 0, block_norm, -1.0)
    from msf_loam_tpu.ops.gauss_newton import _masked_quantile
    thr = _masked_quantile(block_norm, w > 0, 1.0 - reject_frac)
    w2 = w * (block_norm <= thr).astype(jnp.float32)
    x = _weighted_solve(A, b, w2, None, x_prior=x)
    g = x[0:3]
    g = g / jnp.maximum(jnp.linalg.norm(g), 1e-9) * g_norm
    x = _weighted_solve(A, b, w2, g, x_prior=x)

    r = jnp.einsum("mrd,d->mr", A, x) + b
    rms = jnp.sqrt(jnp.mean(jnp.sum(r * r, axis=1) * w2) + 1e-12)
    return GravityInitResult(
        gravity=g,
        velocities=x[3:].reshape(n_frames, 3),
        residual_rms=rms,
    )
