"""VINS-Mono-style IMU preintegration as a ``lax.scan``.

Batched re-implementation of ``IntegrationBase``
(``/root/reference/src/slam/imu_fusion/integration_base.cc``): midpoint
integration of (delta_p, delta_q, delta_v) with 15x15 bias-Jacobian and
covariance propagation (integration_base.cc:53-124), per-sample result
buffers for per-point deskew interpolation (integration_base.cc:187-192),
bias-corrected residual evaluation (integration_base.cc:155-185), and
repropagation = re-running the scan with new linearization points
(integration_base.cc:36-50).

Fixed-shape: a window holds up to S samples; unused slots have dt=0 and are
exact no-ops in the integration (the reference skips dt==0 pushes too,
integration_base.cc:29).

State ordering matches parameters.h: O_P=0, O_R=3, O_V=6, O_BA=9, O_BG=12.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from msf_loam_tpu.config import ImuConfig
from msf_loam_tpu.core.se3 import (quat_exp, quat_multiply, quat_normalize,
                                   quat_rotate, quat_to_matrix, skew)

Array = jax.Array

O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12


class Preintegration(NamedTuple):
    """Result of integrating one IMU window [t_i, t_j]."""

    delta_p: Array        # (3,)
    delta_q: Array        # (4,) wxyz
    delta_v: Array        # (3,)
    jacobian: Array       # (15, 15) d(delta)/d(state at linearization)
    covariance: Array     # (15, 15)
    sum_dt: Array         # ()
    linearized_ba: Array  # (3,)
    linearized_bg: Array  # (3,)
    # per-sample buffers (S+1 entries; entry 0 is the identity start state)
    sum_dt_buf: Array     # (S+1,)
    delta_p_buf: Array    # (S+1, 3)
    delta_q_buf: Array    # (S+1, 4)
    delta_v_buf: Array    # (S+1, 3)
    n_samples: Array      # () int32 — valid sample count


def _noise_matrix(cfg: ImuConfig) -> Array:
    n = jnp.zeros((18, 18), jnp.float32)
    diag = jnp.concatenate([
        jnp.full((3,), cfg.acc_n ** 2), jnp.full((3,), cfg.gyr_n ** 2),
        jnp.full((3,), cfg.acc_n ** 2), jnp.full((3,), cfg.gyr_n ** 2),
        jnp.full((3,), cfg.acc_w ** 2), jnp.full((3,), cfg.gyr_w ** 2),
    ]).astype(jnp.float32)
    return n.at[jnp.arange(18), jnp.arange(18)].set(diag)


def _fv_blocks(dt: Array, acc0: Array, gyr0: Array, acc1: Array, gyr1: Array,
               q0: Array, q1: Array, ba: Array, bg: Array
               ) -> Tuple[Array, Array]:
    """The eq22 F (15x15) / V (15x18) blocks for one midpoint interval,
    given the pre/post orientations (shared by the sequential scan and the
    batched associative path)."""
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    R0 = quat_to_matrix(q0)
    R1 = quat_to_matrix(q1)
    w_x = skew(un_gyr)
    a0_x = skew(acc0 - ba)
    a1_x = skew(acc1 - ba)
    I3 = jnp.eye(3, dtype=q0.dtype)

    R1a1 = R1 @ a1_x
    Iw = I3 - w_x * dt

    F = jnp.zeros((15, 15), q0.dtype)
    F = F.at[0:3, 0:3].set(I3)
    F = F.at[0:3, 3:6].set(-0.25 * (R0 @ a0_x) * dt * dt - 0.25 * R1a1 @ Iw * dt * dt)
    F = F.at[0:3, 6:9].set(I3 * dt)
    F = F.at[0:3, 9:12].set(-0.25 * (R0 + R1) * dt * dt)
    F = F.at[0:3, 12:15].set(0.25 * R1a1 * dt * dt * dt)
    F = F.at[3:6, 3:6].set(Iw)
    F = F.at[3:6, 12:15].set(-I3 * dt)
    F = F.at[6:9, 3:6].set(-0.5 * (R0 @ a0_x) * dt - 0.5 * R1a1 @ Iw * dt)
    F = F.at[6:9, 6:9].set(I3)
    F = F.at[6:9, 9:12].set(-0.5 * (R0 + R1) * dt)
    F = F.at[6:9, 12:15].set(0.5 * R1a1 * dt * dt)
    F = F.at[9:12, 9:12].set(I3)
    F = F.at[12:15, 12:15].set(I3)

    V = jnp.zeros((15, 18), q0.dtype)
    V = V.at[0:3, 0:3].set(0.25 * R0 * dt * dt)
    v03 = -0.125 * R1a1 * dt * dt * dt
    V = V.at[0:3, 3:6].set(v03)
    V = V.at[0:3, 6:9].set(0.25 * R1 * dt * dt)
    V = V.at[0:3, 9:12].set(v03)
    V = V.at[3:6, 3:6].set(0.5 * I3 * dt)
    V = V.at[3:6, 9:12].set(0.5 * I3 * dt)
    V = V.at[6:9, 0:3].set(0.5 * R0 * dt)
    v63 = -0.25 * R1a1 * dt * dt
    V = V.at[6:9, 3:6].set(v63)
    V = V.at[6:9, 6:9].set(0.5 * R1 * dt)
    V = V.at[6:9, 9:12].set(v63)
    V = V.at[9:12, 12:15].set(I3 * dt)
    V = V.at[12:15, 15:18].set(I3 * dt)
    return F, V


def midpoint_step(dt: Array, acc0: Array, gyr0: Array, acc1: Array, gyr1: Array,
                  delta_p: Array, delta_q: Array, delta_v: Array,
                  ba: Array, bg: Array,
                  jacobian: Array, covariance: Array, noise: Array
                  ) -> Tuple[Array, Array, Array, Array, Array]:
    """One midpoint-integration step (integration_base.cc:53-124).

    Returns (delta_p', delta_q', delta_v', jacobian', covariance').
    """
    un_acc_0 = quat_rotate(delta_q, acc0 - ba)
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    # eq7.1 — the reference's first-order quaternion update
    dq_step = jnp.concatenate([jnp.ones((1,)), un_gyr * dt / 2.0])
    result_q = quat_normalize(quat_multiply(delta_q, dq_step))
    un_acc_1 = quat_rotate(result_q, acc1 - ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    result_p = delta_p + delta_v * dt + 0.5 * un_acc * dt * dt   # eq7.2
    result_v = delta_v + un_acc * dt                             # eq7.3

    F, V = _fv_blocks(dt, acc0, gyr0, acc1, gyr1, delta_q, result_q, ba, bg)
    new_jac = F @ jacobian                                        # eq19
    new_cov = F @ covariance @ F.T + V @ noise @ V.T              # eq18
    return result_p, result_q, result_v, new_jac, new_cov


@functools.partial(jax.jit, static_argnames=("cfg",))
def preintegrate(dts: Array, accs: Array, gyrs: Array, valid: Array,
                 ba: Array, bg: Array, cfg: ImuConfig) -> Preintegration:
    """Integrate a padded IMU window.

    Args:
      dts:   (S,) seconds between consecutive samples (0 for padding).
      accs:  (S, 3) accelerometer at the END of each interval.
      gyrs:  (S, 3) gyro at the END of each interval.
      valid: (S,) bool.
      ba/bg: (3,) linearization biases.

    The first valid sample's (acc, gyr) also serve as the window's initial
    (acc0, gyr0), mirroring the IntegrationBase constructor seeding
    (estimator.cc:133).

    ``cfg.preint_mode`` picks the execution strategy: "assoc" (default)
    lowers the recurrences to log-depth associative scans (see
    ``preintegrate_assoc`` — a 40-sample window costs 6 sequential levels
    of batched math instead of 40 tiny sequential steps); "scan" keeps the
    literal per-sample lax.scan (the reference-shaped implementation).
    Both produce the same Preintegration up to fp reassociation
    (test_imu::test_assoc_matches_scan).
    """
    if cfg.preint_mode == "assoc":
        return preintegrate_assoc(dts, accs, gyrs, valid, ba, bg, cfg)
    S = dts.shape[0]
    noise = _noise_matrix(cfg)
    acc_init = accs[0]
    gyr_init = gyrs[0]

    def step(carry, inp):
        (p, q, v, jac, cov, sdt, acc0, gyr0) = carry
        dt, acc1, gyr1, ok = inp
        dt = jnp.where(ok, dt, 0.0)
        p2, q2, v2, jac2, cov2 = midpoint_step(
            dt, acc0, gyr0, acc1, gyr1, p, q, v, ba, bg, jac, cov, noise)
        use = ok & (dt > 0)
        sel = lambda a, b: jnp.where(use, a, b)
        new = (sel(p2, p), sel(q2, q), sel(v2, v),
               jnp.where(use, jac2, jac), jnp.where(use, cov2, cov),
               sdt + jnp.where(use, dt, 0.0),
               jnp.where(use, acc1, acc0), jnp.where(use, gyr1, gyr0))
        out = (new[5], new[0], new[1], new[2])  # cumulative buffers
        return new, out

    init = (jnp.zeros(3), jnp.array([1.0, 0, 0, 0]), jnp.zeros(3),
            jnp.eye(15), jnp.zeros((15, 15)), jnp.float32(0.0),
            acc_init, gyr_init)
    carry, (sdt_buf, p_buf, q_buf, v_buf) = jax.lax.scan(
        step, init, (dts, accs, gyrs, valid))
    p, q, v, jac, cov, sdt, _, _ = carry

    sum_dt_buf = jnp.concatenate([jnp.zeros((1,)), sdt_buf])
    delta_p_buf = jnp.concatenate([jnp.zeros((1, 3)), p_buf])
    delta_q_buf = jnp.concatenate([jnp.array([[1.0, 0, 0, 0]]), q_buf])
    delta_v_buf = jnp.concatenate([jnp.zeros((1, 3)), v_buf])

    return Preintegration(
        delta_p=p, delta_q=q, delta_v=v, jacobian=jac, covariance=cov,
        sum_dt=sdt, linearized_ba=ba, linearized_bg=bg,
        sum_dt_buf=sum_dt_buf, delta_p_buf=delta_p_buf,
        delta_q_buf=delta_q_buf, delta_v_buf=delta_v_buf,
        n_samples=jnp.sum(valid.astype(jnp.int32)),
    )


def preintegrate_assoc(dts: Array, accs: Array, gyrs: Array, valid: Array,
                       ba: Array, bg: Array, cfg: ImuConfig) -> Preintegration:
    """``preintegrate`` lowered to log-depth associative scans.

    The midpoint recurrences factor exactly:
      * delta_q: each interval's dq is state-independent, so the prefix is
        an associative quaternion product (normalize distributes over the
        product — same direction as step-wise normalization);
      * delta_v / delta_p: once all prefix orientations are known the
        midpoint accelerations batch into one rotate, and v/p are
        (exclusive-)cumsums;
      * jacobian / covariance: J_N = F_{N-1}..F_0 and
        C_{k+1} = F C F^T + W compose associatively as affine maps on
        covariance: (F2,W2)o(F1,W1) = (F2 F1, F2 W1 F2^T + W2) — ONE
        associative scan yields both (its final F IS the jacobian).

    Padding/holes are exact no-ops (dq=identity, F=I, W=0, zero
    increments), and each interval's start sample is the previous VALID
    sample (the lax.scan carries it; here a cummax index recovers it).
    """
    S = dts.shape[0]
    noise = _noise_matrix(cfg)
    ok = valid & (dts > 0)
    dt = jnp.where(ok, dts, 0.0)

    # start-of-interval samples: previous valid index (or sample 0)
    iota = jnp.arange(S)
    prev = jax.lax.cummax(jnp.where(ok, iota, -1))
    prev = jnp.concatenate([jnp.array([-1]), prev[:-1]])
    idx0 = jnp.maximum(prev, 0)
    acc0 = accs[idx0]
    gyr0 = gyrs[idx0]

    un_gyr = 0.5 * (gyr0 + gyrs) - bg                        # (S, 3)
    dqs = jnp.concatenate([jnp.ones((S, 1)), un_gyr * dt[:, None] / 2.0],
                          axis=1)
    dqs = jnp.where(ok[:, None], dqs,
                    jnp.array([[1.0, 0, 0, 0]], dqs.dtype))
    q_pref = jax.lax.associative_scan(jax.vmap(quat_multiply), dqs)
    q_all = quat_normalize(q_pref)                           # q_{k+1}
    q_prev = jnp.concatenate([jnp.array([[1.0, 0, 0, 0]], q_all.dtype),
                              q_all[:-1]])                   # q_k

    un_acc0 = quat_rotate(q_prev, acc0 - ba)
    un_acc1 = quat_rotate(q_all, accs - ba)
    un_acc = jnp.where(ok[:, None], 0.5 * (un_acc0 + un_acc1), 0.0)
    dv = un_acc * dt[:, None]
    v_all = jnp.cumsum(dv, axis=0)                           # v_{k+1}
    v_prev = jnp.concatenate([jnp.zeros((1, 3), v_all.dtype), v_all[:-1]])
    dp = v_prev * dt[:, None] + 0.5 * un_acc * dt[:, None] ** 2
    p_all = jnp.cumsum(dp, axis=0)
    sdt_buf = jnp.cumsum(dt)

    F, V = jax.vmap(_fv_blocks, in_axes=(0, 0, 0, 0, 0, 0, 0, None, None))(
        dt, acc0, gyr0, accs, gyrs, q_prev, q_all, ba, bg)
    I15 = jnp.eye(15, dtype=F.dtype)
    F = jnp.where(ok[:, None, None], F, I15)
    W = jnp.einsum("sij,jk,slk->sil", V, noise, V)
    W = jnp.where(ok[:, None, None], W, 0.0)

    def comb(a, b):
        Fa, Wa = a
        Fb, Wb = b
        return (jnp.einsum("sij,sjk->sik", Fb, Fa),
                jnp.einsum("sij,sjk,slk->sil", Fb, Wa, Fb) + Wb)

    Fp, Wp = jax.lax.associative_scan(comb, (F, W))

    return Preintegration(
        delta_p=p_all[-1], delta_q=q_all[-1], delta_v=v_all[-1],
        jacobian=Fp[-1], covariance=Wp[-1], sum_dt=sdt_buf[-1],
        linearized_ba=ba, linearized_bg=bg,
        sum_dt_buf=jnp.concatenate([jnp.zeros((1,)), sdt_buf]),
        delta_p_buf=jnp.concatenate([jnp.zeros((1, 3)), p_all]),
        delta_q_buf=jnp.concatenate([jnp.array([[1.0, 0, 0, 0]]), q_all]),
        delta_v_buf=jnp.concatenate([jnp.zeros((1, 3)), v_all]),
        n_samples=jnp.sum(valid.astype(jnp.int32)),
    )


def evaluate_residual(pre: Preintegration,
                      p_i: Array, q_i: Array, v_i: Array, ba_i: Array, bg_i: Array,
                      p_j: Array, q_j: Array, v_j: Array, ba_j: Array, bg_j: Array,
                      gravity: Array) -> Array:
    """15-dim preintegration residual with first-order bias correction
    (IntegrationBase::evaluate, integration_base.cc:155-185, eq20/eq44)."""
    from msf_loam_tpu.core.se3 import quat_conjugate

    dp_dba = pre.jacobian[O_P:O_P + 3, O_BA:O_BA + 3]
    dp_dbg = pre.jacobian[O_P:O_P + 3, O_BG:O_BG + 3]
    dq_dbg = pre.jacobian[O_R:O_R + 3, O_BG:O_BG + 3]
    dv_dba = pre.jacobian[O_V:O_V + 3, O_BA:O_BA + 3]
    dv_dbg = pre.jacobian[O_V:O_V + 3, O_BG:O_BG + 3]

    dba = ba_i - pre.linearized_ba
    dbg = bg_i - pre.linearized_bg

    corrected_q = quat_multiply(pre.delta_q, quat_exp(dq_dbg @ dbg))
    corrected_v = pre.delta_v + dv_dba @ dba + dv_dbg @ dbg
    corrected_p = pre.delta_p + dp_dba @ dba + dp_dbg @ dbg

    qi_inv = quat_conjugate(q_i)
    sdt = pre.sum_dt
    r_p = quat_rotate(qi_inv, 0.5 * gravity * sdt * sdt + p_j - p_i - v_i * sdt) \
        - corrected_p
    r_q = 2.0 * quat_multiply(quat_conjugate(corrected_q),
                              quat_multiply(qi_inv, q_j))[1:4]
    r_v = quat_rotate(qi_inv, gravity * sdt + v_j - v_i) - corrected_v
    r_ba = ba_j - ba_i
    r_bg = bg_j - bg_i
    return jnp.concatenate([r_p, r_q, r_v, r_ba, r_bg])


def sqrt_information(pre: Preintegration, scale: float = 0.001) -> Array:
    """Whitening matrix 0.001 * chol(cov^-1)^T (imu_factor.cc:41-43)."""
    cov = pre.covariance + 1e-10 * jnp.eye(15)
    info = jnp.linalg.inv(cov)
    # LLT(info).matrixL().transpose() = upper Cholesky factor of info
    L = jnp.linalg.cholesky(info)
    sqrt_info = scale * L.T
    return jnp.where(jnp.isfinite(sqrt_info), sqrt_info, 0.0)


def interpolate_delta(pre: Preintegration, dt: Array) -> Tuple[Array, Array]:
    """Per-point (delta_p, delta_q) at relative times dt — the vectorized
    ``GetDeltaQP`` (scan_undistortion.cc:22-42): binary search into
    sum_dt_buf, slerp rotations / lerp translations.

    dt: (N,) -> (delta_p (N,3), delta_q (N,4)).
    """
    from msf_loam_tpu.core.se3 import quat_slerp

    buf_len = pre.sum_dt_buf.shape[0]
    last = pre.n_samples  # buffers [0..n_samples] are populated
    dt = jnp.clip(dt, 0.0, pre.sum_dt_buf[last])
    idx = jnp.searchsorted(pre.sum_dt_buf, dt, side="right") - 1
    idx = jnp.clip(idx, 0, last - 1)
    t0 = pre.sum_dt_buf[idx]
    t1 = pre.sum_dt_buf[idx + 1]
    s = (dt - t0) / jnp.maximum(t1 - t0, 1e-9)
    s = jnp.clip(s, 0.0, 1.0)
    p = (1.0 - s)[:, None] * pre.delta_p_buf[idx] + s[:, None] * pre.delta_p_buf[idx + 1]
    q = quat_slerp(pre.delta_q_buf[idx], pre.delta_q_buf[idx + 1], s[:, None])
    return p, q
