"""SE(3) / quaternion algebra on batched JAX arrays.

Batched replacement for the reference's ``Rigid3<T>`` type
(``/root/reference/src/common/rigid_transform.h:16-147``) and quaternion
helpers (``/root/reference/src/slam/imu_fusion/utility.h:5-78``).

Conventions
-----------
* Quaternions are stored as ``[w, x, y, z]`` (Hamilton, scalar-first).
* A pose is a pair ``(t, q)``: ``x_world = R(q) @ x_local + t``.
* Tangent updates use the *right* convention used by the reference's
  ``PoseLocalParameterization`` (``pose_local_parameterization.cc:6-21``):
  ``t <- t + dt``, ``q <- q * exp(dtheta)``.
* Everything is shape-polymorphic over leading batch dims: all ops accept
  ``(..., 4)`` quaternions / ``(..., 3)`` vectors and vmap/jit cleanly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array

# ---------------------------------------------------------------------------
# Quaternion ops ([w, x, y, z], Hamilton)
# ---------------------------------------------------------------------------


def quat_identity(dtype=jnp.float32) -> Array:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_multiply(q1: Array, q2: Array) -> Array:
    """Hamilton product q1 ⊗ q2, batched over leading dims."""
    w1, x1, y1, z1 = jnp.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conjugate(q: Array) -> Array:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q: Array, eps: float = 1e-12) -> Array:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, eps)


def quat_rotate(q: Array, v: Array) -> Array:
    """Rotate vector(s) v by quaternion(s) q.

    Uses the expanded 15-mul form (cheaper than building the 3x3 matrix when
    rotating a single vector; for rotating many points by one quaternion
    prefer ``quat_to_matrix`` + one matmul).
    """
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_matrix(q: Array) -> Array:
    """Quaternion -> 3x3 rotation matrix, batched: (..., 4) -> (..., 3, 3)."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: Array) -> Array:
    """3x3 rotation matrix -> quaternion [w,x,y,z], batched, branch-free.

    Shepperd's method evaluated on all four candidates and selected with
    ``argmax`` so it traces without data-dependent control flow.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate 4*q*q_i vectors; the one with the largest pivot is exact.
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    pivots = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    case = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4, 4)
    q = jnp.take_along_axis(cands, case[..., None, None].astype(jnp.int32), axis=-2)
    q = q[..., 0, :]
    return quat_normalize(q)


def quat_exp(theta: Array) -> Array:
    """so(3) tangent -> unit quaternion: exp([0, theta/2]).

    Matches ``Utility::deltaQ`` (``utility.h:8-33``) including the Taylor
    fallback for small angles. Autodiff-safe at theta == 0: the sqrt is
    guarded (double-where) so jacobians of retractions at the identity
    don't produce NaNs.
    """
    sq = jnp.sum(theta * theta, axis=-1, keepdims=True)
    small = sq < 1e-12
    safe_sq = jnp.where(small, 1.0, sq)
    angle = jnp.sqrt(safe_sq)
    half = 0.5 * angle
    # sin(t/2)/t with Taylor fallback 0.5 - t^2/48 + t^4/3840
    sinc_half = jnp.where(small, 0.5 - sq / 48.0 + sq * sq / 3840.0,
                          jnp.sin(half) / angle)
    # cos(t/2) with Taylor fallback 1 - t^2/8 + t^4/384
    w = jnp.where(small, 1.0 - sq / 8.0 + sq * sq / 384.0, jnp.cos(half))
    xyz = sinc_half * theta
    return jnp.concatenate([w, xyz], axis=-1)


def quat_log(q: Array) -> Array:
    """Unit quaternion -> so(3) tangent (inverse of quat_exp).

    Autodiff-safe at the identity (guarded sqrt)."""
    q = jnp.where(q[..., 0:1] < 0, -q, q)  # take the short way around
    w = jnp.clip(q[..., 0:1], -1.0, 1.0)
    vsq = jnp.sum(q[..., 1:4] ** 2, axis=-1, keepdims=True)
    small = vsq < 1e-18
    vnorm = jnp.sqrt(jnp.where(small, 1.0, vsq))
    angle = 2.0 * jnp.arctan2(vnorm, w)
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-12), angle / vnorm)
    return scale * q[..., 1:4]


def quat_slerp(q0: Array, q1: Array, s: Array) -> Array:
    """Spherical interpolation from q0 (s=0) to q1 (s=1), batched.

    Mirrors Eigen's slerp semantics used by the deskew interpolation
    (``scan_undistortion.cc:38``): takes the shortest arc, falls back to
    lerp for nearly-parallel quaternions.
    """
    s = jnp.asarray(s)[..., None] if jnp.ndim(s) == jnp.ndim(q0) - 1 else jnp.asarray(s)
    dot = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(dot < 0, -q1, q1)
    dot = jnp.abs(dot)
    dot = jnp.clip(dot, -1.0, 1.0)
    theta = jnp.arccos(dot)
    sin_theta = jnp.sin(theta)
    near = sin_theta < 1e-6
    w0 = jnp.where(near, 1.0 - s, jnp.sin((1.0 - s) * theta) / jnp.where(near, 1.0, sin_theta))
    w1 = jnp.where(near, s, jnp.sin(s * theta) / jnp.where(near, 1.0, sin_theta))
    return quat_normalize(w0 * q0 + w1 * q1)


def quat_from_two_vectors(a: Array, b: Array) -> Array:
    """Shortest-arc quaternion rotating a onto b (Eigen FromTwoVectors)."""
    a = a / jnp.maximum(jnp.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    b = b / jnp.maximum(jnp.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    c = jnp.cross(a, b)
    d = jnp.sum(a * b, axis=-1, keepdims=True)
    w = 1.0 + d
    # antiparallel fallback: rotate pi around any axis orthogonal to a
    ortho = jnp.cross(a, jnp.where(jnp.abs(a[..., 0:1]) < 0.9,
                                   jnp.array([1.0, 0.0, 0.0], a.dtype),
                                   jnp.array([0.0, 1.0, 0.0], a.dtype)))
    anti = (w < 1e-8)
    q = jnp.where(anti, jnp.concatenate([jnp.zeros_like(w), ortho], axis=-1),
                  jnp.concatenate([w, c], axis=-1))
    return quat_normalize(q)


def skew(v: Array) -> Array:
    """Skew-symmetric (cross-product) matrix: (..., 3) -> (..., 3, 3).

    Same as ``Utility::skewSymmetric`` (``utility.h:35-44``).
    """
    x, y, z = jnp.moveaxis(v, -1, 0)
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def quat_left(q: Array) -> Array:
    """Left-multiplication matrix: quat_multiply(q, p) == Qleft(q) @ p.

    Operates on [w,x,y,z] column vectors (the reference's ``Qleft``
    at ``utility.h:57-66`` uses [x,y,z,w]; only the basis ordering differs).
    """
    w = q[..., 0]
    v = q[..., 1:4]
    top = jnp.concatenate([w[..., None, None], -v[..., None, :]], axis=-1)
    bottom = jnp.concatenate(
        [v[..., :, None], w[..., None, None] * jnp.eye(3, dtype=q.dtype) + skew(v)], axis=-1
    )
    return jnp.concatenate([top, bottom], axis=-2)


def quat_right(q: Array) -> Array:
    """Right-multiplication matrix: quat_multiply(p, q) == Qright(q) @ p."""
    w = q[..., 0]
    v = q[..., 1:4]
    top = jnp.concatenate([w[..., None, None], -v[..., None, :]], axis=-1)
    bottom = jnp.concatenate(
        [v[..., :, None], w[..., None, None] * jnp.eye(3, dtype=q.dtype) - skew(v)], axis=-1
    )
    return jnp.concatenate([top, bottom], axis=-2)


# ---------------------------------------------------------------------------
# SE(3) poses
# ---------------------------------------------------------------------------


class Pose(NamedTuple):
    """SE(3) pose: x_world = R(q) @ x_local + t. Batched over leading dims."""

    t: Array  # (..., 3)
    q: Array  # (..., 4) [w,x,y,z]

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "Pose":
        t = jnp.zeros(batch_shape + (3,), dtype)
        q = jnp.broadcast_to(quat_identity(dtype), batch_shape + (4,))
        return Pose(t, q)

    def compose(self, other: "Pose") -> "Pose":
        """self * other (apply other first, then self). Normalizes like
        the reference's ``Rigid3::operator*`` (rigid_transform.h:105-111)."""
        return Pose(
            t=quat_rotate(self.q, other.t) + self.t,
            q=quat_normalize(quat_multiply(self.q, other.q)),
        )

    def inverse(self) -> "Pose":
        qinv = quat_conjugate(self.q)
        return Pose(t=-quat_rotate(qinv, self.t), q=qinv)

    def apply(self, points: Array) -> Array:
        """Transform points (..., N, 3) or (..., 3) by this pose."""
        if points.ndim >= 2 and self.q.ndim == 1:
            # one pose, many points: one matmul, which must run at f32
            # precision (core.precision) — at 50 m range reduced-precision
            # inputs round to centimetres
            R = quat_to_matrix(self.q)
            return points @ R.T + self.t
        return quat_rotate(self.q, points) + self.t

    def retract(self, delta: Array) -> "Pose":
        """Right-plus with a 6-vector [dt(3), dtheta(3)].

        Matches ``PoseLocalParameterization::Plus``
        (``pose_local_parameterization.cc:6-21``): t += dt, q = q * exp(dθ).
        """
        return Pose(
            t=self.t + delta[..., 0:3],
            q=quat_normalize(quat_multiply(self.q, quat_exp(delta[..., 3:6]))),
        )

    def local(self, other: "Pose") -> Array:
        """Right-minus: 6-vector d with self.retract(d) == other."""
        dq = quat_multiply(quat_conjugate(self.q), other.q)
        return jnp.concatenate([other.t - self.t, quat_log(dq)], axis=-1)

    def to_vec7(self) -> Array:
        """[t(3), qx, qy, qz, qw] layout of Rigid3::ToVector7
        (rigid_transform.h:59-64)."""
        return jnp.concatenate(
            [self.t, self.q[..., 1:4], self.q[..., 0:1]], axis=-1
        )

    @staticmethod
    def from_vec7(v: Array) -> "Pose":
        q = jnp.concatenate([v[..., 6:7], v[..., 3:6]], axis=-1)
        return Pose(t=v[..., 0:3], q=quat_normalize(q))

    def matrix(self) -> Array:
        """(..., 4, 4) homogeneous matrix."""
        R = quat_to_matrix(self.q)
        top = jnp.concatenate([R, self.t[..., :, None]], axis=-1)
        bottom = jnp.broadcast_to(
            jnp.array([0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype),
            self.t.shape[:-1] + (4,),
        )[..., None, :]
        return jnp.concatenate([top, bottom], axis=-2)

    @staticmethod
    def from_matrix(m: Array) -> "Pose":
        return Pose(t=m[..., 0:3, 3], q=matrix_to_quat(m[..., 0:3, 0:3]))

    def astype(self, dtype) -> "Pose":
        return Pose(self.t.astype(dtype), self.q.astype(dtype))
