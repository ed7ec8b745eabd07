"""GPS / odometry pose-graph fusion.

Batched redesign of ``GpsFusion``
(``/root/reference/src/slam/gps_fusion/gps_fusion.cc:27-97``) and its
factors (``gps_factor.h:8-61``):

* ``RelativePoseFactor`` — sequential odometry constraint between
  consecutive keyframes, residual = log of (measured relative pose vs
  current relative pose), translation / 0.1, rotation / 0.01;
* ``GpsFactor`` — time-interpolated translation tie between the two poses
  bracketing each GPS fix, / 0.01.

Every factor touches only consecutive poses, so the Gauss-Newton Hessian is
block-tridiagonal; we assemble (diag, off-diag) 6x6 blocks with batched
scatter-adds and solve exactly with a block-Thomas ``lax.scan`` — O(N) per
iteration instead of a general sparse Cholesky (the reference uses Ceres
SPARSE_NORMAL_CHOLESKY with 10 iterations and Huber(1.0), gps_fusion.cc:
42-48). Jacobians come from ``jax.jacrev`` over the factor residual —
exact, and still one fused XLA program.

The distributed variant (segment partition + Schur complement over the
separator poses, psum'd across devices) lives in parallel/distributed_ba.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from msf_loam_tpu.config import PoseGraphConfig
from msf_loam_tpu.core.precision import f32_matmuls
from msf_loam_tpu.core.se3 import (Pose, quat_conjugate, quat_multiply,
                                   quat_normalize, quat_rotate)

Array = jax.Array


class LoopFactors(NamedTuple):
    """Static-shape loop-closure constraints (padded; invalid rows inert).

    The reference's ``PoseGraphEdgeFactor`` (pose_graph_factor.h:10-19) is a
    RelativePoseFactor between non-consecutive keyframes; its
    ``SparsePoseGraph`` never folds them in (empty stub). Here they ARE
    solved: each loop adds a rank-6 off-tridiagonal coupling handled exactly
    by a Woodbury correction to the block-Thomas solve (optimize_with_loops).
    """

    idx_i: Array    # (L,) int32 keyframe index i
    idx_j: Array    # (L,) int32 keyframe index j (> i)
    meas: Pose      # (L,) measured relative pose i->j
    valid: Array    # (L,) bool

    @staticmethod
    def pad(idx_i, idx_j, meas: Pose, to_l: int) -> "LoopFactors":
        l = int(idx_i.shape[0])
        assert to_l >= l
        p = to_l - l
        return LoopFactors(
            idx_i=jnp.concatenate([jnp.asarray(idx_i, jnp.int32),
                                   jnp.zeros(p, jnp.int32)]),
            idx_j=jnp.concatenate([jnp.asarray(idx_j, jnp.int32),
                                   jnp.ones(p, jnp.int32)]),
            meas=Pose(t=jnp.concatenate([meas.t, jnp.zeros((p, 3))]),
                      q=jnp.concatenate([meas.q, jnp.tile(
                          jnp.asarray([1.0, 0, 0, 0]), (p, 1))])),
            valid=jnp.concatenate([jnp.ones(l, bool), jnp.zeros(p, bool)]),
        )


class PoseGraphData(NamedTuple):
    """Static-shape problem data."""

    times: Array        # (N,) keyframe times
    rel_meas: Pose      # (N-1,) measured relative poses (from odometry)
    rel_valid: Array    # (N-1,) bool
    gps_xyz: Array      # (M, 3) fixed points
    gps_seg: Array      # (M,) index i of the bracketing pair (i, i+1)
    gps_frac: Array     # (M,) interpolation fraction in [0, 1]
    gps_valid: Array    # (M,) bool


def build_graph_data(times: Array, poses: Pose, gps_times: Array,
                     gps_xyz: Array, gps_valid: Array) -> PoseGraphData:
    """Derive measured relative poses + GPS bracketing (gps_fusion.cc:58-71)."""
    inv_q = quat_conjugate(poses.q[:-1])
    rel_t = quat_rotate(inv_q, poses.t[1:] - poses.t[:-1])
    rel_q = quat_normalize(quat_multiply(inv_q, poses.q[1:]))
    rel_meas = Pose(t=rel_t, q=rel_q)

    n = times.shape[0]
    seg = jnp.clip(jnp.searchsorted(times, gps_times, side="right") - 1, 0, n - 2)
    t0 = times[seg]
    t1 = times[seg + 1]
    frac = jnp.clip((gps_times - t0) / jnp.maximum(t1 - t0, 1e-9), 0.0, 1.0)
    in_range = (gps_times >= times[0]) & (gps_times <= times[-1])
    return PoseGraphData(
        times=times, rel_meas=rel_meas,
        rel_valid=jnp.ones(n - 1, bool),
        gps_xyz=gps_xyz, gps_seg=seg.astype(jnp.int32), gps_frac=frac,
        gps_valid=gps_valid & in_range,
    )


# ---------------------------------------------------------------------------
# factor residuals (per pair) — autodiff'd for Jacobians
# ---------------------------------------------------------------------------


def _rel_residual(delta_i: Array, delta_j: Array, pose_i: Pose, pose_j: Pose,
                  meas: Pose, sr: float, st: float) -> Array:
    """RelativePoseFactor residual (gps_factor.h:37-48) at retracted poses."""
    pi = pose_i.retract(delta_i)
    pj = pose_j.retract(delta_j)
    pij = pi.inverse().compose(pj)
    res = pij.inverse().compose(meas)
    r_t = res.t / st
    r_r = res.q[1:4] / sr  # quaternion vector part, like the reference
    return jnp.concatenate([r_t, r_r])


def _gps_residual(delta_i: Array, delta_j: Array, pose_i: Pose, pose_j: Pose,
                  gps: Array, frac: Array, st: float) -> Array:
    """GpsFactor residual (gps_factor.h:13-17) at retracted poses."""
    ti = pose_i.t + delta_i[0:3]
    tj = pose_j.t + delta_j[0:3]
    t = (1.0 - frac) * ti + frac * tj
    return (t - gps) / st


class PoseGraphResult(NamedTuple):
    poses: Pose
    initial_cost: Array
    final_cost: Array


@functools.partial(jax.jit, static_argnames=("cfg", "n_iters"))
@f32_matmuls
def optimize(poses0: Pose, data: PoseGraphData, cfg: PoseGraphConfig,
             n_iters: int = 10) -> PoseGraphResult:
    """Batch pose-graph GN with block-tridiagonal exact solve."""
    return _optimize_impl(poses0, data, cfg, n_iters, solve_block_tridiag)


def _make_factor_fns(cfg: PoseGraphConfig):
    rel_fn = lambda di, dj, pi, pj, meas: _rel_residual(
        di, dj, pi, pj, meas, cfg.rel_sigma_r, cfg.rel_sigma_t)
    gps_fn = lambda di, dj, pi, pj, g, f: _gps_residual(
        di, dj, pi, pj, g, f, cfg.gps_sigma_t)
    return (jax.vmap(rel_fn, in_axes=(0, 0, 0, 0, 0)),
            jax.vmap(jax.jacrev(rel_fn, argnums=(0, 1)),
                     in_axes=(0, 0, 0, 0, 0)),
            jax.vmap(gps_fn, in_axes=(0, 0, 0, 0, 0, 0)),
            jax.vmap(jax.jacrev(gps_fn, argnums=(0, 1)),
                     in_axes=(0, 0, 0, 0, 0, 0)))


def _optimize_impl(poses0: Pose, data: PoseGraphData, cfg: PoseGraphConfig,
                   n_iters: int, solver) -> PoseGraphResult:
    N = poses0.t.shape[0]

    rel_val, rel_jac, gps_val, gps_jac = _make_factor_fns(cfg)

    def total_cost(poses):
        return _chain_cost(poses, data, cfg, N, rel_val, gps_val)

    def gn_step(poses, _):
        D, U, b = _assemble_chain(poses, data, cfg, N,
                                  rel_val, rel_jac, gps_val, gps_jac)
        dx = solver(D, U, -b)                                 # (N, 6)
        new_poses = poses.retract(dx)
        return new_poses, None

    initial = total_cost(poses0)
    poses, _ = jax.lax.scan(gn_step, poses0, None, length=n_iters)
    final = total_cost(poses)
    return PoseGraphResult(poses=poses, initial_cost=initial, final_cost=final)


def _chain_cost(poses: Pose, data: PoseGraphData, cfg: PoseGraphConfig,
                N: int, rel_val, gps_val) -> Array:
    pi = jax.tree.map(lambda a: a[:-1], poses)
    pj = jax.tree.map(lambda a: a[1:], poses)
    z = jnp.zeros((N - 1, 6))
    r_rel = rel_val(z, z, pi, pj, data.rel_meas)
    w_rel = _huber_w(r_rel, cfg.huber_delta) * data.rel_valid
    gi = jax.tree.map(lambda a: a[data.gps_seg], poses)
    gj = jax.tree.map(lambda a: a[data.gps_seg + 1], poses)
    zg = jnp.zeros((data.gps_xyz.shape[0], 6))
    r_gps = gps_val(zg, zg, gi, gj, data.gps_xyz, data.gps_frac)
    w_gps = _huber_w(r_gps, cfg.huber_delta) * data.gps_valid
    return (jnp.sum(w_rel * jnp.sum(r_rel ** 2, -1))
            + jnp.sum(w_gps * jnp.sum(r_gps ** 2, -1)))


def _assemble_chain(poses: Pose, data: PoseGraphData, cfg: PoseGraphConfig,
                    N: int, rel_val, rel_jac, gps_val, gps_jac):
    """Weighted GN normal equations of the chain factors as block-tridiag
    (D (N,6,6), U (N-1,6,6), rhs b (N,6)), LM-damped.

    SCATTER-FREE by design: chain terms land via static pads, GPS terms via
    one-hot matmuls. Dynamic-index ``.at[].add`` scatters here were the root
    cause of the round-1 "distributed solve returns garbage under jit"
    defect — when the scatter result is sharded to feed the shard_map Schur
    solve in the same program, XLA's SPMD partitioner corrupts exactly the
    first row of every shard but the first (scripts/bisect_step4.py shows
    the pattern; scripts/xla_scatter_shardmap_repro.py documents the hunt).
    The one-hot form is exact and partitions trivially.
    """
    pi = jax.tree.map(lambda a: a[:-1], poses)
    pj = jax.tree.map(lambda a: a[1:], poses)
    z = jnp.zeros((N - 1, 6))
    r_rel = rel_val(z, z, pi, pj, data.rel_meas)          # (N-1, 6)
    (Ji, Jj) = rel_jac(z, z, pi, pj, data.rel_meas)       # (N-1, 6, 6) x2
    w_rel = (_huber_w(r_rel, cfg.huber_delta) * data.rel_valid)

    gi = jax.tree.map(lambda a: a[data.gps_seg], poses)
    gj = jax.tree.map(lambda a: a[data.gps_seg + 1], poses)
    M = data.gps_xyz.shape[0]
    zg = jnp.zeros((M, 6))
    r_gps = gps_val(zg, zg, gi, gj, data.gps_xyz, data.gps_frac)  # (M, 3)
    (Gi, Gj) = gps_jac(zg, zg, gi, gj, data.gps_xyz, data.gps_frac)
    w_gps = (_huber_w(r_gps, cfg.huber_delta) * data.gps_valid)

    wJi = Ji * w_rel[:, None, None]
    wJj = Jj * w_rel[:, None, None]
    # factor n couples poses (n, n+1): its i-block pads onto rows [0, N-1),
    # its j-block onto rows [1, N) — static concats, no scatter
    pad_tail = lambda x: jnp.concatenate([x, 0.0 * x[:1]], axis=0)
    pad_head = lambda x: jnp.concatenate([0.0 * x[:1], x], axis=0)
    D = pad_tail(jnp.einsum("nri,nrj->nij", wJi, Ji)) \
        + pad_head(jnp.einsum("nri,nrj->nij", wJj, Jj))
    U = jnp.einsum("nri,nrj->nij", wJi, Jj)   # U[i] couples pose i and i+1
    b = pad_tail(jnp.einsum("nri,nr->ni", wJi, r_rel)) \
        + pad_head(jnp.einsum("nri,nr->ni", wJj, r_rel))

    wGi = Gi * w_gps[:, None, None]
    wGj = Gj * w_gps[:, None, None]
    s = data.gps_seg
    oh = jax.nn.one_hot(s, N, dtype=jnp.float32)          # (M, N)
    oh1 = jax.nn.one_hot(s + 1, N, dtype=jnp.float32)
    ohU = jax.nn.one_hot(s, N - 1, dtype=jnp.float32)
    D = D + jnp.einsum("mn,mij->nij", oh,
                       jnp.einsum("mri,mrj->mij", wGi, Gi))
    D = D + jnp.einsum("mn,mij->nij", oh1,
                       jnp.einsum("mri,mrj->mij", wGj, Gj))
    U = U + jnp.einsum("mn,mij->nij", ohU,
                       jnp.einsum("mri,mrj->mij", wGi, Gj))
    b = b + jnp.einsum("mn,mi->ni", oh,
                       jnp.einsum("mri,mr->mi", wGi, r_gps))
    b = b + jnp.einsum("mn,mi->ni", oh1,
                       jnp.einsum("mri,mr->mi", wGj, r_gps))

    # LM damping (also fixes the global gauge the GPS ties leave free)
    D = D + 1e-4 * jnp.eye(6)[None, :, :] \
        + 1e-6 * jnp.einsum("nii->n", D)[:, None, None] * jnp.eye(6)[None]
    return D, U, b


@functools.partial(jax.jit, static_argnames=("cfg", "n_iters"))
@f32_matmuls
def optimize_with_loops(poses0: Pose, data: PoseGraphData, loops: LoopFactors,
                        cfg: PoseGraphConfig, n_iters: int = 10
                        ) -> PoseGraphResult:
    """Pose-graph GN with chain + GPS + loop-closure factors, solved EXACTLY.

    A loop factor between keyframes (i, j) is the reference's
    PoseGraphEdgeFactor (pose_graph_factor.h:10-19) — a RelativePoseFactor
    at non-consecutive indices. It breaks the tridiagonal structure with one
    rank-6 coupling, so the Hessian is H = T + W Wᵀ where T is the chain
    tridiagonal and W stacks the weighted loop Jacobians (6N x 6L, nonzero
    only at block-rows i and j). Woodbury gives the exact solve from the
    machinery we already have:

        y = T⁻¹ b          (block-Thomas scan)
        Z = T⁻¹ W          (same factorization, 6L right-hand sides)
        S = I + Wᵀ Z       (6L x 6L capacitance, dense)
        x = y − Z S⁻¹ Wᵀ y

    — O(N·L) sequential work instead of a general sparse Cholesky, and all
    of it one fused XLA program. Invalid (padded) loops get zero weight, so
    their W columns vanish and S's block is the identity: inert by
    construction, keeping shapes static across detections.

    The distributed variant (optimize_with_loops_distributed) runs the
    whole Woodbury solve as one mesh-sharded Schur-complement program
    (parallel.distributed_ba.distributed_woodbury_solve); the capacitance
    solve stays replicated (6L x 6L is tiny).
    """
    return _optimize_loops_impl(poses0, data, loops, cfg, n_iters,
                                _woodbury_solve)


def _woodbury_solve(D: Array, U: Array, rhs: Array, W: Array) -> Array:
    """(T + W W^T)^-1 rhs via Thomas + capacitance (single device)."""
    m = W.shape[-1]
    y = solve_block_tridiag(D, U, rhs)
    Z = solve_block_tridiag_multi(D, U, W)
    S = jnp.eye(m) + jnp.einsum("nim,nik->mk", W, Z)
    Wty = jnp.einsum("nim,ni->m", W, y)
    return y - jnp.einsum("nim,m->ni", Z, jnp.linalg.solve(S, Wty))


@f32_matmuls
def optimize_with_loops_distributed(mesh, poses0: Pose, data: PoseGraphData,
                                    loops: LoopFactors, cfg: PoseGraphConfig,
                                    n_iters: int = 10) -> PoseGraphResult:
    """Loop-closure pose-graph GN with the whole Woodbury solve (chain
    Thomas + capacitance correction) distributed over the mesh 'data' axis
    as ONE shard_map program (parallel.distributed_ba.
    distributed_woodbury_solve — see its docstring for why the correction
    must live inside the program). Exact; N must satisfy
    optimize_distributed's divisibility contract (pad_graph/next_bucket).

    The GN loop is a single traced ``lax.scan`` like every other solver —
    one program, matching the reference's single Ceres solve
    (gps_fusion.cc:27-97). (A round-1 eager-only workaround lived here; the
    real defect was scatter-adds in ``_assemble_chain`` being mispartitioned
    when feeding the shard_map solve — see its docstring. The assembly is
    now scatter-free and the composed program is correct under jit/scan,
    pinned by test_distributed_loop_posegraph_matches_single_device.)"""
    from msf_loam_tpu.parallel.distributed_ba import distributed_woodbury_solve

    return _optimize_loops_impl(
        poses0, data, loops, cfg, n_iters,
        functools.partial(distributed_woodbury_solve, mesh))


def _optimize_loops_impl(poses0: Pose, data: PoseGraphData,
                         loops: LoopFactors, cfg: PoseGraphConfig,
                         n_iters: int, woodbury_solver) -> PoseGraphResult:
    N = poses0.t.shape[0]
    L = loops.idx_i.shape[0]
    assert L > 0, "pad loops to at least 1 slot (LoopFactors.pad); " \
                  "invalid slots are inert"
    m = 6 * L
    rel_val, rel_jac, gps_val, gps_jac = _make_factor_fns(cfg)

    loop_fn = lambda di, dj, pi, pj, meas: _rel_residual(
        di, dj, pi, pj, meas, cfg.rel_sigma_r, cfg.rel_sigma_t)
    loop_val = jax.vmap(loop_fn, in_axes=(0, 0, 0, 0, 0))
    loop_jac = jax.vmap(jax.jacrev(loop_fn, argnums=(0, 1)),
                        in_axes=(0, 0, 0, 0, 0))

    def loop_terms(poses):
        li = jax.tree.map(lambda a: a[loops.idx_i], poses)
        lj = jax.tree.map(lambda a: a[loops.idx_j], poses)
        zl = jnp.zeros((L, 6))
        r = loop_val(zl, zl, li, lj, loops.meas)              # (L, 6)
        (Li, Lj) = loop_jac(zl, zl, li, lj, loops.meas)       # (L, 6, 6) x2
        w = _huber_w(r, cfg.huber_delta) * loops.valid
        return r, Li, Lj, w

    def gn_step(poses, _):
        D, U, b = _assemble_chain(poses, data, cfg, N,
                                  rel_val, rel_jac, gps_val, gps_jac)
        r, Li, Lj, w = loop_terms(poses)

        # Loop contributions are dense one-hot matmuls, NOT scatter-adds,
        # for the same reason _assemble_chain is scatter-free: an
        # ``at[idx].add`` whose result feeds the shard_map solve in the
        # same program mispartitions silently (first row of every shard
        # corrupted — see _assemble_chain's docstring). The one-hot form
        # is exact and tiny (L x N). Padded loops have
        # w = 0, so their one-hot rows contribute nothing.
        oh_i = jax.nn.one_hot(loops.idx_i, N, dtype=jnp.float32)  # (L, N)
        oh_j = jax.nn.one_hot(loops.idx_j, N, dtype=jnp.float32)

        # rhs gets the loop gradient directly
        wLi = Li * w[:, None, None]
        wLj = Lj * w[:, None, None]
        b = b + jnp.einsum("ln,li->ni", oh_i,
                           jnp.einsum("lri,lr->li", wLi, r))
        b = b + jnp.einsum("ln,li->ni", oh_j,
                           jnp.einsum("lri,lr->li", wLj, r))

        # W (N, 6, 6L): column block l holds sqrt(w_l)·J_l^T at rows i_l, j_l
        sq = jnp.sqrt(w)[:, None, None]
        Wi = jnp.swapaxes(Li * sq, 1, 2)                      # (L, 6state, 6res)
        Wj = jnp.swapaxes(Lj * sq, 1, 2)
        W = (jnp.einsum("ln,lam->nalm", oh_i, Wi)
             + jnp.einsum("ln,lam->nalm", oh_j, Wj)).reshape(N, 6, m)

        dx = woodbury_solver(D, U, -b, W)                     # (N, 6)
        return poses.retract(dx), None

    def total_cost(poses):
        r, _, _, w = loop_terms(poses)
        chain = _chain_cost(poses, data, cfg, N, rel_val, gps_val)
        return chain + jnp.sum(w * jnp.sum(r * r, -1))

    initial = total_cost(poses0)
    poses, _ = jax.lax.scan(gn_step, poses0, None, length=n_iters)
    final = total_cost(poses)
    return PoseGraphResult(poses=poses, initial_cost=initial, final_cost=final)


@f32_matmuls
def optimize_distributed(mesh, poses0: Pose, data: PoseGraphData,
                         cfg: PoseGraphConfig, n_iters: int = 10
                         ) -> PoseGraphResult:
    """Pose-graph GN with the block-tridiagonal solve distributed over the
    mesh 'data' axis (Schur complement over segment separators,
    parallel/distributed_ba) — the config-5 'distributed BA' applied to the
    real GPS-fusion graph. Assembly/retraction run replicated; only the
    O(N) sequential solve parallelizes (it dominates at KITTI-scale N).

    N must be divisible by the device count with segments >= 2; use
    pad_graph/next_bucket to size the graph.
    """
    from msf_loam_tpu.parallel.distributed_ba import distributed_tridiag_solve

    solver = functools.partial(distributed_tridiag_solve, mesh)
    return _optimize_impl(poses0, data, cfg, n_iters, solver)


def pad_graph(poses: Pose, data: PoseGraphData, to_n: int
              ) -> Tuple[Pose, PoseGraphData]:
    """Pad a graph to ``to_n`` poses so jit programs bucket by size class
    instead of compiling per trajectory length.

    Padding poses chain to the last real pose with identity relative
    measurements and rel_valid=True — they stay glued to it and never
    affect real poses (no GPS ties land on them)."""
    n = poses.t.shape[0]
    assert to_n >= n
    pad = to_n - n
    if pad == 0:
        return poses, data
    last_t = jnp.broadcast_to(poses.t[-1], (pad, 3))
    last_q = jnp.broadcast_to(poses.q[-1], (pad, 4))
    poses_p = Pose(t=jnp.concatenate([poses.t, last_t]),
                   q=jnp.concatenate([poses.q, last_q]))
    dt = 1.0
    times_p = jnp.concatenate([
        data.times, data.times[-1] + dt * (1.0 + jnp.arange(pad))])
    rel_pad = Pose.identity((pad,))
    rel_meas_p = Pose(t=jnp.concatenate([data.rel_meas.t, rel_pad.t]),
                      q=jnp.concatenate([data.rel_meas.q, rel_pad.q]))
    rel_valid_p = jnp.concatenate([data.rel_valid, jnp.ones(pad, bool)])
    return poses_p, data._replace(times=times_p, rel_meas=rel_meas_p,
                                  rel_valid=rel_valid_p)


def next_bucket(n: int, buckets=(64, 128, 256, 512, 1024, 2048, 4096, 8192)
                ) -> int:
    """Smallest standard size class >= n."""
    for b in buckets:
        if b >= n:
            return b
    return n


def _huber_w(r: Array, delta: float) -> Array:
    nrm = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-30)
    return jnp.minimum(1.0, delta / nrm)


def solve_block_tridiag(D: Array, U: Array, b: Array) -> Array:
    """Exact solve of a symmetric block-tridiagonal system via the block
    Thomas algorithm (sequential lax.scan — O(N) 6x6 ops).

    H = tridiag(U^T, D, U); returns x with H x = b.

    Scan inits/pads are derived from the operands (``0 * x`` instead of
    fresh ``jnp.zeros``) so they inherit the operands' varying-manual-axes
    type — this keeps the solver VMA-clean when called on device-varying
    data inside ``shard_map`` (parallel/distributed_ba.py separator solve).
    """
    N = D.shape[0]

    def fwd(carry, inp):
        Dt_prev, bt_prev = carry
        D_i, U_prev, b_i = inp
        # L = U_prev^T inv(Dt_prev); Dt is symmetric so
        # (inv(Dt) U)^T == U^T inv(Dt)
        L = jnp.linalg.solve(Dt_prev, U_prev).T
        Dt_i = D_i - L @ U_prev
        bt_i = b_i - L @ bt_prev
        return (Dt_i, bt_i), (Dt_i, bt_i)

    # pad U with zeros for the first step
    zU = 0.0 * D[:1]
    U_pad = jnp.concatenate([zU, U], axis=0)
    (_, _), (Dt, bt) = jax.lax.scan(
        fwd, (jnp.eye(6) + 0.0 * D[0], 0.0 * b[0]), (D, U_pad, b))

    def bwd(x_next, inp):
        Dt_i, bt_i, U_i = inp
        x_i = jnp.linalg.solve(Dt_i, bt_i - U_i @ x_next)
        return x_i, x_i

    U_pad_end = jnp.concatenate([U, zU], axis=0)
    _, xs = jax.lax.scan(bwd, 0.0 * b[0], (Dt, bt, U_pad_end), reverse=True)
    return xs


def solve_block_tridiag_multi(D: Array, U: Array, B: Array) -> Array:
    """Block-Thomas with m simultaneous right-hand sides: B (N, 6, m) ->
    X (N, 6, m) with tridiag(U^T, D, U) X[:, :, k] = B[:, :, k]. One
    factorization sweep shared by all columns (used by the Woodbury loop
    solve, where m = 6·n_loops). VMA-clean like solve_block_tridiag."""

    def fwd(carry, inp):
        Dt_prev, Bt_prev = carry
        D_i, U_prev, B_i = inp
        L = jnp.linalg.solve(Dt_prev, U_prev).T
        Dt_i = D_i - L @ U_prev
        Bt_i = B_i - L @ Bt_prev
        return (Dt_i, Bt_i), (Dt_i, Bt_i)

    zU = 0.0 * D[:1]
    U_pad = jnp.concatenate([zU, U], axis=0)
    (_, _), (Dt, Bt) = jax.lax.scan(
        fwd, (jnp.eye(6) + 0.0 * D[0], 0.0 * B[0]), (D, U_pad, B))

    def bwd(X_next, inp):
        Dt_i, Bt_i, U_i = inp
        X_i = jnp.linalg.solve(Dt_i, Bt_i - U_i @ X_next)
        return X_i, X_i

    U_pad_end = jnp.concatenate([U, zU], axis=0)
    _, Xs = jax.lax.scan(bwd, 0.0 * B[0], (Dt, Bt, U_pad_end),
                         reverse=True)
    return Xs
