"""Reproduction of an XLA SPMD partitioner defect (jax 0.9.0, CPU backend,
8 virtual devices) that round 1 worked around with an eager-only loop.

Symptom: assemble a block-tridiagonal GN system with dynamic-index
scatter-adds (``zeros.at[idx].add(block)``), feed it to a shard_map Schur
solve (``distributed_woodbury_solve``) — all inside ONE traced program —
and the value delivered to the solve is corrupted at EXACTLY the first row
of every shard except shard 0 (rows 5,10,...,35 for 40 rows on 8 devices),
while the identical math run eagerly (scatter in one dispatch, solve in
another) is bit-correct. jacrev-built Jacobian blocks feeding several
chained scatters appear necessary: simple distillations (single scatter ->
pad -> shard_map with all_gather+psum) pass.

This script embeds the ORIGINAL scatter-based assembly (as shipped in
round 1) so the defect stays reproducible after the production fix: the
live ``posegraph._assemble_chain`` is scatter-free (static pads + one-hot
matmuls), which sidesteps the partitioner entirely.

Run: env JAX_PLATFORMS=cpu \
     XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python scripts/xla_scatter_shardmap_repro.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import functools

import jax
import jax.numpy as jnp
import numpy as np

from msf_loam_tpu.parallel import mesh as mesh_mod
from msf_loam_tpu.parallel.distributed_ba import distributed_woodbury_solve
from msf_loam_tpu.slam import posegraph
from scripts.check_distributed_solve import build_problem


def assemble_chain_scattered(poses, data, cfg, N, rel_val, rel_jac, gps_val,
                             gps_jac):
    """The round-1 scatter-based assembly (verbatim semantics): triggers
    the partitioner defect when its result feeds shard_map under jit."""
    pi = jax.tree.map(lambda a: a[:-1], poses)
    pj = jax.tree.map(lambda a: a[1:], poses)
    z = jnp.zeros((N - 1, 6))
    r_rel = rel_val(z, z, pi, pj, data.rel_meas)
    (Ji, Jj) = rel_jac(z, z, pi, pj, data.rel_meas)
    w_rel = (posegraph._huber_w(r_rel, cfg.huber_delta) * data.rel_valid)

    gi = jax.tree.map(lambda a: a[data.gps_seg], poses)
    gj = jax.tree.map(lambda a: a[data.gps_seg + 1], poses)
    M = data.gps_xyz.shape[0]
    zg = jnp.zeros((M, 6))
    r_gps = gps_val(zg, zg, gi, gj, data.gps_xyz, data.gps_frac)
    (Gi, Gj) = gps_jac(zg, zg, gi, gj, data.gps_xyz, data.gps_frac)
    w_gps = (posegraph._huber_w(r_gps, cfg.huber_delta) * data.gps_valid)

    D = jnp.zeros((N, 6, 6))
    U = jnp.zeros((N - 1, 6, 6))
    b = jnp.zeros((N, 6))
    wJi = Ji * w_rel[:, None, None]
    wJj = Jj * w_rel[:, None, None]
    idx = jnp.arange(N - 1)
    D = D.at[idx].add(jnp.einsum("nri,nrj->nij", wJi, Ji))
    D = D.at[idx + 1].add(jnp.einsum("nri,nrj->nij", wJj, Jj))
    U = U.at[idx].add(jnp.einsum("nri,nrj->nij", wJi, Jj))
    b = b.at[idx].add(jnp.einsum("nri,nr->ni", wJi, r_rel))
    b = b.at[idx + 1].add(jnp.einsum("nri,nr->ni", wJj, r_rel))
    wGi = Gi * w_gps[:, None, None]
    wGj = Gj * w_gps[:, None, None]
    s = data.gps_seg
    D = D.at[s].add(jnp.einsum("mri,mrj->mij", wGi, Gi))
    D = D.at[s + 1].add(jnp.einsum("mri,mrj->mij", wGj, Gj))
    U = U.at[s].add(jnp.einsum("mri,mrj->mij", wGi, Gj))
    b = b.at[s].add(jnp.einsum("mri,mr->mi", wGi, r_gps))
    b = b.at[s + 1].add(jnp.einsum("mri,mr->mi", wGj, r_gps))
    D = D + 1e-4 * jnp.eye(6)[None, :, :] \
        + 1e-6 * jnp.einsum("nii->n", D)[:, None, None] * jnp.eye(6)[None]
    return D, U, b


def gn_step_with(assemble, poses, data, loops, cfg, N, L, solver, capture):
    m = 6 * L
    rel_val, rel_jac, gps_val, gps_jac = posegraph._make_factor_fns(cfg)
    loop_fn = lambda di, dj, pi, pj, meas: posegraph._rel_residual(
        di, dj, pi, pj, meas, cfg.rel_sigma_r, cfg.rel_sigma_t)
    loop_val = jax.vmap(loop_fn, in_axes=(0, 0, 0, 0, 0))
    loop_jac = jax.vmap(jax.jacrev(loop_fn, argnums=(0, 1)),
                        in_axes=(0, 0, 0, 0, 0))

    D, U, b = assemble(poses, data, cfg, N, rel_val, rel_jac, gps_val,
                       gps_jac)
    li = jax.tree.map(lambda a: a[loops.idx_i], poses)
    lj = jax.tree.map(lambda a: a[loops.idx_j], poses)
    zl = jnp.zeros((L, 6))
    r = loop_val(zl, zl, li, lj, loops.meas)
    (Li, Lj) = loop_jac(zl, zl, li, lj, loops.meas)
    w = posegraph._huber_w(r, cfg.huber_delta) * loops.valid
    oh_i = jax.nn.one_hot(loops.idx_i, N, dtype=jnp.float32)
    oh_j = jax.nn.one_hot(loops.idx_j, N, dtype=jnp.float32)
    wLi = Li * w[:, None, None]
    wLj = Lj * w[:, None, None]
    b = b + jnp.einsum("ln,li->ni", oh_i, jnp.einsum("lri,lr->li", wLi, r))
    b = b + jnp.einsum("ln,li->ni", oh_j, jnp.einsum("lri,lr->li", wLj, r))
    sq = jnp.sqrt(w)[:, None, None]
    Wi = jnp.swapaxes(Li * sq, 1, 2)
    Wj = jnp.swapaxes(Lj * sq, 1, 2)
    W = (jnp.einsum("ln,lam->nalm", oh_i, Wi)
         + jnp.einsum("ln,lam->nalm", oh_j, Wj)).reshape(N, 6, m)
    capture["U"] = U
    dx = solver(D, U, -b, W)
    return poses.retract(dx)


def main():
    mesh = mesh_mod.make_mesh(n_map=1, n_data=8)
    poses0, data, loops, cfg = build_problem()
    N = poses0.t.shape[0]
    L = loops.idx_i.shape[0]
    solver = functools.partial(distributed_woodbury_solve, mesh)

    for name, assemble in [
            ("scatter-based (round-1)", assemble_chain_scattered),
            ("scatter-free (current)", posegraph._assemble_chain)]:
        cap_e, cap_j = {}, {}
        step = functools.partial(gn_step_with, assemble)
        eager = step(poses0, data, loops, cfg, N, L, solver, cap_e)

        def traced(p):
            out = step(p, data, loops, cfg, N, L, solver, cap_j)
            return out, cap_j["U"]

        jitted, U_j = jax.jit(traced)(poses0)
        err_pose = float(jnp.max(jnp.abs(jitted.t - eager.t)))
        u_err = np.asarray(jnp.max(jnp.abs(U_j - cap_e["U"]), axis=(1, 2)))
        bad_rows = np.nonzero(u_err > 1.0)[0]
        print(f"{name}: jit-vs-eager pose err {err_pose:.3e}; "
              f"U corrupted rows {bad_rows.tolist()}")


if __name__ == "__main__":
    main()
