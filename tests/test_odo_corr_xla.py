"""Scan-to-scan correspondences (odometry.find_edge_correspondences and
find_plane_correspondences_fit, the XLA distance-matrix reductions)
against a NumPy brute-force a/b/c search over the same scans."""

import jax.numpy as jnp
import numpy as np
import pytest

from msf_loam_tpu.config import FeatureConfig, OdometryConfig
from msf_loam_tpu.core.se3 import Pose, quat_exp
from msf_loam_tpu.dataio import preprocess, synthetic
from msf_loam_tpu.ops import features
from msf_loam_tpu.slam import odometry

FCFG = FeatureConfig(max_points_per_ring=2048, max_less_flat=4096)
OCFG = OdometryConfig()


@pytest.fixture(scope="module")
def scans():
    world = synthetic.World.corridor(seed=0, size=12.0)
    out = []
    for i, t in enumerate(([0.0, 0.0, 0.0], [0.3, 0.05, 0.0])):
        xyz, ring = synthetic.simulate_scan(world, np.asarray(t), np.eye(3),
                                            n_rings=16, pts_per_ring=1800,
                                            noise=0.004, seed=i)
        img = preprocess.preprocess_scan(xyz, ring, FCFG, num_rings=16)
        out.append(features.extract_features(img, jnp.float32(0.1 * i),
                                             FCFG))
    pose = Pose(t=jnp.asarray([0.28, 0.04, 0.01], jnp.float32),
                q=quat_exp(jnp.asarray([0.0, 0.0, 0.01], jnp.float32)))
    return out[0], out[1], pose


def _np(pb):
    return (np.asarray(pb.xyz, np.float64), np.asarray(pb.ring),
            np.asarray(pb.mask))


def _d2(qw, qmask, ref, rmask):
    d2 = ((qw[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
    d2[~(qmask[:, None] & rmask[None, :])] = np.inf
    return d2


def _masked_argmin(d2, mask):
    dm = np.where(mask, d2, np.inf)
    i = np.argmin(dm, axis=1)
    return i, dm[np.arange(len(i)), i]


def _np_plane_fit(nb, ok, tol, cond=0.05):
    center = nb.mean(1)
    c = nb - center[:, None, :]
    ev, V = np.linalg.eigh(np.einsum("nki,nkj->nij", c, c))
    normal = V[..., :, 0]
    resid = np.abs(np.einsum("ni,nki->nk", normal, c))
    valid = ok.all(1) & (resid <= tol).all(1) & (ev[:, 1] > cond * ev[:, 2])
    return center, normal, valid


def test_edge_correspondences_match_bruteforce(scans):
    last, curr, pose = scans
    rx, rring, rmask = _np(last.corner_less_sharp)
    qx, _, qmask = _np(curr.corner_sharp)
    qw = np.asarray(pose.apply(curr.corner_sharp.xyz), np.float64)

    d2 = _d2(qw, qmask, rx, rmask)
    a, a_d = _masked_argmin(d2, True)
    a_ok = (a_d < OCFG.dist_sq_threshold) & qmask
    dr = np.abs(rring[None, :] - rring[a][:, None])
    b, b_d = _masked_argmin(d2, (dr > 0) & (dr <= OCFG.nearby_scan))
    direction = rx[a] - rx[b]
    nrm = np.linalg.norm(direction, axis=1, keepdims=True)
    line_n = direction / np.maximum(nrm, 1e-12)
    d_line = np.linalg.norm(np.cross(line_n, qw - rx[a]), axis=1)
    want = (a_ok & (b_d < OCFG.dist_sq_threshold) & (nrm[:, 0] > 1e-6)
            & (d_line < OCFG.corr_max_resid))

    got = odometry.find_edge_correspondences(
        curr.corner_sharp, last.corner_less_sharp, pose, OCFG)
    valid = np.asarray(got.valid)
    assert want.sum() > 100
    assert (valid == want).mean() >= 0.99
    both = valid & want
    np.testing.assert_allclose(np.asarray(got.line_c)[both], rx[a][both],
                               atol=1e-5)
    cos = np.abs((np.asarray(got.line_n)[both] * line_n[both]).sum(1))
    assert (cos > 1 - 1e-4).mean() >= 0.99


def test_plane_correspondences_fit_match_bruteforce(scans):
    last, curr, pose = scans
    rx, rring, rmask = _np(last.surf_less_flat)
    qx, _, qmask = _np(curr.surf_flat)
    qw = np.asarray(pose.apply(curr.surf_flat.xyz), np.float64)
    thr, near = OCFG.dist_sq_threshold, OCFG.nearby_scan
    n = len(qw)

    d2 = _d2(qw, qmask, rx, rmask)
    a, a_d = _masked_argmin(d2, True)
    a_ok = (a_d < thr) & qmask
    ring_a = rring[a]
    dr = np.abs(rring[None, :] - ring_a[:, None])
    c, c_d = _masked_argmin(d2, (dr > 0) & (dr <= near))
    c_ok = c_d < thr
    # the K=16 nearest candidates; 2 nearest same-ring (not a) and the
    # plane_support_extra nearest nearby-ring among them
    cand = np.argsort(d2, axis=1, kind="stable")[:, :16]
    cd = np.take_along_axis(d2, cand, axis=1)
    cok = cd < thr
    cring = rring[cand]
    same = (cring == ring_a[:, None]) & (cand != a[:, None]) & cok
    nearby = (np.abs(cring - ring_a[:, None]) <= near) & cok

    def first(mask, k):
        idx = np.zeros((n, k), int)
        ok = np.zeros((n, k), bool)
        for i in range(n):
            hits = cand[i][mask[i]][:k]
            idx[i, :len(hits)], ok[i, :len(hits)] = hits, True
        return idx, ok

    b_idx, b_ok = first(same, 2)
    e_idx, e_ok = first(nearby, OCFG.plane_support_extra)
    sup = np.concatenate([a[:, None], b_idx, c[:, None], e_idx], axis=1)
    sup_ok = np.concatenate([a_ok[:, None], b_ok, c_ok[:, None], e_ok], axis=1)
    center, normal, fit_ok = _np_plane_fit(rx[sup], sup_ok,
                                           OCFG.plane_fit_tol)
    resid = np.abs((normal * (qw - center)).sum(1))
    want = a_ok & fit_ok & (resid < OCFG.corr_max_resid)

    got = odometry.find_plane_correspondences_fit(
        curr.surf_flat, last.surf_less_flat, pose, OCFG)
    valid = np.asarray(got.valid)
    assert want.sum() > 100
    assert (valid == want).mean() >= 0.98
    both = valid & want
    close = np.all(np.abs(np.asarray(got.plane_c)[both] - center[both])
                   < 1e-4, axis=1)
    cos = np.abs((np.asarray(got.plane_n)[both] * normal[both]).sum(1))
    assert (close & (cos > 1 - 1e-3)).mean() >= 0.98
