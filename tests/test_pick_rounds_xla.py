"""The greedy feature pick rounds (features.run_pick_rounds) on real scans:
per-sector budgets, pickability, the reference's +/-5-neighbour
suppression rule, and the first sharp pick of each sector against a NumPy
argmax (no suppression exists before it, so it must match exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest

from msf_loam_tpu.config import FeatureConfig
from msf_loam_tpu.dataio import preprocess, synthetic
from msf_loam_tpu.ops import features as F

WORLD = synthetic.World.corridor(seed=0, size=12.0)


def _planes(n_rings, seed, cfg, yaw=0.3):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    xyz, ring = synthetic.simulate_scan(
        WORLD, np.array([1.0, 0.4, 0.0]), R, n_rings=n_rings,
        pts_per_ring=1800, noise=0.004, seed=seed)
    img = preprocess.preprocess_scan(xyz, ring, cfg, num_rings=n_rings)
    curv, eligible = F.compute_curvature(img.xyz, img.mask, cfg)
    n_valid = jnp.sum(img.mask.astype(jnp.int32), axis=1)
    sector = F.assign_sectors(eligible, n_valid, cfg)
    gap = F._gap_sq(img.xyz)
    pickable = eligible & ~F.unreliable_mask(img.xyz, img.mask, cfg)
    gate = F.corner_gate_array(curv, eligible, sector, cfg)
    return curv, pickable, sector, gap, gate


def _unbroken(bad_row, i, j):
    lo, hi = min(i, j), max(i, j)
    return not bad_row[lo:hi].any()


SCENES = {
    "16ring": (16, 0, FeatureConfig(max_points_per_ring=2048), 0.3),
    "other_scene": (16, 3, FeatureConfig(max_points_per_ring=2048), 1.2),
    "odd_rings": (12, 1, FeatureConfig(max_points_per_ring=2048), 0.3),
    "nondefault_budget": (16, 2, FeatureConfig(
        max_points_per_ring=2048, sharp_per_sector=3,
        less_sharp_per_sector=15, flat_per_sector=2), 0.3),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_pick_rounds_invariants(scene):
    n_rings, seed, cfg, yaw = SCENES[scene]
    curv, pickable, sector, gap, gate = _planes(n_rings, seed, cfg, yaw)
    corner, flat, suppressed = F.run_pick_rounds(curv, pickable, sector, gap,
                                                 gate, cfg)
    corner, flat = np.asarray(corner), np.asarray(flat)
    suppressed = np.asarray(suppressed)
    curv, pickable = np.asarray(curv), np.asarray(pickable)
    sector, gate = np.asarray(sector), np.asarray(gate)
    bad = np.asarray(gap) > cfg.neighbor_gap_sq
    S, nsup = cfg.num_sectors, cfg.neighbor_suppress
    assert corner.shape == (cfg.less_sharp_per_sector, n_rings, S)
    assert flat.shape == (cfg.flat_per_sector, n_rings, S)
    assert (corner >= 0).sum() > 50 and (flat >= 0).sum() > 50

    for r in range(n_rings):
        cw = corner[:, r, :][corner[:, r, :] >= 0]
        fw = flat[:, r, :][flat[:, r, :] >= 0]
        assert len(np.unique(cw)) == len(cw)
        assert len(np.unique(fw)) == len(fw)
        for slot, sec in zip(*np.nonzero(corner[:, r, :] >= 0)):
            w = corner[slot, r, sec]
            assert pickable[r, w] and sector[r, w] == sec
            assert curv[r, w] > gate[r, w]
            assert suppressed[r, w]
        for slot, sec in zip(*np.nonzero(flat[:, r, :] >= 0)):
            w = flat[slot, r, sec]
            assert pickable[r, w] and sector[r, w] == sec
            assert curv[r, w] < cfg.curvature_threshold
            # flats respect the corner phases' suppression
            assert not suppressed[r, w]
        # no two picks of one class within +/-nsup on an unbroken chain
        for ws in (cw, fw):
            for i in ws:
                for j in ws:
                    if i != j and abs(i - j) <= nsup:
                        assert not _unbroken(bad[r], i, j), (r, i, j)
        # sharp slots are a prefix of each sector's picks
        sharp = corner[:cfg.sharp_per_sector, r, :]
        rest = corner[cfg.sharp_per_sector:, r, :]
        assert not ((sharp < 0).any(axis=0) & (rest >= 0).any(axis=0)).any()

    # round 0 picks each sector's argmax of the gated curvature exactly
    score = np.where(pickable & (curv > gate), curv, -np.inf)
    for r in range(n_rings):
        for s in range(S):
            sec_score = np.where(sector[r] == s, score[r], -np.inf)
            want = int(np.argmax(sec_score)) if np.isfinite(
                sec_score.max()) else -1
            assert corner[0, r, s] == want, (r, s)
