"""Batched LOAM feature extraction.

Batched redesign of the reference's scan registration stage
(``/root/reference/src/msf_loam_node.cc:160-378``):

* curvature = squared norm of an 11-tap [1,1,1,1,1,-10,1,1,1,1,1] filter per
  axis (``msf_loam_node.cc:206-240``) — here a stack of shifted adds the XLA
  fuser turns into one vectorized pass;
* per-(ring, sector) greedy max/min-curvature picks with ±5-neighbor
  suppression (``msf_loam_node.cc:251-344``) — here a short ``lax.scan``
  over pick rounds where every (ring, sector) picks in parallel and the
  suppression masks are merged each round. The serial pick order of the
  reference is deliberately NOT reproduced point-for-point; equivalence is
  held at trajectory level (SURVEY.md §7.3).

Input is a ``RingImage``: per-ring, azimuth-ordered, front-packed rows
(the tensorized analog of the reference's per-ring vectors).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from msf_loam_tpu.config import FeatureConfig
from msf_loam_tpu.core.pointcloud import PointBatch, RingImage, ScanFeatures
from msf_loam_tpu.core.precision import f32_matmuls
from msf_loam_tpu.ops.voxel import voxel_downsample_compact_idx

Array = jax.Array

# a NumPy scalar, not a device array: importing this module must not
# initialise a JAX backend (a producer process that imports the package
# would otherwise reserve the accelerator's memory)
_BIG = np.float32(1e18)


def compute_curvature(xyz: Array, mask: Array, cfg: FeatureConfig) -> Tuple[Array, Array]:
    """11-point curvature per ring row.

    Args:
      xyz:  (R, W, 3) front-packed ring image.
      mask: (R, W) validity.

    Returns:
      curvature: (R, W) float32 — sum of squared per-axis diffs.
      eligible:  (R, W) bool — margin-respecting positions (index in
                 [margin, n_valid - margin - 1]), matching the reference's
                 concatenation bounds (msf_loam_node.cc:192-194).
    """
    m = cfg.edge_margin
    # net center weight after the 0-shift below contributes +1: -(2m+1)+1 = -2m
    acc = -(2 * m + 1) * xyz
    for s in range(-m, m + 1):
        acc = acc + jnp.roll(xyz, -s, axis=1)
    curv = jnp.sum(acc * acc, axis=-1)

    n_valid = jnp.sum(mask.astype(jnp.int32), axis=1, keepdims=True)  # (R, 1)
    idx = jnp.arange(xyz.shape[1])[None, :]
    eligible = (idx >= m) & (idx <= n_valid - m - 1) & mask
    return curv, eligible


def _prefix_sum_lanes(x: Array) -> Array:
    """Inclusive prefix sum along the last axis (same as jnp.cumsum) via
    log-depth shifted adds: 11 elementwise passes over a (64, 2048) image
    that fuse with their neighbours."""
    n = x.shape[-1]
    d = 1
    while d < n:
        shifted = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(d, 0)])[..., :n]
        x = x + shifted
        d *= 2
    return x


def assign_sectors(eligible: Array, n_valid: Array, cfg: FeatureConfig) -> Array:
    """Sector id per position: [margin, n-margin-1] split into equal sixths
    (msf_loam_node.cc:255-259). Returns (R, W) int32 in [0, S-1], with
    ineligible positions mapped to -1."""
    m = cfg.edge_margin
    span = jnp.maximum(n_valid[:, None] - 2 * m, 1)  # ep - sp + 1
    idx = jnp.arange(eligible.shape[1])[None, :]
    sector = ((idx - m) * cfg.num_sectors) // span
    sector = jnp.clip(sector, 0, cfg.num_sectors - 1)
    return jnp.where(eligible, sector, -1).astype(jnp.int32)


def unreliable_mask(xyz: Array, mask: Array, cfg: FeatureConfig) -> Array:
    """Occluded-boundary ("veil") and parallel-beam rejection.

    Returns (R, W) bool — True where a point must NOT be picked as a
    feature anchor. Two rules from the original LOAM paper (Zhang & Singh
    RSS'14 §5.1; the A-LOAM-derived reference omits them, but without them
    occlusion boundaries in street scenes — rays grazing a building edge
    onto the surface behind — produce edge points whose 3D position moves
    WITH the sensor and systematically bias the scan-to-map solve backward
    along the travel direction):

    * occlusion: if the next azimuth-adjacent range is closer by more than
      ``occlusion_gap``, the far-side run (the point and its 5 precursors /
      successors) sits on a possibly-occluded grazing boundary;
    * parallel beam: both adjacent ranges differing by more than
      ``parallel_frac`` x range means the beam is nearly parallel to the
      surface and the return is unstable.
    """
    r = jnp.where(mask, jnp.linalg.norm(xyz, axis=-1), 0.0)     # (R, W)
    r_next = jnp.roll(r, -1, axis=1)
    both_valid = mask & jnp.roll(mask, -1, axis=1)
    far_here = both_valid & (r - r_next > cfg.occlusion_gap)    # i is far side
    far_next = both_valid & (r_next - r > cfg.occlusion_gap)    # i+1.. far side
    block = jnp.zeros_like(mask)
    for j in range(0, cfg.edge_margin + 1):
        block = block | jnp.roll(far_here, -j, axis=1)          # i-5 .. i
    for j in range(1, cfg.edge_margin + 2):
        block = block | jnp.roll(far_next, j, axis=1)           # i+1 .. i+6
    d_prev = jnp.abs(jnp.roll(r, 1, axis=1) - r)
    d_next = jnp.abs(r_next - r)
    parallel = (d_prev > cfg.parallel_frac * r) & \
               (d_next > cfg.parallel_frac * r) & mask & \
               jnp.roll(mask, 1, axis=1) & jnp.roll(mask, -1, axis=1)
    return block | parallel


def corner_gate_array(curv: Array, eligible: Array, sector: Array,
                      cfg: FeatureConfig) -> Array:
    """Sector-adaptive corner gate, (R, W): a corner pick must beat BOTH
    the absolute threshold (reference, msf_loam_node.cc:275) and a multiple
    of the sector's smooth-population mean curvature (its noise floor). On
    ground-dominated rings (street scenes) the per-sector top-k otherwise
    has no real edge to pick and promotes pure range-noise spikes — 80% of
    the corner budget became ground noise and biased the mapping solve.

    (R, S, W) layout: W stays the minor (lane) dim, same reasoning as
    _pick_rounds. Shared with scripts/profile_features.py so the profiled
    sub-stage cannot drift from production."""
    S = cfg.num_sectors
    S_oh = (sector[:, None, :] == jnp.arange(S)[None, :, None])   # (R, S, W)
    smooth = eligible & (curv < cfg.curvature_threshold)
    w_sm = (S_oh & smooth[:, None, :]).astype(jnp.float32)
    sec_mean = (jnp.einsum("rsw,rw->rs", w_sm, curv)
                / jnp.maximum(jnp.sum(w_sm, axis=2), 1.0))        # (R, S)
    gate_rs = jnp.maximum(cfg.curvature_threshold,
                          cfg.corner_gate_factor * sec_mean)
    # per-position lookup as S static selects rather than an
    # element-granular (R, W) gather from the (R, S) table; bit-exact
    # (sector -1 falls through to sector 0)
    gate = jnp.broadcast_to(gate_rs[:, 0:1], sector.shape)
    for s in range(1, S):
        gate = jnp.where(sector == s, gate_rs[:, s:s + 1], gate)
    return gate


def _gap_sq(xyz: Array) -> Array:
    """g[i] = ||x[i+1] - x[i]||^2 along the ring (last column is huge)."""
    d = jnp.roll(xyz, -1, axis=1) - xyz
    g = jnp.sum(d * d, axis=-1)
    return g.at[:, -1].set(_BIG)


def _topk_iter(x: Array, k: int) -> Tuple[Array, Array]:
    """Exact top-k along the last axis (ties surface in ascending-index
    order, same as iterative argmax). k == 1 lowers to a plain argmax
    reduction; k > 1 uses ``lax.top_k``."""
    if k == 1:
        i = jnp.argmax(x, axis=-1).astype(jnp.int32)
        v = jnp.take_along_axis(x, i[..., None], axis=-1)[..., 0]
        return v[..., None], i[..., None]
    vals, idxs = jax.lax.top_k(x, k)
    return vals, idxs.astype(jnp.int32)


def _pick_rounds(curv: Array, base_mask: Array, sector: Array, gap: Array,
                 cfg: FeatureConfig, n_total: int, maximize: bool,
                 curv_gate, picks_per_round: int = 5,
                 suppressed0: Array = None):
    """Parallel per-(ring,sector) greedy picks, several per round.

    Each round every sector takes its top ``picks_per_round`` remaining
    candidates at once (one ``lax.top_k``); picks that a HIGHER-curvature
    pick of the same round would have suppressed (within ±neighbor_suppress
    indices with an unbroken gap chain — exactly the reference's
    suppression rule, msf_loam_node.cc:288-303) are dropped, and all
    surviving picks' neighbor suppressions merge into the shared per-ring
    mask before the next round. Collapses the reference's 20-long serial
    greedy pick into ceil(20/T) sequential steps.

    Returns:
      picks:     (n_rounds*T, R, S) int32 — W-index per pick slot (-1 if
                 none), ordered by descending score (round-major).
      suppressed:(R, W) bool — final suppression mask (includes the picks).
    """
    R, W = curv.shape
    S = cfg.num_sectors
    T = picks_per_round
    n_rounds = -(-n_total // T)
    # (R, S, W) layout: W stays the minor dim, so the per-sector top_k
    # reduces along contiguous memory
    sec_onehot = sector[:, None, :] == jnp.arange(S)[None, :, None]  # (R, S, W)

    score = curv if maximize else -curv
    score = jnp.where(base_mask & curv_gate(curv), score, -_BIG)

    # exclusive prefix count of broken gaps: chain a..b unbroken iff
    # cb0[b] - cb0[a] == 0
    bad = (gap > cfg.neighbor_gap_sq).astype(jnp.int32)
    cb0 = _prefix_sum_lanes(bad) - bad  # (R, W)

    def round_fn(suppressed, _):
        avail = jnp.where(suppressed, -_BIG, score)  # (R, W)
        per_sec = jnp.where(sec_onehot, avail[:, None, :], -_BIG)  # (R, S, W)
        vals, idxs = _topk_iter(per_sec, T)          # (R, S, T)
        ok = vals > -_BIG * 0.5

        # within-round pairwise suppression across the whole ring
        fi = idxs.reshape(R, S * T)          # (R, ST) W-indices
        fv = vals.reshape(R, S * T)
        fok = ok.reshape(R, S * T)
        fcb = jnp.take_along_axis(cb0, jnp.maximum(fi, 0), axis=1)
        di = jnp.abs(fi[:, :, None] - fi[:, None, :])         # (R, ST, ST)
        near = (di > 0) & (di <= cfg.neighbor_suppress)
        unbroken = fcb[:, :, None] == fcb[:, None, :]
        # q dominates p if strictly better score, or equal score + lower idx
        better = (fv[:, None, :] > fv[:, :, None]) | (
            (fv[:, None, :] == fv[:, :, None]) & (fi[:, None, :] < fi[:, :, None]))
        dominated = jnp.any(near & unbroken & better & fok[:, None, :], axis=2)
        keep = fok & ~dominated

        # picks + their ±n gap-chain neighbors, scatter-free: position w is
        # newly suppressed iff some surviving pick p of this round has
        # |w - fi_p| <= n with an unbroken gap chain between them
        # (cb0[w] == cb0[fi_p] counts broken links on the open interval;
        # w == fi_p marks the pick itself). A broadcast-compare instead of
        # a scatter, so the whole round stays one elementwise fusion.
        w_pos = jnp.arange(W, dtype=fi.dtype)[None, None, :]   # (1, 1, W)
        near_w = jnp.abs(w_pos - fi[:, :, None]) <= cfg.neighbor_suppress
        chain_w = cb0[:, None, :] == fcb[:, :, None]
        picked_or_sup = jnp.any(near_w & chain_w & keep[:, :, None], axis=1)
        # emit in (T, R, S) order so round-major slots sort by score
        pick_trs = jnp.where(keep, fi, -1).reshape(R, S, T).transpose(2, 0, 1)
        return suppressed | picked_or_sup, pick_trs.astype(jnp.int32)

    if suppressed0 is None:
        suppressed0 = jnp.zeros((R, W), bool)
    # full unroll: rounds are few (<=4) and unrolling lets XLA fuse the
    # mask/top_k chains across rounds instead of round-tripping the scan
    # carry through HBM each iteration
    suppressed, picks = jax.lax.scan(round_fn, suppressed0, None,
                                     length=n_rounds, unroll=True)
    picks = picks.reshape(n_rounds * T, R, S)
    return picks, suppressed


def run_pick_rounds(curv: Array, pickable: Array, sector: Array, gap: Array,
                    corner_gate_arr: Array, cfg: FeatureConfig):
    """All three pick phases (sharp -> less-sharp -> flat, chained
    suppression). Returns (corner_picks (20,R,S), flat_picks (4,R,S),
    suppressed-after-corner-phases) — the latter is what the less-flat
    mask consumes."""
    n_rest = cfg.less_sharp_per_sector - cfg.sharp_per_sector
    corner_gate = lambda c: c > corner_gate_arr
    # corner picks (max curvature, > threshold): the sharp picks stay
    # exact single-pick rounds (they anchor the edge factors); the bulk
    # less-sharp picks batch up in top-6 rounds
    sharp_picks, suppressed = _pick_rounds(
        curv, pickable, sector, gap, cfg,
        n_total=cfg.sharp_per_sector, maximize=True,
        curv_gate=corner_gate, picks_per_round=1,
    )
    rest_picks, suppressed = _pick_rounds(
        curv, pickable, sector, gap, cfg,
        n_total=n_rest, maximize=True, curv_gate=corner_gate,
        picks_per_round=6, suppressed0=suppressed,
    )
    corner_picks = jnp.concatenate([sharp_picks, rest_picks], axis=0)
    # flat picks (min curvature, < threshold): exact single-pick rounds,
    # respecting corner suppression. (Multi-pick flats measurably degrade
    # odometry rotation accuracy — the 4 flat anchors per sector carry the
    # plane constraints; keep them exact.)
    flat_picks, _ = _pick_rounds(
        curv, pickable, sector, gap, cfg,
        n_total=cfg.flat_per_sector, maximize=False,
        curv_gate=lambda c: c < cfg.curvature_threshold,
        picks_per_round=1, suppressed0=suppressed,
    )
    return corner_picks, flat_picks, suppressed


def _gather_picks(ring_image: RingImage, picks: Array, n_keep: int,
                  capacity: int) -> PointBatch:
    """Gather pick rounds 0..n_keep-1 into a flat PointBatch of fixed size.

    picks: (n_rounds, R, S) W-indices, -1 for no pick.
    """
    R = picks.shape[1]
    sel = picks[:n_keep]                       # (n_keep, R, S)
    w_idx = jnp.transpose(sel, (1, 0, 2)).reshape(R, -1)  # (R, n_keep*S)
    valid = w_idx >= 0
    w_safe = jnp.maximum(w_idx, 0)
    gather = lambda a: jnp.take_along_axis(a, w_safe, axis=1)
    xyz = jnp.take_along_axis(ring_image.xyz, w_safe[..., None], axis=1)
    rel = gather(ring_image.rel_time)
    ring = jnp.broadcast_to(jnp.arange(R)[:, None], w_idx.shape)
    pb = PointBatch(
        xyz=xyz.reshape(-1, 3),
        rel_time=rel.reshape(-1),
        ring=ring.reshape(-1).astype(jnp.int32),
        mask=valid.reshape(-1),
    )
    return _pad_or_trim(pb, capacity)


def _pad_or_trim(pb: PointBatch, capacity: int) -> PointBatch:
    n = pb.xyz.shape[0]
    if n == capacity:
        return pb
    if n > capacity:
        # keep valid points first (stable partition by mask)
        order = jnp.argsort(~pb.mask, stable=True)
        take = order[:capacity]
        return PointBatch(pb.xyz[take], pb.rel_time[take], pb.ring[take], pb.mask[take])
    pad = capacity - n
    return PointBatch(
        xyz=jnp.pad(pb.xyz, ((0, pad), (0, 0))),
        rel_time=jnp.pad(pb.rel_time, (0, pad)),
        ring=jnp.pad(pb.ring, (0, pad)),
        mask=jnp.pad(pb.mask, (0, pad)),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
@f32_matmuls
def extract_features(ring_image: RingImage, scan_time: Array,
                     cfg: FeatureConfig) -> ScanFeatures:
    """Full feature extraction: RingImage -> five feature clouds.

    Mirrors the selection budget of the reference (2 sharp / 20 less-sharp /
    4 flat per ring-sector; everything flat-or-unlabeled, voxel-downsampled,
    as less-flat)."""
    R, W, _ = ring_image.xyz.shape
    S = cfg.num_sectors

    curv, eligible = compute_curvature(ring_image.xyz, ring_image.mask, cfg)
    n_valid = jnp.sum(ring_image.mask.astype(jnp.int32), axis=1)
    sector = assign_sectors(eligible, n_valid, cfg)
    gap = _gap_sq(ring_image.xyz)

    # pick anchors must avoid occlusion veils / parallel beams; the dense
    # less-flat cloud keeps them (they are real points on the far surface)
    pickable = eligible & ~unreliable_mask(ring_image.xyz, ring_image.mask,
                                           cfg)

    corner_gate_arr = corner_gate_array(curv, eligible, sector, cfg)

    # named scopes mark the frame's stages in profiler traces
    with jax.named_scope("pick_rounds"):
        corner_picks, flat_picks, suppressed = run_pick_rounds(
            curv, pickable, sector, gap, corner_gate_arr, cfg)

    sharp = _gather_picks(ring_image, corner_picks, cfg.sharp_per_sector,
                          R * S * cfg.sharp_per_sector)
    less_sharp = _gather_picks(ring_image, corner_picks, cfg.less_sharp_per_sector,
                               R * S * cfg.less_sharp_per_sector)
    flat = _gather_picks(ring_image, flat_picks, cfg.flat_per_sector,
                         R * S * cfg.flat_per_sector)

    # less-flat: everything eligible that is not a corner pick / corner
    # neighbor (reference labels those P_SHARP / P_LESS_SHARP and keeps only
    # P_FLAT / P_UNKNOWN in the less-flat cloud, msf_loam_node.cc:270-344).
    # `suppressed` (post corner rounds) == corner picks + their ±5 labeled
    # neighbors, so the mask is exactly eligible-and-not-corner-labeled.
    less_flat_mask = eligible & ~suppressed
    lf_xyz = ring_image.xyz.reshape(-1, 3)
    lf_rel = ring_image.rel_time.reshape(-1)
    lf_ring = jnp.broadcast_to(jnp.arange(R)[:, None], (R, W)).reshape(-1)
    # reference filters less-flat PER RING then concatenates (one VoxelGrid
    # per scan line, msf_loam_node.cc:347-348): salt the voxel key with the
    # ring index so same-voxel points on different rings both survive.
    # Default off: the global filter is trajectory-equivalent and ~2x
    # sparser (A/B measured in docs/RESULTS.md).
    lf_salt = lf_ring if cfg.less_flat_per_ring else None
    lf_idx, lf_valid = voxel_downsample_compact_idx(
        lf_xyz, less_flat_mask.reshape(-1), cfg.less_flat_leaf,
        cfg.max_less_flat, salt=lf_salt)
    lf = PointBatch(
        xyz=lf_xyz[lf_idx], rel_time=lf_rel[lf_idx],
        ring=lf_ring[lf_idx].astype(jnp.int32), mask=lf_valid)

    full = PointBatch(
        xyz=ring_image.xyz.reshape(-1, 3),
        rel_time=ring_image.rel_time.reshape(-1),
        ring=lf_ring.astype(jnp.int32),
        mask=ring_image.mask.reshape(-1),
    )

    return ScanFeatures(
        time=scan_time,
        full=full,
        corner_sharp=sharp,
        corner_less_sharp=less_sharp,
        surf_flat=flat,
        surf_less_flat=lf,
    )


def extract_features_batched(imgs: RingImage, scan_time: Array,
                             cfg: FeatureConfig) -> ScanFeatures:
    """``extract_features`` over a (B, R, W) lane batch by FLATTENING lanes
    into rings instead of vmapping.

    Every stage up to the less-flat filter is ring-row independent
    (curvature taps, sector split, gates, pick rounds, pick gathers all
    operate along W within one ring), so running them once on a
    (B*R, W) image is exactly the per-lane math of ``extract_features``.
    Only the per-lane less-flat voxel compaction vmaps: its dedup sort
    must stay lane-local.

    Not used by the batched pipeline, whose scan body vmaps
    ``extract_features`` instead (the flattened form forces
    (B*R, W) <-> (B, ...) relayouts on the scan-carried clouds). Kept for
    callers whose consumers want flattened-row layouts.

    Returns ScanFeatures whose leaves carry a leading (B,) axis, leaf-
    for-leaf identical to ``jax.vmap(extract_features)`` (pinned by
    tests/test_features.py).
    """
    B, R, W, _ = imgs.xyz.shape
    S = cfg.num_sectors
    xyz = imgs.xyz.reshape(B * R, W, 3)
    mask = imgs.mask.reshape(B * R, W)
    rel = imgs.rel_time.reshape(B * R, W)

    curv, eligible = compute_curvature(xyz, mask, cfg)
    n_valid = jnp.sum(mask.astype(jnp.int32), axis=1)
    sector = assign_sectors(eligible, n_valid, cfg)
    gap = _gap_sq(xyz)
    pickable = eligible & ~unreliable_mask(xyz, mask, cfg)
    corner_gate_arr = corner_gate_array(curv, eligible, sector, cfg)

    corner_picks, flat_picks, suppressed = run_pick_rounds(
        curv, pickable, sector, gap, corner_gate_arr, cfg)

    # within-lane ring index per flattened row: row b*R + r -> r
    ring_row = jnp.tile(jnp.arange(R, dtype=jnp.int32), B)[:, None]  # (BR, 1)

    def gather(picks: Array, n_keep: int) -> PointBatch:
        """_gather_picks on the flattened rows, reshaped to (B, ...) —
        rows are lane-major so lane blocks are contiguous."""
        sel = picks[:n_keep]                              # (n_keep, BR, S)
        w_idx = jnp.transpose(sel, (1, 0, 2)).reshape(B * R, n_keep * S)
        valid = w_idx >= 0
        w_safe = jnp.maximum(w_idx, 0)
        p_xyz = jnp.take_along_axis(xyz, w_safe[..., None], axis=1)
        p_rel = jnp.take_along_axis(rel, w_safe, axis=1)
        p_ring = jnp.broadcast_to(ring_row, w_idx.shape)
        cap = R * n_keep * S
        return PointBatch(
            xyz=p_xyz.reshape(B, cap, 3),
            rel_time=p_rel.reshape(B, cap),
            ring=p_ring.reshape(B, cap),
            mask=valid.reshape(B, cap),
        )

    sharp = gather(corner_picks, cfg.sharp_per_sector)
    less_sharp = gather(corner_picks, cfg.less_sharp_per_sector)
    flat = gather(flat_picks, cfg.flat_per_sector)

    less_flat_mask = (eligible & ~suppressed).reshape(B, R * W)
    lf_xyz = imgs.xyz.reshape(B, R * W, 3)
    lf_rel = imgs.rel_time.reshape(B, R * W)
    lf_ring = jnp.broadcast_to(
        jnp.arange(R, dtype=jnp.int32)[None, :, None], (B, R, W)
    ).reshape(B, R * W)

    def lane_lf(x, m, rng):
        salt = rng if cfg.less_flat_per_ring else None
        return voxel_downsample_compact_idx(
            x, m, cfg.less_flat_leaf, cfg.max_less_flat, salt=salt)

    lf_idx, lf_valid = jax.vmap(lane_lf)(lf_xyz, less_flat_mask, lf_ring)
    lf = PointBatch(
        xyz=jnp.take_along_axis(lf_xyz, lf_idx[..., None], axis=1),
        rel_time=jnp.take_along_axis(lf_rel, lf_idx, axis=1),
        ring=jnp.take_along_axis(lf_ring, lf_idx, axis=1),
        mask=lf_valid,
    )

    full = PointBatch(xyz=lf_xyz, rel_time=lf_rel, ring=lf_ring,
                      mask=imgs.mask.reshape(B, R * W))
    return ScanFeatures(
        time=jnp.broadcast_to(jnp.asarray(scan_time, jnp.float32), (B,)),
        full=full,
        corner_sharp=sharp,
        corner_less_sharp=less_sharp,
        surf_flat=flat,
        surf_less_flat=lf,
    )
