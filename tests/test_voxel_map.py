"""Voxel hash map: insert/query semantics vs brute force, leaf dedup,
slab overflow, incremental growth."""

import jax.numpy as jnp
import numpy as np

from msf_loam_tpu.slam import voxel_map

RNG = np.random.default_rng(21)


def _new_map():
    return voxel_map.create_map(table_size=1 << 12, slab_capacity=32,
                                cell_size=2.0, leaf=0.2)


def test_insert_then_query_finds_nearest():
    m = _new_map()
    pts = RNG.uniform(-10, 10, size=(2000, 3)).astype(np.float32)
    m = voxel_map.insert(m, jnp.asarray(pts), jnp.ones(2000, bool))

    q = RNG.uniform(-9, 9, size=(64, 3)).astype(np.float32)
    d2, nxyz, valid = voxel_map.query_knn(m, jnp.asarray(q), jnp.ones(64, bool), k=5)
    d2, nxyz, valid = np.asarray(d2), np.asarray(nxyz), np.asarray(valid)

    # compare against brute-force over the points actually stored in the map
    stored = np.asarray(m.points).reshape(-1, 3)
    occ = (np.arange(m.slab_capacity)[None, :] < np.asarray(m.count)[:, None]).reshape(-1)
    stored = stored[occ]
    for i in range(64):
        bf = np.sort(((stored - q[i]) ** 2).sum(1))[:5]
        # within-cell-neighborhood neighbors must match brute force whenever
        # the true NN is within one cell (cell 2.0 >> typical NN dist here)
        if valid[i, 0] and bf[0] < 1.0:
            np.testing.assert_allclose(d2[i, 0], bf[0], rtol=1e-3, atol=1e-4)


def test_leaf_dedup_on_insert():
    m = _new_map()
    # 100 copies of nearly the same point (placed mid-voxel) -> one stored
    center = np.array([0.1, 0.1, 0.1])
    pts = (center + RNG.normal(size=(100, 3)) * 0.001).astype(np.float32)
    m = voxel_map.insert(m, jnp.asarray(pts), jnp.ones(100, bool))
    assert int(m.total_points()) == 1


def test_dedup_across_inserts():
    m = _new_map()
    pts = RNG.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    m = voxel_map.insert(m, jnp.asarray(pts), jnp.ones(500, bool))
    n1 = int(m.total_points())
    # inserting the same points again must not grow the map
    m = voxel_map.insert(m, jnp.asarray(pts), jnp.ones(500, bool))
    assert int(m.total_points()) == n1


def test_masked_points_not_inserted():
    m = _new_map()
    pts = RNG.uniform(-5, 5, size=(100, 3)).astype(np.float32)
    mask = np.zeros(100, bool)
    mask[:10] = True
    m = voxel_map.insert(m, jnp.asarray(pts), jnp.asarray(mask))
    assert int(m.total_points()) <= 10


def test_slab_overflow_drops_not_corrupts():
    m = voxel_map.create_map(table_size=8, slab_capacity=4, cell_size=100.0,
                             leaf=0.01)
    # all points in one cell, far more than capacity
    pts = RNG.uniform(-1, 1, size=(100, 3)).astype(np.float32)
    m = voxel_map.insert(m, jnp.asarray(pts), jnp.ones(100, bool))
    assert int(m.count.max()) <= 4
    d2, nxyz, valid = voxel_map.query_knn(m, jnp.zeros((1, 3)), jnp.ones(1, bool), k=4)
    assert bool(valid[0, 0])


def test_query_empty_map():
    m = _new_map()
    d2, nxyz, valid = voxel_map.query_knn(m, jnp.zeros((4, 3)), jnp.ones(4, bool), k=5)
    assert not np.asarray(valid).any()


def test_neighbors_across_cell_boundary():
    m = _new_map()
    # two points in adjacent cells, query between them
    pts = np.array([[1.99, 0, 0], [2.01, 0, 0]], np.float32)
    m = voxel_map.insert(m, jnp.asarray(pts), jnp.ones(2, bool))
    d2, nxyz, valid = voxel_map.query_knn(m, jnp.asarray([[2.0, 0, 0]]),
                                          jnp.ones(1, bool), k=2)
    assert bool(valid[0, 0]) and bool(valid[0, 1])
    np.testing.assert_allclose(np.asarray(d2[0]).sum(), 2 * 0.01 ** 2, atol=1e-5)


def test_evict_far_releases_distant_cells():
    m = _new_map()
    near = RNG.uniform(-5, 5, size=(200, 3)).astype(np.float32)
    far = (RNG.uniform(-5, 5, size=(200, 3)) + 500.0).astype(np.float32)
    m = voxel_map.insert(m, jnp.asarray(near), jnp.ones(200, bool))
    m = voxel_map.insert(m, jnp.asarray(far), jnp.ones(200, bool))
    total_before = int(m.total_points())
    m = voxel_map.evict_far(m, jnp.zeros(3), radius=100.0)
    total_after = int(m.total_points())
    assert total_after < total_before
    # near points still queryable, far gone
    d2, _, valid = voxel_map.query_knn(m, jnp.asarray(near[:8]),
                                       jnp.ones(8, bool), k=1)
    assert bool(np.asarray(valid).any())
    d2, _, valid = voxel_map.query_knn(m, jnp.asarray(far[:8]),
                                       jnp.ones(8, bool), k=1)
    assert not bool(np.asarray(valid).any())
    # released slots are reusable
    m = voxel_map.insert(m, jnp.asarray(far[:50]), jnp.ones(50, bool))
    d2, _, valid = voxel_map.query_knn(m, jnp.asarray(far[:8]),
                                       jnp.ones(8, bool), k=1)
    assert bool(np.asarray(valid).any())


def test_evict_far_is_collision_proof():
    # Tiny table so far and near points are guaranteed to share slots via
    # hash collisions: per-POINT eviction must keep every near point and
    # drop every far one regardless of slab cohabitation.
    m = voxel_map.create_map(table_size=8, slab_capacity=64,
                             cell_size=2.0, leaf=0.2)
    near = RNG.uniform(-5, 5, size=(40, 3)).astype(np.float32)
    far = (RNG.uniform(-5, 5, size=(40, 3)) + 500.0).astype(np.float32)
    m = voxel_map.insert(m, jnp.asarray(far), jnp.ones(40, bool))
    m = voxel_map.insert(m, jnp.asarray(near), jnp.ones(40, bool))
    stored_before = _stored(m)
    n_near_before = int((np.linalg.norm(stored_before, axis=1) < 100).sum())
    m = voxel_map.evict_far(m, jnp.zeros(3), radius=100.0)
    stored = _stored(m)
    dist = np.linalg.norm(stored, axis=1)
    assert (dist <= 100.0).all()                       # all far points gone
    assert (dist < 100.0).sum() == n_near_before       # no near point lost


def _stored(m):
    pts = np.asarray(m.points).reshape(-1, 3)
    occ = (np.arange(m.slab_capacity)[None, :]
           < np.asarray(m.count)[:, None]).reshape(-1)
    return pts[occ]


def test_evicted_slabs_stay_queryable_and_insertable():
    m = voxel_map.create_map(table_size=8, slab_capacity=64,
                             cell_size=2.0, leaf=0.2)
    near = RNG.uniform(-3, 3, size=(30, 3)).astype(np.float32)
    far = (RNG.uniform(-3, 3, size=(30, 3)) + 300.0).astype(np.float32)
    m = voxel_map.insert(m, jnp.asarray(far), jnp.ones(30, bool))
    m = voxel_map.insert(m, jnp.asarray(near), jnp.ones(30, bool))
    m = voxel_map.evict_far(m, jnp.zeros(3), radius=100.0)
    # near survivors answer queries
    _, _, valid = voxel_map.query_knn(m, jnp.asarray(near[:8]),
                                      jnp.ones(8, bool), k=1)
    assert bool(np.asarray(valid).any())
    # compacted slabs accept new inserts and dedup still works (leaf keys
    # beyond the compacted count were invalidated)
    m2 = voxel_map.insert(m, jnp.asarray(near), jnp.ones(30, bool))
    assert int(m2.total_points()) == int(m.total_points())  # all dups
    m3 = voxel_map.insert(m, jnp.asarray(far[:10]), jnp.ones(10, bool))
    assert int(m3.total_points()) > int(m.total_points())


def test_query_knn_2r_strict_matches_query_knn_and_wide_superset():
    """The strict half of the two-radius query must be bit-identical to
    query_knn; the wide half must (a) contain every strict hit and (b)
    find cross-ring points outside the strict radius but within cell_size."""
    m = _new_map()
    pts = RNG.uniform(-10, 10, size=(3000, 3)).astype(np.float32)
    m = voxel_map.insert(m, jnp.asarray(pts), jnp.ones(3000, bool))
    q = RNG.uniform(-9, 9, size=(64, 3)).astype(np.float32)
    qm = jnp.ones(64, bool)

    d2_ref, xyz_ref, v_ref = voxel_map.query_knn(m, jnp.asarray(q), qm, k=5)
    d2, xyz, v, d2w, xyzw, vw = voxel_map.query_knn_2r(
        m, jnp.asarray(q), qm, k=5, k2=16)
    np.testing.assert_array_equal(np.asarray(d2), np.asarray(d2_ref))
    np.testing.assert_array_equal(np.asarray(v), np.asarray(v_ref))

    for i in range(64):
        strict = set(map(tuple, np.asarray(xyz[i])[np.asarray(v[i])].tolist()))
        wide = set(map(tuple, np.asarray(xyzw[i])[np.asarray(vw[i])].tolist()))
        nw = int(np.asarray(vw[i]).sum())
        assert nw == 16 or strict <= wide  # superset unless k2 overflowed
    # wide reaches beyond the strict radius
    r2 = (m.cell_size * 0.5) ** 2
    dw = np.asarray(d2w)[np.asarray(vw)]
    assert (dw > r2).any() and (dw <= m.cell_size ** 2 + 1e-5).all()


def test_empty_coord_tail_invariant():
    """Unoccupied slab entries hold EMPTY_COORD through create/insert/evict
    (a slab entry past the count can then never pass a radius gate)."""
    import numpy as np

    from msf_loam_tpu.slam.voxel_map import (EMPTY_COORD, create_map,
                                             evict_far, insert)

    rng = np.random.default_rng(0)
    m = create_map(256, 8, 2.0, 0.4)

    def check(vm):
        occ = np.arange(vm.slab_capacity)[None, :] < np.asarray(vm.count)[:, None]
        tails = np.asarray(vm.points)[~occ]
        assert tails.size == 0 or bool((tails == EMPTY_COORD).all())

    check(m)
    for step in range(3):
        pts = jnp.asarray(rng.uniform(-30, 30, (500, 3)).astype(np.float32))
        mask = jnp.asarray(rng.uniform(size=500) > 0.2)
        m = insert(m, pts, mask)
        check(m)
        m = evict_far(m, jnp.zeros(3), radius=18.0)
        check(m)
    assert int(m.total_points()) > 0
