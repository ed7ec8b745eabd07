"""Every frame program runs its matmuls at f32 precision: each
``dot_general`` in the lowered StableHLO carries HIGHEST (an unpinned one
prints DEFAULT and may run in TF32 on a GPU)."""

import re

import jax
import jax.numpy as jnp
import pytest

from msf_loam_tpu.config import (FeatureConfig, ImuConfig, MappingConfig,
                                 MsfLoamConfig)
from msf_loam_tpu.core.pointcloud import RingImage
from msf_loam_tpu.core.se3 import Pose
from msf_loam_tpu.ops import features as feat_mod
from msf_loam_tpu.slam import voxel_map

R, W = 4, 64
CFG = MsfLoamConfig(
    features=FeatureConfig(max_points_per_ring=W, max_less_flat=128),
    mapping=MappingConfig(map_table_size=64, map_cell_capacity=4,
                          max_query_points=32),
    imu=ImuConfig(tight_coupling=True, max_imu_samples=8))
IMG = RingImage(xyz=jnp.zeros((R, W, 3)), rel_time=jnp.zeros((R, W)),
                mask=jnp.zeros((R, W), bool))


def _maps(create=voxel_map.create_map):
    mc = CFG.mapping
    return (create(mc.map_table_size, mc.map_cell_capacity, mc.map_cell_size,
                   mc.line_resolution),
            create(mc.map_table_size, mc.map_cell_capacity, mc.map_cell_size,
                   mc.plane_resolution))


def _lio_tail():
    n = CFG.imu.max_imu_samples
    w = (jnp.zeros(n), jnp.zeros((n, 3)), jnp.zeros((n, 3)),
         jnp.zeros(n, bool))
    return (*w, *w, jnp.zeros(3), jnp.asarray([1.0, 0, 0, 0]), jnp.zeros(3),
            jnp.asarray([0.0, 0.0, 9.81]))


def _prev():
    return feat_mod.extract_features(IMG, jnp.float32(0.0), CFG.features)


def _lower_single():
    from msf_loam_tpu.slam.pipeline import fused_frame_step_from_image
    cmap, smap = _maps()
    p = Pose.identity()
    return fused_frame_step_from_image.lower(
        CFG, cmap, smap, _prev(), IMG, jnp.float32(0.1), p, p, p,
        jnp.bool_(False))


def _lower_lio():
    from msf_loam_tpu.slam.pipeline import fused_lio_frame
    cmap, smap = _maps()
    p = Pose.identity()
    return fused_lio_frame.lower(CFG, cmap, smap, _prev(), IMG,
                                 jnp.float32(0.1), p, p, p,
                                 jnp.bool_(False), *_lio_tail())


def _lower_batched():
    from msf_loam_tpu.slam import batch_pipeline
    B, T = 2, 2
    state = batch_pipeline.init_batch_state(CFG, B, n_rings=R)
    imgs = jax.tree.map(lambda a: jnp.broadcast_to(a, (T, B) + a.shape), IMG)
    return batch_pipeline.run_batch.lower(CFG, state, imgs)


def _lower_sharded():
    from msf_loam_tpu.parallel import mesh as mesh_mod
    from msf_loam_tpu.parallel import sharded_map
    from msf_loam_tpu.parallel.sharded_pipeline import (_sharded_frame_program,
                                                        _sharded_lio_program)
    mesh = mesh_mod.make_mesh(n_map=4, n_data=1)
    cmap, smap = _maps(lambda *a: sharded_map.create_sharded_map(mesh, *a))
    p = Pose.identity()
    prev = _prev()
    frame = _sharded_frame_program(mesh, CFG).lower(
        cmap, smap, prev, prev, p, p, p, jnp.bool_(False))
    lio = _sharded_lio_program(mesh, CFG).lower(
        cmap, smap, prev, IMG, jnp.float32(0.1), p, p, p, jnp.bool_(False),
        *_lio_tail())
    return frame, lio


def _dot_precisions(lowered):
    text = lowered.as_text()
    return [m.group(1) for m in re.finditer(
        r"stablehlo\.dot_general[^\n]*?precision = \[([A-Z, ]+)\]", text)], \
        text.count("stablehlo.dot_general")


@pytest.mark.parametrize("program", ["single", "lio", "batched", "sharded"])
def test_frame_program_matmuls_are_f32(program):
    lowered = {"single": _lower_single, "lio": _lower_lio,
               "batched": _lower_batched, "sharded": _lower_sharded}[program]()
    for low in (lowered if isinstance(lowered, tuple) else (lowered,)):
        precisions, n_dots = _dot_precisions(low)
        assert n_dots > 0 and len(precisions) == n_dots
        assert all(p == "HIGHEST, HIGHEST" for p in precisions), \
            sorted(set(precisions))
