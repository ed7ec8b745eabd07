"""Device mesh construction + sharding helpers.

The communication layer (SURVEY.md §2.9): where the
reference has a mutex-guarded queue between two threads
(``laser_mapping.h:71-72``) and no distributed backend at all, we scale by
laying out work over a ``jax.sharding.Mesh`` and letting XLA insert
collectives (psum / all_gather) inside ``shard_map``-ped programs.

Axes:
* ``map``  — voxel-map shard axis (hash-slot ranges; model-parallel analog)
* ``data`` — batch axis over residuals / sequences (data-parallel analog)
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_map: Optional[int] = None, n_data: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a (data, map) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_map is None:
        n_map = len(devices) // n_data
    assert n_map * n_data <= len(devices), (
        f"need {n_map * n_data} devices, have {len(devices)}")
    dev = np.asarray(devices[: n_map * n_data]).reshape(n_data, n_map)
    return Mesh(dev, axis_names=("data", "map"))


def map_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for VoxelHashMap arrays: split the hash-table axis."""
    return NamedSharding(mesh, P(None if "data" not in mesh.axis_names else None))


def shard_over(mesh: Mesh, axis: str) -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
