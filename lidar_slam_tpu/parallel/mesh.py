"""Device-mesh construction for multi-chip / multi-host scaling.

The reference's only "distribution" is an HTTP relay chain and an FPGA
register interface (SURVEY §2.4). This framework scales instead by
sharding the particle axis (data-parallel analog) and map blocks (spatial
analog) over a ``jax.sharding.Mesh``, with resampling and halo exchange as
collectives between devices (NVLink between the GPUs of one host).

Axes:
- ``particles``: the batch-like axis; propagation/scoring shard cleanly.
- ``map``: spatial grid-block axis for the sharded EDT (halo width bounded
  by the 10 px clamp).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_particles_shards: int | None = None,
              n_map_shards: int = 1,
              devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_particles_shards is None:
        n_particles_shards = n // n_map_shards
    assert n_particles_shards * n_map_shards == n, (
        f"{n_particles_shards}x{n_map_shards} != {n} devices")
    arr = np.asarray(devices).reshape(n_particles_shards, n_map_shards)
    return Mesh(arr, axis_names=("particles", "map"))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis over 'particles', rest replicated."""
    return NamedSharding(mesh, P("particles"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_particle_state(state, mesh: Mesh):
    """Place a ParticleState: per-particle leaves sharded, map/grids replicated."""
    from lidar_slam_tpu.models.fastslam import ParticleState

    ps = particle_sharding(mesh)
    rep = replicated(mesh)

    def place(path, leaf):
        import numpy as np

        # make_array_from_callback instead of device_put: it is the
        # multi-process placement API (each process contributes its
        # addressable shards; no cross-process value check — device_put's
        # assert_equal mishandles 0-d leaves like a grid's pixel size).
        leaf = np.asarray(leaf)
        name = path[0].name if path else ""
        sh = ps if name in ("poses", "prev_poses", "logw") else rep
        return jax.make_array_from_callback(
            leaf.shape, sh, lambda idx, l=leaf: l[idx])

    return jax.tree_util.tree_map_with_path(place, state)
