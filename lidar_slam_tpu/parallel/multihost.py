"""Multi-host initialization and scaling-run helpers.

The reference's "distribution" is a hand-rolled HTTP topology with hardcoded
IPs (esp32_edge.c:59, ESP32_Server.c:58). The equivalent here is
``jax.distributed`` + a global mesh over all hosts' devices; particle shards
ride the network between hosts and NVLink between the GPUs of one host.

On a single host, `initialize()` is a no-op and the same code paths run over
the local devices.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed when running under a multi-host launcher.

    Resolution order: explicit args > JAX_COORDINATOR_ADDRESS env (with
    JAX_NUM_PROCESSES / JAX_PROCESS_ID) > single-process no-op. Nothing
    discovers a cluster on its own: the coordinator address, process count
    and process id are always given.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return  # single host
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=int(num_processes
                          or os.environ.get("JAX_NUM_PROCESSES", 1)),
        process_id=int(process_id or os.environ.get("JAX_PROCESS_ID", 0)))


def global_particle_mesh(n_map_shards: int = 1):
    """Mesh over every device of every host: particles x map blocks."""
    from lidar_slam_tpu.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(n_map_shards=n_map_shards,
                              devices=jax.devices())


def scaling_report(ranges: np.ndarray, n_particles: int = 1024,
                   shard_counts=(1, 2, 4, 8), n_scans: int = 60,
                   **particle_overrides) -> dict:
    """Throughput at several particle-shard counts (for the scaling table).

    On several GPUs this measures cross-device scaling; on the virtual CPU
    mesh it validates that the sharded program runs at every size.
    """
    import dataclasses
    import time

    import jax.numpy as jnp

    from lidar_slam_tpu.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu.models import fastslam
    from lidar_slam_tpu.parallel import mesh as mesh_lib, sharded

    results = {}
    n_dev = len(jax.devices())
    for d in shard_counts:
        if d > n_dev:
            continue
        mesh = mesh_lib.make_mesh(n_particles_shards=d, n_map_shards=1,
                                  devices=jax.devices()[:d])
        cfg = dataclasses.replace(
            DEFAULT_CONFIG, particles=ParticleConfig(n_particles=n_particles,
                                                     **particle_overrides))
        step, place = sharded.make_sharded_pf_step(cfg, mesh)
        state = place(fastslam.init_particles(jnp.asarray(ranges[0]), cfg))
        state, est = step(state, jnp.asarray(ranges[1]))  # compile
        jax.block_until_ready(est)
        t0 = time.time()
        for t in range(2, min(n_scans, len(ranges))):
            state, est = step(state, jnp.asarray(ranges[t]))
        jax.block_until_ready(est)
        dt = time.time() - t0
        results[d] = (min(n_scans, len(ranges)) - 2) / dt
    return results
