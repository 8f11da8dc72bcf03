"""lidar_slam_tpu — a 2D lidar SLAM framework in JAX (jit, vmap, shard_map).

A from-scratch re-design of the capabilities of the reference project
``circuitpotato/Hardware-Acceleration-of-LIDAR-SLAM`` (correlative scan-to-map
matching over a clamped Euclidean-distance-transform likelihood field; see
``Subsystem_1/main.c`` for the canonical C pipeline), built for an
accelerator:

- the EDT and scan-match scoring are fixed-shape jnp programs that XLA
  fuses (``ops/``),
- the full SLAM step is a single fixed-shape jitted function that can be
  driven by ``lax.scan`` over the whole dataset with zero host round-trips,
- thousands of particles run as vmapped batched computation with systematic
  resampling expressed as collectives (``models/fastslam.py``, ``parallel/``),
- a pose-graph backend with Gauss-Newton/Schur solves closes loops
  (``models/posegraph.py``).

Subpackages
-----------
core      sensor model, SE(2) geometry, occupancy grids
ops       EDT, correlation volume, scan matching
models    scan-matcher pipeline, FastSLAM particle filter, pose graph
parallel  device meshes, sharded pipelines, distributed resampling
io        dataset synthesis, CSV loading, streaming scan server
utils     metrics (ATE), profiling, checkpointing, visualization
native    C++ runtime pieces (fast CSV ingest, clean-room C oracle)
"""

__version__ = "0.1.0"
