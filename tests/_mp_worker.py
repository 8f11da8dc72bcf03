"""Worker for the real multi-process jax.distributed test.

Launched by ``tests/test_multiprocess.py`` as N separate OS processes, each
with 8//N virtual CPU devices; together they form one 8-device global mesh
over DCN (the gloo CPU collectives backend). This is the code path the
reference exercised with its ESP32/HTTP topology (esp32_edge.c:59 ->
ESP32_Server.c:58 -> Lidar_server.py:56) — here it is jax.distributed +
GSPMD instead of hand-rolled sockets.

argv: process_id num_processes coordinator_port out_path
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    port, out_path = sys.argv[3], sys.argv[4]
    per_proc = 8 // nproc

    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count={per_proc}").strip()

    import jax

    from lidar_slam_tpu.parallel import multihost

    multihost.initialize(coordinator=f"127.0.0.1:{port}",
                         num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 8, jax.devices()

    import numpy as np

    resample = os.environ.get("MP_WORKER_RESAMPLE", "1") == "1"
    path = run_case(resample=resample)
    if pid == 0:
        np.save(out_path, path)
    jax.distributed.shutdown()


def run_case(resample: bool = True):
    """The shared workload: 12 sharded PF steps on the 8-device global mesh.

    Called both by the workers (global mesh spanning 2-4 processes) and by
    the single-process reference run (8 local virtual devices).

    ``resample=False`` pins the DETERMINISTIC contract: without the
    resampling argmin/categorical selections, the only cross-topology
    difference is collective reduction order, and the trajectories must
    match to float tolerance. With resampling on, a one-ulp weight
    difference can flip a selection and legally move the estimate by a
    couple of pixels — that run is compared with an estimator-noise bound
    instead (see test_multiprocess.py)."""
    import dataclasses

    from lidar_slam_tpu.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu.io import simulate
    from lidar_slam_tpu.parallel import mesh as mesh_lib, sharded

    ranges, _ = simulate.generate_dataset(n_scans=13, seed=0)
    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        particles=ParticleConfig(
            n_particles=64, vol_theta_bins=5, vol_half=4,
            resample_threshold=0.5 if resample else 0.0))
    mesh = mesh_lib.make_mesh(n_map_shards=1)  # 8 global devices
    path, _ = sharded.run_sharded_pf(ranges, cfg, mesh, seed=0)
    return path


if __name__ == "__main__":
    main()
