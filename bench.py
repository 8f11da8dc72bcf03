"""Benchmark: SLAM throughput and accuracy on one NVIDIA GPU.

Headline (BASELINE.json): scans/s at 1024 particles on the 1000-scan museum
dataset, against the reference C pipeline's 3.95 scans/s (253.28 s / 1000
scans on a Ryzen 7 6800U, dissertation p.33 §10). The other stages re-measure
every mode the README quotes: fidelity mode (museum and building-3800, with
bit-exactness against the C++ oracle), PF-10240, the building workload in its
wide, PF+closure and graph configurations, the hybrid EKF, graph and
submap-graph SLAM on the loop tour, per-scan streaming latency, the two
kernels on the hot path, and the C++ oracle with the reference's naive EDT
on this host.

    python bench.py                     # every stage
    python bench.py --stages headline,kernels

One process, one card. Every stage warms up (the first call compiles; its
time is reported as ``first_call_s``), then times warm runs with the host
clock around ``block_until_ready``. Every result carries the device it ran
on. The script refuses to run without a GPU, and exits nonzero when any
stage fails. It prints exactly one JSON line on stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np

C_BASELINE_SCANS_PER_SEC = 3.95  # reference: 1000 scans / 253.28 s
REF_HLS_EDT_MS_400 = 0.4         # dissertation p.46 fig. 14 (400x400)

# Per-card peaks for the roofline denominator, keyed by jax device_kind.
# NVIDIA H100 data sheet, dense rates: f32 outside the tensor cores, HBM.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_s": 3.35e12},
    "NVIDIA H100 PCIe": {"f32_flops": 51e12, "hbm_bytes_s": 2.0e12},
}

_T0 = time.time()


def _log(msg: str) -> None:
    print(f"[{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def _device() -> dict:
    import subprocess

    import jax

    d = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card[0] if card else None}


def _timed(fn, reps: int = 3) -> tuple[float, float]:
    """(first call s, median warm s) of ``fn()``, which must block."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return first, statistics.median(ts)


def _run_entry(run, gt, n: int, reps: int = 3) -> dict:
    """Time a whole-dataset run ``run() -> (path, state)``; ATE from it."""
    import jax

    from lidar_slam_tpu.utils.metrics import ate

    first, warm = _timed(lambda: jax.block_until_ready(run()), reps)
    path = np.asarray(run()[0])
    return {"scans_per_sec": (n - 1) / warm, "ate": float(ate(path, gt)),
            "first_call_s": first, "warm_s": warm, "n_scans": n}


def _museum():
    from lidar_slam_tpu.io import dataset

    ranges, gt, _ = dataset.ensure_dataset(n_scans=1000, seed=0)
    return ranges, gt, len(ranges)


def _building():
    from lidar_slam_tpu.io import dataset, simulate

    ranges, gt, _ = dataset.ensure_dataset(
        n_scans=simulate.BUILDING_N_SCANS, world="building")
    return ranges, gt, len(ranges)


def _loop700():
    from lidar_slam_tpu.io import simulate

    ranges, gt = simulate.generate_dataset(
        n_scans=700, seed=0, waypoints=simulate.LOOP_WAYPOINTS)
    return ranges, gt, len(ranges)


# ===========================================================================
# Stages
# ===========================================================================

def stage_headline() -> dict:
    """PF-1024 on museum-1000: the BASELINE.json headline configuration."""
    from lidar_slam_tpu.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu.models import fastslam

    ranges, gt, n = _museum()
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, particles=ParticleConfig(n_particles=1024))
    return {"pf1024_museum1000": _run_entry(
        lambda: fastslam.run_pf(ranges, cfg), gt, n, reps=5)}


def stage_oracle() -> dict:
    """Clean-room C++ oracle with the reference's naive EDT, on this host."""
    from lidar_slam_tpu import native

    ranges, _, _ = _museum()
    n_o = 200
    t0 = time.perf_counter()
    native.run_oracle(ranges[:n_o], use_naive_edt=True)
    return {"oracle_naive_local": {
        "scans_per_sec": n_o / (time.perf_counter() - t0),
        "where": "host CPU"}}


def _roofline(fn, args, ms: float, kind: str) -> dict:
    from lidar_slam_tpu.utils.profiling import cost_analysis

    costs = cost_analysis(fn, *args)
    flops = float(costs.get("flops", 0.0))
    bytes_ = float(costs.get("bytes accessed", 0.0))
    peak = PEAKS.get(kind)
    out = {"ms": ms, "flops": flops, "bytes": bytes_, "roofline_frac": None,
           "bound": None}
    if peak and ms > 0:
        t_f = flops / peak["f32_flops"]
        t_b = bytes_ / peak["hbm_bytes_s"]
        out["roofline_frac"] = max(t_f, t_b) / (ms * 1e-3)
        out["bound"] = "compute" if t_f > t_b else "memory"
    return out


def stage_kernels() -> dict:
    """The EDT (400^2, 512^2) and the PF correlation volume, each checked
    against its plain reference on the card (chip_smoke.py phase 1) and
    timed inside one program (chip_smoke.device_ms)."""
    import jax

    import chip_smoke as cs
    from lidar_slam_tpu.ops import correlative, edt

    kind = jax.devices()[0].device_kind
    out = {}
    rng = np.random.default_rng(0)
    for size in (400, 512):
        r = cs.check_edt(size)
        occ = rng.random((size, size)) < 0.02
        ent = _roofline(lambda o: edt.edt_clamped(o, 10), (occ,),
                        r["xla_ms"], kind)
        ent["exact_vs_oracle"] = True
        if size == 400:
            ent["vs_ref_hls_0.4ms"] = (REF_HLS_EDT_MS_400 / r["xla_ms"]
                                       if r["xla_ms"] > 0 else None)
        out[f"edt_{size}"] = ent
    r = cs.check_volume("pf")
    metric, grid, sx, sy, valid, base, t, step, half = cs._volume_case("pf")

    def vol(m, x, y, v, b):
        return correlative.build_score_volume(
            m, grid, x, y, v, b, n_theta=t, theta_step=step,
            half=half).scores

    ent = _roofline(vol, (metric, sx, sy, valid, base), r["ms"], kind)
    ent["exact_vs_reference"] = True
    out["volume_7x13x13"] = ent
    return out


def stage_fidelity() -> dict:
    from lidar_slam_tpu import native
    from lidar_slam_tpu.config import DEFAULT_CONFIG
    from lidar_slam_tpu.models import scan_matcher
    from lidar_slam_tpu.utils.metrics import max_abs_err

    ranges, gt, n = _museum()
    ent = _run_entry(lambda: scan_matcher.run_scan(ranges, DEFAULT_CONFIG),
                     gt, n)
    cpath, _ = native.run_oracle(ranges)
    jpath, _ = scan_matcher.run_scan(ranges, DEFAULT_CONFIG)
    ent["max_abs_err_vs_oracle"] = float(max_abs_err(np.asarray(jpath),
                                                     cpath))
    ent["bit_exact_vs_oracle"] = ent["max_abs_err_vs_oracle"] == 0.0
    return {"fidelity_museum1000": ent}


def stage_pf10240() -> dict:
    from lidar_slam_tpu.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu.models import fastslam

    ranges, gt, n = _museum()
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, particles=ParticleConfig(n_particles=10240))
    return {"pf10240_museum1000": _run_entry(
        lambda: fastslam.run_pf(ranges, cfg), gt, n)}


def stage_building() -> dict:
    """Building-3800: parity config (+-1 window) and the wide (+-2) one."""
    from lidar_slam_tpu import native
    from lidar_slam_tpu.config import BUILDING_CONFIG, BUILDING_WIDE_CONFIG
    from lidar_slam_tpu.models import scan_matcher
    from lidar_slam_tpu.utils.metrics import max_abs_err

    ranges, gt, n = _building()
    ent = _run_entry(lambda: scan_matcher.run_scan(ranges, BUILDING_CONFIG),
                     gt, n, reps=1)
    cpath, _ = native.run_oracle_cfg(ranges, BUILDING_CONFIG)
    jpath, _ = scan_matcher.run_scan(ranges, BUILDING_CONFIG)
    ent["bit_exact_vs_oracle"] = bool(
        max_abs_err(np.asarray(jpath), cpath) == 0.0)
    wide = _run_entry(
        lambda: scan_matcher.run_scan(ranges, BUILDING_WIDE_CONFIG),
        gt, n, reps=1)
    return {"fidelity_building3800": ent, "building3800_wide": wide}


def _graph_entry(gs, ranges, gt, n: int) -> dict:
    """One cold run of a GraphSlam-family model (host loop around jitted
    pieces): wall time includes compilation, reported as such."""
    from lidar_slam_tpu.utils.metrics import ate

    t0 = time.perf_counter()
    path, _ = gs.run(ranges)
    dt = time.perf_counter() - t0
    return {"scans_per_sec_wall": (n - 1) / dt, "wall_s": dt,
            "ate": float(ate(np.asarray(path), gt)),
            "ate_smoothed": float(ate(gs.smoothed_path(path), gt)),
            "closures": len(gs.closures), "n_scans": n,
            "stages_s": dict(gs.timer.totals)}


def stage_building_pf() -> dict:
    """PF-1024 + graph-closure feedback on building-3800."""
    from lidar_slam_tpu.config import BUILDING_CONFIG
    from lidar_slam_tpu.models.pf_graph_slam import PFGraphSlam

    ranges, gt, n = _building()
    cfg = dataclasses.replace(
        BUILDING_CONFIG, particles=dataclasses.replace(
            BUILDING_CONFIG.particles, n_particles=1024))
    return {"pf1024_building3800": _graph_entry(PFGraphSlam(cfg), ranges,
                                                gt, n)}


def stage_building_graph() -> dict:
    """Graph backend on building-3800 (wide frontend + gated closures)."""
    from lidar_slam_tpu.config import BUILDING_WIDE_CONFIG
    from lidar_slam_tpu.models.graph_slam import GraphSlam

    ranges, gt, n = _building()
    return {"building3800_graph": _graph_entry(GraphSlam(BUILDING_WIDE_CONFIG),
                                               ranges, gt, n)}


def stage_ekf() -> dict:
    """Hybrid grid+landmark EKF-FastSLAM, 1024 particles, museum-1000."""
    from lidar_slam_tpu.models import ekf_slam
    from lidar_slam_tpu.models.ekf_hybrid import run_ekf_hybrid

    ranges, gt, n = _museum()
    ecfg = ekf_slam.long_tour_config(1024)
    return {"ekf1024_museum1000": _run_entry(
        lambda: run_ekf_hybrid(ranges, ecfg), gt, n)}


def stage_graph() -> dict:
    """Graph SLAM with loop closures on loop-700: a cold run (compiles)
    then a second run of a fresh instance."""
    from lidar_slam_tpu.config import DEFAULT_CONFIG
    from lidar_slam_tpu.models.graph_slam import GraphSlam

    ranges, gt, n = _loop700()
    cold = _graph_entry(GraphSlam(DEFAULT_CONFIG), ranges, gt, n)
    warm = _graph_entry(GraphSlam(DEFAULT_CONFIG), ranges, gt, n)
    warm["cold_wall_s"] = cold["wall_s"]
    return {"graph_700loop": warm}


def stage_submap() -> dict:
    """Submap-atlas graph SLAM on loop-700."""
    from lidar_slam_tpu.config import DEFAULT_CONFIG, SubmapConfig
    from lidar_slam_tpu.models.submap_graph_slam import SubmapGraphSlam

    ranges, gt, n = _loop700()
    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        submaps=SubmapConfig(n_submaps=32, submap_capacity=4096,
                             k_nearest=8, spawn_dist=2.0))
    gs = SubmapGraphSlam(cfg)
    ent = _graph_entry(gs, ranges, gt, n)
    ent["resident_submaps"] = int(gs.final_state.atlas.n_submaps)
    return {"submap_graph": ent}


def stage_streaming() -> dict:
    """Per-scan latency of the streamed fidelity step (HTTP server ->
    prefetching client -> jitted step) against the reference's 10 Hz
    sensor budget (dissertation p.23 §8.2); chip_smoke.py phase 5."""
    import chip_smoke as cs

    ent = cs.phase_stream(n=140)
    ent["budget_ms"] = 100.0
    return {"streaming_latency": ent}


STAGES = {
    "headline": stage_headline,
    "kernels": stage_kernels,
    "oracle": stage_oracle,
    "fidelity": stage_fidelity,
    "pf10240": stage_pf10240,
    "ekf": stage_ekf,
    "graph": stage_graph,
    "submap": stage_submap,
    "streaming": stage_streaming,
    "building": stage_building,
    "building_pf": stage_building_pf,
    "building_graph": stage_building_graph,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma-separated subset of: " + ",".join(STAGES))
    args = ap.parse_args(argv)
    names = [s for s in args.stages.split(",") if s]
    unknown = [s for s in names if s not in STAGES]
    if unknown:
        ap.error(f"unknown stages {unknown}")

    import jax

    if any(d.platform != "gpu" for d in jax.devices()):
        print(f"bench: no GPU (JAX devices: {jax.devices()})",
              file=sys.stderr)
        return 2
    from lidar_slam_tpu.utils import compile_cache

    result = {"device": _device(), "compile_cache": compile_cache.enable(),
              "results": {}, "stages": {}}
    for name in names:
        t0 = time.perf_counter()
        try:
            res = STAGES[name]()
        except Exception as e:  # noqa: BLE001 — report, then fail the run
            result["stages"][name] = f"failed ({type(e).__name__}: {e})"[:300]
            _log(f"{name}: FAILED {type(e).__name__}: {e}")
            continue
        result["results"].update(res)
        result["stages"][name] = f"ok ({time.perf_counter() - t0:.0f}s)"
        _log(f"{name}: {json.dumps(res)}")
    head = result["results"].get("pf1024_museum1000")
    if head:
        result["metric"] = "scans/s, PF-1024, museum-1000"
        result["value"] = head["scans_per_sec"]
        result["ate"] = head["ate"]
        result["vs_baseline"] = head["scans_per_sec"] / C_BASELINE_SCANS_PER_SEC
    print(json.dumps(result), flush=True)
    failed = [n for n, s in result["stages"].items() if not s.startswith("ok")]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
