"""Command-line interface.

The reference has no CLI at all — every parameter is a compile-time constant
(dataset path main.c:842, resolutions main.c:832-833, row counts main.c:6) and
each variant is a separately edited copy of the program. Here one binary runs
every pipeline:

  python -m lidar_slam_tpu simulate --scans 1000 --out data/museum.csv
  python -m lidar_slam_tpu run --mode fidelity --scans 500 --render map.png
  python -m lidar_slam_tpu run --mode pf --particles 4096
  python -m lidar_slam_tpu run --mode graph --scans 700 --loop
  python -m lidar_slam_tpu oracle --scans 500          # C++ golden pipeline
  python -m lidar_slam_tpu serve --port 8080           # HTTP scan server
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _load_ranges(args) -> tuple[np.ndarray, np.ndarray | None]:
    from lidar_slam_tpu.io import dataset, simulate

    if args.dataset:
        from lidar_slam_tpu import native

        n_rows = args.scans or sum(1 for _ in open(args.dataset))
        return native.read_csv(args.dataset, n_rows), None
    world = getattr(args, "world", "museum")
    n = args.scans or (simulate.BUILDING_N_SCANS if world == "building" else 1000)
    if getattr(args, "loop", False):
        ranges, gt = simulate.generate_dataset(
            n_scans=n, seed=args.seed, waypoints=simulate.LOOP_WAYPOINTS)
    else:
        ranges, gt, _ = dataset.ensure_dataset(n_scans=n, seed=args.seed,
                                               world=world)
    return np.asarray(ranges), np.asarray(gt)


def _base_config(args):
    """Pick the grid/map preset matching the workload world."""
    import dataclasses as _dc

    from lidar_slam_tpu.config import BUILDING_CONFIG, DEFAULT_CONFIG

    cfg = (BUILDING_CONFIG if getattr(args, "world", "museum") == "building"
           else DEFAULT_CONFIG)
    w = getattr(args, "window", None)
    if w is not None:
        # +-w-step correlative search per matcher stage; w=2 is the
        # BUILDING_WIDE_CONFIG that solves the building tour (w=1 =
        # reference-exact parity window)
        # replace() keeps every other matcher field (resolutions,
        # center-bias penalty) from the preset (ADVICE r4: a fresh
        # MatcherConfig silently reset them to defaults)
        cfg = _dc.replace(cfg, matcher=_dc.replace(cfg.matcher,
                                                   window_t=w, window_r=w))
    return cfg


def cmd_simulate(args) -> int:
    from lidar_slam_tpu.io import dataset, simulate

    wps = simulate.LOOP_WAYPOINTS if args.loop else None
    ranges, gt = simulate.generate_dataset(n_scans=args.scans or 1000,
                                           seed=args.seed, waypoints=wps)
    out = args.out or "lidar_dataset.csv"
    dataset.save_csv(out, ranges)
    np.savetxt(out.replace(".csv", "_gt.csv"), gt, delimiter=",", fmt="%.6f")
    print(f"wrote {ranges.shape[0]} scans to {out}")
    return 0


def cmd_run(args) -> int:
    from lidar_slam_tpu.config import ParticleConfig
    from lidar_slam_tpu.utils import viz
    from lidar_slam_tpu.utils.metrics import ate

    ranges, gt = _load_ranges(args)
    cfg = dataclasses.replace(
        _base_config(args),
        particles=ParticleConfig(n_particles=args.particles))

    ate_from = 0  # resumed runs only report ATE over the resumed suffix
    t0 = time.time()
    if args.mode == "fidelity":
        from lidar_slam_tpu.models import scan_matcher

        path, state = scan_matcher.run_scan(ranges, cfg)
        path = np.asarray(path)
        map_xy = np.asarray(state.pmap.xy[: int(state.pmap.size)])
    elif args.mode == "pf":
        import jax.numpy as jnp

        from lidar_slam_tpu.models import fastslam
        from lidar_slam_tpu.utils import checkpoint

        if args.supervised:
            # watchdog-contained run: a wedged device kills only the worker;
            # the run resumes from its checkpoint (utils/watchdog)
            from lidar_slam_tpu.utils import watchdog

            run_dir = args.run_dir or ".slam_run"
            path, report = watchdog.run_pf_supervised(
                ranges, cfg, run_dir, seed=args.seed,
                stall_timeout_s=args.stall_timeout,
                resume=bool(args.resume))
            print(f"supervised run: completed={report.completed} "
                  f"attempts={report.attempts} stalls={report.stalls} "
                  f"({report.seconds:.1f}s)")
            if not report.completed:
                return 1
            template = fastslam.init_particles(jnp.asarray(ranges[0]), cfg,
                                               args.seed)
            state = checkpoint.load_state(
                os.path.join(run_dir, watchdog.CKPT_FILE), template)
        elif args.resume:
            # resume a checkpointed run with the host-loop driver
            step = fastslam.make_pf_step(cfg)
            template = fastslam.init_particles(jnp.asarray(ranges[0]), cfg,
                                               args.seed)
            state = checkpoint.load_state(args.resume, template)
            start = ate_from = int(state.step)
            print(f"resumed from {args.resume} at scan {start}")
            poses = [np.zeros(3, np.float32)] * start
            for t in range(start, len(ranges)):
                state, pose = step(state, jnp.asarray(ranges[t]))
                poses.append(np.asarray(pose))
            path = np.stack(poses)
        else:
            path, state = fastslam.run_pf(ranges, cfg, seed=args.seed)
            path = np.asarray(path)
        if args.checkpoint:
            checkpoint.save_state(args.checkpoint, state)
            print(f"checkpoint -> {args.checkpoint}")
        map_xy = np.asarray(state.pmap.xy[: int(state.pmap.size)])
    elif args.mode == "ekf-hybrid":
        # Hybrid grid+landmark EKF-FastSLAM (models/ekf_hybrid.py): the
        # corner-landmark banks PLUS the correlation-volume grid likelihood
        # in every particle weight — the accuracy config for config-2 runs.
        from lidar_slam_tpu.models import ekf_slam
        from lidar_slam_tpu.models.ekf_hybrid import run_ekf_hybrid

        ecfg = ekf_slam.long_tour_config(args.particles)
        path, final = run_ekf_hybrid(ranges, ecfg, cfg, seed=args.seed)
        path = np.asarray(path)
        map_xy = np.asarray(
            final.pmap.xy[: int(np.asarray(final.pmap.size))])
    elif args.mode == "pf-graph":
        # PF frontend + pose-graph closure feedback
        # (models/pf_graph_slam.py): closures re-anchor the particle cloud
        # and rebuild the shared map — the robust multi-hypothesis config.
        from lidar_slam_tpu.models.pf_graph_slam import run_pf_graph

        path, _opt, gs = run_pf_graph(ranges, cfg, seed=args.seed)
        path = np.asarray(path)
        state = gs.final_state
        map_xy = np.asarray(state.pmap.xy[: int(np.asarray(state.pmap.size))])
        print(f"keyframes {int(gs.kf.count)}  loop closures {len(gs.closures)}")
    elif args.mode == "ekf":
        # Scan-driven EKF-FastSLAM: the same ranges CSV as every other mode;
        # landmarks are corner detections extracted from the scans
        # (ops/landmarks.py) with per-particle ML association.
        from lidar_slam_tpu.models import ekf_slam

        ecfg = ekf_slam.long_tour_config(args.particles)
        path, final = ekf_slam.run_ekf_slam_scan(
            ranges, ecfg, lidar_cfg=cfg.lidar, seed=args.seed,
            max_range=ekf_slam.LONG_TOUR_MAX_RANGE)
        path = np.asarray(path)
        est_lms = ekf_slam.landmark_estimates(final)
        n_seen = float(np.asarray(final.lm_seen).sum(axis=1).mean())
        print(f"landmark slots in use (mean over particles): {n_seen:.1f}")
        map_xy = est_lms[np.asarray(final.lm_seen).any(axis=0)]
    elif args.mode == "submap":
        from lidar_slam_tpu.models import submap_slam
        from lidar_slam_tpu.utils import paging

        if args.paged:
            paged = paging.PagedAtlas()
            path, state = paging.run_host_loop_paged(ranges, cfg, paged)
            map_xy = paged.world_points(state.atlas)
            print(f"submaps: {int(state.atlas.n_submaps)} resident, "
                  f"{len(paged.archive)} archived "
                  f"({paged.pages_out} out / {paged.pages_in} in)")
        else:
            path, state = submap_slam.run_scan(ranges, cfg)
            path = np.asarray(path)
            from lidar_slam_tpu.core import submap as sm

            wx, wy, mask = sm.submap_world_points(state.atlas)
            wx, wy, mask = np.asarray(wx), np.asarray(wy), np.asarray(mask)
            map_xy = np.stack([wx[mask], wy[mask]], axis=1)
            print(f"submaps: {int(state.atlas.n_submaps)}, "
                  f"{len(map_xy)} map points")
    elif args.mode == "submap-graph":
        from lidar_slam_tpu.models.submap_graph_slam import SubmapGraphSlam

        gs = SubmapGraphSlam(cfg)
        path, opt_kf = gs.run(ranges)
        map_xy = gs.world_map(gs.final_state)
        print(f"keyframes {int(gs.kf.count)}  loop closures {len(gs.closures)}"
              f"  submaps {int(gs.final_state.atlas.n_submaps)}")
    elif args.mode == "graph":
        from lidar_slam_tpu.models.graph_slam import GraphSlam

        gs = GraphSlam(cfg)
        path, opt_kf = gs.run(ranges)
        # world-frame keyframe points from optimized poses
        pts = []
        for k in range(int(gs.kf.count)):
            import jax.numpy as jnp

            from lidar_slam_tpu.core import se2

            wx, wy = se2.transform_ref(gs.kf.x[k], gs.kf.y[k],
                                       jnp.asarray(opt_kf[k]))
            v = np.asarray(gs.kf.valid[k])
            pts.append(np.stack([np.asarray(wx)[v], np.asarray(wy)[v]], 1))
        map_xy = np.concatenate(pts) if pts else np.zeros((0, 2))
        print(f"keyframes {int(gs.kf.count)}  loop closures {len(gs.closures)}")
    else:
        raise SystemExit(f"unknown mode {args.mode}")
    dt = time.time() - t0

    if args.debug_checks:
        # sanitizer-analog audit (utils/debug): final state + trajectory
        from lidar_slam_tpu.utils import debug

        violations = []
        if not np.isfinite(np.asarray(path)).all():
            violations.append("trajectory contains non-finite poses")
        for nm, obj in (("state", locals().get("state")),
                        ("final", locals().get("final"))):
            if obj is not None:
                violations += debug.validate_state(obj, nm)
        if violations:
            print("DEBUG-CHECKS FAILED:\n  " + "\n  ".join(violations))
            return 2
        print("debug-checks: all state invariants hold")

    n = len(path)
    print(f"{args.mode}: {n} scans in {dt:.2f}s = {n / dt:.1f} scans/s")
    if gt is not None and len(gt) == n:
        print(f"ATE vs ground truth: {ate(path[ate_from:], gt[ate_from:]):.4f} m")
    if args.out_map:
        viz.map_to_csv(map_xy, args.out_map)
        print(f"map ({len(map_xy)} points) -> {args.out_map}")
    if args.render:
        viz.render_map(map_xy, path=path, out_path=args.render,
                       gt=gt if gt is not None and len(gt) == n else None,
                       title=f"{args.mode} | {n} scans")
        print(f"render -> {args.render}")
    return 0


def cmd_oracle(args) -> int:
    from lidar_slam_tpu import native
    from lidar_slam_tpu.utils.metrics import ate

    ranges, gt = _load_ranges(args)
    t0 = time.time()
    path, omap = native.run_oracle_cfg(ranges, _base_config(args),
                                       use_naive_edt=args.naive_edt)
    dt = time.time() - t0
    print(f"oracle: {len(path)} scans in {dt:.2f}s = {len(path) / dt:.1f} scans/s"
          f" ({'naive' if args.naive_edt else 'separable'} EDT)")
    if gt is not None:
        print(f"ATE vs ground truth: {ate(path, gt):.4f} m")
    if args.out_map:
        np.savetxt(args.out_map, omap, delimiter=",", fmt="%f")
    return 0


def cmd_serve(args) -> int:
    from lidar_slam_tpu.io import server

    ranges, _ = _load_ranges(args)
    srv = server.ScanServer(ranges, port=args.port).start()
    print(f"serving {len(ranges)} scans at {srv.url} (?param=N; Ctrl-C to stop)")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.stop()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lidar_slam_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scans", type=int, default=None)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--dataset", type=str, default=None,
                        help="CSV of range rows (default: synthesize)")
        sp.add_argument("--loop", action="store_true",
                        help="use the loop-closure trajectory")
        sp.add_argument("--world", choices=["museum", "building"],
                        default="museum",
                        help="synthetic workload: museum (20x15 m) or the "
                        "building-scale hard workload (60x45 m, 3800 scans; "
                        "selects BUILDING_CONFIG grids automatically)")

    sp = sub.add_parser("simulate", help="generate a synthetic dataset CSV")
    common(sp)
    sp.add_argument("--out", type=str, default=None)
    sp.set_defaults(fn=cmd_simulate)

    sp = sub.add_parser("run", help="run a SLAM pipeline")
    common(sp)
    sp.add_argument("--mode",
                    choices=["fidelity", "pf", "pf-graph", "ekf",
                             "ekf-hybrid", "graph", "submap", "submap-graph"],
                    default="fidelity")
    sp.add_argument("--window", type=int, default=None,
                    help="matcher search window in steps per stage "
                    "(1 = reference-exact; 2 solves the building tour)")
    sp.add_argument("--particles", type=int, default=1024)
    sp.add_argument("--paged", action="store_true",
                    help="submap mode: page cold submaps to host memory")
    sp.add_argument("--out-map", type=str, default=None)
    sp.add_argument("--render", type=str, default=None)
    sp.add_argument("--checkpoint", type=str, default=None,
                    help="save final state (pf mode)")
    sp.add_argument("--resume", type=str, default=None,
                    help="resume from a saved state (pf mode); with "
                    "--supervised, any value resumes the run-dir "
                    "checkpoint when its run identity matches")
    sp.add_argument("--supervised", action="store_true",
                    help="pf mode: run under the device-failure watchdog "
                    "(stall kill + restart + checkpoint-resume)")
    sp.add_argument("--run-dir", type=str, default=None,
                    help="supervised mode: heartbeat/checkpoint directory "
                    "(default .slam_run)")
    sp.add_argument("--stall-timeout", type=float, default=120.0,
                    help="supervised mode: seconds without a heartbeat "
                    "before the worker is killed and restarted")
    sp.add_argument("--debug-checks", action="store_true",
                    help="audit final state/trajectory invariants "
                    "(finiteness, capacities, weight health; utils/debug)")
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("oracle", help="run the native C++ golden pipeline")
    common(sp)
    sp.add_argument("--naive-edt", action="store_true")
    sp.add_argument("--out-map", type=str, default=None)
    sp.set_defaults(fn=cmd_oracle)

    sp = sub.add_parser("serve", help="serve scans over HTTP")
    common(sp)
    sp.add_argument("--port", type=int, default=8080)
    sp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    from lidar_slam_tpu.utils import compile_cache

    compile_cache.enable()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
