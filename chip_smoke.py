"""GPU smoke test: the SLAM main path once, end to end, on one NVIDIA GPU.

    python chip_smoke.py            # phases 0-5 on one GPU
    python chip_smoke.py --four     # phase 6 only: the sharded paths, 4 GPUs

Phases (each prints one ``phase <name>: {...}`` line; any failed check
raises, so the script exits nonzero and prints no result line):

0. device   — every JAX device is a GPU; card name and power limit, JAX
              versions, compile-cache directory.
1. kernels  — the EDT, the correlation volume and the trilinear lookup,
              compiled for the card at real widths, against plain
              references (the C++ EDT, the brute-force EDT, a float64
              per-beam window sum, a float64 trilinear interpolation).
2. pf       — ``run --mode pf --particles 1024`` on museum-1000.
3. fidelity — ``run --mode fidelity`` on museum-1000 against the C++ oracle.
4. graph    — ``run --mode graph --loop --scans 700``, plus one pose-graph
              solve of that graph against a float64 Gauss-Newton.
5. stream   — ``ScanServer`` -> ``scan_stream`` -> scan-matcher step.
6. four     — ``__graft_entry__.dryrun_multichip(4)``, the sharded PF step
              against the single-device step, the halo-exchange EDT against
              the single-device EDT.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
The tests marked ``gpu`` (tests/test_gpu.py) call the same phase functions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(name: str, payload: dict) -> None:
    print(f"phase {name}: {json.dumps(payload)}", flush=True)


def card_line() -> str:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def device_ms(fn, x, n1: int = 10, n2: int = 110) -> float:
    """Device time of ``fn(x)`` per call: two chained ``fori_loop`` lengths
    in one program each, warm, host clock around ``block_until_ready``;
    the difference over the extra calls drops dispatch and launch cost.
    Each call's input depends on a full reduction of the previous call's
    output, so XLA can neither hoist the call out of the loop nor compute
    only part of its output."""
    import jax
    import jax.numpy as jnp

    def make(n):
        @jax.jit
        def many(x0):
            def body(_, carry):
                out = fn(carry)
                # always False, but only a full reduction can tell
                dep = jnp.sum(out, dtype=jnp.float32) < -1.0
                return jax.tree.map(lambda a: a + dep.astype(a.dtype), carry)
            return jax.lax.fori_loop(0, n, body, x0)
        return many

    f1, f2 = make(n1), make(n2)
    jax.block_until_ready(f1(x))
    jax.block_until_ready(f2(x))
    t1, t2 = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(f1(x))
        t1.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        jax.block_until_ready(f2(x))
        t2.append(time.perf_counter() - t0)
    return max(statistics.median(t2) - statistics.median(t1), 0.0) \
        / (n2 - n1) * 1e3


def wall(fn, reps: int = 3) -> float:
    """Median warm wall seconds of ``fn()`` (which blocks on its result)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def cli(argv: list) -> tuple[str, float]:
    """Run the package CLI in this process; returns (stdout, seconds)."""
    from lidar_slam_tpu.__main__ import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    dt = time.perf_counter() - t0
    out = buf.getvalue()
    check(rc == 0, f"CLI {argv} exited {rc}: {out[-500:]}")
    return out, dt


def _grab(pattern: str, text: str) -> float:
    m = re.search(pattern, text)
    check(m is not None, f"pattern {pattern!r} not in CLI output {text!r}")
    return float(m.group(1))


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def phase_device(count: int | None = None) -> dict:
    import jax
    import jaxlib

    from lidar_slam_tpu.utils import compile_cache

    devs = jax.devices()
    plats = sorted({d.platform for d in devs})
    check(plats == ["gpu"], f"need GPU devices, JAX has {plats}")
    if count is not None:
        check(len(devs) >= count, f"need {count} GPUs, have {len(devs)}")
    return {"card": card_line(), "jax": jax.__version__,
            "jaxlib": jaxlib.__version__, "kind": devs[0].device_kind,
            "count": len(devs), "compile_cache": compile_cache.enable()}


# ---------------------------------------------------------------------------
# phase 1: kernels against plain references
# ---------------------------------------------------------------------------

def check_edt(size: int, density: float = 0.02, seed: int = 0) -> dict:
    """XLA's clamped EDT vs the C++ EDT and the brute-force reference."""
    import jax.numpy as jnp

    from lidar_slam_tpu import native
    from lidar_slam_tpu.ops import edt

    occ = np.random.default_rng(seed).random((size, size)) < density
    got = np.asarray(edt.edt_clamped(jnp.asarray(occ), 10))
    want_native = native.edt_native(occ, 10.0)
    want_ref = edt.edt_clamped_reference(occ, 10.0)
    check(np.array_equal(got, want_native),
          f"EDT {size}^2 != native: max {np.abs(got - want_native).max()}")
    check(np.array_equal(got, want_ref),
          f"EDT {size}^2 != reference: max {np.abs(got - want_ref).max()}")
    ms = device_ms(lambda o: edt.edt_clamped(o, 10), jnp.asarray(occ))
    return {"size": size, "exact_vs_native": True, "exact_vs_reference": True,
            "xla_ms": ms}


def _volume_case(case: str, seed: int = 0):
    """Real-width volume inputs: a lattice-valued clamped EDT field and a
    1079-beam scan landing on it. PF: T=7, half=6 on the 400^2 fine grid
    (config.ParticleConfig); closure: T=21, half=14 on the 256^2 keyframe
    raster (graph_slam.LoopClosureConfig)."""
    import jax.numpy as jnp

    from lidar_slam_tpu.core.gridmap import OccGrid
    from lidar_slam_tpu.ops import edt

    rng = np.random.default_rng(seed)
    if case == "pf":
        s, t, half, step, pixel = 400, 7, 6, 0.004363, 0.1
        n_rows, n_cols = 380, 390
    else:
        s, t, half, step, pixel = 256, 21, 14, 0.008727, 0.2
        n_rows = n_cols = s
    occ = rng.random((s, s)) < 0.02
    metric = edt.edt_clamped(jnp.asarray(occ), 10)
    origin = -0.5 * s * pixel
    grid = OccGrid(occ=jnp.asarray(occ), n_rows=jnp.int32(n_rows),
                   n_cols=jnp.int32(n_cols),
                   origin=jnp.asarray([origin, origin], jnp.float32),
                   pixel=jnp.float32(pixel))
    n = 1079
    ang = np.linspace(-2.35, 2.35, n)
    rad = rng.uniform(0.5, 0.45 * s * pixel, n)
    sx = jnp.asarray(rad * np.cos(ang), jnp.float32)
    sy = jnp.asarray(rad * np.sin(ang), jnp.float32)
    valid = jnp.asarray(rng.random(n) < 0.95)
    base = jnp.asarray([0.37, -0.21, 0.05], jnp.float32)
    return metric, grid, sx, sy, valid, base, t, step, half


def volume_reference(metric, grid, cx0, cy0, valid, half: int):
    """float64 numpy per-beam window sum (scores, counts)."""
    m = np.asarray(metric, np.float64)
    s = m.shape[0]
    cx0, cy0 = np.asarray(cx0), np.asarray(cy0)
    v = np.asarray(valid)
    n_rows, n_cols = int(grid.n_rows), int(grid.n_cols)
    offs = np.arange(-half, half + 1)
    w = offs.size
    t = cx0.shape[0]
    scores = np.zeros((t, w, w))
    counts = np.zeros((t, w, w))
    for b in np.nonzero(v)[0]:
        for ti in range(t):
            rows = cy0[ti, b] + offs
            cols = cx0[ti, b] + offs
            rok = (rows >= 1) & (rows < n_rows - 1)
            cok = (cols >= 1) & (cols < n_cols - 1)
            inb = rok[:, None] & cok[None, :]
            win = m[np.clip(rows, 0, s - 1)][:, np.clip(cols, 0, s - 1)]
            scores[ti] += np.where(inb, win, 0.0)
            counts[ti] += inb
    return scores, counts


def check_volume(case: str) -> dict:
    """Scores and counts must equal the float64 sum exactly: lattice values
    summed below 2^14 are exact in f32, so any difference means lost bits
    (a TF32 contraction, for one)."""
    import jax

    from lidar_slam_tpu.ops import correlative

    metric, grid, sx, sy, valid, base, t, step, half = _volume_case(case)
    build = jax.jit(lambda m, x, y, v, b: correlative.build_score_volume(
        m, grid, x, y, v, b, n_theta=t, theta_step=step, half=half))
    vol = build(metric, sx, sy, valid, base)
    cx0, cy0 = correlative.base_cells(grid, sx, sy, base, t, step)
    want_s, want_c = volume_reference(metric, grid, cx0, cy0, valid, half)
    got_s = np.asarray(vol.scores, np.float64)
    got_c = np.asarray(vol.counts, np.float64)
    check(np.array_equal(got_s, want_s),
          f"volume {case} scores differ: max {np.abs(got_s - want_s).max()}")
    check(np.array_equal(got_c, want_c),
          f"volume {case} counts differ: max {np.abs(got_c - want_c).max()}")
    ms = device_ms(lambda b: build(metric, sx, sy, valid, b).scores, base)
    return {"case": case, "shape": list(vol.scores.shape), "exact": True,
            "ms": ms}


def trilinear_reference(scores, counts, base, ipixel, theta_step, half,
                        poses):
    """float64 trilinear interpolation of scores and counts, then ratio."""
    sc = np.asarray(scores, np.float64)
    ct = np.asarray(counts, np.float64)
    t, w, _ = sc.shape
    p = np.asarray(poses, np.float64)
    b = np.asarray(base, np.float64)
    f = np.stack([(p[:, 2] - b[2]) / theta_step + t // 2,
                  (p[:, 1] - b[1]) * ipixel + half,
                  (p[:, 0] - b[0]) * ipixel + half], 1)
    i0 = np.floor(f).astype(int)
    a = f - i0
    num = np.zeros(len(p))
    den = np.zeros(len(p))
    for corner in np.ndindex(2, 2, 2):
        c = np.asarray(corner)
        wgt = np.prod(np.where(c, a, 1 - a), axis=1)
        idx = np.clip(i0 + c, 0, [t - 1, w - 1, w - 1])
        num += wgt * sc[idx[:, 0], idx[:, 1], idx[:, 2]]
        den += wgt * ct[idx[:, 0], idx[:, 1], idx[:, 2]]
    return num / np.maximum(den, 1.0)


def check_lookup() -> dict:
    """Trilinear lookup of 1024 in-window poses at rtol 1e-6."""
    import jax
    import jax.numpy as jnp

    from lidar_slam_tpu.ops import correlative

    metric, grid, sx, sy, valid, base, t, step, half = _volume_case("pf")
    vol = correlative.build_score_volume(metric, grid, sx, sy, valid, base,
                                         n_theta=t, theta_step=step,
                                         half=half)
    rng = np.random.default_rng(1)
    px = float(grid.pixel)
    poses = np.asarray(base) + np.stack(
        [rng.uniform(-half * px, half * px, 1024),
         rng.uniform(-half * px, half * px, 1024),
         rng.uniform(-(t // 2) * step, (t // 2) * step, 1024)], 1)
    poses = jnp.asarray(poses, jnp.float32)
    got = np.asarray(jax.jit(correlative.lookup_avg_distance)(vol, poses))
    want = trilinear_reference(vol.scores, vol.counts, base,
                               float(vol.ipixel), step, half, poses)
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    check(err <= 1e-6, f"trilinear lookup rel err {err} > 1e-6")
    return {"poses": 1024, "max_rel_err": err}


def phase_kernels() -> dict:
    out = {"edt": [check_edt(400), check_edt(512)],
           "volume": [check_volume("pf"), check_volume("closure")],
           "lookup": check_lookup()}
    return out


# ---------------------------------------------------------------------------
# phase 2-5: the main path through the CLI and library entry points
# ---------------------------------------------------------------------------

def phase_pf() -> dict:
    """PF-1024 on museum-1000 through the CLI, then timed warm."""
    import jax

    from lidar_slam_tpu.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu.io import dataset
    from lidar_slam_tpu.models import fastslam
    from lidar_slam_tpu.utils.metrics import ate

    out, cold = cli(["run", "--mode", "pf", "--particles", "1024"])
    cli_ate = _grab(r"ATE vs ground truth: ([0-9.eE+-]+) m", out)
    ranges, gt, _ = dataset.ensure_dataset(n_scans=1000, seed=0)
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, particles=ParticleConfig(n_particles=1024))
    path = np.asarray(fastslam.run_pf(ranges, cfg)[0])
    err = float(ate(path, gt))
    check(np.isfinite(path).all() and path.shape == (1000, 3),
          "PF path not finite (1000, 3)")
    check(err < 0.10, f"PF-1024 ATE {err} >= 0.10 m")
    check(abs(err - cli_ate) < 1e-3, f"CLI ATE {cli_ate} != library {err}")
    warm = wall(lambda: jax.block_until_ready(fastslam.run_pf(ranges, cfg)))
    return {"ate_m": err, "scans_per_s": (len(ranges) - 1) / warm,
            "warm_s": warm, "cli_cold_s": cold,
            "compile_s": max(cold - warm, 0.0)}


def phase_fidelity() -> dict:
    """Fidelity mode on museum-1000 against the C++ oracle."""
    import jax

    from lidar_slam_tpu import native
    from lidar_slam_tpu.config import DEFAULT_CONFIG
    from lidar_slam_tpu.io import dataset
    from lidar_slam_tpu.models import scan_matcher
    from lidar_slam_tpu.utils.metrics import ate, max_abs_err

    out, cold = cli(["run", "--mode", "fidelity"])
    cli_ate = _grab(r"ATE vs ground truth: ([0-9.eE+-]+) m", out)
    ranges, gt, _ = dataset.ensure_dataset(n_scans=1000, seed=0)
    jpath = np.asarray(scan_matcher.run_scan(ranges, DEFAULT_CONFIG)[0])
    cpath, _ = native.run_oracle(ranges)
    err, oracle_err = float(ate(jpath, gt)), float(ate(cpath, gt))
    mae = float(max_abs_err(jpath, cpath))
    first = (int(np.argmax(np.any(jpath != cpath, axis=1)))
             if mae > 0 else None)
    check(np.isfinite(jpath).all(), "fidelity path not finite")
    check(err < 0.08, f"fidelity ATE {err} >= 0.08 m")
    check(abs(err - oracle_err) < 1e-3,
          f"fidelity ATE {err} vs oracle {oracle_err}: more than 1 mm apart")
    check(abs(err - cli_ate) < 1e-3, f"CLI ATE {cli_ate} != library {err}")
    warm = wall(lambda: jax.block_until_ready(
        scan_matcher.run_scan(ranges, DEFAULT_CONFIG)))
    return {"ate_m": err, "oracle_ate_m": oracle_err, "max_abs_err": mae,
            "bit_exact": mae == 0.0, "first_diverging_scan": first,
            "scans_per_s": (len(ranges) - 1) / warm, "cli_cold_s": cold,
            "compile_s": max(cold - warm, 0.0)}


def posegraph_reference(g, iters: int = 10, damping: float = 1e-4,
                        huber_delta: float = 3.0) -> np.ndarray:
    """float64 numpy damped Gauss-Newton with the same robust weighting,
    gauge prior and inactive-node rows as ``posegraph.optimize``."""
    poses = np.asarray(g.poses, np.float64).copy()
    ei, ej = np.asarray(g.edge_i), np.asarray(g.edge_j)
    z = np.asarray(g.edge_z, np.float64)
    w = np.asarray(g.edge_w, np.float64) * np.asarray(g.edge_active)[:, None]
    act = np.asarray(g.node_active)
    k = poses.shape[0]
    wrap = lambda a: a - 2 * np.pi * np.floor((a + np.pi) / (2 * np.pi))
    for _ in range(iters):
        xi, xj = poses[ei], poses[ej]
        c, s = np.cos(xi[:, 2]), np.sin(xi[:, 2])
        dx, dy = xj[:, 0] - xi[:, 0], xj[:, 1] - xi[:, 1]
        r = np.stack([c * dx + s * dy - z[:, 0], -s * dx + c * dy - z[:, 1],
                      wrap(xj[:, 2] - xi[:, 2] - z[:, 2])], 1)
        zero, one = np.zeros_like(c), np.ones_like(c)
        ji = np.stack([np.stack([-c, -s, -s * dx + c * dy], 1),
                       np.stack([s, -c, -c * dx - s * dy], 1),
                       np.stack([zero, zero, -one], 1)], 1)
        jj = np.stack([np.stack([c, s, zero], 1),
                       np.stack([-s, c, zero], 1),
                       np.stack([zero, zero, one], 1)], 1)
        chi = np.sqrt(np.maximum(np.sum(w * r * r, 1), 1e-12))
        wm = w * np.minimum(1.0, huber_delta / chi)[:, None]
        h = np.zeros((3 * k, 3 * k))
        b = np.zeros(3 * k)
        for a_idx, ja in ((ei, ji), (ej, jj)):
            for b_idx, jb in ((ei, ji), (ej, jj)):
                blk = np.einsum("eab,ea,eac->ebc", ja, wm, jb)
                for e in range(len(ei)):
                    ra, rb = 3 * a_idx[e], 3 * b_idx[e]
                    h[ra:ra + 3, rb:rb + 3] += blk[e]
            be = np.einsum("eab,ea->eb", ja, wm * r)
            np.add.at(b, (3 * a_idx[:, None] + np.arange(3)).ravel(),
                      be.ravel())
        diag = np.arange(3 * k)
        h[diag, diag] += (np.where(diag < 3, 1e6, 0.0)
                          + np.repeat(~act, 3) + damping)
        delta = np.linalg.solve(h, -b).reshape(k, 3)
        poses = poses + delta * act[:, None]
        poses[:, 2] = wrap(poses[:, 2])
    return poses


# Pose-graph tolerance, in metres and radians: the f32 solve (an LU
# factorisation of the dense (3K)^2 normal matrix, K = 512 slots) against a
# float64 solve of the same damped Gauss-Newton. Keyframe coordinates reach
# tens of metres, where one f32 ulp is ~2e-6 m; ten iterations of an LU
# solve with a 1e6 gauge prior amplify round-off by a few tens of ulps (the
# CPU backend lands at ~1e-6 m). 1e-4 allows 50 ulps and is still 1/1000
# of the 0.1 m ATE limit the graph is held to.
POSEGRAPH_ATOL = 1e-4


def check_posegraph(g) -> dict:
    from lidar_slam_tpu.models import posegraph

    got = np.asarray(posegraph.optimize(g, iters=10).poses, np.float64)
    want = posegraph_reference(g)
    act = np.asarray(g.node_active)
    err_xy = float(np.max(np.abs(got[act, :2] - want[act, :2])))
    err_th = float(np.max(np.abs(got[act, 2] - want[act, 2])))
    check(err_xy <= POSEGRAPH_ATOL and err_th <= POSEGRAPH_ATOL,
          f"pose-graph solve vs float64: {err_xy} m, {err_th} rad")
    return {"nodes": int(act.sum()), "edges": int(g.n_edges),
            "max_err_m": err_xy, "max_err_rad": err_th,
            "atol": POSEGRAPH_ATOL}


def phase_graph() -> dict:
    """Graph mode with loop closures on loop-700, then its pose graph."""
    from lidar_slam_tpu.config import DEFAULT_CONFIG
    from lidar_slam_tpu.io import simulate
    from lidar_slam_tpu.models.graph_slam import GraphSlam
    from lidar_slam_tpu.utils.metrics import ate

    out, cold = cli(["run", "--mode", "graph", "--loop", "--scans", "700"])
    cli_ate = _grab(r"ATE vs ground truth: ([0-9.eE+-]+) m", out)
    cli_closures = _grab(r"loop closures (\d+)", out)
    ranges, gt = simulate.generate_dataset(
        n_scans=700, seed=0, waypoints=simulate.LOOP_WAYPOINTS)
    gs = GraphSlam(DEFAULT_CONFIG)
    t0 = time.perf_counter()
    path, _ = gs.run(ranges)
    warm = time.perf_counter() - t0
    err = float(ate(np.asarray(path), gt))
    check(np.isfinite(path).all(), "graph path not finite")
    check(len(gs.closures) >= 1, "no loop closure on loop-700")
    check(err < 0.1, f"graph ATE {err} >= 0.1 m")
    check(cli_closures >= 1 and cli_ate < 0.1,
          f"CLI graph run: {cli_closures} closures, ATE {cli_ate}")
    return {"ate_m": err, "closures": len(gs.closures),
            "keyframes": int(gs.kf.count),
            "scans_per_s": (len(ranges) - 1) / warm, "warm_s": warm,
            "cli_cold_s": cold, "compile_s": max(cold - warm, 0.0),
            "stages_s": {k: round(v, 3) for k, v in gs.timer.totals.items()},
            "posegraph": check_posegraph(gs.graph)}


def phase_stream(n: int = 50) -> dict:
    """HTTP scan server -> prefetching client -> jitted scan-matcher step."""
    import jax.numpy as jnp

    from lidar_slam_tpu.config import DEFAULT_CONFIG
    from lidar_slam_tpu.io import dataset
    from lidar_slam_tpu.io import server as srv
    from lidar_slam_tpu.models import scan_matcher

    ranges, _, _ = dataset.ensure_dataset(n_scans=1000, seed=0)
    step = scan_matcher.make_step_fn(DEFAULT_CONFIG)
    server = srv.ScanServer(ranges[:n]).start()
    lats, poses = [], []
    try:
        stream = srv.scan_stream(server.url, n)
        state = scan_matcher.init_state(jnp.asarray(next(stream)),
                                        DEFAULT_CONFIG)
        t_prev = time.perf_counter()
        for r in stream:
            state, pose = step(state, jnp.asarray(r))
            poses.append(np.asarray(pose))
            now = time.perf_counter()
            lats.append(now - t_prev)
            t_prev = now
    finally:
        server.stop()
    check(len(poses) == n - 1 and np.isfinite(poses).all(),
          f"stream returned {len(poses)} poses for {n - 1} scans")
    ms = np.asarray(lats[1:]) * 1e3        # first step carries the compile
    return {"scans": n, "first_step_s": lats[0],
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


# ---------------------------------------------------------------------------
# phase 6: four cards
# ---------------------------------------------------------------------------

def phase_four(n: int = 4) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import __graft_entry__ as ge
    from lidar_slam_tpu.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu.core import sensor
    from lidar_slam_tpu.io import dataset
    from lidar_slam_tpu.models import fastslam
    from lidar_slam_tpu.ops import edt
    from lidar_slam_tpu.parallel import mesh as mesh_lib
    from lidar_slam_tpu.parallel import sharded, sharded_edt
    from lidar_slam_tpu.utils.metrics import ate

    devs = jax.devices()[:n]
    ge.dryrun_multichip(n)

    # sharded PF-1024 step (particles over the cards) vs the plain step.
    # One step from the same state must agree (only the reduction order
    # over the particle axis differs). Over a whole run a flipped
    # resampling ancestor lets the two filters drift apart by noise, so
    # there the sharded run is held to phase 2's accuracy limit.
    ranges, gt, _ = dataset.ensure_dataset(n_scans=1000, seed=0)
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, particles=ParticleConfig(n_particles=1024))
    angles = jnp.asarray(sensor.beam_angles(cfg.lidar))
    mesh = mesh_lib.make_mesh(n_particles_shards=n, n_map_shards=1,
                              devices=devs)
    step, place = sharded.make_sharded_pf_step(cfg, mesh)
    st0 = fastslam.init_particles(jnp.asarray(ranges[0]), cfg)
    _, est_p = jax.jit(lambda s, r: fastslam.pf_step(s, r, cfg, angles))(
        st0, jnp.asarray(ranges[1]))
    _, est_s = step(place(st0), jnp.asarray(ranges[1]))
    one_step = float(np.max(np.abs(np.asarray(est_p) - np.asarray(est_s))))
    check(one_step < 1e-3, f"sharded PF step vs plain, one step: {one_step}")
    path_s, _ = sharded.run_sharded_pf(ranges, cfg, mesh)
    path_p = np.asarray(fastslam.run_pf(ranges, cfg)[0])
    ate_s, ate_p = float(ate(path_s, gt)), float(ate(path_p, gt))
    check(ate_s < 0.10, f"sharded PF-1024 museum-1000 ATE {ate_s} >= 0.10")

    # halo-exchange EDT over a 4-card map axis vs the single-device EDT
    occ = np.random.default_rng(0).random((512, 512)) < 0.02
    got = np.asarray(sharded_edt.edt_sharded(
        jnp.asarray(occ), Mesh(np.asarray(devs), ("map",))))
    want = np.asarray(edt.edt_clamped(jnp.asarray(occ), 10))
    check(np.array_equal(got, want), "sharded EDT != single-device EDT")
    return {"count": n, "dryrun_multichip": "ok",
            "pf_one_step_abs_diff": one_step, "pf_ate_sharded_m": ate_s,
            "pf_ate_plain_m": ate_p, "edt_sharded_exact": True}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    try:
        import jax
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if any(d.platform != "gpu" for d in jax.devices()):
        print(f"chip_smoke: no GPU (JAX devices: {jax.devices()})",
              file=sys.stderr)
        return 2
    dev = phase_device(4 if args.four else None)
    say("device", dev)
    phases = ([("four", phase_four)] if args.four else
              [("kernels", phase_kernels), ("pf", phase_pf),
               ("fidelity", phase_fidelity), ("graph", phase_graph),
               ("stream", phase_stream)])
    for name, fn in phases:
        t0 = time.perf_counter()
        res = fn()
        res["phase_s"] = time.perf_counter() - t0
        say(name, res)
    check("matplotlib" not in sys.modules, "matplotlib was imported")
    d = jax.devices()[0]
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
