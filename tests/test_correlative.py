"""Correlation-volume scoring: math properties + exactness vs float64."""

import numpy as np
import jax.numpy as jnp
import pytest

from lidar_slam_tpu.core.gridmap import OccGrid
from lidar_slam_tpu.ops import correlative


def _toy_grid(seed=0, s=64):
    rng = np.random.default_rng(seed)
    metric = jnp.asarray(rng.random((s, s)), jnp.float32) * 10.0
    grid = OccGrid(occ=jnp.zeros((s, s), jnp.bool_),
                   n_rows=jnp.int32(s - 4), n_cols=jnp.int32(s - 6),
                   origin=jnp.asarray([-3.0, -3.0], jnp.float32), pixel=0.1)
    n = 64
    scan_x = jnp.asarray(rng.uniform(-2, 2, n), jnp.float32)
    scan_y = jnp.asarray(rng.uniform(-2, 2, n), jnp.float32)
    valid = jnp.asarray(rng.random(n) < 0.9)
    return metric, grid, scan_x, scan_y, valid


def test_volume_matches_direct_scoring():
    """Volume value at integer offsets == direct masked gather scoring."""
    metric, grid, sx, sy, valid = _toy_grid()
    base = jnp.asarray([0.2, -0.1, 0.3], jnp.float32)
    vol = correlative.build_score_volume(metric, grid, sx, sy, valid, base,
                                         n_theta=3, half=4)
    # direct: project at the base pose, sum metric under shifted cells
    from lidar_slam_tpu.ops import matching

    cell_x, cell_y = matching.project_scan(sx, sy, base[None], grid)
    for dy, dx in [(0, 0), (2, -1), (-3, 3)]:
        cx = cell_x[0] + dx
        cy = cell_y[0] + dy
        inb = (cx > 1) & (cy > 1) & (cx < grid.n_cols) & (cy < grid.n_rows) & valid
        vals = metric[jnp.clip(cy - 1, 0, 63), jnp.clip(cx - 1, 0, 63)]
        want = float(jnp.sum(jnp.where(inb, vals, 0.0)))
        got = float(vol.scores[1, 4 + dy, 4 + dx])
        assert got == pytest.approx(want, rel=1e-5), (dy, dx)
        assert float(vol.counts[1, 4 + dy, 4 + dx]) == pytest.approx(
            float(jnp.sum(inb)), rel=1e-6)


def test_trilinear_lookup_interpolates():
    metric, grid, sx, sy, valid = _toy_grid(seed=5)
    base = jnp.asarray([0.0, 0.0, 0.0], jnp.float32)
    vol = correlative.build_score_volume(metric, grid, sx, sy, valid, base,
                                         n_theta=3, half=4)
    # at exactly the base pose the lookup hits the volume center
    d0 = float(correlative.lookup_avg_distance(vol, base[None])[0])
    want = float(vol.scores[1, 4, 4] / jnp.maximum(vol.counts[1, 4, 4], 1.0))
    assert d0 == pytest.approx(want, rel=1e-5)
    # halfway to the next cell: average of the two cell scores (bilinear)
    half_px = grid.pixel / 2.0
    d_half = float(correlative.lookup_avg_distance(
        vol, jnp.asarray([[half_px, 0.0, 0.0]]))[0])
    s_mid = 0.5 * (vol.scores[1, 4, 4] + vol.scores[1, 4, 5])
    c_mid = 0.5 * (vol.counts[1, 4, 4] + vol.counts[1, 4, 5])
    assert d_half == pytest.approx(float(s_mid / c_mid), rel=1e-4)


def _lattice_case(s, n_rows, n_cols, origin, pixel, lo, hi, n, seed):
    """Field on the 2^-10 lattice in [0, 10] (what the EDT produces), so
    every per-beam sum is exact in f32 whatever the summation order."""
    from lidar_slam_tpu.ops import edt

    rng = np.random.default_rng(seed)
    metric = edt.quantize_metric(
        jnp.asarray(rng.random((s, s)), jnp.float32) * 10.0)
    grid = OccGrid(occ=jnp.zeros((s, s), jnp.bool_),
                   n_rows=jnp.int32(n_rows), n_cols=jnp.int32(n_cols),
                   origin=jnp.asarray([origin, origin], jnp.float32),
                   pixel=pixel)
    sx = jnp.asarray(rng.uniform(lo, hi, n), jnp.float32)
    sy = jnp.asarray(rng.uniform(lo, hi, n), jnp.float32)
    valid = jnp.asarray(rng.random(n) < 0.9)
    return metric, grid, sx, sy, valid


@pytest.mark.parametrize("case", [
    # toy grid, partial active region
    dict(s=64, n_rows=60, n_cols=58, origin=-3.0, pixel=0.1, lo=-2, hi=2,
         n=64, seed=3, base=[-0.3, 0.4, -0.2], n_theta=5, step=0.004363,
         half=4),
    # wide window (the loop-closure half=14) over a larger grid
    dict(s=96, n_rows=96, n_cols=96, origin=-9.6, pixel=0.2, lo=-8, hi=8,
         n=64, seed=11, base=[0.3, -0.2, 0.15], n_theta=3, step=0.008727,
         half=14),
    # full-size fixed array with a small active region (the common case)
    dict(s=400, n_rows=120, n_cols=100, origin=-3.0, pixel=0.1, lo=0, hi=6,
         n=48, seed=9, base=[0.5, 0.5, 0.1], n_theta=3, step=0.004363,
         half=2),
])
def test_volume_exact_vs_float64_window_sum(case):
    """Scores and counts equal a float64 per-beam window sum bit for bit
    (the reference the GPU smoke test holds the card to)."""
    from chip_smoke import volume_reference

    metric, grid, sx, sy, valid = _lattice_case(
        case["s"], case["n_rows"], case["n_cols"], case["origin"],
        case["pixel"], case["lo"], case["hi"], case["n"], case["seed"])
    base = jnp.asarray(case["base"], jnp.float32)
    vol = correlative.build_score_volume(
        metric, grid, sx, sy, valid, base, n_theta=case["n_theta"],
        theta_step=case["step"], half=case["half"])
    cx0, cy0 = correlative.base_cells(grid, sx, sy, base, case["n_theta"],
                                      case["step"])
    want_s, want_c = volume_reference(metric, grid, cx0, cy0, valid,
                                      case["half"])
    assert np.array_equal(np.asarray(vol.scores, np.float64), want_s)
    assert np.array_equal(np.asarray(vol.counts, np.float64), want_c)
    assert want_c.sum() > 0   # the case does exercise in-bounds beams


def test_windowed_fast_match_default_is_reference_27():
    """window=1 must produce the reference's exact candidate grid (order and
    values), so fidelity-mode bit-parity is unchanged by the window feature."""
    from lidar_slam_tpu.ops import matching

    pose = jnp.asarray([1.0, -2.0, 0.3], jnp.float32)
    got = matching.candidate_grid_ref(pose, 0.05, 0.01, 1, 1)
    offs = jnp.array([-1.0, 0.0, 1.0], jnp.float32)
    th = jnp.repeat(pose[2] + offs * 0.01, 9)
    tx = jnp.tile(jnp.repeat(pose[0] + offs * 0.05, 3), 3)
    ty = jnp.tile(pose[1] + offs * 0.05, 9)
    want = jnp.stack([tx, ty, th], axis=-1)
    assert got.shape == (27, 3)
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_windowed_fast_match_recovers_large_offset():
    """A +-4-step window finds an alignment 3 steps away that the reference's
    +-1 window cannot reach in one call."""
    from lidar_slam_tpu.ops import matching

    metric, grid, sx, sy, valid = _toy_grid(seed=2)
    # plant a zero-cost trench exactly at offset (+3 steps in x)
    true_pose = jnp.asarray([0.3, 0.0, 0.0], jnp.float32)
    cx, cy = matching.project_scan(sx, sy, true_pose[None], grid)
    metric = metric.at[jnp.clip(cy[0] - 1, 0, 63),
                       jnp.clip(cx[0] - 1, 0, 63)].set(0.0)
    guess = jnp.zeros(3, jnp.float32)
    narrow = matching.fast_match(metric, grid, sx, sy, valid, guess,
                                 0.1, 0.01, 1, 1)
    wide = matching.fast_match(metric, grid, sx, sy, valid, guess,
                               0.1, 0.01, 4, 1)
    assert wide.score < narrow.score
    assert abs(float(wide.pose[0]) - 0.3) < 1e-6
