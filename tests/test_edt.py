"""EDT kernel tests: fast implementations vs the brute-force oracle.

Mirrors the reference's hardware-vs-software testbench strategy (random
bitmaps, dissertation p.45 §15.3.3) including its scaled-down-fixture trick
(10x10 sub-maps, p.46 §15.3.4).
"""

import numpy as np
import pytest

from lidar_slam_tpu.ops import edt


@pytest.mark.parametrize("shape,density,seed", [
    ((10, 10), 0.1, 0),
    ((10, 10), 0.5, 1),
    ((32, 48), 0.05, 2),
    ((64, 64), 0.02, 3),
    ((64, 64), 0.0, 4),   # empty grid: everything clamps to MAX_DIST
    ((200, 200), 0.01, 0),
    ((400, 400), 0.005, 1),
    ((64, 128), 0.1, 2),
    ((64, 128), 0.0, 5),
])
def test_edt_matches_oracle(shape, density, seed):
    """Exact against the brute-force reference and the C++ EDT."""
    from lidar_slam_tpu import native

    rng = np.random.default_rng(seed)
    occ = rng.random(shape) < density
    want = edt.edt_clamped_reference(occ, 10.0)
    got = np.asarray(edt.edt_clamped(occ, 10))
    assert np.array_equal(got, want)
    assert np.array_equal(got, native.edt_native(occ, 10.0))


def test_edt_single_obstacle_exact_values():
    occ = np.zeros((21, 21), bool)
    occ[10, 10] = True
    out = np.asarray(edt.edt_clamped(occ, 10))
    assert out[10, 10] == 0.0
    assert out[10, 13] == pytest.approx(3.0)
    assert out[7, 6] == pytest.approx(5.0)        # 3-4-5 triangle
    assert out[0, 0] == pytest.approx(10.0)        # sqrt(200) clamps
    # exactly MAX_DIST away stays clamped (strict < in the reference update)
    assert out[10, 0] == pytest.approx(10.0)


def test_edt_clamp_boundary():
    # distance sqrt(101) > 10 must clamp; distance sqrt(100) == 10 stays 10
    occ = np.zeros((4, 30), bool)
    occ[0, 0] = True
    out = np.asarray(edt.edt_clamped(occ, 10))
    assert out[0, 10] == pytest.approx(10.0)
    assert out[1, 10] == pytest.approx(10.0)
    assert out[0, 9] == pytest.approx(9.0)


def test_scatter_variant_equals_gather_form():
    """The accelerated variant's obstacle-outward EDT (main_accelerated.c)
    is semantically identical to the canonical gather form — the self-term
    relaxes occupied cells to 0. Pin the verified equivalence."""
    rng = np.random.default_rng(7)
    for density in (0.0, 0.02, 0.3):
        occ = rng.random((48, 80)) < density
        a = np.asarray(edt.edt_clamped(occ, 10))
        b = np.asarray(edt.edt_clamped_scatter_variant(occ, 10))
        np.testing.assert_allclose(a, b, atol=1e-6)
