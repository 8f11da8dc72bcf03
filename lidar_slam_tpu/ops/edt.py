"""Clamped Euclidean distance transform — the reference's profiled bottleneck.

The reference computes, for every free cell, the distance to the nearest
occupied cell, clamped to MAX_DIST = 10 px; occupied cells get 0
(``euclidean_distance_transform{,2}``, main.c:223-269). Its implementation is
an O(W*H*W*H) brute-force double scan (89.98% of total runtime, dissertation
p.33); the FPGA variant offloads exactly this loop.

Design: the clamp is the gift. Squared Euclidean distance separates, so the
clamped EDT is exact as two 1-D windowed min-passes with a window of +-R
(R = 10):

    d1[y, x]  = min_{|dx| <= R} (occ[y, x+dx] ? dx^2 : INF)
    d2[y, x]  = min_{|dy| <= R} (d1[y+dy, x] + dy^2)
    out[y, x] = occ[y, x] ? 0 : min(sqrt(d2), R)

(2R+1 shifted mins per pass instead of (2R+1)^2, all elementwise; any true
distance > R clamps to R, so no occupied cell outside the window can change
the result.) ``edt_clamped`` is the jnp form: XLA fuses the shift stack.
``edt_clamped_reference`` is the O(N^4)-faithful oracle used by tests, kept in
numpy so its cost stays off the hot path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_INF = np.float32(3.0e38)  # np scalar: inlined literal, never a hoisted const-buffer

# Distances are snapped to the 2^-10 lattice (see quantize_metric). With all
# values in [0, 10] on that lattice, a matcher score (sum over <= 1079 beams,
# bound 10790 < 2^14) and every partial sum are integer multiples of 2^-10
# below 2^24 * 2^-10 — exactly representable in f32 — so f32 summation is
# associative here and the score is identical no matter how XLA vs the C++
# oracle order the reduction. This is what makes trajectory parity enforceable
# at full workload scale: near-tie argmin candidates tie *exactly* in both
# implementations and resolve by the shared first-minimum order.
QUANT = np.float32(1024.0)
QUANT_INV = np.float32(1.0 / 1024.0)


def quantize_metric(dist: jnp.ndarray) -> jnp.ndarray:
    """Snap non-negative distances to multiples of 2^-10 (roundf semantics)."""
    return jnp.trunc(dist * QUANT + jnp.float32(0.5)) * QUANT_INV


@functools.partial(jax.jit, static_argnames=("max_dist",))
def edt_clamped(occ: jnp.ndarray, max_dist: int = 10) -> jnp.ndarray:
    """Exact clamped EDT of a boolean occupancy grid. Returns f32 (H, W).

    Free cells: min(distance to nearest occupied cell, max_dist).
    Occupied cells: 0. Matches main.c:223-245 on the valid region as long as
    cells outside the region are unoccupied.
    """
    occ = occ.astype(jnp.bool_)
    h, w = occ.shape
    r = int(max_dist)
    max_f = jnp.float32(float(max_dist))

    # Pass 1 (along x): d1 = min over dx of (occ shifted by dx ? dx^2 : INF)
    occ_pad = jnp.pad(occ, ((0, 0), (r, r)), constant_values=False)
    d1 = jnp.full((h, w), _INF)
    for dx in range(-r, r + 1):
        shifted = jax.lax.dynamic_slice(occ_pad, (0, dx + r), (h, w))
        d1 = jnp.minimum(d1, jnp.where(shifted, jnp.float32(dx * dx), _INF))

    # Pass 2 (along y): d2 = min over dy of (d1 shifted by dy) + dy^2
    d1_pad = jnp.pad(d1, ((r, r), (0, 0)), constant_values=_INF)
    d2 = jnp.full((h, w), _INF)
    for dy in range(-r, r + 1):
        shifted = jax.lax.dynamic_slice(d1_pad, (dy + r, 0), (h, w))
        d2 = jnp.minimum(d2, shifted + jnp.float32(dy * dy))

    dist = jnp.minimum(jnp.sqrt(jnp.minimum(d2, _INF)), max_f)
    return jnp.where(occ, jnp.float32(0.0), quantize_metric(dist))


@functools.partial(jax.jit, static_argnames=("max_dist",))
def edt_clamped_scatter_variant(occ: jnp.ndarray, max_dist: int = 10) -> jnp.ndarray:
    """The accelerated/HLS variant's EDT (reference C8b) — scatter form.

    ``main_accelerated.c:215-284`` (and the standalone HLS kernel) compute
    the transform obstacle-outward: init all cells to MAX_DIST, then each
    occupied cell relaxes every cell via ``d2 < distance^2``. An occupied
    cell's own dx=dy=0 term relaxes it to 0, so the scatter form is
    *semantically identical* to the canonical gather form — the dataflow
    difference only matters for hardware pipelining (loop unroll/partition
    in HLS, dissertation p.46 Table 7). We verified the equivalence and
    implement it without the occupied-cell branch; a test pins
    ``edt_clamped_scatter_variant == edt_clamped`` on random grids.
    """
    occ = occ.astype(jnp.bool_)
    # identical to edt_clamped except occupied cells are not forced to 0 by a
    # branch — the dx=dy=0 term produces it
    h, w = occ.shape
    r = int(max_dist)
    max_f = jnp.float32(float(max_dist))
    occ_pad = jnp.pad(occ, ((0, 0), (r, r)), constant_values=False)
    d1 = jnp.full((h, w), _INF)
    for dx in range(-r, r + 1):
        shifted = jax.lax.dynamic_slice(occ_pad, (0, dx + r), (h, w))
        d1 = jnp.minimum(d1, jnp.where(shifted, jnp.float32(dx * dx), _INF))
    d1_pad = jnp.pad(d1, ((r, r), (0, 0)), constant_values=_INF)
    d2 = jnp.full((h, w), _INF)
    for dy in range(-r, r + 1):
        shifted = jax.lax.dynamic_slice(d1_pad, (dy + r, 0), (h, w))
        d2 = jnp.minimum(d2, shifted + jnp.float32(dy * dy))
    return quantize_metric(jnp.minimum(jnp.sqrt(jnp.minimum(d2, _INF)), max_f))


def edt_clamped_reference(occ: np.ndarray, max_dist: float = 10.0) -> np.ndarray:
    """Brute-force oracle with the reference's exact update rule.

    Reproduces the quirk of main.c:230-241: ``min_dist`` starts at MAX_DIST
    and is lowered only when ``dist_square < min_dist**2`` — i.e. a cell at
    exactly distance MAX_DIST stays clamped. Used in tests to pin down the
    fast implementations (mirrors the reference's HW-vs-SW testbench pattern,
    dissertation p.45 §15.3.3).
    """
    occ = np.asarray(occ, bool)
    h, w = occ.shape
    out = np.zeros((h, w), np.float32)
    ys, xs = np.nonzero(occ)
    for y in range(h):
        for x in range(w):
            if occ[y, x]:
                continue
            min_dist = np.float32(max_dist)
            if len(xs):
                d2 = (xs - x) ** 2 + (ys - y) ** 2
                best = np.float32(np.sqrt(np.min(d2)))
                if best < min_dist:
                    min_dist = best
            out[y, x] = np.float32(np.trunc(min_dist * np.float32(1024.0)
                                            + np.float32(0.5))
                                   * np.float32(1.0 / 1024.0))
    return out
