"""Sensor model: beam angle table, range gating, polar->cartesian.

Capability parity with reference ``Subsystem_1/main.c``:
- ``SetLidarParameters`` (main.c:45-58): fixed angle table.
- ``readAScan`` (main.c:71-95): range gating + polar->cartesian with
  *compaction* (valid points packed to the front, ``scan.size`` count).

Design: no data-dependent compaction under jit. A scan is always a
fixed-shape ``(n_beams,)`` family of arrays plus a validity mask. Where the
reference's compacted ordering is behaviorally observable (the bestHits/scan
index interplay in map updates, main.c:941-948), we reproduce it with
mask-cumsum arithmetic instead of dynamic shapes — see
``models/scan_matcher.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from lidar_slam_tpu.config import LidarConfig


class Scan(NamedTuple):
    """One gated lidar scan in the sensor frame (fixed shape).

    ``x``/``y`` are the *valid-compacted* cartesian coordinates, zero-padded:
    entry ``j`` is the j-th valid beam in beam order (matching the reference's
    ``scan.x[0..size)``), and entries ``size..n_beams`` are zero. ``valid[j]``
    is ``j < size``.
    """

    x: jnp.ndarray      # (N,) f32
    y: jnp.ndarray      # (N,) f32
    valid: jnp.ndarray  # (N,) bool — prefix mask: valid[j] == (j < size)
    size: jnp.ndarray   # () i32


def beam_angles(cfg: LidarConfig) -> np.ndarray:
    """Angle table. The reference accumulates ``angle += increment`` in f32
    (main.c:53-57); we reproduce the accumulation to match its rounding."""
    angles = np.empty(cfg.n_beams, np.float32)
    a = np.float32(cfg.angle_min)
    inc = np.float32(cfg.angle_increment)
    for i in range(cfg.n_beams):
        angles[i] = a
        a = np.float32(a + inc)
    return angles


def read_scan(ranges: jnp.ndarray, angles: jnp.ndarray, cfg: LidarConfig) -> Scan:
    """Gate + convert one scan; jit-safe fixed-shape equivalent of readAScan.

    Gating matches main.c:78: drop if ``r < range_min`` or ``r > usable_range``
    (strict comparisons). Compaction to the front preserves beam order, which
    the downstream map-update indexing depends on.
    """
    from lidar_slam_tpu.core.trig32 import sincos32

    ranges = ranges.astype(jnp.float32)
    ok = (ranges >= cfg.range_min) & (ranges <= cfg.usable_range)
    sa, ca = sincos32(angles)   # deterministic trig shared with the C++ oracle
    x = ranges * ca
    y = ranges * sa
    # Stable compaction: position of each valid beam in the packed output.
    # Invalid beams are routed to an out-of-range slot so mode="drop" discards
    # them instead of clobbering the valid write that shares their cumsum slot.
    n = ranges.shape[0]
    pos = jnp.where(ok, jnp.cumsum(ok) - 1, n)
    size = jnp.sum(ok).astype(jnp.int32)
    cx = jnp.zeros(n, jnp.float32).at[pos].set(x, mode="drop")
    cy = jnp.zeros(n, jnp.float32).at[pos].set(y, mode="drop")
    valid = jnp.arange(n) < size
    return Scan(x=cx, y=cy, valid=valid, size=size)
