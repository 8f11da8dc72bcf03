"""Native C++ runtime pieces, exposed through ctypes.

The reference's native components (SURVEY §2.2) are a C pipeline, an
HLS-targeted EDT kernel, and C/C++ offload hosts. Here the native layer
provides:

- ``run_oracle``: a clean-room C++ implementation of the whole baseline
  pipeline (golden trajectories for ATE parity tests; C-baseline timing on
  this very host, so bench comparisons are apples-to-apples);
- ``edt_native``: standalone clamped-EDT oracle;
- ``read_csv``: fast dataset ingest (the production input path — numpy's
  loadtxt is ~20x slower on the 1000x1079 dump).

Built from ``src/slam_core.cpp`` with g++ on first use (plain ctypes ABI);
the library is a build output and is never committed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "src", "slam_core.cpp")
_LIB = os.path.join(os.path.dirname(__file__), "libtpuslam.so")
_lib = None


def _build() -> None:
    # -ffp-contract=off: keep multiply-add rounding identical to XLA:CPU so
    # trajectory parity tests can demand bit-exactness over long runs.
    # Build to a private name and rename: concurrent first uses (test
    # workers) never load a half-written library.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared",
           "-fPIC", "-std=c++17", "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        _build()
    lib = ctypes.CDLL(_LIB)
    lib.tpuslam_run.restype = ctypes.c_int
    lib.tpuslam_run.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.tpuslam_run_cfg.restype = ctypes.c_int
    lib.tpuslam_run_cfg.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.tpuslam_edt.restype = None
    lib.tpuslam_edt.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.POINTER(ctypes.c_float),
    ]
    lib.tpuslam_sincos32.restype = None
    lib.tpuslam_sincos32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.tpuslam_read_csv.restype = ctypes.c_int
    lib.tpuslam_read_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def run_oracle(ranges: np.ndarray, use_naive_edt: bool = False,
               map_capacity: int = 20000, usable_range: float = 0.0,
               coarse_size: int = 0, fine_size: int = 0):
    """Run the C++ oracle pipeline. Returns (path (T,3), map (M,2)).

    The keyword overrides (0 = keep the museum defaults) select the
    building-scale configuration — pass the matching ``SlamConfig`` fields
    (e.g. ``config.BUILDING_CONFIG``) so oracle-vs-JAX parity is like-for-like.
    """
    lib = get_lib()
    ranges = np.ascontiguousarray(ranges, np.float32)
    t, n_beams = ranges.shape
    path = np.zeros((t, 3), np.float32)
    omap = np.zeros((map_capacity, 2), np.float32)
    msize = lib.tpuslam_run_cfg(_fptr(ranges), t, n_beams,
                                1 if use_naive_edt else 0,
                                ctypes.c_float(usable_range),
                                coarse_size, fine_size, map_capacity,
                                _fptr(path), _fptr(omap), map_capacity)
    return path, omap[:msize]


def run_oracle_cfg(ranges: np.ndarray, cfg, use_naive_edt: bool = False):
    """run_oracle with sizes taken from a ``SlamConfig``."""
    return run_oracle(ranges, use_naive_edt=use_naive_edt,
                      map_capacity=cfg.map.map_capacity,
                      usable_range=cfg.lidar.usable_range,
                      coarse_size=cfg.grid.coarse_size,
                      fine_size=cfg.grid.fine_size)


def edt_native(occ: np.ndarray, max_dist: float = 10.0) -> np.ndarray:
    lib = get_lib()
    occ8 = np.ascontiguousarray(occ, np.uint8)
    h, w = occ8.shape
    out = np.zeros((h, w), np.float32)
    lib.tpuslam_edt(occ8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    h, w, max_dist, _fptr(out))
    return out


def read_csv(path: str, n_rows: int, n_cols: int = 1079) -> np.ndarray:
    lib = get_lib()
    out = np.zeros((n_rows, n_cols), np.float32)
    got = lib.tpuslam_read_csv(path.encode(), n_rows, n_cols, _fptr(out))
    if got < 0:
        raise FileNotFoundError(path)
    return out[:got]
