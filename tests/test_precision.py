"""Precision policy: every f32 contraction on the hot paths runs at HIGHEST.

On a GPU a default-precision f32 dot may run in TF32 (11 significant bits),
which breaks the exact lattice sums the matcher and the oracle parity rely
on (ops/edt.py). The policy is stated at each call site; these tests walk
the jaxprs of the PF step and of one closure match and fail on any f32
``dot_general`` without ``precision=HIGHEST``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lidar_slam_tpu.config import DEFAULT_CONFIG, ParticleConfig


def _dots(jaxpr):
    """Every dot_general equation in a closed jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dots(sub)


def _f32_dots_not_highest(closed):
    bad, n = [], 0
    for eqn in _dots(closed.jaxpr):
        if not any(v.aval.dtype == jnp.float32 for v in eqn.invars):
            continue
        n += 1
        prec = eqn.params.get("precision")
        precs = prec if isinstance(prec, tuple) else (prec, prec)
        if not all(p == jax.lax.Precision.HIGHEST for p in precs):
            bad.append(str(eqn)[:200])
    return n, bad


def test_pf_step_f32_dots_are_highest():
    from lidar_slam_tpu.core import sensor
    from lidar_slam_tpu.io import simulate
    from lidar_slam_tpu.models import fastslam

    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        particles=ParticleConfig(n_particles=64, grad_refine_steps=1))
    ranges, _ = simulate.generate_dataset(n_scans=2, seed=0)
    angles = jnp.asarray(sensor.beam_angles(cfg.lidar))
    state = fastslam.init_particles(jnp.asarray(ranges[0]), cfg)
    closed = jax.make_jaxpr(
        lambda s, r: fastslam.pf_step(s, r, cfg, angles))(
            state, jnp.asarray(ranges[1]))
    n, bad = _f32_dots_not_highest(closed)
    assert n > 0            # the walk does see the step's contractions
    assert not bad, bad


def test_closure_match_f32_dots_are_highest():
    from lidar_slam_tpu.models import graph_slam

    lc = graph_slam.LoopClosureConfig()
    s, n = lc.raster_size, 1079
    rng = np.random.default_rng(0)
    args = (jnp.asarray(rng.random((2, s, s)), jnp.float32),
            jnp.asarray(rng.uniform(-5, 5, (2, n)), jnp.float32),
            jnp.asarray(rng.uniform(-5, 5, (2, n)), jnp.float32),
            jnp.ones((2, n), bool), jnp.zeros((2, 3), jnp.float32))
    closed = jax.make_jaxpr(
        lambda *a: graph_slam._match_keyframes_batch(*a, lc))(*args)
    n_dots, bad = _f32_dots_not_highest(closed)
    assert n_dots > 0
    assert not bad, bad


@pytest.mark.parametrize("module", ["lidar_slam_tpu.models.posegraph",
                                    "lidar_slam_tpu.models.ba",
                                    "lidar_slam_tpu.parallel.sharded_ba"])
def test_solver_einsums_are_highest(module):
    """Every einsum in the pose-graph and BA solvers names its precision."""
    import ast
    import importlib

    src = open(importlib.import_module(module).__file__).read()
    calls = [node for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute)
             and node.func.attr == "einsum"]
    assert calls
    for c in calls:
        kw = {k.arg: k.value for k in c.keywords}
        assert "precision" in kw and getattr(kw["precision"], "id",
                                             None) == "HIGHEST", c.lineno
