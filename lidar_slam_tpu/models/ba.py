"""Landmark bundle adjustment with Schur-complement reduction.

BASELINE.json config 5: "pose-graph backend with Schur-complement reduced
bundle adjustment". The pose graph (``posegraph.py``) optimizes pose-pose
factors; this module adds landmark-augmented BA: poses (K, 3) and landmarks
(L, 2) jointly, with range/bearing observation factors, solved per
Gauss-Newton iteration by eliminating the landmarks first:

    [Hpp  Hpl] [dp]   [bp]
    [Hlp  Hll] [dl] = [bl]

    S  = Hpp - Hpl Hll^-1 Hlp          (reduced pose system)
    dp = solve(S, bp - Hpl Hll^-1 bl)
    dl = Hll^-1 (bl - Hlp dp)          (back-substitution)

Structure: ``Hll`` is block-diagonal 2x2 (landmarks are
independent given poses) so its inverse is a closed-form batched op; all
factor residuals/Jacobians come from one vmapped ``jacfwd``; the block
products are einsums feeding scatter-adds; the only dense solve is the
(3K, 3K) reduced system. Fixed capacities + masks throughout.

Observation convention matches ``models/ekf_slam.py``: reference-convention
poses, z = (range, bearing) with bearing = atan2(dy, dx) + theta.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lidar_slam_tpu.core import se2

# f32 contractions run at full precision on every backend (no TF32)
HIGHEST = jax.lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    poses: jnp.ndarray        # (K, 3) initial pose estimates
    landmarks: jnp.ndarray    # (L, 2) initial landmark estimates
    pose_active: jnp.ndarray  # (K,) bool
    lm_active: jnp.ndarray    # (L,) bool
    # odometry factors (pose i -> pose j, measurement in standard convention)
    odo_i: jnp.ndarray        # (E,) i32
    odo_j: jnp.ndarray        # (E,)
    odo_z: jnp.ndarray        # (E, 3)
    odo_w: jnp.ndarray        # (E, 3)
    odo_active: jnp.ndarray   # (E,) bool
    # observation factors (pose i observes landmark j)
    obs_i: jnp.ndarray        # (F,) i32
    obs_j: jnp.ndarray        # (F,) i32
    obs_z: jnp.ndarray        # (F, 2) (range, bearing)
    obs_w: jnp.ndarray        # (F, 2) diagonal information
    obs_active: jnp.ndarray   # (F,) bool


def _obs_residual(pose: jnp.ndarray, lm: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    dx = lm[0] - pose[0]
    dy = lm[1] - pose[1]
    r = jnp.sqrt(jnp.maximum(dx * dx + dy * dy, 1e-12))
    bearing = jnp.arctan2(dy, dx) + pose[2]
    return jnp.stack([r - z[0], se2.wrap_angle(bearing - z[1])])


def _odo_residual(xi: jnp.ndarray, xj: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    r = se2.between(xi, xj) - z
    return r.at[2].set(se2.wrap_angle(r[2]))


def _inv2(m):
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = jnp.maximum(a * d - b * c, 1e-12)
    inv = jnp.stack([jnp.stack([d, -b], -1), jnp.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_ba(p: BAProblem, iters: int = 10, damping: float = 1e-3) -> BAProblem:
    """Damped Gauss-Newton with Schur-complement landmark elimination."""
    kmax = p.poses.shape[0]
    lmax = p.landmarks.shape[0]

    obs_jac = jax.vmap(jax.jacfwd(_obs_residual, argnums=(0, 1)),
                       in_axes=(0, 0, 0))
    obs_res = jax.vmap(_obs_residual, in_axes=(0, 0, 0))
    odo_jac = jax.vmap(jax.jacfwd(_odo_residual, argnums=(0, 1)),
                       in_axes=(0, 0, 0))
    odo_res = jax.vmap(_odo_residual, in_axes=(0, 0, 0))

    def gn_iter(_, carry):
        poses, lms = carry

        # --- odometry factor blocks (as in posegraph.optimize)
        xi = poses[p.odo_i]
        xj = poses[p.odo_j]
        (ji, jj) = odo_jac(xi, xj, p.odo_z)
        ro = odo_res(xi, xj, p.odo_z)
        wo = p.odo_w * p.odo_active[:, None]
        h_ii = jnp.einsum("eab,ea,eac->ebc", ji, wo, ji, precision=HIGHEST)
        h_jj = jnp.einsum("eab,ea,eac->ebc", jj, wo, jj, precision=HIGHEST)
        h_ij = jnp.einsum("eab,ea,eac->ebc", ji, wo, jj, precision=HIGHEST)
        b_i = jnp.einsum("eab,ea,ea->eb", ji, wo, ro, precision=HIGHEST)
        b_j = jnp.einsum("eab,ea,ea->eb", jj, wo, ro, precision=HIGHEST)

        hpp = jnp.zeros((kmax, kmax, 3, 3), jnp.float32)
        hpp = hpp.at[p.odo_i, p.odo_i].add(h_ii, mode="drop")
        hpp = hpp.at[p.odo_j, p.odo_j].add(h_jj, mode="drop")
        hpp = hpp.at[p.odo_i, p.odo_j].add(h_ij, mode="drop")
        hpp = hpp.at[p.odo_j, p.odo_i].add(jnp.swapaxes(h_ij, 1, 2), mode="drop")
        bp = jnp.zeros((kmax, 3), jnp.float32)
        bp = bp.at[p.odo_i].add(b_i, mode="drop")
        bp = bp.at[p.odo_j].add(b_j, mode="drop")

        # --- observation factor blocks
        xo = poses[p.obs_i]
        lo = lms[p.obs_j]
        (jp_, jl) = obs_jac(xo, lo, p.obs_z)          # (F,2,3), (F,2,2)
        rv = obs_res(xo, lo, p.obs_z)                 # (F,2)
        wv = p.obs_w * p.obs_active[:, None]          # (F,2)
        hpp_o = jnp.einsum("fab,fa,fac->fbc", jp_, wv, jp_,
                           precision=HIGHEST)             # (F,3,3)
        hll_o = jnp.einsum("fab,fa,fac->fbc", jl, wv, jl,
                           precision=HIGHEST)             # (F,2,2)
        hpl_o = jnp.einsum("fab,fa,fac->fbc", jp_, wv, jl,
                           precision=HIGHEST)             # (F,3,2)
        bp_o = jnp.einsum("fab,fa,fa->fb", jp_, wv, rv,
                          precision=HIGHEST)              # (F,3)
        bl_o = jnp.einsum("fab,fa,fa->fb", jl, wv, rv,
                          precision=HIGHEST)              # (F,2)

        hpp = hpp.at[p.obs_i, p.obs_i].add(hpp_o, mode="drop")
        bp = bp.at[p.obs_i].add(bp_o, mode="drop")
        hll = jnp.zeros((lmax, 2, 2), jnp.float32)
        hll = hll.at[p.obs_j].add(hll_o, mode="drop")
        bl = jnp.zeros((lmax, 2), jnp.float32)
        bl = bl.at[p.obs_j].add(bl_o, mode="drop")

        # damp + activate landmark blocks, closed-form invert
        eye2 = jnp.eye(2, dtype=jnp.float32)
        hll = hll + eye2[None] * (damping
                                  + (~p.lm_active).astype(jnp.float32))[:, None, None]
        hll_inv = _inv2(hll)                                   # (L,2,2)

        # --- Schur complement: S = Hpp - Hpl Hll^-1 Hlp. Hpl's nonzero
        # (pose, landmark) blocks are scatter-added into U (L, K, 3, 2);
        # the correction folds over the landmark axis as one einsum
        # (block-diagonal Hll^-1 in the middle). For SLAM-scale K, L this
        # is a few-MB tensor and dense contractions.
        u = jnp.zeros((lmax, kmax, 3, 2), jnp.float32)
        u = u.at[p.obs_j, p.obs_i].add(hpl_o, mode="drop")
        s_corr = jnp.einsum("lkab,lbc,lmdc->kmad", u, hll_inv, u,
                            precision=HIGHEST)
        bp_corr = jnp.einsum("lkab,lbc,lc->ka", u, hll_inv, bl,
                             precision=HIGHEST)

        s_blocks = hpp - s_corr
        b_red = bp - bp_corr

        s = jnp.transpose(s_blocks, (0, 2, 1, 3)).reshape(3 * kmax, 3 * kmax)
        bf = b_red.reshape(3 * kmax)
        diag = jnp.arange(3 * kmax)
        gauge = jnp.where(diag < 3, 1e6, 0.0)
        inactive = jnp.repeat(~p.pose_active, 3).astype(jnp.float32)
        s = s + jnp.diag(gauge + inactive + damping)

        dp = jnp.linalg.solve(s, -bf).reshape(kmax, 3)
        dp = dp * p.pose_active[:, None]
        # back-substitute landmarks: dl = Hll^-1 (-bl - Hlp dp)
        hlp_dp = jnp.einsum("lkba,kb->la", u, dp, precision=HIGHEST)
        dl = jnp.einsum("lab,lb->la", hll_inv, -bl - hlp_dp, precision=HIGHEST)
        dl = dl * p.lm_active[:, None]

        new_poses = poses + dp
        new_poses = new_poses.at[:, 2].set(se2.wrap_angle(new_poses[:, 2]))
        return new_poses, lms + dl

    poses, lms = jax.lax.fori_loop(0, iters, gn_iter, (p.poses, p.landmarks))
    return p._replace(poses=poses, landmarks=lms)


def ba_error(p: BAProblem) -> jnp.ndarray:
    ro = jax.vmap(_odo_residual)(p.poses[p.odo_i], p.poses[p.odo_j], p.odo_z)
    rv = jax.vmap(_obs_residual)(p.poses[p.obs_i], p.landmarks[p.obs_j], p.obs_z)
    return (jnp.sum(p.odo_w * ro * ro * p.odo_active[:, None])
            + jnp.sum(p.obs_w * rv * rv * p.obs_active[:, None]))
