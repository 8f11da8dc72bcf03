"""Distributed Schur-complement bundle adjustment (multi-device).

``models/ba.py`` solves the reduced pose system densely on one device; at
scale (thousands of keyframes) both the Schur-correction einsum and the
(3K)^2 reduced matrix outgrow a single chip. This module block-shards the
solve over keyframes, the design SURVEY §7 calls "Schur-complement reduced
BA with block-sharded linear algebra" (the reference has no distribution at
all — its only "multi-node" mechanism is an HTTP relay chain, SURVEY §2.4).

Sharding layout (1-D mesh axis, default name "graph"):

- factor arrays (odometry E axis, observation F axis) are sharded — each
  device linearizes only its factor shard (embarrassingly parallel jacfwd);
- the reduced system is never materialized ANYWHERE: the Schur matvec
  S v = Hpp v - U^T Hll^-1 (U v) is evaluated *factor-wise* (the iterative-
  Schur form of ceres/g2o): each device scatter-adds its factors' 3x3/3x2
  block products into (K, 3)- and (L, 2)-shaped vectors and a ``psum``
  completes the row. The largest per-device intermediate is
  O(E/D + F/D + K + L) — no (K, K)- or (L, K)-shaped array exists on any
  device at any K (the round-4 version assembled a dense (K, K, 3, 3)
  Hessian per shard before scattering, gigabytes at the "thousands of
  keyframes" this module targets; ``test_sharded_ba.test_no_k2_intermediate``
  pins the property on the compiled HLO at K=256);
- the landmark system (Hll block-diagonal, bl) is psum-replicated —
  landmarks couple poses across shards, and the 2x2 blocks are tiny;
- the reduced solve is preconditioned conjugate gradients on replicated
  (K, 3) vectors with a block-Jacobi (3x3 pose-block) preconditioner
  (diagonal blocks assembled exactly, Schur diagonal correction summed
  per-factor); three ``psum``s per CG iteration, all K-shaped.

Gauge: pose 0 (and inactive poses) are handled as *exact* constraints
(matvec masks fixed rows/columns, identity diagonal) instead of the dense
path's 1e6 prior — a 1e6 diagonal entry would wreck CG conditioning.

Collectives used: ``psum`` only; nothing communicated ever
exceeds O(K + L) blocks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from lidar_slam_tpu.core import se2
from lidar_slam_tpu.models.ba import BAProblem, _inv2, _obs_residual, _odo_residual

# f32 contractions run at full precision on every backend (no TF32)
HIGHEST = jax.lax.Precision.HIGHEST


def make_graph_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name 'graph'."""
    devices = np.asarray(list(devices if devices is not None else jax.devices()))
    return Mesh(devices, axis_names=("graph",))


def _pad_to(x: jnp.ndarray, n: int, fill=0):
    if x.shape[0] == n:
        return x
    pad_width = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=fill)


def pad_problem(p: BAProblem, n_dev: int) -> BAProblem:
    """Pad every axis (K, L, E, F) to a multiple of ``n_dev``.

    Padded slots are inactive: they contribute zero to every normal-equation
    block and their states are pinned by the exact-constraint rows.
    """

    def up(n):
        return ((n + n_dev - 1) // n_dev) * n_dev

    k = up(p.poses.shape[0])
    l = up(p.landmarks.shape[0])
    e = up(p.odo_i.shape[0])
    f = up(p.obs_i.shape[0])
    return BAProblem(
        poses=_pad_to(p.poses, k),
        landmarks=_pad_to(p.landmarks, l),
        pose_active=_pad_to(p.pose_active, k, fill=False),
        lm_active=_pad_to(p.lm_active, l, fill=False),
        odo_i=_pad_to(p.odo_i, e),
        odo_j=_pad_to(p.odo_j, e),
        odo_z=_pad_to(p.odo_z, e),
        odo_w=_pad_to(p.odo_w, e),
        odo_active=_pad_to(p.odo_active, e, fill=False),
        obs_i=_pad_to(p.obs_i, f),
        obs_j=_pad_to(p.obs_j, f),
        obs_z=_pad_to(p.obs_z, f),
        obs_w=_pad_to(p.obs_w, f),
        obs_active=_pad_to(p.obs_active, f, fill=False),
    )


def _ba_kernel(poses0, lms0, pose_active, lm_active,
               odo_i, odo_j, odo_z, odo_w, odo_active,
               obs_i, obs_j, obs_z, obs_w, obs_active,
               *, axis_name: str, iters: int, cg_iters: int, damping: float):
    """Per-shard body. Factor arrays are local shards; state is replicated."""
    kmax = poses0.shape[0]
    lmax = lms0.shape[0]
    d = jax.lax.axis_size(axis_name)
    my = jax.lax.axis_index(axis_name)
    kl = kmax // d
    ll = lmax // d
    eye3 = jnp.eye(3, dtype=jnp.float32)

    # exact-constraint poses: gauge (node 0) + inactive slots
    fixed = (~pose_active) | (jnp.arange(kmax) == 0)

    obs_jac = jax.vmap(jax.jacfwd(_obs_residual, argnums=(0, 1)), in_axes=(0, 0, 0))
    obs_res = jax.vmap(_obs_residual, in_axes=(0, 0, 0))
    odo_jac = jax.vmap(jax.jacfwd(_odo_residual, argnums=(0, 1)), in_axes=(0, 0, 0))
    odo_res = jax.vmap(_odo_residual, in_axes=(0, 0, 0))

    def gn_iter(_, carry):
        poses, lms = carry

        # --- local factor linearization (this shard's factors only) -------
        xi = poses[odo_i]
        xj = poses[odo_j]
        (ji, jj) = odo_jac(xi, xj, odo_z)
        ro = odo_res(xi, xj, odo_z)
        wo = odo_w * odo_active[:, None]
        h_ii = jnp.einsum("eab,ea,eac->ebc", ji, wo, ji,
                          precision=HIGHEST)              # (E, 3, 3)
        h_jj = jnp.einsum("eab,ea,eac->ebc", jj, wo, jj, precision=HIGHEST)
        h_ij = jnp.einsum("eab,ea,eac->ebc", ji, wo, jj, precision=HIGHEST)
        b_i = jnp.einsum("eab,ea,ea->eb", ji, wo, ro, precision=HIGHEST)
        b_j = jnp.einsum("eab,ea,ea->eb", jj, wo, ro, precision=HIGHEST)

        xo = poses[obs_i]
        lo = lms[obs_j]
        (jp_, jl) = obs_jac(xo, lo, obs_z)
        rv = obs_res(xo, lo, obs_z)
        wv = obs_w * obs_active[:, None]
        hpp_o = jnp.einsum("fab,fa,fac->fbc", jp_, wv, jp_,
                           precision=HIGHEST)             # (F, 3, 3)
        hll_o = jnp.einsum("fab,fa,fac->fbc", jl, wv, jl,
                           precision=HIGHEST)             # (F, 2, 2)
        hpl_o = jnp.einsum("fab,fa,fac->fbc", jp_, wv, jl,
                           precision=HIGHEST)             # (F, 3, 2)
        bp_o = jnp.einsum("fab,fa,fa->fb", jp_, wv, rv, precision=HIGHEST)
        bl_o = jnp.einsum("fab,fa,fa->fb", jl, wv, rv, precision=HIGHEST)

        # --- assembled SMALL systems (K- and L-shaped only; psum completes
        # every row across shards — the factor blocks themselves never leave
        # their device, and no (K, K)- or (L, K)-shaped array is built)
        bp = jnp.zeros((kmax, 3), jnp.float32)
        bp = bp.at[odo_i].add(b_i, mode="drop")
        bp = bp.at[odo_j].add(b_j, mode="drop")
        bp = bp.at[obs_i].add(bp_o, mode="drop")
        bp = jax.lax.psum(bp, axis_name)
        hll = jnp.zeros((lmax, 2, 2), jnp.float32).at[obs_j].add(
            hll_o, mode="drop")
        bl = jnp.zeros((lmax, 2), jnp.float32).at[obs_j].add(bl_o, mode="drop")
        hll = jax.lax.psum(hll, axis_name)
        bl = jax.lax.psum(bl, axis_name)

        eye2 = jnp.eye(2, dtype=jnp.float32)
        hll = hll + eye2[None] * (damping
                                  + (~lm_active).astype(jnp.float32))[:, None, None]
        hll_inv = _inv2(hll)

        # --- reduced RHS: b_red = bp - U^T Hll^-1 bl, factor-wise (exact:
        # the correction is linear in U = sum of per-factor (3, 2) blocks)
        zb = jnp.einsum("lab,lb->la", hll_inv, bl,
                        precision=HIGHEST)                # (L, 2)
        corr = jnp.zeros((kmax, 3), jnp.float32).at[obs_i].add(
            jnp.einsum("fab,fb->fa", hpl_o, zb[obs_j],
                       precision=HIGHEST), mode="drop")
        b_red = bp - jax.lax.psum(corr, axis_name)
        rhs = jnp.where(fixed[:, None], 0.0, -b_red)          # (K, 3)

        # --- block-Jacobi preconditioner: exact Hpp diagonal blocks minus
        # the per-factor Schur diagonal correction (exact when each
        # (landmark, pose) pair carries one observation — the usual case —
        # and a fine preconditioner regardless)
        dpp = jnp.zeros((kmax, 3, 3), jnp.float32)
        dpp = dpp.at[odo_i].add(h_ii, mode="drop")
        dpp = dpp.at[odo_j].add(h_jj, mode="drop")
        dpp = dpp.at[obs_i].add(hpp_o, mode="drop")
        sdiag_f = jnp.einsum("fab,fbc,fdc->fad", hpl_o, hll_inv[obs_j],
                             hpl_o,
                                 precision=HIGHEST)       # (F, 3, 3)
        dpp = dpp.at[obs_i].add(-sdiag_f, mode="drop")
        dpp = jax.lax.psum(dpp, axis_name)                     # (K, 3, 3)
        dblocks = jnp.where(fixed[:, None, None], eye3[None],
                            dpp + damping * eye3[None])
        minv = jnp.linalg.inv(dblocks)                         # (K, 3, 3)

        notfix = (~fixed)[:, None].astype(jnp.float32)

        def matvec(v):
            """S v factor-wise; v and the result are replicated (K, 3)."""
            vm = v * notfix
            y = jnp.zeros((kmax, 3), jnp.float32)
            y = y.at[odo_i].add(
                jnp.einsum("eab,eb->ea", h_ii, vm[odo_i], precision=HIGHEST)
                + jnp.einsum("eab,eb->ea", h_ij, vm[odo_j],
                             precision=HIGHEST), mode="drop")
            y = y.at[odo_j].add(
                jnp.einsum("eba,eb->ea", h_ij, vm[odo_i], precision=HIGHEST)
                + jnp.einsum("eab,eb->ea", h_jj, vm[odo_j],
                             precision=HIGHEST), mode="drop")
            y = y.at[obs_i].add(
                jnp.einsum("fab,fb->fa", hpp_o, vm[obs_i],
                           precision=HIGHEST), mode="drop")
            # Schur term: yl = U^T vm (per-landmark), zl = Hll^-1 yl,
            # y -= U zl. U spans shards, so yl must psum BEFORE Hll^-1.
            yl = jnp.zeros((lmax, 2), jnp.float32).at[obs_j].add(
                jnp.einsum("fba,fb->fa", hpl_o, vm[obs_i],
                           precision=HIGHEST), mode="drop")
            y = jax.lax.psum(y, axis_name)
            yl = jax.lax.psum(yl, axis_name)
            zl = jnp.einsum("lab,lb->la", hll_inv, yl, precision=HIGHEST)
            y2 = jnp.zeros((kmax, 3), jnp.float32).at[obs_i].add(
                jnp.einsum("fab,fb->fa", hpl_o, zl[obs_j],
                           precision=HIGHEST), mode="drop")
            y = y - jax.lax.psum(y2, axis_name)
            # exact constraints: identity on fixed rows, damping on free
            return y * notfix + v * fixed[:, None] + damping * vm

        def precond(r):
            return jnp.einsum("kab,kb->ka", minv, r, precision=HIGHEST)

        # --- distributed PCG on S dp = rhs ----------------------------------
        x0 = jnp.zeros_like(rhs)
        r0 = rhs
        z0 = precond(r0)
        rz0 = jnp.sum(r0 * z0)

        def cg_step(_, st):
            x, r, z, pvec, rz = st
            ap = matvec(pvec)
            den = jnp.sum(pvec * ap)
            alpha = jnp.where(jnp.abs(den) > 1e-20, rz / den, 0.0)
            x = x + alpha * pvec
            r = r - alpha * ap
            z = precond(r)
            rz_new = jnp.sum(r * z)
            beta = jnp.where(jnp.abs(rz) > 1e-20, rz_new / rz, 0.0)
            return x, r, z, z + beta * pvec, rz_new

        dp, *_ = jax.lax.fori_loop(0, cg_iters, cg_step,
                                   (x0, r0, z0, z0, rz0))
        dp = jnp.where(fixed[:, None], 0.0, dp)

        # --- landmark back-substitution (replicated; L x tiny blocks) -------
        hlp_dp = jnp.zeros((lmax, 2), jnp.float32).at[obs_j].add(
            jnp.einsum("fba,fb->fa", hpl_o, dp[obs_i],
                       precision=HIGHEST), mode="drop")
        hlp_dp = jax.lax.psum(hlp_dp, axis_name)
        dl = jnp.einsum("lab,lb->la", hll_inv, -bl - hlp_dp, precision=HIGHEST)
        dl = dl * lm_active[:, None]

        new_poses = poses + dp
        new_poses = new_poses.at[:, 2].set(se2.wrap_angle(new_poses[:, 2]))
        return new_poses, lms + dl

    poses, lms = jax.lax.fori_loop(0, iters, gn_iter, (poses0, lms0))
    # return this shard's row-slices; shard_map reassembles the full arrays
    return (jax.lax.dynamic_slice_in_dim(poses, my * kl, kl, axis=0),
            jax.lax.dynamic_slice_in_dim(lms, my * ll, ll, axis=0))


@functools.partial(jax.jit,
                   static_argnames=("mesh", "axis_name", "iters", "cg_iters",
                                    "damping"))
def _run_sharded(p: BAProblem, mesh: Mesh, axis_name: str, iters: int,
                 cg_iters: int, damping: float):
    spec = P(axis_name)
    rep = P()
    kernel = functools.partial(_ba_kernel, axis_name=axis_name, iters=iters,
                               cg_iters=cg_iters, damping=damping)
    return jax.shard_map(
        kernel, mesh=mesh,
        in_specs=(rep, rep, rep, rep,
                  spec, spec, spec, spec, spec,
                  spec, spec, spec, spec, spec),
        out_specs=(spec, spec),
        check_vma=False,
    )(p.poses, p.landmarks, p.pose_active, p.lm_active,
      p.odo_i, p.odo_j, p.odo_z, p.odo_w, p.odo_active,
      p.obs_i, p.obs_j, p.obs_z, p.obs_w, p.obs_active)


def optimize_ba_sharded(p: BAProblem, mesh: Mesh | None = None,
                        axis_name: str = "graph", iters: int = 10,
                        damping: float = 1e-3,
                        cg_iters: int | None = None) -> BAProblem:
    """Distributed damped Gauss-Newton with Schur landmark elimination.

    Drop-in for ``models.ba.optimize_ba`` on a device mesh. ``cg_iters``
    defaults to the full reduced dimension (exact solve in exact arithmetic);
    at scale a few dozen iterations suffice thanks to the block-Jacobi
    preconditioner.
    """
    if mesh is None:
        mesh = make_graph_mesh()
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names
                         if a == axis_name]))
    orig_k = p.poses.shape[0]
    orig_l = p.landmarks.shape[0]
    pp = pad_problem(p, n_dev)
    if cg_iters is None:
        cg_iters = 3 * pp.poses.shape[0]
    poses, lms = _run_sharded(pp, mesh, axis_name, iters, int(cg_iters),
                              float(damping))
    return p._replace(poses=poses[:orig_k], landmarks=lms[:orig_l])
