"""SE(2) pose-graph backend: keyframe graph + Gauss-Newton optimization.

North-star capability (BASELINE.json config 5; absent in the reference —
SURVEY §0 "no loop closure, no pose graph"). Design:

- fixed-capacity graph (K_max nodes, E_max edges) with activity masks — the
  whole optimizer jits with static shapes;
- per-edge residuals/Jacobians via vmapped ``jax.jacfwd`` (3x3 blocks),
  assembled into the dense normal matrix H (3K x 3K) by scatter-add;
- damped Gauss-Newton (Levenberg) iterations under ``lax.fori_loop`` with a
  dense Cholesky/LU solve — for SLAM-scale K (hundreds of keyframes) the
  (3K)^3 solve is far below the EDT in cost. (The Schur-complement
  block elimination for landmark-augmented BA lives in ``models/ba.py``.)
- gauge fixed by a strong prior on node 0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lidar_slam_tpu.core import se2

# f32 contractions run at full precision on every backend (no TF32)
HIGHEST = jax.lax.Precision.HIGHEST


class PoseGraph(NamedTuple):
    poses: jnp.ndarray        # (K, 3)
    node_active: jnp.ndarray  # (K,) bool
    n_nodes: jnp.ndarray      # () i32
    edge_i: jnp.ndarray       # (E,) i32
    edge_j: jnp.ndarray       # (E,) i32
    edge_z: jnp.ndarray       # (E, 3) measured relative pose (frame i)
    edge_w: jnp.ndarray       # (E, 3) diagonal information (wx, wy, wtheta)
    edge_active: jnp.ndarray  # (E,) bool
    n_edges: jnp.ndarray      # () i32


def empty_graph(max_nodes: int, max_edges: int) -> PoseGraph:
    return PoseGraph(
        poses=jnp.zeros((max_nodes, 3), jnp.float32),
        node_active=jnp.zeros(max_nodes, jnp.bool_),
        n_nodes=jnp.int32(0),
        edge_i=jnp.zeros(max_edges, jnp.int32),
        edge_j=jnp.zeros(max_edges, jnp.int32),
        edge_z=jnp.zeros((max_edges, 3), jnp.float32),
        edge_w=jnp.ones((max_edges, 3), jnp.float32),
        edge_active=jnp.zeros(max_edges, jnp.bool_),
        n_edges=jnp.int32(0),
    )


def add_node(g: PoseGraph, pose: jnp.ndarray) -> tuple[PoseGraph, jnp.ndarray]:
    """Append a node (drops silently at capacity). Returns (graph, node_id)."""
    k = g.n_nodes
    poses = g.poses.at[k].set(pose, mode="drop")
    active = g.node_active.at[k].set(True, mode="drop")
    kmax = g.poses.shape[0]
    return g._replace(poses=poses, node_active=active,
                      n_nodes=jnp.minimum(k + 1, kmax)), k


def add_edge(g: PoseGraph, i: jnp.ndarray, j: jnp.ndarray, z: jnp.ndarray,
             w: jnp.ndarray, valid: jnp.ndarray | bool = True) -> PoseGraph:
    """Append an edge with measurement z = (i ⊖ j) and diagonal info w.

    ``valid=False`` burns no slot (used for masked/conditional insertion)."""
    valid = jnp.asarray(valid, jnp.bool_)
    e = g.n_edges
    slot = jnp.where(valid, e, g.edge_i.shape[0])
    return g._replace(
        edge_i=g.edge_i.at[slot].set(i.astype(jnp.int32), mode="drop"),
        edge_j=g.edge_j.at[slot].set(j.astype(jnp.int32), mode="drop"),
        edge_z=g.edge_z.at[slot].set(z, mode="drop"),
        edge_w=g.edge_w.at[slot].set(w, mode="drop"),
        edge_active=g.edge_active.at[slot].set(True, mode="drop"),
        n_edges=jnp.minimum(e + valid.astype(jnp.int32), g.edge_i.shape[0]),
    )


def _edge_residual(xi: jnp.ndarray, xj: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    r = se2.between(xi, xj) - z
    return r.at[2].set(se2.wrap_angle(r[2]))


@functools.partial(jax.jit, static_argnames=("iters", "robust"))
def optimize(g: PoseGraph, iters: int = 10, damping: float = 1e-4,
             robust: bool = True, huber_delta: float = 3.0) -> PoseGraph:
    """Damped Gauss-Newton over all active nodes/edges. Fixed shapes.

    ``robust=True`` applies Huber-style iteratively-reweighted least squares
    per edge (weight scaled by min(1, delta/||r||_W)), so a single bad loop
    closure cannot drag the whole graph (a standard robust-SLAM kernel)."""
    kmax = g.poses.shape[0]

    jac = jax.vmap(jax.jacfwd(_edge_residual, argnums=(0, 1)), in_axes=(0, 0, 0))
    res = jax.vmap(_edge_residual, in_axes=(0, 0, 0))

    def gn_iter(_, poses):
        xi = poses[g.edge_i]
        xj = poses[g.edge_j]
        (ji, jj) = jac(xi, xj, g.edge_z)                  # (E,3,3) each
        r = res(xi, xj, g.edge_z)                          # (E,3)
        wmask = g.edge_w * g.edge_active[:, None]          # (E,3)
        if robust:
            chi = jnp.sqrt(jnp.maximum(jnp.sum(wmask * r * r, axis=1), 1e-12))
            scale = jnp.minimum(1.0, huber_delta / chi)    # (E,)
            wmask = wmask * scale[:, None]

        # H and b accumulated blockwise via scatter-add into (K,K,3,3)/(K,3).
        wji = wmask[:, :, None] * ji                       # Omega @ Ji
        wjj = wmask[:, :, None] * jj
        h_ii = jnp.einsum("eab,eac->ebc", ji, wji, precision=HIGHEST)
        h_jj = jnp.einsum("eab,eac->ebc", jj, wjj, precision=HIGHEST)
        h_ij = jnp.einsum("eab,eac->ebc", ji, wjj, precision=HIGHEST)
        b_i = jnp.einsum("eab,ea->eb", ji, wmask * r, precision=HIGHEST)
        b_j = jnp.einsum("eab,ea->eb", jj, wmask * r, precision=HIGHEST)

        hblocks = jnp.zeros((kmax, kmax, 3, 3), jnp.float32)
        hblocks = hblocks.at[g.edge_i, g.edge_i].add(h_ii, mode="drop")
        hblocks = hblocks.at[g.edge_j, g.edge_j].add(h_jj, mode="drop")
        hblocks = hblocks.at[g.edge_i, g.edge_j].add(h_ij, mode="drop")
        hblocks = hblocks.at[g.edge_j, g.edge_i].add(
            jnp.swapaxes(h_ij, 1, 2), mode="drop")
        b = jnp.zeros((kmax, 3), jnp.float32)
        b = b.at[g.edge_i].add(b_i, mode="drop")
        b = b.at[g.edge_j].add(b_j, mode="drop")

        h = jnp.transpose(hblocks, (0, 2, 1, 3)).reshape(3 * kmax, 3 * kmax)
        bf = b.reshape(3 * kmax)

        # gauge prior on node 0 + identity rows for inactive nodes + damping
        diag = jnp.arange(3 * kmax)
        gauge = jnp.where(diag < 3, 1e6, 0.0)
        inactive = jnp.repeat(~g.node_active, 3).astype(jnp.float32)
        h = h + jnp.diag(gauge + inactive + damping)

        delta = jnp.linalg.solve(h, -bf).reshape(kmax, 3)
        new_poses = poses + delta * g.node_active[:, None]
        return new_poses.at[:, 2].set(se2.wrap_angle(new_poses[:, 2]))

    poses = jax.lax.fori_loop(0, iters, gn_iter, g.poses)
    return g._replace(poses=poses)


def graph_error(g: PoseGraph) -> jnp.ndarray:
    """Total weighted squared residual over active edges (diagnostics)."""
    res = jax.vmap(_edge_residual, in_axes=(0, 0, 0))(
        g.poses[g.edge_i], g.poses[g.edge_j], g.edge_z)
    return jnp.sum(g.edge_w * res * res * g.edge_active[:, None])
