"""Pose-graph residuals and refinement (north-star capability, BASELINE.json
config 3: BFS-ordered incremental BA with pose-graph refinement).

The reference has no pose-graph stage; this is new capability. Standard
formulation: poses are world->camera transforms (angle-axis w, translation t
— the same parameterization as the scene extrinsics); an edge (i, j) carries
a measured relative transform T_ij = T_i o T_j^-1, and the residual is the
6-dof log of the discrepancy:

    R_rel = R_i R_j^T                  t_rel = t_i - R_rel t_j
    r_rot = log(R_meas^T R_rel)        r_t   = t_rel - t_meas

Batched over edges, differentiable (rotation log via the quaternion path in
geometry.rotation), minimized with the dense LM core (solver.lm).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from deeparc_tpu.geometry.rotation import (
    angle_axis_to_matrix,
    matrix_to_angle_axis,
)


class PoseGraph(NamedTuple):
    edges: jnp.ndarray      # (L, 2) int32 (i, j)
    meas_rot: jnp.ndarray   # (L, 3) angle-axis of measured T_ij
    meas_trans: jnp.ndarray  # (L, 3)
    weight_rot: float = 1.0
    weight_trans: float = 1.0


def relative_pose(rot_i, trans_i, rot_j, trans_j):
    """T_ij = T_i o T_j^-1 as (angle-axis, translation); batched."""
    R_i = angle_axis_to_matrix(rot_i)
    R_j = angle_axis_to_matrix(rot_j)
    R_rel = jnp.einsum("...ab,...cb->...ac", R_i, R_j,  # R_i R_j^T
                       precision=jax.lax.Precision.HIGHEST)
    t_rel = trans_i - jnp.einsum("...ab,...b->...a", R_rel, trans_j,
                                 precision=jax.lax.Precision.HIGHEST)
    return matrix_to_angle_axis(R_rel), t_rel


def pose_graph_residuals(
    x: jnp.ndarray, graph: PoseGraph, anchor_mask: jnp.ndarray = None
) -> jnp.ndarray:
    """Flat residual vector for LM: x is (P, 6) poses flattened to (6P,)."""
    poses = x.reshape(-1, 6)
    rot, trans = poses[:, :3], poses[:, 3:]
    i, j = graph.edges[:, 0], graph.edges[:, 1]
    R_i = angle_axis_to_matrix(rot[i])
    R_j = angle_axis_to_matrix(rot[j])
    R_rel = jnp.einsum("lab,lcb->lac", R_i, R_j,
                       precision=jax.lax.Precision.HIGHEST)
    t_rel = trans[i] - jnp.einsum("lab,lb->la", R_rel, trans[j],
                                  precision=jax.lax.Precision.HIGHEST)
    R_meas = angle_axis_to_matrix(graph.meas_rot)
    R_err = jnp.einsum("lba,lbc->lac", R_meas, R_rel,  # R_meas^T R_rel
                       precision=jax.lax.Precision.HIGHEST)
    r_rot = matrix_to_angle_axis(R_err) * graph.weight_rot
    r_t = (t_rel - graph.meas_trans) * graph.weight_trans
    return jnp.concatenate([r_rot.reshape(-1), r_t.reshape(-1)])


def solve_pose_graph(
    poses0: jnp.ndarray,
    graph: PoseGraph,
    anchor: jnp.ndarray,
    max_iterations: int = 100,
):
    """Refine (P, 6) poses; rows where ``anchor`` is True stay fixed (gauge).

    Returns the refined (P, 6) array. Uses the shared dense LM trust-region
    core — pose graphs are small (one pose per camera)."""
    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.solver.lm import levenberg_marquardt

    free = jnp.repeat(1.0 - anchor.astype(poses0.dtype), 6)
    result = levenberg_marquardt(
        pose_graph_residuals,
        poses0.reshape(-1),
        SolverOptions(max_iterations=max_iterations),
        free,
        graph,
    )
    return result.x.reshape(-1, 6)
