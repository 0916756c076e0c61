"""Distributed bundle adjustment: shard_map Schur complement over a mesh.

The reference has no distributed layer at all (SURVEY.md section 2.5 — its
only parallelism is Ceres' thread pool, ``src/sfm.cc:70``); this module is
the new capability required by the north star (BASELINE.json): scale the
solve across the devices of a mesh with JAX collectives (on GPUs XLA hands
them to NCCL, over NVLink within a host).

Decomposition (the natural one for block-sparse BA):

  * POINTS are partitioned across the ``data`` mesh axis; every observation
    lives on its point's shard, so the 3x3 point eliminations, g_p, and the
    back-substitution are entirely local (zero communication — the analogue
    of Ceres' per-thread residual partitions, but across chips).
  * The reduced CAMERA system is small (C = 6E + 6K) and replicated: each
    shard computes its local contribution to S and the reduced rhs, and one
    ``psum`` over the axis assembles them (SURVEY.md section 7, hard part
    (d): psum the small reduced camera matrix, not the point blocks).
  * LM trust-region scalars (cost, rho, radius) are derived from psum-reduced
    quantities, so control flow stays replicated and the whole LM loop runs
    inside one ``shard_map`` + ``lax.while_loop`` computation — no host
    round-trips between iterations.

Single-chip semantics are preserved exactly: a sharded solve on N devices
produces the same iterates as ``solver.ba.solve_ba`` up to float re-association
in the psums (tested bit-for-tolerance on the virtual CPU mesh).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from deeparc_tpu.config import SolverOptions
from deeparc_tpu.residuals.reprojection import (
    cost as cost_fn,
    flatten_camera,
    jacobian_blocks,
    unflatten_camera,
)
from deeparc_tpu.scene import BAParams, Scene, SceneIndex
from deeparc_tpu.solver import trust_region as tr_mod
from deeparc_tpu.solver.linalg import HIGHEST, masked_spd_solve
from deeparc_tpu.solver.schur import (
    sys_r,
    _augmented_point_blocks,
    _cam_aug_diag,
    back_substitute,
    build_system,
    dense_S,
    j_times,
    reduced_rhs,
)


class ShardedScene(NamedTuple):
    """Host-prepared shard-major arrays (leading dim = number of shards)."""

    # per-shard observation arrays (S, M_s, ...) — obs_point is SHARD-LOCAL
    obs_point: np.ndarray
    obs_outer: np.ndarray
    obs_inner: np.ndarray
    obs_intr: np.ndarray
    obs_xy: np.ndarray
    obs_mask: np.ndarray
    # per-shard point tables (S, N_s, ...)
    points: np.ndarray
    point_mask: np.ndarray
    point_free: np.ndarray
    # replicated camera tables / masks
    ext_rot: np.ndarray
    ext_trans: np.ndarray
    center: np.ndarray
    focal: np.ndarray
    dist: np.ndarray
    focal_shared: np.ndarray
    dist_m1: np.ndarray
    dist_m2: np.ndarray
    cam_free: np.ndarray     # (C,)


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    """Flat 1-D mesh over the first ``n_devices`` devices (all by
    default). Every card of a host reaches every other at the same rate,
    so the mesh follows the algorithm alone."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def shard_scene(scene: Scene, free: BAParams, n_shards: int) -> ShardedScene:
    """Partition points (and their observations) into n contiguous shards.

    Observations are already point-sorted (scene.from_deeparc); shards are
    padded to a common obs count / point count with dead (masked) entries so
    shapes are static and identical across devices.
    """
    N = scene.n_points
    n_local = -(-N // n_shards)
    obs_point = np.asarray(scene.index.obs_point)
    shard_of_point = np.minimum(np.arange(N) // n_local, n_shards - 1)
    obs_shard = shard_of_point[obs_point]

    obs_mask_g = np.asarray(scene.index.obs_mask)
    counts = np.bincount(obs_shard, minlength=n_shards)
    m_local = max(int(counts.max()), 1)

    def gather_obs(arr, fill):
        arr = np.asarray(arr)
        out = np.full((n_shards, m_local) + arr.shape[1:], fill, arr.dtype)
        for s in range(n_shards):
            sel = obs_shard == s
            out[s, : counts[s]] = arr[sel]
        return out

    # local point index = global - shard offset
    local_point = obs_point - (obs_shard * n_local)
    identity = scene.identity_ext

    def pad_points(arr, fill):
        arr = np.asarray(arr)
        out = np.full((n_shards * n_local,) + arr.shape[1:], fill, arr.dtype)
        out[:N] = arr
        return out.reshape((n_shards, n_local) + arr.shape[1:])

    return ShardedScene(
        obs_point=gather_obs(local_point.astype(np.int32), 0),
        obs_outer=gather_obs(scene.index.obs_outer, identity),
        obs_inner=gather_obs(scene.index.obs_inner, identity),
        obs_intr=gather_obs(scene.index.obs_intr, 0),
        obs_xy=gather_obs(scene.index.obs_xy, 0.0),
        obs_mask=gather_obs(obs_mask_g, 0.0),
        points=pad_points(scene.params.points, 0.0),
        point_mask=pad_points(scene.index.point_mask, 0.0),
        point_free=pad_points(np.asarray(free.points), 0.0),
        ext_rot=np.asarray(scene.params.ext_rot),
        ext_trans=np.asarray(scene.params.ext_trans),
        center=np.asarray(scene.params.center),
        focal=np.asarray(scene.params.focal),
        dist=np.asarray(scene.params.dist),
        focal_shared=np.asarray(scene.index.focal_shared),
        dist_m1=np.asarray(scene.index.dist_m1),
        dist_m2=np.asarray(scene.index.dist_m2),
        cam_free=np.asarray(flatten_camera(free)),
    )


class ShardedResult(NamedTuple):
    points: jnp.ndarray      # (S, N_s, 3) refined structure
    cam_vec: jnp.ndarray     # (C,) refined camera vector
    cost: jnp.ndarray
    iterations: jnp.ndarray
    status: jnp.ndarray


def solve_ba_sharded(
    sharded: ShardedScene,
    options: SolverOptions = SolverOptions(),
    mesh: Mesh | None = None,
    axis: str = "data",
) -> ShardedResult:
    """Run the full LM loop SPMD over the mesh; returns sharded structure."""
    if mesh is None:
        mesh = make_mesh()
    n_ext_rows = sharded.ext_rot.shape[0]

    def local_scene(points, obs, cam_params: BAParams):
        """Rebuild (BAParams, SceneIndex) views on one shard."""
        params = dataclasses.replace(cam_params, points=points)
        index = SceneIndex(
            obs_point=obs["obs_point"], obs_outer=obs["obs_outer"],
            obs_inner=obs["obs_inner"], obs_intr=obs["obs_intr"],
            obs_xy=obs["obs_xy"], obs_mask=obs["obs_mask"],
            point_mask=obs["point_mask"],
            focal_shared=obs["focal_shared"], dist_m1=obs["dist_m1"],
            dist_m2=obs["dist_m2"],
        )
        return params, index

    def spmd(obs, points, point_free, cam_parts, cam_free):
        # shard_map delivers (1, M_s, ...) blocks of the (S, M_s, ...) inputs;
        # drop the shard dim for local compute, restore it on output.
        obs = {
            k: (v[0] if k not in ("focal_shared", "dist_m1", "dist_m2") else v)
            for k, v in obs.items()
        }
        points = points[0]
        point_free = point_free[0]
        cam_template = BAParams(
            points=points, ext_rot=cam_parts["ext_rot"],
            ext_trans=cam_parts["ext_trans"], center=cam_parts["center"],
            focal=cam_parts["focal"], dist=cam_parts["dist"],
        )
        n_local = points.shape[0]
        n_cam = cam_free.shape[0]

        def total_cost(points_, cam_vec):
            params, index = local_scene(
                points_, obs, unflatten_camera(cam_vec, cam_template)
            )
            return jax.lax.psum(cost_fn(params, index), axis)

        def step(state):
            points_, cam_vec, cost, tr, k, status = state
            params, index = local_scene(
                points_, obs, unflatten_camera(cam_vec, cam_template)
            )
            blocks = jacobian_blocks(params, index)
            n_intr = cam_template.center.shape[0]
            sys = build_system(
                blocks.r, blocks.j_point, blocks.j_cam, index,
                n_local, n_ext_rows, n_intr, cam_free, point_free,
            )
            # assemble the replicated reduced camera system over the mesh
            g_c = jax.lax.psum(sys.g_c, axis)
            hcc_diag = jax.lax.psum(sys.hcc_diag, axis)
            sys = sys._replace(g_c=g_c, hcc_diag=hcc_diag)

            binv = _augmented_point_blocks(sys, tr.radius, options)
            cam_aug = _cam_aug_diag(sys, tr.radius, options)

            # reduced_rhs subtracts the replicated g_c once per shard; add
            # back (S-1) copies so the psum yields -g_c + psum(E^T B^-1 g_p).
            n_shards = jax.lax.psum(1, axis)
            rhs = (
                jax.lax.psum(reduced_rhs(sys, binv), axis)
                + (n_shards - 1) * g_c
            ) * cam_free

            S = jax.lax.psum(dense_S(sys, binv), axis) + jnp.diag(cam_aug)
            dc = masked_spd_solve(S, rhs, cam_free)
            dp = back_substitute(sys, binv, dc)

            j_dx = j_times(sys, dp, dc)
            mcc = jax.lax.psum(
                tr_mod.model_cost_change(j_dx, sys_r(sys)), axis)

            new_points = points_ + dp
            new_cam = cam_vec + dc
            new_cost = total_cost(new_points, new_cam)
            rho = (cost - new_cost) / jnp.maximum(mcc, 1e-300)
            accept = (mcc > 0) & (rho > options.min_relative_decrease)

            tr_next = jax.tree.map(
                lambda a, b: jnp.where(accept, a, b),
                tr_mod.step_accepted(tr, rho, options.max_radius),
                tr_mod.step_rejected(tr),
            )
            points_next = jnp.where(accept, new_points, points_)
            cam_next = jnp.where(accept, new_cam, cam_vec)
            cost_next = jnp.where(accept, new_cost, cost)

            grad_max = jnp.maximum(
                jnp.max(jnp.abs(g_c)),
                jax.lax.pmax(jnp.max(jnp.abs(sys.g_p)), axis),
            )
            step_norm = jnp.sqrt(
                jax.lax.psum(jnp.vdot(dp, dp, precision=HIGHEST), axis)
                + jnp.vdot(dc, dc, precision=HIGHEST)
            )
            x_norm = jnp.sqrt(
                jax.lax.psum(jnp.vdot(points_, points_,
                                      precision=HIGHEST), axis)
                + jnp.vdot(cam_vec, cam_vec, precision=HIGHEST)
            )
            cost_change = cost - new_cost
            ftol = accept & (
                jnp.abs(cost_change) <= options.function_tolerance * cost
            )
            ptol = accept & (
                step_norm <= options.parameter_tolerance
                * (x_norm + options.parameter_tolerance)
            )
            gtol = grad_max <= options.gradient_tolerance
            radius_min = tr_next.radius <= options.min_radius
            status_next = jnp.where(
                gtol, 3, jnp.where(ftol, 2, jnp.where(
                    ptol, 4, jnp.where(radius_min, 5, 0)))
            )
            return (points_next, cam_next, cost_next, tr_next, k + 1,
                    jnp.asarray(status_next))

        cam_vec0 = flatten_camera(cam_template)
        dtype = points.dtype
        init = (
            points, cam_vec0, total_cost(points, cam_vec0),
            tr_mod.init_tr(options.initial_radius, dtype),
            jnp.asarray(0), jnp.asarray(0),
        )
        final = jax.lax.while_loop(
            lambda s: (s[5] == 0) & (s[4] < options.max_iterations),
            step, init,
        )
        points_f, cam_f, cost_f, _, k_f, status_f = final
        return points_f[None], cam_f, cost_f, k_f, status_f

    obs_tree = {
        "obs_point": sharded.obs_point, "obs_outer": sharded.obs_outer,
        "obs_inner": sharded.obs_inner, "obs_intr": sharded.obs_intr,
        "obs_xy": sharded.obs_xy, "obs_mask": sharded.obs_mask,
        "point_mask": sharded.point_mask,
        "focal_shared": sharded.focal_shared, "dist_m1": sharded.dist_m1,
        "dist_m2": sharded.dist_m2,
    }
    cam_parts = {
        "ext_rot": sharded.ext_rot, "ext_trans": sharded.ext_trans,
        "center": sharded.center, "focal": sharded.focal,
        "dist": sharded.dist,
    }
    replicated_keys = ("focal_shared", "dist_m1", "dist_m2")
    obs_specs = {
        k: (P() if k in replicated_keys else P(axis)) for k in obs_tree
    }

    fn = shard_map(
        spmd,
        mesh=mesh,
        in_specs=(obs_specs, P(axis), P(axis), {k: P() for k in cam_parts}, P()),
        out_specs=(P(axis), P(), P(), P(), P()),
    )
    points_f, cam_f, cost_f, k_f, status_f = jax.jit(fn)(
        obs_tree, sharded.points, sharded.point_free, cam_parts,
        sharded.cam_free,
    )
    return ShardedResult(
        points=points_f, cam_vec=cam_f, cost=cost_f,
        iterations=k_f, status=status_f,
    )
