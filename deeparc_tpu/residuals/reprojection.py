"""Batched reprojection residuals and Jacobian blocks over the flat scene.

Batched JAX replacement for Ceres' forward-mode autodiff through the residual
functor (``DynamicAutoDiffCostFunction`` over
``src/snavely_reprojection_error.hh:94-118``; SURVEY.md section 2.2): one
``vmap(jacfwd(...))`` over all observations produces the block-sparse
Jacobian as dense per-observation blocks —

    J_point  (M, 2, 3)   d residual / d point3d
    J_cam    (M, 2, 18)  d residual / d [rot_o, t_o, rot_i, t_i,
                                         center, focal, dist]

which is exactly the layout the Schur-complement solver consumes (camera
columns gathered via :func:`camera_col_indices` into the flattened camera
parameter vector of size C = 6 * (E + 1) + 6 * K).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from deeparc_tpu.geometry.projection import (
    CameraSlice,
    StructureMasks,
    project_observation,
)
from deeparc_tpu.scene import BAParams, SceneIndex

# Per-observation camera-side parameter count:
# rot_outer(3) + t_outer(3) + rot_inner(3) + t_inner(3) + center(2) + focal(2)
# + dist(2). Fixed arity replaces the reference's 1-2 extrinsic / 1-2 focal /
# 0-2 distortion runtime cases (structure masks zero the absent slots).
OBS_CAM_DIM = 18


class ObsJacobians(NamedTuple):
    r: jnp.ndarray       # (M, 2) masked residuals
    j_point: jnp.ndarray  # (M, 2, 3)
    j_cam: jnp.ndarray   # (M, 2, 18)


def gather_slices(params: BAParams, index: SceneIndex):
    """Gather per-observation parameter slices + structure masks."""
    cam = CameraSlice(
        point=params.points[index.obs_point],
        center=params.center[index.obs_intr],
        focal=params.focal[index.obs_intr],
        dist=params.dist[index.obs_intr],
        rot_outer=params.ext_rot[index.obs_outer],
        t_outer=params.ext_trans[index.obs_outer],
        rot_inner=params.ext_rot[index.obs_inner],
        t_inner=params.ext_trans[index.obs_inner],
    )
    masks = StructureMasks(
        focal_shared=index.focal_shared[index.obs_intr],
        dist_m1=index.dist_m1[index.obs_intr],
        dist_m2=index.dist_m2[index.obs_intr],
    )
    return cam, masks


def residuals(params: BAParams, index: SceneIndex) -> jnp.ndarray:
    """Masked residuals (M, 2); dead observations contribute exactly zero."""
    cam, masks = gather_slices(params, index)
    r = project_observation(cam, masks, index.obs_xy)
    return r * index.obs_mask[:, None]


def cost(params: BAParams, index: SceneIndex) -> jnp.ndarray:
    """0.5 * sum of squared residuals (Ceres' cost convention)."""
    r = residuals(params, index)
    return 0.5 * jnp.sum(r * r)


def jacobian_blocks(params: BAParams, index: SceneIndex) -> ObsJacobians:
    """Residuals + dense per-observation Jacobian blocks via forward-mode AD.

    The batched analogue of Ceres evaluating every residual block's local
    Jacobian (stride-10 Jets, ``snavely_reprojection_error.hh:11-14``): one
    fused XLA computation, no per-block dispatch.
    """
    cam, masks = gather_slices(params, index)

    def f(cam_slice, m, xy):
        return project_observation(cam_slice, m, xy)

    def per_obs(cam_slice, m, xy):
        r = f(cam_slice, m, xy)
        jac = jax.jacfwd(f)(cam_slice, m, xy)  # CameraSlice of (2, k) blocks
        j_cam = jnp.concatenate(
            [
                jac.rot_outer, jac.t_outer, jac.rot_inner, jac.t_inner,
                jac.center, jac.focal, jac.dist,
            ],
            axis=-1,
        )
        return r, jac.point, j_cam

    r, j_point, j_cam = jax.vmap(per_obs)(cam, masks, index.obs_xy)
    w = index.obs_mask[:, None]
    return ObsJacobians(
        r=r * w, j_point=j_point * w[..., None], j_cam=j_cam * w[..., None]
    )


class FlatObsJacobians(NamedTuple):
    r: jnp.ndarray   # (M, 2) masked residuals
    jp: jnp.ndarray  # (M, 6)  d res / d point, columns r*3+i
    jc: jnp.ndarray  # (M, 36) d res / d camera, columns r*18+c


def jacobian_blocks_flat(params: BAParams, index: SceneIndex,
                         chunk: int = 262_144) -> FlatObsJacobians:
    """Residuals + Jacobian blocks in the FLAT rank-2 layout.

    Same math as :func:`jacobian_blocks`, but every per-observation array
    stays rank-2 with M leading (one packed row per observation, no tiny
    trailing dims — solver/schur.py consumes this layout). Evaluation is
    chunked so the gathered parameter slices never materialize at full M.
    """
    M = index.obs_point.shape[0]
    chunk = min(chunk, M)
    n_chunks = -(-M // chunk)
    pad = n_chunks * chunk - M

    def pad0(a):
        return jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a

    op = pad0(index.obs_point)
    oo = pad0(index.obs_outer)
    oi = pad0(index.obs_inner)
    ok = pad0(index.obs_intr)
    xy = pad0(index.obs_xy)
    msk = pad0(index.obs_mask)

    def chunk_fn(args):
        opc, ooc, oic, okc, xyc, mc = args
        cam = CameraSlice(
            point=params.points[opc],
            center=params.center[okc],
            focal=params.focal[okc],
            dist=params.dist[okc],
            rot_outer=params.ext_rot[ooc],
            t_outer=params.ext_trans[ooc],
            rot_inner=params.ext_rot[oic],
            t_inner=params.ext_trans[oic],
        )
        masks = StructureMasks(
            focal_shared=index.focal_shared[okc],
            dist_m1=index.dist_m1[okc],
            dist_m2=index.dist_m2[okc],
        )

        def per_obs(cam_slice, m, xy_one):
            # has_aux shares the primal evaluation with the Jacobian pass
            # (one residual-chain trace instead of two per observation)
            f = lambda cs: (lambda rr: (rr, rr))(
                project_observation(cs, m, xy_one))
            jac, r = jax.jacfwd(f, has_aux=True)(cam_slice)
            j_cam = jnp.concatenate(
                [jac.rot_outer, jac.t_outer, jac.rot_inner, jac.t_inner,
                 jac.center, jac.focal, jac.dist], axis=-1)
            return r, jac.point.reshape(6), j_cam.reshape(36)

        r, jp, jc = jax.vmap(per_obs)(cam, masks, xyc)
        w = mc[:, None]
        return r * w, jp * w, jc * w

    shaped = lambda a: a.reshape((n_chunks, chunk) + a.shape[1:])
    r, jp, jc = jax.lax.map(
        chunk_fn, (shaped(op), shaped(oo), shaped(oi), shaped(ok),
                   shaped(xy), shaped(msk)))
    return FlatObsJacobians(
        r=r.reshape(-1, 2)[:M], jp=jp.reshape(-1, 6)[:M],
        jc=jc.reshape(-1, 36)[:M])


# ---------------------------------------------------------------------------
# Flattened camera-parameter vector layout (the Schur "reduced camera system"
# coordinates): per extrinsic row e: cols [6e, 6e+3) = rot, [6e+3, 6e+6) = t;
# then per intrinsic k: cols 6*(E+1) + 6k + {0,1}=center, {2,3}=focal,
# {4,5}=dist.
# ---------------------------------------------------------------------------


def camera_dim(params: BAParams) -> int:
    n_ext_rows = params.ext_rot.shape[0]
    n_intr = params.center.shape[0]
    return 6 * n_ext_rows + 6 * n_intr


def flatten_camera(params: BAParams) -> jnp.ndarray:
    ext = jnp.concatenate([params.ext_rot, params.ext_trans], axis=1)  # (E+1, 6)
    intr = jnp.concatenate(
        [params.center, params.focal, params.dist], axis=1
    )  # (K, 6)
    return jnp.concatenate([ext.reshape(-1), intr.reshape(-1)])


def unflatten_camera(vec: jnp.ndarray, template: BAParams) -> BAParams:
    n_ext_rows = template.ext_rot.shape[0]
    n_intr = template.center.shape[0]
    ext = vec[: 6 * n_ext_rows].reshape(n_ext_rows, 6)
    intr = vec[6 * n_ext_rows:].reshape(n_intr, 6)
    return BAParams(
        points=template.points,
        ext_rot=ext[:, 0:3],
        ext_trans=ext[:, 3:6],
        center=intr[:, 0:2],
        focal=intr[:, 2:4],
        dist=intr[:, 4:6],
    )


def camera_col_indices(index: SceneIndex, n_ext_rows: int) -> jnp.ndarray:
    """Per-observation column indices (M, 18) into the flattened camera vector."""
    six = jnp.arange(6, dtype=jnp.int32)
    outer = index.obs_outer[:, None] * 6 + six[None, :]
    inner = index.obs_inner[:, None] * 6 + six[None, :]
    intr = 6 * n_ext_rows + index.obs_intr[:, None] * 6 + six[None, :]
    return jnp.concatenate([outer, inner, intr], axis=1)
