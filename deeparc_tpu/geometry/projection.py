"""The deeparc projection model: composed-extrinsic pinhole + radial distortion.

Array-native re-design of the reference's templated residual functor
``SnavelyReprojectionError`` (``src/snavely_reprojection_error.hh:38-118``).
Instead of four runtime arities (1-2 focals x 0-2 distortions) and two
extrinsic-chain shapes handled by C++ branches, every observation evaluates
ONE uniform model:

    p  = R_outer @ (R_inner @ X + t_inner) + t_outer          (hh:96-108)
    xp, yp = p.x / p.z, p.y / p.z                             (hh:49-50)
    fx = focal[0]; fy = focal_shared ? focal[0] : focal[1]    (hh:53-55)
    d  = 1 + r2 * (dist[0]*m1 + dist[1]*m2*r2)                (hh:58-67)
    predicted = [fx, fy] * d * [xp, yp] + principal           (hh:71-72)
    residual  = predicted - observed                          (hh:75-76)

where the "inner" slot is the ring extrinsic and the "outer" the arc
extrinsic for composed rig cameras, and the inner slot points at a frozen
identity extrinsic for single-extrinsic observations (see scene.py). The
structure masks (focal_shared, m1, m2) are per-intrinsic constants, so the
whole model is a single branch-free vmap-able function, which is what makes
forward-mode Jacobians one fused XLA computation.

Note the reference, despite its Bundler comment (hh:43-44), does NOT negate
the perspective divide; this implementation is faithful to the code, not the
comment.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from deeparc_tpu.geometry.rotation import angle_axis_rotate


class CameraSlice(NamedTuple):
    """Per-observation differentiable parameters (the autodiff inputs).

    This is the flat-array analogue of the ordered parameter-pointer list the
    reference hands to Ceres (``src/ParameterBlock.hh:68-94``): point(3),
    principal(2), focal(2), distortion(2), outer rot/trans(3+3), inner
    rot/trans(3+3). Fixed arity: unused slots are masked by the structure
    constants rather than absent.
    """

    point: jnp.ndarray      # (..., 3)
    center: jnp.ndarray     # (..., 2) principal point
    focal: jnp.ndarray      # (..., 2)
    dist: jnp.ndarray       # (..., 2) radial distortion coefficients
    rot_outer: jnp.ndarray  # (..., 3) angle-axis (arc slot)
    t_outer: jnp.ndarray    # (..., 3)
    rot_inner: jnp.ndarray  # (..., 3) angle-axis (ring slot; identity if single)
    t_inner: jnp.ndarray    # (..., 3)


class StructureMasks(NamedTuple):
    """Per-observation non-differentiable structure constants.

    focal_shared: 1.0 when the intrinsic has one focal (fy = fx),
      reference ``snavely_reprojection_error.hh:55``.
    dist_m1 / dist_m2: 1.0 when >=1 / >=2 radial coefficients are present,
      reference ``snavely_reprojection_error.hh:61-67``.
    """

    focal_shared: jnp.ndarray  # (...,)
    dist_m1: jnp.ndarray       # (...,)
    dist_m2: jnp.ndarray       # (...,)


def transform_point(cam: CameraSlice) -> jnp.ndarray:
    """Apply the (inner -> outer) extrinsic chain to the point.

    Reference: the two ``rotatePoint`` calls in ``operator()``
    (``src/snavely_reprojection_error.hh:94-116``).
    """
    p = angle_axis_rotate(cam.rot_inner, cam.point) + cam.t_inner
    p = angle_axis_rotate(cam.rot_outer, p) + cam.t_outer
    return p


def project_observation(
    cam: CameraSlice, masks: StructureMasks, observed_xy: jnp.ndarray
) -> jnp.ndarray:
    """Reprojection residual (2,) for one observation (vmap over leading dims).

    Faithful to ``projectPoint`` (``src/snavely_reprojection_error.hh:38-78``).
    """
    p = transform_point(cam)
    xp = p[..., 0] / p[..., 2]
    yp = p[..., 1] / p[..., 2]

    fx = cam.focal[..., 0]
    fy = jnp.where(masks.focal_shared > 0.5, cam.focal[..., 0], cam.focal[..., 1])

    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (
        cam.dist[..., 0] * masks.dist_m1
        + cam.dist[..., 1] * masks.dist_m2 * r2
    )

    pred_x = fx * distortion * xp + cam.center[..., 0]
    pred_y = fy * distortion * yp + cam.center[..., 1]
    pred = jnp.stack([pred_x, pred_y], axis=-1)
    return pred - observed_xy
