"""Camera-center math for single and composed (ring -> arc) extrinsics.

Batched JAX equivalents of the Eigen formulas in the reference
(``src/DeepArcManager.cc:242-264``):

  single:    c = -R^T t                                        (cc:242-251)
  composed:  c = -R_ring^T t_ring - R_ring^T R_arc^T t_arc     (cc:253-264)

and of the hemisphere enumeration ``getCameraCenter``
(``src/DeepArcManager.cc:501-518``), which walks every (arc, ring) cell and
picks the single/composed formula by the same rules as the PLY exporter
(``src/DeepArcManager.cc:287-300``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from deeparc_tpu.geometry.rotation import angle_axis_to_matrix


def camera_center_single(rot: jnp.ndarray, trans: jnp.ndarray) -> jnp.ndarray:
    """c = -R^T t for angle-axis rot (..., 3), trans (..., 3) -> (..., 3)."""
    R = angle_axis_to_matrix(rot)
    return -jnp.einsum("...ji,...j->...i", R, trans,
                       precision=jax.lax.Precision.HIGHEST)


def camera_center_composed(
    rot_arc: jnp.ndarray,
    t_arc: jnp.ndarray,
    rot_ring: jnp.ndarray,
    t_ring: jnp.ndarray,
) -> jnp.ndarray:
    """c = -R_ring^T t_ring - R_ring^T R_arc^T t_arc (DeepArcManager.cc:260)."""
    R_ring = angle_axis_to_matrix(rot_ring)
    R_arc = angle_axis_to_matrix(rot_arc)
    term1 = jnp.einsum("...ji,...j->...i", R_ring, t_ring,
                       precision=jax.lax.Precision.HIGHEST)
    RtArc_t = jnp.einsum("...ji,...j->...i", R_arc, t_arc,
                         precision=jax.lax.Precision.HIGHEST)
    term2 = jnp.einsum("...ji,...j->...i", R_ring, RtArc_t,
                       precision=jax.lax.Precision.HIGHEST)
    return -(term1 + term2)


def hemisphere_camera_centers(
    ext_rot: jnp.ndarray,
    ext_trans: jnp.ndarray,
    arc_size: int,
    ring_size: int,
) -> jnp.ndarray:
    """Centers for every (arc, ring) cell of a shared-extrinsic rig.

    ``ext_rot`` / ``ext_trans`` are the (E, 3) extrinsic tables laid out as in
    the ``.deeparc`` file: rows [0, arc_size) are arc extrinsics, and ring r
    maps to row 0 if r == 0 else r + arc_size - 1
    (``src/DeepArcManager.cc:166-171``). Selection rules per cell follow
    ``getCameraCenter`` (``src/DeepArcManager.cc:507-513``):
      ring == 0            -> single(arc)
      arc == 0, ring != 0  -> single(ring)
      else                 -> composed(arc, ring)

    Returns (arc_size * ring_size, 3) in (arc-major, ring-minor) order.
    """
    arcs = jnp.arange(arc_size)
    rings = jnp.arange(ring_size)
    arc_idx = jnp.repeat(arcs, ring_size)          # (A*R,)
    ring_pos = jnp.tile(rings, arc_size)           # (A*R,)
    ring_idx = jnp.where(ring_pos == 0, 0, ring_pos + arc_size - 1)

    rot_a, t_a = ext_rot[arc_idx], ext_trans[arc_idx]
    rot_r, t_r = ext_rot[ring_idx], ext_trans[ring_idx]

    single_arc = camera_center_single(rot_a, t_a)
    single_ring = camera_center_single(rot_r, t_r)
    composed = camera_center_composed(rot_a, t_a, rot_r, t_r)

    use_arc = (ring_pos == 0)[:, None]
    use_ring = ((arc_idx == 0) & (ring_pos != 0))[:, None]
    return jnp.where(use_arc, single_arc, jnp.where(use_ring, single_ring, composed))
