"""Batched, differentiable rotation kernels (angle-axis centric).

Batched JAX replacements for the Ceres rotation routines the reference relies
on (SURVEY.md section 2.2): ``AngleAxisRotatePoint``
(reference ``src/snavely_reprojection_error.hh:87``),
``AngleAxisToRotationMatrix`` (``src/Camera/Extrinsic.hh:14``),
``RotationMatrixToAngleAxis`` / ``QuaternionToAngleAxis``
(``src/DeepArcManager.cc:142,144``). All functions broadcast over leading
batch dimensions, are safe to differentiate at the theta -> 0 singularity
(double-where guards), and are pure jnp so XLA fuses them into surrounding
compute.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Angle below which the small-angle (first-order Taylor) branch is used.
# Matches Ceres' use of DBL_EPSILON-scale switch in AngleAxisRotatePoint.
_SMALL_THETA2 = 1e-24


def angle_axis_rotate(aa: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Rotate point(s) ``p`` by angle-axis vector(s) ``aa`` (Rodrigues).

    Equivalent to ``ceres::AngleAxisRotatePoint``
    (reference call site ``src/snavely_reprojection_error.hh:87``).
    Shapes: aa (..., 3), p (..., 3) -> (..., 3), broadcasting on the left.
    """
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)
    small = theta2 < _SMALL_THETA2
    # Guard: substitute 1 for theta^2 in the unsafe branch so its value and
    # gradient stay finite; the result there is discarded by the where.
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    w = aa / theta
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)
    w_cross_p = jnp.cross(w, p)
    w_dot_p = jnp.sum(w * p, axis=-1, keepdims=True)
    large_out = cos_t * p + sin_t * w_cross_p + (1.0 - cos_t) * w_dot_p * w
    # First-order: p + aa x p  (Ceres' near-zero branch).
    small_out = p + jnp.cross(aa, p)
    return jnp.where(small, small_out, large_out)


def angle_axis_to_matrix(aa: jnp.ndarray) -> jnp.ndarray:
    """Angle-axis (..., 3) -> rotation matrix (..., 3, 3) with R @ x == rotate(aa, x).

    Equivalent to ``ceres::AngleAxisToRotationMatrix`` as consumed through the
    Eigen column-major map in the reference (``src/Camera/Extrinsic.hh:12-17``):
    the returned R satisfies R @ X = angle_axis_rotate(aa, X).
    """
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)
    small = theta2 < _SMALL_THETA2
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    w = aa / theta
    c = jnp.cos(theta)[..., None]
    s = jnp.sin(theta)[..., None]
    one_c = 1.0 - c
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    # Skew-symmetric cross-product matrix K of w.
    K = jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=aa.dtype), K.shape)
    wwT = w[..., :, None] * w[..., None, :]
    large_R = c * eye + s * K + one_c * wwT
    # Small angle: I + K(aa)
    ax, ay, az = aa[..., 0], aa[..., 1], aa[..., 2]
    Ka = jnp.stack(
        [
            jnp.stack([zeros, -az, ay], axis=-1),
            jnp.stack([az, zeros, -ax], axis=-1),
            jnp.stack([-ay, ax, zeros], axis=-1),
        ],
        axis=-2,
    )
    small_R = eye + Ka
    return jnp.where(small[..., None], small_R, large_R)


def cross_matrix(v: jnp.ndarray) -> jnp.ndarray:
    """[v]_x skew-symmetric matrix (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_right_jacobian(aa: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian J_r of SO(3) at angle-axis aa (..., 3) -> (..., 3, 3).

    Satisfies R(w + dw) ~ R(w) Exp(J_r(w) dw), hence
    d(R(w) v)/dw = -R(w) [v]_x J_r(w) — the exact derivative of the global
    angle-axis parameterization the reference optimizes (Ceres autodiffs
    through plain angle-axis arrays; this is its closed form).
    J_r = I - (1-cos t)/t^2 [w]_x + (t - sin t)/t^3 [w]_x^2, with the
    t -> 0 Taylor limits 1/2 and 1/6.
    """
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)[..., None]
    small = theta2 < 1e-12
    t2 = jnp.where(small, 1.0, theta2)
    t = jnp.sqrt(t2)
    c1 = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(t)) / t2)
    c2 = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (t - jnp.sin(t)) / (t2 * t))
    K = cross_matrix(aa)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=aa.dtype), K.shape)
    KK = jnp.matmul(K, K, precision=jax.lax.Precision.HIGHEST)
    return eye - c1 * K + c2 * KK


def matrix_to_angle_axis(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (..., 3, 3) -> angle-axis (..., 3).

    Equivalent of ``ceres::RotationMatrixToAngleAxis`` (reference load path
    for 9-element rotations, ``src/DeepArcManager.cc:141-142``). Goes via the
    quaternion for numerical robustness near theta = 0 and theta = pi.
    """
    # Shepperd's method: pick the largest of (trace, R00, R11, R22).
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _case(tw, tx, ty, tz, s):
        return jnp.stack([tw, tx, ty, tz], axis=-1) / (2.0 * jnp.sqrt(s)[..., None])

    s0 = jnp.maximum(1.0 + tr, 1e-30)
    q0 = _case(s0, m21 - m12, m02 - m20, m10 - m01, s0)
    s1 = jnp.maximum(1.0 + m00 - m11 - m22, 1e-30)
    q1 = _case(m21 - m12, s1, m01 + m10, m02 + m20, s1)
    s2 = jnp.maximum(1.0 - m00 + m11 - m22, 1e-30)
    q2 = _case(m02 - m20, m01 + m10, s2, m12 + m21, s2)
    s3 = jnp.maximum(1.0 - m00 - m11 + m22, 1e-30)
    q3 = _case(m10 - m01, m02 + m20, m12 + m21, s3, s3)

    # Select branch: trace-dominant else the largest diagonal element.
    diag_max01 = jnp.where((m00 > m11)[..., None], q1, q2)
    diag_max = jnp.where(
        (jnp.maximum(m00, m11) > m22)[..., None], diag_max01, q3
    )
    q = jnp.where((tr > 0.0)[..., None], q0, diag_max)
    return quaternion_to_angle_axis(q)


def quaternion_to_angle_axis(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (w, x, y, z) (..., 4) -> angle-axis (..., 3).

    Equivalent of ``ceres::QuaternionToAngleAxis`` (reference load path for
    4-element rotations, ``src/DeepArcManager.cc:143-145``).
    """
    w = q[..., 0]
    xyz = q[..., 1:]
    sin_half2 = jnp.sum(xyz * xyz, axis=-1)
    small = sin_half2 < _SMALL_THETA2
    sin_half = jnp.sqrt(jnp.where(small, 1.0, sin_half2))
    # atan2 handles w < 0 (angle in (pi, 2pi) folded to (-pi, 0]) like Ceres.
    two_theta = 2.0 * jnp.arctan2(
        jnp.where(w < 0.0, -sin_half, sin_half), jnp.where(w < 0.0, -w, w)
    )
    k_large = two_theta / sin_half
    k_small = 2.0  # lim theta->0 of 2*theta/sin(theta/2)/2... first order: aa = 2*xyz
    k = jnp.where(small, k_small, k_large)
    return xyz * k[..., None]
