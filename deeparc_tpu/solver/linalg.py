"""Small batched linear algebra: 3x3 block solves, masked Cholesky, PCG.

These are the primitives behind the Schur elimination (SURVEY.md section
2.2, DENSE_SCHUR row): closed-form batched 3x3 inverses for the point-block
eliminations (adjugate formula — elementwise arithmetic, no LAPACK dispatch
per block) and a matrix-free preconditioned conjugate gradient for
the reduced camera system at scale.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

# Every float32 product in the solver asks for full float32 precision: on a
# GPU a float32 matmul may otherwise run in TF32 (about three decimal
# digits), which rounds exact one-hot selections and Schur complements.
HIGHEST = jax.lax.Precision.HIGHEST


def inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form inverse of (..., 3, 3) via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / det
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], axis=-1),
            jnp.stack([A21, A22, A23], axis=-1),
            jnp.stack([A31, A32, A33], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def solve3x3(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched solve A x = b for (..., 3, 3) and (..., 3)."""
    return jnp.einsum("...ij,...j->...i", inv3x3(A), b, precision=HIGHEST)


def masked_spd_solve(
    A: jnp.ndarray, b: jnp.ndarray, free: jnp.ndarray
) -> jnp.ndarray:
    """Solve A x = b over the free coordinates; frozen coordinates get x = 0.

    The dense equivalent of Ceres holding parameter blocks constant
    (``SetParameterBlockConstant``, ``src/sfm.cc:50-63``): frozen rows /
    columns are replaced by identity, frozen rhs entries by zero.
    """
    free = free.astype(A.dtype)
    mask2 = free[:, None] * free[None, :]
    A_m = A * mask2 + jnp.diag(1.0 - free)
    b_m = b * free
    L = jnp.linalg.cholesky(A_m)
    x = jax.scipy.linalg.cho_solve((L, True), b_m)
    return x * free


class CGResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray
    residual_norm: jnp.ndarray


def pcg(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    precond: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
    max_iterations: int = 500,
    tol: float = 1e-10,
) -> CGResult:
    """Matrix-free preconditioned conjugate gradient (jit-compatible).

    Solves A x = b where ``matvec`` applies the SPD operator A — here the
    Schur complement S applied implicitly through per-observation block
    products (never materializing S). Runs in a ``lax.while_loop``.
    """
    if precond is None:
        precond = lambda v: v
    b_norm = jnp.linalg.norm(b)
    atol2 = (tol * b_norm) ** 2

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0, precision=HIGHEST)

    def cond(state):
        _, r, _, _, rz, k = state
        return (jnp.vdot(r, r,
                         precision=HIGHEST) > atol2) & (k < max_iterations)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = matvec(p)
        denom = jnp.vdot(p, Ap, precision=HIGHEST)
        alpha = jnp.where(denom > 0, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.vdot(r, z, precision=HIGHEST)
        beta = jnp.where(rz > 0, rz_new / rz, 0.0)
        p = z + beta * p
        return (x, r, z, p, rz_new, k + 1)

    x, r, _, _, _, k = jax.lax.while_loop(cond, body, (x0, r0, z0, p0, rz0, 0))
    return CGResult(x=x, iterations=k, residual_norm=jnp.linalg.norm(r))
