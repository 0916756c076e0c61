"""Levenberg-Marquardt trust-region control (Ceres-parity step policy).

The reference's minimizer is Ceres' default LM strategy (SURVEY.md section
2.2, ``ceres::Solve`` at ``src/sfm.cc:73``); this module reimplements its
control law natively so both the small dense LM and the Schur BA solver share
it:

  * step: solve (J^T J + (1/radius) * diag(clamp(diag(J^T J)))) dx = -g
  * step quality: rho = actual_cost_drop / model_cost_drop
  * accept (rho > min_relative_decrease):
        radius <- radius / max(1/3, 1 - (2 rho - 1)^3); decrease_factor <- 2
  * reject: radius <- radius / decrease_factor; decrease_factor <- 2x
    (Ceres LevenbergMarquardtStrategy::StepRejected)
  * convergence: function / gradient / parameter tolerances
    (Ceres Solver::Options defaults; the reference does not override them).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class TRState(NamedTuple):
    radius: jnp.ndarray          # trust-region radius (scalar)
    decrease_factor: jnp.ndarray  # scalar, doubles on consecutive rejects


def init_tr(radius: float, dtype=jnp.float64) -> TRState:
    return TRState(
        radius=jnp.asarray(radius, dtype),
        decrease_factor=jnp.asarray(2.0, dtype),
    )


def step_accepted(tr: TRState, rho: jnp.ndarray, max_radius: float) -> TRState:
    shrink = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
    return TRState(
        radius=jnp.minimum(tr.radius / shrink, max_radius),
        decrease_factor=jnp.asarray(2.0, tr.decrease_factor.dtype),
    )


def step_rejected(tr: TRState) -> TRState:
    return TRState(
        radius=tr.radius / tr.decrease_factor,
        decrease_factor=tr.decrease_factor * 2.0,
    )


def lm_diagonal(
    jtj_diag: jnp.ndarray, min_diag: float, max_diag: float
) -> jnp.ndarray:
    """Ceres' clamped LM scaling diagonal D^2 = clamp(diag(J^T J))."""
    return jnp.clip(jtj_diag, min_diag, max_diag)


def model_cost_change(
    j_dx: jnp.ndarray, r: jnp.ndarray
) -> jnp.ndarray:
    """m(0) - m(dx) for m(dx) = 0.5 || r + J dx ||^2, from the J dx product."""
    hi = jax.lax.Precision.HIGHEST
    return -(jnp.vdot(r, j_dx, precision=hi)
             + 0.5 * jnp.vdot(j_dx, j_dx, precision=hi))
