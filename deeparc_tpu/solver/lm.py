"""Generic dense Levenberg-Marquardt for small problems (jit, lax.while_loop).

The native replacement for ``ceres::Solve`` on small dense problems — in the
pipeline this runs the hemisphere-radius prior fit (reference
``src/sfm.cc:89-103``: 1000-iteration LM over 4 parameters with one residual
per camera center). The entire minimizer — linearization (jacfwd), normal
equations, trust-region control, convergence tests — is one compiled
``lax.while_loop``; no Python in the loop.

Convergence reason codes (LMResult.status):
  0 = running / hit max_iterations
  2 = function tolerance      3 = gradient tolerance
  4 = parameter tolerance     5 = trust region collapsed to min_radius
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from deeparc_tpu.config import SolverOptions
from deeparc_tpu.solver import trust_region as tr_mod
from deeparc_tpu.solver.linalg import HIGHEST, masked_spd_solve


class LMResult(NamedTuple):
    x: jnp.ndarray
    cost: jnp.ndarray
    iterations: jnp.ndarray
    status: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("residual_fn", "options"))
def levenberg_marquardt(
    residual_fn: Callable,
    x0: jnp.ndarray,
    options: SolverOptions = SolverOptions(),
    free_mask: jnp.ndarray | None = None,
    *aux,
) -> LMResult:
    """Minimize 0.5 ||residual_fn(x, *aux)||^2 over free coordinates of x."""
    if free_mask is None:
        free_mask = jnp.ones_like(x0)
    free_mask = free_mask.astype(x0.dtype)

    def cost_of(x):
        r = residual_fn(x, *aux)
        return 0.5 * jnp.vdot(r, r, precision=HIGHEST)

    def lin(x):
        r = residual_fn(x, *aux)
        J = jax.jacfwd(residual_fn)(x, *aux) * free_mask[None, :]
        return r, J

    TRState = tr_mod.TRState

    class State(NamedTuple):
        x: jnp.ndarray
        cost: jnp.ndarray
        tr: TRState
        k: jnp.ndarray
        status: jnp.ndarray

    def cond(s: State):
        return (s.status == 0) & (s.k < options.max_iterations)

    def body(s: State):
        r, J = lin(s.x)
        g = jnp.dot(J.T, r, precision=HIGHEST)
        jtj = jnp.dot(J.T, J, precision=HIGHEST)
        d2 = tr_mod.lm_diagonal(
            jnp.diagonal(jtj), options.min_lm_diagonal, options.max_lm_diagonal
        )
        H = jtj + jnp.diag(d2) / s.tr.radius
        dx = masked_spd_solve(H, -g, free_mask)
        j_dx = jnp.dot(J, dx, precision=HIGHEST)
        mcc = tr_mod.model_cost_change(j_dx, r)

        x_new = s.x + dx
        new_cost = cost_of(x_new)
        rho = (s.cost - new_cost) / jnp.maximum(mcc, 1e-300)
        accept = (mcc > 0) & (rho > options.min_relative_decrease)

        tr_acc = tr_mod.step_accepted(s.tr, rho, options.max_radius)
        tr_rej = tr_mod.step_rejected(s.tr)
        tr_next = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), tr_acc, tr_rej
        )

        x_next = jnp.where(accept, x_new, s.x)
        cost_next = jnp.where(accept, new_cost, s.cost)

        # Convergence tests (Ceres order: gradient, then per-accepted-step
        # function/parameter tolerances).
        g_max = jnp.max(jnp.abs(g * free_mask))
        step_norm = jnp.linalg.norm(dx)
        x_norm = jnp.linalg.norm(s.x)
        ftol = accept & (
            jnp.abs(s.cost - new_cost)
            <= options.function_tolerance * s.cost
        )
        ptol = accept & (
            step_norm
            <= options.parameter_tolerance
            * (x_norm + options.parameter_tolerance)
        )
        gtol = g_max <= options.gradient_tolerance
        radius_min = tr_next.radius <= options.min_radius

        status = jnp.where(
            gtol, 3,
            jnp.where(ftol, 2, jnp.where(ptol, 4, jnp.where(radius_min, 5, 0))),
        )
        return State(x=x_next, cost=cost_next, tr=tr_next, k=s.k + 1,
                     status=jnp.asarray(status))

    dtype = x0.dtype
    init = State(
        x=x0,
        cost=cost_of(x0),
        tr=tr_mod.init_tr(options.initial_radius, dtype),
        k=jnp.asarray(0),
        status=jnp.asarray(0),
    )
    final = jax.lax.while_loop(cond, body, init)
    return LMResult(
        x=final.x, cost=final.cost, iterations=final.k, status=final.status
    )


def fit_hemisphere(
    camera_centers: jnp.ndarray, max_iterations: int = 1000
) -> jnp.ndarray:
    """Fit the hemisphere prior to camera centers (reference src/sfm.cc:86-103).

    Returns [cx, cy, cz, radius] where — preserving the reference residual's
    convention (``src/hemisphere_radius.hh:19-28``) — ``radius`` converges to
    the MEAN SQUARED distance r^2, not r. Initialization matches the
    reference: center = 0, radius = 1 (``src/sfm.cc:87-88``).
    """
    from deeparc_tpu.residuals.hemisphere import hemisphere_residuals

    x0 = jnp.array([0.0, 0.0, 0.0, 1.0], camera_centers.dtype)
    opts = SolverOptions(max_iterations=max_iterations)
    result = levenberg_marquardt(
        hemisphere_residuals, x0, opts, None, camera_centers
    )
    return result.x
