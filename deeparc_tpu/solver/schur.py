"""Schur-complement elimination of points: the reduced camera system.

Batched replacement for Ceres' DENSE_SCHUR linear solver (SURVEY.md
section 2.2; selected by the reference at ``src/sfm.cc:67,95``). The normal
equations of one LM iteration,

    [ B   E ] [dp]   [-g_p]        B: (N, 3, 3) per-point blocks
    [ E^T C ] [dc] = [-g_c]        C: (C, C) camera-camera

are solved by eliminating every point's 3x3 block in parallel (closed-form
batched inverses, elementwise work) and solving the reduced camera system

    S dc = -g_c + E^T B^-1 g_p,    S = C - E^T B^-1 E

either densely (exact Cholesky — the DENSE_SCHUR analogue, for moderate
camera counts) or matrix-free with preconditioned CG (ITERATIVE_SCHUR — the
at-scale path: S is never materialized; each application of S is a handful of
batched products over observations plus segment-sums). Back-substitution then recovers
dp = -B^-1 (g_p + E dc) pointwise.

MEMORY LAYOUT: every per-observation array here is RANK-2 with M leading:
all residual/Jacobian blocks are PACKED into one (M, 44) buffer — columns [0:2) residual,
[2:8) d res/d point row-major (r*3+i), [8:44) d res/d camera (r*18+c) —
one tile-padded allocation total, and every contraction is explicit slice
arithmetic on (M, k<=36) operands that XLA fuses without materializing
rank-3 shapes.

Camera-side accumulations exploit the column structure (18 per-observation
columns = 3 groups of 6 keyed by outer-extrinsic / inner-extrinsic /
intrinsic id) and use per-group segment sums instead of generic
scatter-add.

All operators respect freeze masks (gauge fixing / frozen intrinsics /
freeze-camera pre-solve, ``src/sfm.cc:50-63``): frozen columns are zeroed in
J and their rows of S are replaced by identity, so frozen deltas are exactly
zero.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from deeparc_tpu.config import SolverOptions
from deeparc_tpu.solver.linalg import HIGHEST, inv3x3, masked_spd_solve, pcg
from deeparc_tpu.solver.trust_region import lm_diagonal


class SchurSystem(NamedTuple):
    """One linearization, masked and ready for (possibly repeated) solves."""

    jrc: jnp.ndarray        # (M, 44) packed [r | j_point | j_cam], see above
    obs_point: jnp.ndarray  # (M,)
    obs_outer: jnp.ndarray  # (M,) outer-extrinsic row ids
    obs_inner: jnp.ndarray  # (M,) inner-extrinsic row ids
    obs_intr: jnp.ndarray   # (M,) intrinsic ids
    n_ext_rows: int         # static: extrinsic rows incl. identity slot
    n_intr: int             # static
    g_p: jnp.ndarray        # (N, 3)
    g_c: jnp.ndarray        # (C,)
    hpp: jnp.ndarray        # (N, 3, 3)
    hcc_diag: jnp.ndarray   # (C,)
    cam_free: jnp.ndarray   # (C,) 0/1
    point_free: jnp.ndarray  # (N, 3) 0/1


# -- packed-buffer accessors (views; fused into consumers by XLA) -----------

def sys_r(sys: "SchurSystem") -> jnp.ndarray:
    """(M, 2) residuals."""
    return sys.jrc[:, 0:2]


def sys_jp(sys: "SchurSystem") -> jnp.ndarray:
    """(M, 6) point Jacobian, columns r*3+i."""
    return sys.jrc[:, 2:8]


def sys_jc(sys: "SchurSystem") -> jnp.ndarray:
    """(M, 36) camera Jacobian, columns r*18+c."""
    return sys.jrc[:, 8:44]


def sys_cols(sys: "SchurSystem") -> jnp.ndarray:
    """(M, 18) flat camera-vector column ids (computed, never stored)."""
    six = jnp.arange(6, dtype=jnp.int32)
    outer = sys.obs_outer[:, None] * 6 + six[None, :]
    inner = sys.obs_inner[:, None] * 6 + six[None, :]
    intr = 6 * sys.n_ext_rows + sys.obs_intr[:, None] * 6 + six[None, :]
    return jnp.concatenate([outer, inner, intr], axis=1)


# -- flat contraction helpers (all outputs rank-2, M leading) ---------------

def _jp_r(jp, t2):
    """sum_r jp[m, r*3+i] * t[m, r] -> (M, 3)."""
    return jp[:, 0:3] * t2[:, 0:1] + jp[:, 3:6] * t2[:, 1:2]


def _jc_r(jc, t2):
    """sum_r jc[m, r*18+c] * t[m, r] -> (M, 18)."""
    return jc[:, 0:18] * t2[:, 0:1] + jc[:, 18:36] * t2[:, 1:2]


def _jp_dot(jp, v3):
    """sum_i jp[m, r*3+i] * v[m, i] -> (M, 2)."""
    return jnp.stack([jnp.sum(jp[:, 0:3] * v3, axis=1),
                      jnp.sum(jp[:, 3:6] * v3, axis=1)], axis=1)


def _jc_dot(jc, v18):
    """sum_c jc[m, r*18+c] * v[m, c] -> (M, 2)."""
    return jnp.stack([jnp.sum(jc[:, 0:18] * v18, axis=1),
                      jnp.sum(jc[:, 18:36] * v18, axis=1)], axis=1)


def _outer_cols(a0, a1, b0, b1):
    """sum_r a_r[m, i] * b_r[m, j] flattened -> (M, ka*kb), cols i*kb+j."""
    ka, kb = a0.shape[1], b0.shape[1]
    cols = [a0[:, i:i + 1] * b0 + a1[:, i:i + 1] * b1 for i in range(ka)]
    return jnp.concatenate(cols, axis=1)


def cam_accumulate(sys: "SchurSystem", vals: jnp.ndarray) -> jnp.ndarray:
    """Accumulate per-observation 18-wide camera values into the flat (C,)
    camera vector without generic scatter: the 18 columns decompose into
    three groups of 6 keyed by (outer, inner, intrinsic) id, each a plain
    segment-sum (column layout guarantees group g of obs m lands at rows
    id_g(m)*6 .. +6)."""
    ext = jax.ops.segment_sum(
        vals[:, 0:6], sys.obs_outer, num_segments=sys.n_ext_rows
    ) + jax.ops.segment_sum(
        vals[:, 6:12], sys.obs_inner, num_segments=sys.n_ext_rows
    )
    intr = jax.ops.segment_sum(
        vals[:, 12:18], sys.obs_intr, num_segments=sys.n_intr
    )
    return jnp.concatenate([ext.reshape(-1), intr.reshape(-1)])


def build_system(
    r: jnp.ndarray,
    j_point: jnp.ndarray,
    j_cam: jnp.ndarray,
    index,
    n_points: int,
    n_ext_rows: int,
    n_intr: int,
    cam_free: jnp.ndarray,
    point_free: jnp.ndarray,
) -> SchurSystem:
    """Assemble the masked system from Jacobian blocks + a SceneIndex-like
    object carrying (obs_point, obs_outer, obs_inner, obs_intr).

    Blocks may be flat ((M,2)/(M,6)/(M,36)) or rank-3 ((M,2,3)/(M,2,18) —
    the autodiff layout; reshaped row-major, which matches the flat column
    convention)."""
    M = r.shape[0]
    jp = j_point.reshape(M, 6)
    jc = j_cam.reshape(M, 36)
    obs_point = index.obs_point

    free18 = cam_free[_cols_of(index, n_ext_rows)]          # (M, 18)
    jc = jc * jnp.concatenate([free18, free18], axis=1)
    pf3 = point_free[obs_point]                             # (M, 3)
    jp = jp * jnp.concatenate([pf3, pf3], axis=1)
    jrc = jnp.concatenate([r, jp, jc], axis=1)              # (M, 44)

    sys = SchurSystem(
        jrc=jrc, obs_point=obs_point,
        obs_outer=index.obs_outer, obs_inner=index.obs_inner,
        obs_intr=index.obs_intr, n_ext_rows=n_ext_rows, n_intr=n_intr,
        g_p=None, g_c=None, hpp=None, hcc_diag=None,
        cam_free=cam_free, point_free=point_free,
    )
    # one fused (M, 12) segment-sum carries g_p + the 3x3 point Hessian
    hpp9 = _outer_cols(jp[:, 0:3], jp[:, 3:6], jp[:, 0:3], jp[:, 3:6])
    gp_hpp = jax.ops.segment_sum(
        jnp.concatenate([_jp_r(jp, r), hpp9], axis=1),
        obs_point, num_segments=n_points,
    )
    g_c = cam_accumulate(sys, _jc_r(jc, r))
    hcc_diag = cam_accumulate(
        sys, jc[:, 0:18] * jc[:, 0:18] + jc[:, 18:36] * jc[:, 18:36])
    return sys._replace(
        g_p=gp_hpp[:, 0:3], hpp=gp_hpp[:, 3:12].reshape(n_points, 3, 3),
        g_c=g_c, hcc_diag=hcc_diag,
    )


def _cols_of(index, n_ext_rows: int) -> jnp.ndarray:
    from deeparc_tpu.residuals.reprojection import camera_col_indices

    return camera_col_indices(index, n_ext_rows)


def _augmented_point_blocks(
    sys: SchurSystem, radius: jnp.ndarray, options: SolverOptions
) -> jnp.ndarray:
    """B~^-1: inverses of LM-augmented per-point 3x3 blocks (frozen -> I)."""
    diag = jnp.diagonal(sys.hpp, axis1=-2, axis2=-1)
    d2 = lm_diagonal(diag, options.min_lm_diagonal, options.max_lm_diagonal)
    aug = sys.hpp + jnp.eye(3, dtype=sys.hpp.dtype) * d2[:, :, None] / radius
    # frozen coords: identity rows/cols keep the block invertible; their
    # gradient entries are already zero so their delta is exactly zero.
    frozen = 1.0 - sys.point_free
    aug = aug + frozen[:, :, None] * jnp.eye(3, dtype=aug.dtype)
    return inv3x3(aug)


def _cam_aug_diag(
    sys: SchurSystem, radius: jnp.ndarray, options: SolverOptions
) -> jnp.ndarray:
    d2 = lm_diagonal(
        sys.hcc_diag, options.min_lm_diagonal, options.max_lm_diagonal
    )
    return d2 / radius


def schur_matvec(
    sys: SchurSystem,
    binv: jnp.ndarray,
    cam_aug: jnp.ndarray,
    v: jnp.ndarray,
) -> jnp.ndarray:
    """Apply S = (Hcc + aug) - E^T B~^-1 E matrix-free; frozen rows act as I."""
    n_points = sys.g_p.shape[0]
    jp, jc = sys_jp(sys), sys_jc(sys)
    v_cols = v[sys_cols(sys)]                               # (M, 18)
    t = _jc_dot(jc, v_cols)                                 # (M, 2)
    hcc_v = cam_accumulate(sys, _jc_r(jc, t))
    ev = jax.ops.segment_sum(
        _jp_r(jp, t), sys.obs_point, num_segments=n_points)
    w = jnp.einsum("pij,pj->pi", binv, ev, precision=HIGHEST)
    t2 = _jp_dot(jp, w[sys.obs_point])
    corr = cam_accumulate(sys, _jc_r(jc, t2))
    s = hcc_v + cam_aug * v - corr
    return jnp.where(sys.cam_free > 0.5, s, v)


def _groups(sys: SchurSystem):
    """(ids, row-count, column offset in the 18, flat col offset) per
    structured group. The camera vector is [ext rows | intr rows]; both the
    outer and inner extrinsic groups land in the ext region."""
    R, K = sys.n_ext_rows, sys.n_intr
    return (
        (sys.obs_outer, R, 0, 0),
        (sys.obs_inner, R, 6, 0),
        (sys.obs_intr, K, 12, 6 * R),
    )


def _jc_group(jc, off):
    """The two per-residual-row 6-wide slices of one column group."""
    return jc[:, off: off + 6], jc[:, 18 + off: 18 + off + 6]


def _dense_E(sys: SchurSystem) -> jnp.ndarray:
    """Materialize E (N, 3, C) with full-grid segment sums — no scatter.

    For group g with R_g rows, the per-observation 3x6 coupling block
    W = J_point^T J_cam[:, g] is segment-summed with key
    point * R_g + id_g; the (N * R_g, 18) flat result IS the dense
    per-point E restricted to that group. Memory is
    O(N * (2 * n_ext_rows + n_intr) * 18) — the dense path is for moderate
    problems (rigs); at BAL scale use ITERATIVE_SCHUR.
    """
    n_points = sys.g_p.shape[0]
    n_cam = sys.g_c.shape[0]
    jp, jc = sys_jp(sys), sys_jc(sys)
    E = jnp.zeros((n_points, 3, n_cam), sys.jrc.dtype)
    for ids, R_g, off, flat_off in _groups(sys):
        g0, g1 = _jc_group(jc, off)
        W = _outer_cols(jp[:, 0:3], jp[:, 3:6], g0, g1)     # (M, 18) i*6+c
        grid = jax.ops.segment_sum(
            W, sys.obs_point * R_g + ids, num_segments=n_points * R_g
        ).reshape(n_points, R_g, 3, 6)
        part = grid.transpose(0, 2, 1, 3).reshape(n_points, 3, 6 * R_g)
        E = E.at[:, :, flat_off: flat_off + 6 * R_g].add(part)
    return E


def reduced_rhs(sys: SchurSystem, binv: jnp.ndarray) -> jnp.ndarray:
    """-g_c + E^T B~^-1 g_p (local part; psum across shards if distributed)."""
    jp, jc = sys_jp(sys), sys_jc(sys)
    w_g = jnp.einsum("pij,pj->pi", binv, sys.g_p, precision=HIGHEST)
    t_g = _jp_dot(jp, w_g[sys.obs_point])
    return -sys.g_c + cam_accumulate(sys, _jc_r(jc, t_g))


def back_substitute(
    sys: SchurSystem, binv: jnp.ndarray, dc: jnp.ndarray
) -> jnp.ndarray:
    """dp = -B~^-1 (g_p + E dc)."""
    jp, jc = sys_jp(sys), sys_jc(sys)
    t_dc = _jc_dot(jc, dc[sys_cols(sys)])
    e_dc = jax.ops.segment_sum(
        _jp_r(jp, t_dc), sys.obs_point, num_segments=sys.g_p.shape[0])
    dp = -jnp.einsum("pij,pj->pi", binv, sys.g_p + e_dc, precision=HIGHEST)
    return dp * sys.point_free


def hcc_dense(sys: SchurSystem) -> jnp.ndarray:
    """Hcc = sum_m A_m^T A_m materialized (C, C) via the 9 group-pair
    full-grid segment sums (key id1 * R2 + id2 covers the whole block grid,
    so the segment-sum output reshapes straight into the dense block matrix —
    no arbitrary-index scatter)."""
    n_cam = sys.g_c.shape[0]
    jc = sys_jc(sys)
    hcc = jnp.zeros((n_cam, n_cam), sys.jrc.dtype)
    groups = _groups(sys)
    for ids1, R1, off1, flat1 in groups:
        a0, a1 = _jc_group(jc, off1)
        for ids2, R2, off2, flat2 in groups:
            b0, b1 = _jc_group(jc, off2)
            blocks = _outer_cols(a0, a1, b0, b1)            # (M, 36)
            grid = jax.ops.segment_sum(
                blocks, ids1 * R2 + ids2, num_segments=R1 * R2
            ).reshape(R1, R2, 6, 6)
            dense = grid.transpose(0, 2, 1, 3).reshape(6 * R1, 6 * R2)
            hcc = hcc.at[flat1: flat1 + 6 * R1,
                         flat2: flat2 + 6 * R2].add(dense)
    return hcc


def dense_S(sys: SchurSystem, binv: jnp.ndarray) -> jnp.ndarray:
    """Hcc - E^T B~^-1 E materialized (C, C), WITHOUT the LM diagonal."""
    E = _dense_E(sys)
    return hcc_dense(sys) - jnp.einsum("pic,pij,pjd->cd", E, binv, E,
                                       precision=HIGHEST)


def block_jacobi_preconditioner(sys: SchurSystem, cam_aug: jnp.ndarray):
    """6x6 block-Jacobi preconditioner from the Hcc block diagonal + LM
    augmentation (the analogue of Ceres' JACOBI/SCHUR_JACOBI options for
    ITERATIVE_SCHUR). Frozen coordinates get identity rows so the operator
    stays SPD and acts as I on them."""
    R, K = sys.n_ext_rows, sys.n_intr
    jc = sys_jc(sys)

    def group_blocks(off, ids, n):
        a0, a1 = _jc_group(jc, off)
        return jax.ops.segment_sum(
            _outer_cols(a0, a1, a0, a1), ids, num_segments=n
        ).reshape(n, 6, 6)

    ext = (group_blocks(0, sys.obs_outer, R)
           + group_blocks(6, sys.obs_inner, R))
    intr = group_blocks(12, sys.obs_intr, K)
    blocks = jnp.concatenate([ext, intr], axis=0)        # (R + K, 6, 6)
    aug = cam_aug.reshape(R + K, 6)
    frozen = 1.0 - sys.cam_free.reshape(R + K, 6)
    eye6 = jnp.eye(6, dtype=blocks.dtype)
    blocks = blocks + eye6 * (aug + frozen)[:, :, None]
    inv_blocks = jnp.linalg.inv(blocks)

    def precond(v):
        vb = v.reshape(R + K, 6)
        return jnp.einsum("bij,bj->bi", inv_blocks, vb,
                          precision=HIGHEST).reshape(-1)

    return precond


def solve_schur(
    sys: SchurSystem,
    radius: jnp.ndarray,
    options: SolverOptions,
) -> tuple:
    """Solve the augmented normal equations; returns (dp (N,3), dc (C,))."""
    binv = _augmented_point_blocks(sys, radius, options)
    cam_aug = _cam_aug_diag(sys, radius, options)
    rhs = reduced_rhs(sys, binv) * sys.cam_free

    if options.linear_solver == "dense_schur":
        S = dense_S(sys, binv) + jnp.diag(cam_aug)
        dc = masked_spd_solve(S, rhs, sys.cam_free)
    elif options.linear_solver == "iterative_schur":
        if options.preconditioner == "block_jacobi":
            precond = block_jacobi_preconditioner(sys, cam_aug)
        else:
            precond_diag = jnp.where(
                sys.cam_free > 0.5,
                1.0 / (sys.hcc_diag + cam_aug + 1e-300), 1.0,
            )
            precond = lambda v: precond_diag * v
        result = pcg(
            lambda v: schur_matvec(sys, binv, cam_aug, v),
            rhs,
            precond=precond,
            max_iterations=options.cg_max_iterations,
            tol=options.cg_tolerance,
        )
        dc = result.x * sys.cam_free
    else:
        raise ValueError(f"unknown linear_solver {options.linear_solver!r}")

    dp = back_substitute(sys, binv, dc)
    return dp, dc


def j_times(
    sys: SchurSystem, dp: jnp.ndarray, dc: jnp.ndarray
) -> jnp.ndarray:
    """J [dp; dc] per observation (M, 2) — for the model-cost-change test."""
    jp, jc = sys_jp(sys), sys_jc(sys)
    return (_jp_dot(jp, dp[sys.obs_point])
            + _jc_dot(jc, dc[sys_cols(sys)]))
