"""Plane-form (structure-of-arrays) linearization for the dense-grid engine.

The einsum formulation in :mod:`rig_grid` carries Jacobian blocks as
``(N, T, 2, 3)`` tensors with tiny trailing dims. This module computes the
identical quantities with every intermediate a ``(N, T)`` *plane*
(points x cells) and the small 2x3 / 3x3 structure unrolled into
Python-level lists of planes:

  * projection/residual chain: elementwise arithmetic on (N, T) planes;
  * the 2x18 camera Jacobian: 36 planes, stacked once into a
    ``(2N, 18, T)`` tensor so the per-slot Gram matrix H_cc and gradient are
    single batched contractions;
  * the point-camera coupling E: per-column (N, T) @ (T, R) one-hot
    matmuls (contraction over the cell axis);
  * per-point H_pp / g_p: reductions of (N, T) planes over cells.

Every product runs at ``Precision.HIGHEST``: on a GPU a float32 product
may otherwise run in TF32 (about three decimal digits), which would round
the one-hot selections and the Gram sums.

:func:`linearize_banded` / :func:`cost_banded` are the same math over the
live-band layout of :mod:`rig_band` (each point tile pays only its band of
cells): the grid engine's path on sparse rigs.

Derivation shortcuts (vs the chain in ``rig_grid.grid_jacobians``, itself
the closed form of ``src/snavely_reprojection_error.hh:38-118``):
with A = dres/dp3 (2x3 planes),

  j_t_outer = A                      j_x = A R_oi
  j_t_inner = B := A R_o             j_w_outer = -(B x p2) J_r(w_o)
  j_w_inner = -(j_x x X) J_r(w_i)

using  sum_c M_kc [v]_x,cd = (M_k x v)_d  to turn the cross-product matrix
contractions into plane cross products. Validated against the einsum
implementation in tests/test_rig_grid.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from deeparc_tpu.solver.linalg import HIGHEST
from deeparc_tpu.solver.loss import rho as loss_rho, weight as loss_weight


def _rows(M):
    """(T, 3, 3) -> 3x3 nested list of (1, T) planes."""
    return [[M[:, a, b][None, :] for b in range(3)] for a in range(3)]


def _vec(v):
    """(T, 3) -> list of 3 (1, T) planes."""
    return [v[:, a][None, :] for a in range(3)]


def _project_planes(points, sp, xy0, xy1, mask):
    """Shared residual-chain planes. Returns a dict of (N, T) planes."""
    X = [points[:, i:i + 1] for i in range(3)]         # (N, 1)
    Ri, Ro = _rows(sp.R_i), _rows(sp.R_o)
    ti, to = _vec(sp.t_i), _vec(sp.t_o)

    p2 = [X[0] * Ri[a][0] + X[1] * Ri[a][1] + X[2] * Ri[a][2] + ti[a]
          for a in range(3)]
    p3 = [p2[0] * Ro[a][0] + p2[1] * Ro[a][1] + p2[2] * Ro[a][2] + to[a]
          for a in range(3)]
    inv_z = 1.0 / p3[2]
    u0 = p3[0] * inv_z
    u1 = p3[1] * inv_z
    r2 = u0 * u0 + u1 * u1
    d0, d1 = sp.d0[None, :], sp.d1[None, :]
    dcoef = 1.0 + r2 * (d0 + d1 * r2)
    fx, fy = sp.fx[None, :], sp.fy[None, :]
    cx = sp.center[:, 0][None, :]
    cy = sp.center[:, 1][None, :]
    r0 = (fx * dcoef * u0 + cx - xy0) * mask
    r1 = (fy * dcoef * u1 + cy - xy1) * mask
    return dict(X=X, p2=p2, inv_z=inv_z, u0=u0, u1=u1, r2=r2,
                dcoef=dcoef, d0=d0, d1=d1, fx=fx, fy=fy, r0=r0, r1=r1)


def cost_planes(points, sp, xy0, xy1, mask, loss="trivial", loss_scale=0.5):
    """Robustified half-SSE over the grid — the trial-cost pass."""
    c = _project_planes(points, sp, xy0, xy1, mask)
    s = c["r0"] * c["r0"] + c["r1"] * c["r1"]
    return 0.5 * jnp.sum(loss_rho(s, loss, loss_scale) * mask)


def linearize_planes(
    points, sp, grid, xy0, xy1, mask,
    free_outer, free_inner, free_intr, point_free,
    loss="trivial", loss_scale=0.5, ext_only=False,
):
    """One chunk's normal-equation pieces, all-plane arithmetic.

    Returns (cost, g_p (N,3), hpp (N,3,3), g_slots (T,18),
    hcc_slots (T,18,18), E (N,3,C)) matching the einsum implementation in
    ``rig_grid.assemble_grid_system`` bit-for-tolerance. ``ext_only=True``
    omits E's intrinsic columns (E is (N, 3, 6R), the first 6R flat
    columns) for solves whose intrinsics are frozen.
    """
    c = _project_planes(points, sp, xy0, xy1, mask)
    X, p2 = c["X"], c["p2"]
    inv_z, u0, u1, r2 = c["inv_z"], c["u0"], c["u1"], c["r2"]
    dcoef, fx, fy = c["dcoef"], c["fx"], c["fy"]
    r0, r1 = c["r0"], c["r1"]
    Ro, Roi = _rows(sp.R_o), _rows(sp.R_oi)
    Jro, Jri = _rows(sp.Jr_o), _rows(sp.Jr_i)

    raw_s = r0 * r0 + r1 * r1
    cost = 0.5 * jnp.sum(loss_rho(raw_s, loss, loss_scale) * mask)
    if loss != "trivial":
        w = loss_weight(raw_s, loss, loss_scale)
        wm = mask * w
        r0, r1 = r0 * w, r1 * w
    else:
        wm = mask

    # A = d res / d p3 (2x3), masked+weighted
    g = c["d0"] + 2.0 * c["d1"] * r2
    c00 = dcoef + 2.0 * g * u0 * u0
    c11 = dcoef + 2.0 * g * u1 * u1
    c01 = 2.0 * g * u0 * u1
    ccr = dcoef + 2.0 * g * r2
    fxz, fyz = fx * inv_z * wm, fy * inv_z * wm
    A = [[fxz * c00, fxz * c01, -fxz * u0 * ccr],
         [fyz * c01, fyz * c11, -fyz * u1 * ccr]]

    def chain(Ak, M):
        return [Ak[0] * M[0][b] + Ak[1] * M[1][b] + Ak[2] * M[2][b]
                for b in range(3)]

    def cross(v, w):
        return [v[1] * w[2] - v[2] * w[1],
                v[2] * w[0] - v[0] * w[2],
                v[0] * w[1] - v[1] * w[0]]

    jx, jti, jwo, jwi = [], [], [], []
    for k in range(2):
        jx_k = chain(A[k], Roi)
        B_k = chain(A[k], Ro)
        Cw = cross(B_k, p2)
        Dw = cross(jx_k, X)
        jwo.append([-(Cw[0] * Jro[0][b] + Cw[1] * Jro[1][b]
                      + Cw[2] * Jro[2][b]) for b in range(3)])
        jwi.append([-(Dw[0] * Jri[0][b] + Dw[1] * Jri[1][b]
                      + Dw[2] * Jri[2][b]) for b in range(3)])
        jx.append(jx_k)
        jti.append(B_k)

    # intrinsic columns [cx, cy, f0, f1, d0, d1] (2 x 6 planes)
    zero = jnp.zeros_like(wm)
    du0, du1 = dcoef * u0, dcoef * u1
    sh = grid.focal_shared[None, :] > 0.5
    m1 = grid.dist_m1[None, :]
    m2 = grid.dist_m2[None, :]
    jint = [
        [wm, zero, du0 * wm, zero,
         fx * u0 * r2 * m1 * wm, fx * u0 * r2 * r2 * m2 * wm],
        [zero, wm, jnp.where(sh, du1, 0.0) * wm,
         jnp.where(sh, 0.0, du1) * wm,
         fy * u1 * r2 * m1 * wm, fy * u1 * r2 * r2 * m2 * wm],
    ]

    # freeze masks: cameras per (slot, column); points per (point, axis)
    pf = [point_free[:, b:b + 1] for b in range(3)]
    jx_f = [[jx[k][b] * pf[b] for b in range(3)] for k in range(2)]
    P = [
        [jwo[k][b] * free_outer[:, b][None, :] for b in range(3)]
        + [A[k][b] * free_outer[:, 3 + b][None, :] for b in range(3)]
        + [jwi[k][b] * free_inner[:, b][None, :] for b in range(3)]
        + [jti[k][b] * free_inner[:, 3 + b][None, :] for b in range(3)]
        + [jint[k][j] * free_intr[:, j][None, :] for j in range(6)]
        for k in range(2)
    ]

    # point side: lane-axis reductions
    g_p = jnp.stack(
        [jnp.sum(jx_f[0][i] * r0 + jx_f[1][i] * r1, axis=1)
         for i in range(3)], axis=-1)
    h = {}
    for i in range(3):
        for j in range(i, 3):
            h[i, j] = jnp.sum(
                jx_f[0][i] * jx_f[0][j] + jx_f[1][i] * jx_f[1][j], axis=1)
    hpp = jnp.stack([
        jnp.stack([h[min(i, j), max(i, j)] for j in range(3)], axis=-1)
        for i in range(3)], axis=-2)

    # camera side: one (2N, 18, T) stack -> batched contractions
    Jbig = jnp.stack(
        [jnp.stack(P[k], axis=1) for k in range(2)]
    ).reshape((-1,) + (18, mask.shape[1]))                  # (2N, 18, T)
    rbig = jnp.concatenate([r0, r1])                        # (2N, T)
    g_slots = jnp.einsum("xit,xt->ti", Jbig, rbig,
                         precision=HIGHEST)                 # (T, 18)
    hcc_slots = jnp.einsum("xit,xjt->tij", Jbig, Jbig,
                           precision=HIGHEST)               # (T, 18, 18)

    # E: per-column one-hot matmuls over the cell axis
    groups = ((0, grid.onehot_outer, grid.onehot_inner),
              (12, grid.onehot_intr, None))[:1 if ext_only else 2]
    e_rows = []
    for i in range(3):
        segs = []
        for off, oh_a, oh_b in groups:
            cols = []
            for j in range(6):
                W = jx_f[0][i] * P[0][off + j] + jx_f[1][i] * P[1][off + j]
                col = jnp.dot(W, oh_a, precision=HIGHEST)
                if oh_b is not None:
                    W2 = (jx_f[0][i] * P[0][off + 6 + j]
                          + jx_f[1][i] * P[1][off + 6 + j])
                    col = col + jnp.dot(W2, oh_b, precision=HIGHEST)
                cols.append(col)
            seg = jnp.stack(cols, axis=-1)                  # (N, R, 6)
            segs.append(seg.reshape(seg.shape[0], -1))      # (N, 6R)
        e_rows.append(jnp.concatenate(segs, axis=-1))
    E = jnp.stack(e_rows, axis=1)                           # (N, 3, C)
    return cost, g_p, hpp, g_slots, hcc_slots, E


# ---------------------------------------------------------------------------
# Banded (live-window) layout
# ---------------------------------------------------------------------------
# After solver/rig_band.band_grid renumbers cells and sorts points, each tile
# of ``block_np`` points sees only a cyclic window of ``w`` cells starting at
# 8 * starts[tile]; ``w_band`` is one width or width-bucket groups
# ((w, tile_lo, tile_hi), ...). ``pxm`` holds the pre-gathered (3, w, n)
# [xy0; xy1; mask] stack of each group (rig_band.gather_banded_planes).


class _BandCells(NamedTuple):
    """Per-tile band rows of the per-cell grid structure that
    :func:`linearize_planes` reads (duck-typed to GridIndex)."""

    focal_shared: jnp.ndarray
    dist_m1: jnp.ndarray
    dist_m2: jnp.ndarray
    onehot_outer: jnp.ndarray
    onehot_inner: jnp.ndarray
    onehot_intr: jnp.ndarray


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _band_layout(points, grid, starts, w_band, block_np, pxm):
    """Shared banded prologue: (groups, pxm tuple, t_pad, n_pad, padded
    points (n_pad, 3))."""
    from deeparc_tpu.solver.rig_band import (
        band_groups, banded_planes, gather_banded_planes,
    )

    N, T = grid.xy0.shape
    t_pad = _round_up(T, 8)
    if isinstance(w_band, tuple):
        n_pad = w_band[-1][2] * block_np
    else:
        first = pxm[0] if isinstance(pxm, tuple) else pxm
        n_pad = _round_up(N, block_np) if pxm is None else first.shape[-1]
    groups = band_groups(w_band, n_pad, block_np)
    if starts.shape[0] != n_pad // block_np:
        raise ValueError(
            f"band start table has {starts.shape[0]} tiles, the layout "
            f"{n_pad // block_np} (built for another block_np?)")
    if pxm is None:
        pxm_ext = banded_planes(grid, n_pad, max(w for w, _, _ in groups))
        pxm = tuple(gather_banded_planes(pxm_ext, starts, w, block_np, lo, hi)
                    for w, lo, hi in groups)
    pxms = pxm if isinstance(pxm, tuple) else (pxm,)
    pts = jnp.zeros((n_pad, 3), points.dtype).at[:N].set(points)
    pts = pts.at[N:, 2].set(1.0)             # z-safe padding points
    return groups, pxms, t_pad, n_pad, pts


def _band_cells(starts, w, lo, hi, t_pad, T):
    """(tiles, w) band rows modulo t_pad, and their cell ids clipped to the
    real cells (rows >= T are padding cells; their mask is zero)."""
    rows = (starts[lo:hi, None] * 8
            + jnp.arange(w, dtype=starts.dtype)) % t_pad
    return rows, jnp.minimum(rows, T - 1)


def _tiles_planes(pxm_g, bn):
    """(3, w, tiles * bn) band stack -> three (tiles, bn, w) planes."""
    _, w, n = pxm_g.shape
    stack = jnp.moveaxis(pxm_g.reshape(3, w, n // bn, bn), 2, 0)
    planes = jnp.swapaxes(stack, -1, -2)     # (tiles, 3, bn, w)
    return planes[:, 0], planes[:, 1], planes[:, 2]


def linearize_banded(
    points, point_free, sp, grid, free_outer, free_inner, free_intr,
    starts, w_band, loss="trivial", loss_scale=0.5, block_np=256,
    ext_only=False, pxm=None,
):
    """:func:`linearize_planes` over each point tile's live band.

    ``vmap`` over tiles of the plane-form linearization with the tile's
    gathered slot tables; slot sums are scatter-added back by band row.
    Returns (cost, g_p (N,3), hpp (N,3,3), g_slots (T,18),
    hcc_slots (T,18,18), E (N,3,C)) with E in flat camera order (the first
    6R columns only when ``ext_only``)."""
    N, T = grid.xy0.shape
    dtype = points.dtype
    groups, pxms, t_pad, n_pad, pts = _band_layout(
        points, grid, starts, w_band, block_np, pxm)
    pf = jnp.zeros((n_pad, 3), dtype).at[:N].set(point_free.astype(dtype))
    per_cell = (free_outer, free_inner, free_intr)

    cost = jnp.zeros((), dtype)
    g_slots = jnp.zeros((t_pad, 18), dtype)
    hcc_slots = jnp.zeros((t_pad, 18, 18), dtype)
    gp_parts, hpp_parts, e_parts = [], [], []
    for (w, lo, hi), pxm_g in zip(groups, pxms):
        if hi == lo:
            continue
        rows, cells = _band_cells(starts, w, lo, hi, t_pad, T)
        sp_t = jax.tree.map(lambda a: a[cells], sp)
        g_t = _BandCells(
            grid.focal_shared[cells], grid.dist_m1[cells],
            grid.dist_m2[cells], grid.onehot_outer[cells],
            grid.onehot_inner[cells], grid.onehot_intr[cells])
        fo, fi, fk = (f[cells] for f in per_cell)
        xy0, xy1, msk = _tiles_planes(pxm_g, block_np)
        tile = lambda a: a[lo * block_np: hi * block_np].reshape(
            hi - lo, block_np, 3)

        def one_tile(p, pf_t, x0, x1, m, s, g, a, b, c):
            return linearize_planes(p, s, g, x0, x1, m, a, b, c, pf_t,
                                    loss=loss, loss_scale=loss_scale,
                                    ext_only=ext_only)

        c_t, gp_t, hpp_t, gs_t, hs_t, e_t = jax.vmap(one_tile)(
            tile(pts), tile(pf), xy0, xy1, msk, sp_t, g_t, fo, fi, fk)
        cost = cost + jnp.sum(c_t)
        flat_rows = rows.reshape(-1)
        g_slots = g_slots.at[flat_rows].add(gs_t.reshape(-1, 18))
        hcc_slots = hcc_slots.at[flat_rows].add(hs_t.reshape(-1, 18, 18))
        gp_parts.append(gp_t.reshape(-1, 3))
        hpp_parts.append(hpp_t.reshape(-1, 3, 3))
        e_parts.append(e_t.reshape((-1,) + e_t.shape[2:]))
    g_p = jnp.concatenate(gp_parts)[:N]
    hpp = jnp.concatenate(hpp_parts)[:N]
    E = jnp.concatenate(e_parts)[:N]
    return cost, g_p, hpp, g_slots[:T], hcc_slots[:T], E


def cost_banded(points, sp, grid, starts, w_band, loss="trivial",
                loss_scale=0.5, block_np=1024, pxm=None):
    """Banded robustified half-SSE (the trial-cost pass over live bands):
    :func:`cost_planes` per point tile over its band. ``starts``/``pxm``
    must be the cost-pass table and stacks built for THIS ``block_np``."""
    N, T = grid.xy0.shape
    dtype = points.dtype
    groups, pxms, t_pad, n_pad, pts = _band_layout(
        points, grid, starts, w_band, block_np, pxm)
    total = jnp.zeros((), dtype)
    for (w, lo, hi), pxm_g in zip(groups, pxms):
        if hi == lo:
            continue
        _, cells = _band_cells(starts, w, lo, hi, t_pad, T)
        sp_t = jax.tree.map(lambda a: a[cells], sp)
        xy0, xy1, msk = _tiles_planes(pxm_g, block_np)
        tile_pts = pts[lo * block_np: hi * block_np].reshape(
            hi - lo, block_np, 3)
        costs = jax.vmap(
            lambda p, s, x0, x1, m: cost_planes(
                p, s, x0, x1, m, loss=loss, loss_scale=loss_scale)
        )(tile_pts, sp_t, xy0, xy1, msk)
        total = total + jnp.sum(costs)
    return total
