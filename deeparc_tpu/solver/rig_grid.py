"""Dense-grid bundle adjustment for shared-extrinsic rigs.

This module removes every indexed memory op (gather, scatter, segment-sum)
from the hot path by exploiting the rig structure the ``.deeparc`` format
encodes (SURVEY.md section 2.4): a camera cell is an (arc, ring) pair, and
the extrinsic/intrinsic ids of an observation depend only on its CELL,
never on the point. Laying observations out as a dense (points N x cells T)
grid with a visibility mask makes

  * residual evaluation a batched (T,3,3) x (N,3) matmul chain,
  * per-point Hessian blocks and gradients plain einsum reductions over T,
  * camera-side reductions tiny (T,*) one-hot matmuls,
  * the point->camera coupling E a dense (N, 3, C) tensor built by
    slot-constant matmuls,

with zero gathers/scatters/segment-sums. The reduced camera system is solved
EXACTLY (dense Cholesky — true DENSE_SCHUR, ``src/sfm.cc:67``) because rig
camera counts are small; Jacobians are closed-form (the right-Jacobian
formula for the global angle-axis parameterization — exactly what Ceres'
Jets compute through ``snavely_reprojection_error.hh:94-118``), validated
against the autodiff path in tests.

Sparse rigs pay for dead slots of the grid unless the live-band layout of
``rig_band.py`` is active: then each point tile evaluates only its band of
cells, through the plain-XLA banded path (``rig_planes.linearize_banded``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from deeparc_tpu.config import SolverOptions
from deeparc_tpu.geometry.rotation import (
    angle_axis_to_matrix,
    cross_matrix,
    so3_right_jacobian,
)
from deeparc_tpu.scene import BAParams, Scene
from deeparc_tpu.solver import trust_region as tr_mod
from deeparc_tpu.solver.linalg import HIGHEST, inv3x3, masked_spd_solve
from deeparc_tpu.solver.trust_region import lm_diagonal


class GridIndex(NamedTuple):
    """Dense (N points x T cells) observation grid + per-cell structure.

    Observed pixels are stored as two (N, T) *planes* (not one (N, T, 2)
    tensor), so every per-slot quantity is a plane with no tiny trailing
    dimension.
    """

    xy0: jnp.ndarray         # (N, T) observed pixel x (0 where masked)
    xy1: jnp.ndarray         # (N, T) observed pixel y
    mask: jnp.ndarray        # (N, T) 1.0 = observed
    point_mask: jnp.ndarray  # (N,)
    slot_outer: jnp.ndarray  # (T,) int32 extrinsic row ids
    slot_inner: jnp.ndarray  # (T,)
    slot_intr: jnp.ndarray   # (T,)
    onehot_outer: jnp.ndarray  # (T, R) float
    onehot_inner: jnp.ndarray  # (T, R)
    onehot_intr: jnp.ndarray   # (T, K)
    # per-slot intrinsic structure constants
    focal_shared: jnp.ndarray  # (T,)
    dist_m1: jnp.ndarray       # (T,)
    dist_m2: jnp.ndarray       # (T,)
    # optional live-band tables from solver/rig_band.band_grid:
    # (starts_lin (n_tiles,), starts_cost (n_cost_tiles,), lin plane
    # stacks, cost plane stacks); int32 8-cell slab starts
    band: tuple = ()


def grid_from_scene(scene: Scene, dtype=None) -> GridIndex:
    """Host-side: densify the observation list onto the (N, A*R) cell grid."""
    if not scene.meta.share_extrinsic:
        raise ValueError("grid layout requires a shared-extrinsic rig scene")
    A, R_rings = scene.meta.arc_size, scene.meta.ring_size
    T = A * R_rings
    N = scene.n_points
    dtype = dtype or scene.params.points.dtype

    arc = np.repeat(np.arange(A), R_rings).astype(np.int64)
    ring = np.tile(np.arange(R_rings), A).astype(np.int64)
    ring_rec = np.where(ring == 0, 0, ring + A - 1)
    identity = scene.identity_ext
    outer = np.where(ring == 0, arc, np.where(arc == 0, ring_rec, arc))
    inner = np.where((ring == 0) | (arc == 0), identity, ring_rec)
    intr = arc

    cell_of_obs = (
        scene.meta.obs_arc.astype(np.int64) * R_rings
        + scene.meta.obs_ring.astype(np.int64)
    )

    # densify ON DEVICE from the flat observation list, with NO host
    # round-trips: the dense (N, T) planes are ~12x the obs list's bytes
    # (at flagship scale ~920 MB vs ~80 MB), and the index/mask arrays
    # already live on device.
    # Dead observations scatter a zero mask, which is exact because each
    # (point, cell) pair holds at most one observation.
    op_d = scene.index.obs_point
    cell_d = jnp.asarray(cell_of_obs, jnp.int32)
    m_d = scene.index.obs_mask.astype(dtype)
    xy_d = scene.index.obs_xy.astype(dtype)
    xy0_d = jnp.zeros((N, T), dtype).at[op_d, cell_d].set(xy_d[:, 0] * m_d)
    xy1_d = jnp.zeros((N, T), dtype).at[op_d, cell_d].set(xy_d[:, 1] * m_d)
    mask_d = jnp.zeros((N, T), dtype).at[op_d, cell_d].set(m_d)

    n_ext_rows = scene.params.ext_rot.shape[0]
    K = scene.n_intrinsics

    def onehot(ids, n):
        out = np.zeros((T, n))
        out[np.arange(T), ids] = 1.0
        return out

    fs = np.asarray(scene.index.focal_shared)[intr]
    m1 = np.asarray(scene.index.dist_m1)[intr]
    m2 = np.asarray(scene.index.dist_m2)[intr]
    return GridIndex(
        xy0=xy0_d,
        xy1=xy1_d,
        mask=mask_d,
        point_mask=jnp.asarray(np.asarray(scene.index.point_mask), dtype),
        slot_outer=jnp.asarray(outer, jnp.int32),
        slot_inner=jnp.asarray(inner, jnp.int32),
        slot_intr=jnp.asarray(intr, jnp.int32),
        onehot_outer=jnp.asarray(onehot(outer, n_ext_rows), dtype),
        onehot_inner=jnp.asarray(onehot(inner, n_ext_rows), dtype),
        onehot_intr=jnp.asarray(onehot(intr, K), dtype),
        focal_shared=jnp.asarray(fs, dtype),
        dist_m1=jnp.asarray(m1, dtype),
        dist_m2=jnp.asarray(m2, dtype),
    )


class SlotParams(NamedTuple):
    """Per-cell camera quantities (all (T, ...) — tiny)."""

    R_i: jnp.ndarray   # (T, 3, 3) inner rotation matrices
    R_o: jnp.ndarray   # (T, 3, 3)
    R_oi: jnp.ndarray  # (T, 3, 3) R_o @ R_i
    t_i: jnp.ndarray   # (T, 3)
    t_o: jnp.ndarray   # (T, 3)
    # -R_o [.]x J_r factors for rotation derivatives
    Jr_o: jnp.ndarray  # (T, 3, 3) right Jacobian at w_outer
    Jr_i: jnp.ndarray  # (T, 3, 3)
    center: jnp.ndarray  # (T, 2)
    fx: jnp.ndarray     # (T,)
    fy: jnp.ndarray     # (T,)
    d0: jnp.ndarray     # (T,) masked by m1
    d1: jnp.ndarray     # (T,) masked by m2


def slot_params(params: BAParams, grid: GridIndex) -> SlotParams:
    w_o = params.ext_rot[grid.slot_outer]
    w_i = params.ext_rot[grid.slot_inner]
    R_o = angle_axis_to_matrix(w_o)
    R_i = angle_axis_to_matrix(w_i)
    focal = params.focal[grid.slot_intr]
    dist = params.dist[grid.slot_intr]
    return SlotParams(
        R_i=R_i, R_o=R_o, R_oi=jnp.matmul(R_o, R_i, precision=HIGHEST),
        t_i=params.ext_trans[grid.slot_inner],
        t_o=params.ext_trans[grid.slot_outer],
        Jr_o=so3_right_jacobian(w_o),
        Jr_i=so3_right_jacobian(w_i),
        center=params.center[grid.slot_intr],
        fx=focal[:, 0],
        fy=jnp.where(grid.focal_shared > 0.5, focal[:, 0], focal[:, 1]),
        d0=dist[:, 0] * grid.dist_m1,
        d1=dist[:, 1] * grid.dist_m2,
    )


def grid_residuals(
    points: jnp.ndarray, sp: SlotParams, grid: GridIndex
) -> jnp.ndarray:
    """Masked residuals (N, T, 2), evaluated on (N, T) planes."""
    from deeparc_tpu.solver.rig_planes import _project_planes

    c = _project_planes(points, sp, grid.xy0, grid.xy1, grid.mask)
    return jnp.stack([c["r0"], c["r1"]], axis=-1)


class GridBlocks(NamedTuple):
    r: jnp.ndarray      # (N, T, 2) masked residuals
    j_x: jnp.ndarray    # (N, T, 2, 3)  d res / d point
    j_wo: jnp.ndarray   # (N, T, 2, 3)  d res / d outer rotation
    j_to: jnp.ndarray   # (N, T, 2, 3)
    j_wi: jnp.ndarray   # (N, T, 2, 3)
    j_ti: jnp.ndarray   # (N, T, 2, 3)
    j_intr: jnp.ndarray  # (N, T, 2, 6) [center(2), focal(2), dist(2)]


def grid_jacobians(
    points: jnp.ndarray, sp: SlotParams, grid: GridIndex
) -> GridBlocks:
    """Closed-form Jacobian blocks for every (point, cell) slot.

    Derivative chain of ``projectPoint`` + two ``rotatePoint``s
    (``src/snavely_reprojection_error.hh:38-118``), with rotation
    derivatives via d(R(w) v)/dw = -R(w) [v]_x J_r(w) (global angle-axis,
    matching Ceres' Jets through the same parameterization).
    """
    mask = grid.mask[..., None]
    p2 = jnp.einsum("tab,pb->pta", sp.R_i, points,
                    precision=HIGHEST) + sp.t_i[None]
    p3 = jnp.einsum("tab,ptb->pta", sp.R_o, p2,
                    precision=HIGHEST) + sp.t_o[None]
    z = p3[..., 2]
    inv_z = 1.0 / z
    u = p3[..., :2] * inv_z[..., None]          # (N, T, 2)
    r2 = jnp.sum(u * u, axis=-1)
    dcoef = 1.0 + r2 * (sp.d0[None] + sp.d1[None] * r2)
    f2 = jnp.stack(
        [jnp.broadcast_to(sp.fx[None], z.shape),
         jnp.broadcast_to(sp.fy[None], z.shape)], axis=-1
    )                                            # (N, T, 2)
    pred = f2 * dcoef[..., None] * u + sp.center[None]
    r = (pred - jnp.stack([grid.xy0, grid.xy1], axis=-1)) * mask

    # du/dp3: rows [1/z, 0, -ux/z], [0, 1/z, -uy/z]
    zero = jnp.zeros_like(inv_z)
    du_dp = jnp.stack(
        [
            jnp.stack([inv_z, zero, -u[..., 0] * inv_z], axis=-1),
            jnp.stack([zero, inv_z, -u[..., 1] * inv_z], axis=-1),
        ],
        axis=-2,
    )                                            # (N, T, 2, 3)
    # dres_k/dp3 = f_k (dcoef du_k/dp + u_k * ddcoef/dr2 * dr2/dp)
    ddcoef_dr2 = sp.d0[None] + 2.0 * sp.d1[None] * r2
    dr2_dp = 2.0 * jnp.einsum("ptk,ptka->pta", u, du_dp,  # (N, T, 3)
                              precision=HIGHEST)
    dres_dp = f2[..., None] * (
        dcoef[..., None, None] * du_dp
        + u[..., None] * (ddcoef_dr2[..., None] * dr2_dp)[..., None, :]
    )                                            # (N, T, 2, 3)
    dres_dp = dres_dp * mask[..., None]

    # chain to parameters
    j_x = jnp.einsum("ptka,tab->ptkb", dres_dp, sp.R_oi, precision=HIGHEST)
    j_to = dres_dp
    j_ti = jnp.einsum("ptka,tab->ptkb", dres_dp, sp.R_o, precision=HIGHEST)
    # outer rotation: dp3/dwo = -R_o [p2]x Jr_o
    cross_p2 = cross_matrix(p2)                  # (N, T, 3, 3)
    dp3_dwo = -jnp.einsum(
        "tab,ptbc,tcd->ptad", sp.R_o, cross_p2, sp.Jr_o,
        precision=HIGHEST
    )
    j_wo = jnp.einsum("ptka,ptab->ptkb", dres_dp, dp3_dwo, precision=HIGHEST)
    # inner rotation: dp3/dwi = -R_o R_i [X]x Jr_i
    cross_x = cross_matrix(points)               # (N, 3, 3)
    dp3_dwi = -jnp.einsum(
        "tab,pbc,tcd->ptad", sp.R_oi, cross_x, sp.Jr_i,
        precision=HIGHEST
    )
    j_wi = jnp.einsum("ptka,ptab->ptkb", dres_dp, dp3_dwi, precision=HIGHEST)

    # intrinsics: center (identity), focal, distortion
    eye2 = jnp.eye(2, dtype=z.dtype)
    j_center = jnp.broadcast_to(eye2, r.shape + (2,)) * mask[..., None]
    du_term = dcoef[..., None] * u               # (N, T, 2)
    shared = grid.focal_shared[None, :, None]
    # d res_x / d f0 = dcoef*ux; d res_y / d f0 = shared ? dcoef*uy : 0
    j_f0 = jnp.stack(
        [du_term[..., 0], jnp.where(shared[..., 0] > 0.5, du_term[..., 1], 0.0)],
        axis=-1,
    )
    j_f1 = jnp.stack(
        [jnp.zeros_like(z),
         jnp.where(shared[..., 0] > 0.5, 0.0, du_term[..., 1])],
        axis=-1,
    )
    j_focal = jnp.stack([j_f0, j_f1], axis=-1) * mask[..., None]  # (N,T,2,2)
    fu = f2 * u                                   # (N, T, 2)
    j_d0 = fu * (r2 * grid.dist_m1[None])[..., None]
    j_d1 = fu * (r2 * r2 * grid.dist_m2[None])[..., None]
    j_dist = jnp.stack([j_d0, j_d1], axis=-1) * mask[..., None]
    j_intr = jnp.concatenate([j_center, j_focal, j_dist], axis=-1)
    return GridBlocks(
        r=r, j_x=j_x, j_wo=j_wo, j_to=j_to, j_wi=j_wi, j_ti=j_ti,
        j_intr=j_intr,
    )


# ---------------------------------------------------------------------------
# Assembly: chunked over points, everything dense.
# ---------------------------------------------------------------------------


class GridSystem(NamedTuple):
    cost: jnp.ndarray      # scalar 0.5 ||r||^2
    g_p: jnp.ndarray       # (N, 3)
    hpp: jnp.ndarray       # (N, 3, 3)
    g_c: jnp.ndarray       # (C,)
    hcc: jnp.ndarray       # (C, C)
    E: jnp.ndarray         # (N, 3, C)


def _cam_groups(blocks: GridBlocks):
    """Per-structure-group (N, T, 2, 6) camera Jacobians."""
    outer = jnp.concatenate([blocks.j_wo, blocks.j_to], axis=-1)
    inner = jnp.concatenate([blocks.j_wi, blocks.j_ti], axis=-1)
    return outer, inner, blocks.j_intr


def _bin_slot_system(g_slots, hcc_slots, grid, C, dtype):
    """Fold per-slot (T, 18) / (T, 18, 18) pieces into the flat camera
    gradient (C,) and dense H_cc (C, C) via the one-hot bin matrices."""
    R_rows = grid.onehot_outer.shape[1]
    g_ext = (
        jnp.einsum("tr,tj->rj", grid.onehot_outer, g_slots[:, 0:6],
                   precision=HIGHEST)
        + jnp.einsum("tr,tj->rj", grid.onehot_inner, g_slots[:, 6:12],
                     precision=HIGHEST)
    )
    g_c = jnp.concatenate([
        g_ext.reshape(-1),
        jnp.einsum("tk,tj->kj", grid.onehot_intr, g_slots[:, 12:18],
                   precision=HIGHEST)
        .reshape(-1),
    ])
    groups = (
        (grid.onehot_outer, slice(0, 6), 0),
        (grid.onehot_inner, slice(6, 12), 0),
        (grid.onehot_intr, slice(12, 18), 6 * R_rows),
    )
    hcc = jnp.zeros((C, C), dtype)
    for oh_a, sl_a, off_a in groups:
        Ra = oh_a.shape[1]
        for oh_b, sl_b, off_b in groups:
            Rb = oh_b.shape[1]
            dense = jnp.einsum(
                "tij,tu,tv->uivj", hcc_slots[:, sl_a, sl_b], oh_a, oh_b,
                precision=HIGHEST
            ).reshape(6 * Ra, 6 * Rb)
            hcc = hcc.at[
                off_a: off_a + 6 * Ra, off_b: off_b + 6 * Rb
            ].add(dense)
    return g_c, hcc


def assemble_grid_system(
    points: jnp.ndarray,
    sp: SlotParams,
    grid: GridIndex,
    cam_free: jnp.ndarray,
    point_free: jnp.ndarray,
    chunk_size: int = 8192,
    loss: str = "trivial",
    loss_scale: float = 0.5,
    impl: str = "planes",
    band_width: int = 0,
    band_block: int = 0,
    band_intr_frozen: bool = False,
) -> GridSystem:
    """Linearize + accumulate normal-equation pieces, chunked over points.

    The (C,) free mask is applied by zeroing camera Jacobian groups per
    column; the (N, 3) point mask by zeroing j_x.

    ``impl`` selects the linearization: "planes" (structure-of-arrays
    (N, T) planes in plain XLA, see rig_planes.py) or "einsum" (the
    reference formulation carrying (N, T, 2, 3) blocks).

    With ``band_width`` set and a band-prepared grid (``grid.band``) the
    "planes" path evaluates each point tile over its live band only;
    ``band_intr_frozen`` then drops E's intrinsic columns (E holds the
    first 6R flat camera columns).
    """
    N = points.shape[0]
    T = grid.mask.shape[1]
    R_rows = grid.onehot_outer.shape[1]
    K = grid.onehot_intr.shape[1]
    C = 6 * R_rows + 6 * K
    dtype = points.dtype

    # per-slot 6-wide free masks gathered from the flat camera mask
    cam_free_rows = cam_free[: 6 * R_rows].reshape(R_rows, 6)
    cam_free_intr = cam_free[6 * R_rows:].reshape(K, 6)
    free_outer = cam_free_rows[grid.slot_outer]    # (T, 6)
    free_inner = cam_free_rows[grid.slot_inner]
    free_intr = cam_free_intr[grid.slot_intr]

    if impl == "planes" and band_width and grid.band:
        from deeparc_tpu.solver.rig_planes import linearize_banded

        cost, g_p, hpp, g_slots, hcc_slots, E = linearize_banded(
            points, point_free, sp, grid, free_outer, free_inner, free_intr,
            grid.band[0], band_width, loss=loss, loss_scale=loss_scale,
            block_np=band_block or min(chunk_size, 256),
            ext_only=band_intr_frozen, pxm=grid.band[2])
        g_c, hcc = _bin_slot_system(g_slots, hcc_slots, grid, C, dtype)
        return GridSystem(cost=cost, g_p=g_p, hpp=hpp, g_c=g_c, hcc=hcc, E=E)

    n_chunks = -(-N // chunk_size)
    pad = n_chunks * chunk_size - N
    points_p = jnp.concatenate([points, jnp.zeros((pad, 3), dtype)])
    # padded points sit at the origin; give them z-safe coordinates and a
    # zero mask so they contribute nothing
    points_p = points_p.at[N:, 2].set(1.0)
    pad_plane = jnp.zeros((pad, T), dtype)
    xy0_p = jnp.concatenate([grid.xy0, pad_plane])
    xy1_p = jnp.concatenate([grid.xy1, pad_plane])
    mask_p = jnp.concatenate([grid.mask, pad_plane])
    pfree_p = jnp.concatenate([point_free, jnp.zeros((pad, 3), dtype)])

    def chunk_fn_einsum(args):
        from deeparc_tpu.solver.loss import rho as loss_rho, weight as loss_weight

        pts, xy0, xy1, msk, pfree = args
        g = grid._replace(xy0=xy0, xy1=xy1, mask=msk)
        blocks = grid_jacobians(pts, sp, g)
        raw_s = jnp.sum(blocks.r * blocks.r, axis=-1)
        if loss != "trivial":
            w = loss_weight(raw_s, loss, loss_scale)[..., None]
            blocks = GridBlocks(
                r=blocks.r * w,
                j_x=blocks.j_x * w[..., None],
                j_wo=blocks.j_wo * w[..., None],
                j_to=blocks.j_to * w[..., None],
                j_wi=blocks.j_wi * w[..., None],
                j_ti=blocks.j_ti * w[..., None],
                j_intr=blocks.j_intr * w[..., None],
            )
        j_x = blocks.j_x * pfree[:, None, None, :]
        outer, inner, intr = _cam_groups(blocks)
        outer = outer * free_outer[None, :, None, :]
        inner = inner * free_inner[None, :, None, :]
        intr = intr * free_intr[None, :, None, :]
        r = blocks.r
        cost = 0.5 * jnp.sum(loss_rho(raw_s, loss, loss_scale) * msk)
        g_p = jnp.einsum("ptki,ptk->pi", j_x, r, precision=HIGHEST)
        hpp = jnp.einsum("ptki,ptkj->pij", j_x, j_x, precision=HIGHEST)

        # camera side: per-slot gradient + 18x18 Gram, then one-hot binned
        g_out = jnp.einsum("ptkj,ptk->tj", outer, r, precision=HIGHEST)
        g_in = jnp.einsum("ptkj,ptk->tj", inner, r, precision=HIGHEST)
        g_int = jnp.einsum("ptkj,ptk->tj", intr, r, precision=HIGHEST)
        g_slots = jnp.concatenate([g_out, g_in, g_int], axis=-1)
        J18 = jnp.concatenate([outer, inner, intr], axis=-1)  # (c, T, 2, 18)
        hcc_slots = jnp.einsum("ptki,ptkj->tij", J18, J18,  # (T, 18, 18)
                               precision=HIGHEST)
        g_c, hcc = _bin_slot_system(g_slots, hcc_slots, grid, C, dtype)

        # E: point-camera coupling, slot-binned dense (c, 3, C)
        def e_part(grp, oh):
            W = jnp.einsum("ptki,ptkj->ptij", j_x, grp,  # (c, T, 3, 6)
                           precision=HIGHEST)
            binned = jnp.einsum("ptij,tr->prij", W, oh,  # (c, R, 3, 6)
                                precision=HIGHEST)
            cdim = binned.shape[1] * 6
            return binned.transpose(0, 2, 1, 3).reshape(-1, 3, cdim)

        E_ext = e_part(outer, grid.onehot_outer) + e_part(
            inner, grid.onehot_inner
        )
        E_int = e_part(intr, grid.onehot_intr)
        E = jnp.concatenate([E_ext, E_int], axis=-1)          # (c, 3, C)
        return cost, g_p, hpp, g_c, hcc, E

    def chunk_fn_planes(args):
        from deeparc_tpu.solver.rig_planes import linearize_planes

        pts, xy0, xy1, msk, pfree = args
        cost, g_p, hpp, g_slots, hcc_slots, E = linearize_planes(
            pts, sp, grid, xy0, xy1, msk,
            free_outer, free_inner, free_intr, pfree,
            loss=loss, loss_scale=loss_scale,
        )
        g_c, hcc = _bin_slot_system(g_slots, hcc_slots, grid, C, dtype)
        return cost, g_p, hpp, g_c, hcc, E

    chunk_fn = chunk_fn_planes if impl == "planes" else chunk_fn_einsum
    shaped = lambda a: a.reshape((n_chunks, chunk_size) + a.shape[1:])
    cost_c, g_p_c, hpp_c, g_c_c, hcc_c, E_c = jax.lax.map(
        chunk_fn,
        (shaped(points_p), shaped(xy0_p), shaped(xy1_p), shaped(mask_p),
         shaped(pfree_p)),
    )
    return GridSystem(
        cost=jnp.sum(cost_c),
        g_p=g_p_c.reshape(-1, 3)[:N],
        hpp=hpp_c.reshape(-1, 3, 3)[:N],
        g_c=jnp.sum(g_c_c, axis=0),
        hcc=jnp.sum(hcc_c, axis=0),
        E=E_c.reshape(-1, 3, E_c.shape[-1])[:N],
    )


def grid_cost(
    points: jnp.ndarray, sp: SlotParams, grid: GridIndex,
    chunk_size: int = 16384,
    loss: str = "trivial", loss_scale: float = 0.5,
    impl: str = "planes",
    band_width: int = 0,
    band_block: int = 0,
) -> jnp.ndarray:
    """Residual-only (robustified) cost pass (trial evaluation), chunked:
    over the live bands when the grid is band-prepared, else over (N, T)
    planes. One elementwise chain feeding one sum, which XLA fuses into a
    single reduction."""
    if impl == "planes" and band_width and grid.band:
        from deeparc_tpu.solver.rig_planes import cost_banded

        return cost_banded(
            points, sp, grid, grid.band[1], band_width, loss=loss,
            loss_scale=loss_scale,
            block_np=band_block or min(chunk_size, 1024), pxm=grid.band[3])
    N = points.shape[0]
    T = grid.mask.shape[1]
    dtype = points.dtype
    n_chunks = -(-N // chunk_size)
    pad = n_chunks * chunk_size - N
    points_p = jnp.concatenate([points, jnp.zeros((pad, 3), dtype)])
    points_p = points_p.at[N:, 2].set(1.0)
    pad_plane = jnp.zeros((pad, T), dtype)
    xy0_p = jnp.concatenate([grid.xy0, pad_plane])
    xy1_p = jnp.concatenate([grid.xy1, pad_plane])
    mask_p = jnp.concatenate([grid.mask, pad_plane])

    def chunk_fn(args):
        from deeparc_tpu.solver.loss import rho as loss_rho

        pts, xy0, xy1, msk = args
        if impl == "planes":
            from deeparc_tpu.solver.rig_planes import cost_planes

            return cost_planes(pts, sp, xy0, xy1, msk,
                               loss=loss, loss_scale=loss_scale)
        r = grid_residuals(pts, sp, grid._replace(xy0=xy0, xy1=xy1, mask=msk))
        s = jnp.sum(r * r, axis=-1)
        return 0.5 * jnp.sum(loss_rho(s, loss, loss_scale) * msk)

    shaped = lambda a: a.reshape((n_chunks, chunk_size) + a.shape[1:])
    costs = jax.lax.map(
        chunk_fn,
        (shaped(points_p), shaped(xy0_p), shaped(xy1_p), shaped(mask_p)),
    )
    return jnp.sum(costs)


# ---------------------------------------------------------------------------
# The grid LM step: exact dense Schur each iteration.
# ---------------------------------------------------------------------------


class GridState(NamedTuple):
    points: jnp.ndarray    # (N, 3)
    cam_vec: jnp.ndarray   # (C,) flattened camera vector
    cost: jnp.ndarray
    tr: tr_mod.TRState
    k: jnp.ndarray
    status: jnp.ndarray


class GridStateF(NamedTuple):
    """Fused-trial state: carries the linearization at the current iterate
    (make_grid_step(fuse_trial=True)). ``cost == sys.cost`` always."""

    points: jnp.ndarray
    cam_vec: jnp.ndarray
    cost: jnp.ndarray
    sys: "GridSystem"
    tr: tr_mod.TRState
    k: jnp.ndarray
    status: jnp.ndarray


def flatten_cam_tables(params: BAParams) -> jnp.ndarray:
    from deeparc_tpu.residuals.reprojection import flatten_camera

    return flatten_camera(params)


def _params_from(cam_vec: jnp.ndarray, points: jnp.ndarray,
                 template: BAParams) -> BAParams:
    from deeparc_tpu.residuals.reprojection import unflatten_camera

    out = unflatten_camera(cam_vec, template)
    return dataclasses.replace(out, points=points)


def make_grid_step(options: SolverOptions, template: BAParams,
                   chunk_size: int = 8192, impl: str = "planes",
                   axis: str | None = None,
                   band_widths: tuple = (0, 0),
                   band_blocks: tuple = (0, 0),
                   band_intr_frozen: bool = False,
                   fuse_trial: bool = False):
    """Pure LM step over the grid layout:
    step(state, grid, cam_free, point_free) -> (state, info).

    With ``axis`` set, the step is SPMD over that mesh axis: the caller
    shards points (grid rows + state.points) across shards, and every
    cross-point reduction is a ``psum``/``pmax`` over the axis — the reduced
    camera system, trial cost, and trust-region scalars come out replicated,
    so the identical step function serves both the single-chip and the
    distributed grid engine (SURVEY.md section 2.5).

    ``band_widths`` = (linearize, cost) static live-band widths from
    solver/rig_band.band_grid (planes impl; (0, 0) = unbanded),
    ``band_blocks`` the point-tile widths the two start tables were built
    for. The grid passed to the step must then carry the matching ``band``
    start tables."""
    from deeparc_tpu.solver.ba import StepInfo

    impl = resolve_grid_impl(impl)

    if axis is None:
        allsum = allmax = allsum_sym = lambda x: x
    else:
        allsum = lambda x: jax.lax.psum(x, axis)
        allmax = lambda x: jax.lax.pmax(x, axis)

        def allsum_sym(m):
            """psum a symmetric (C, C) matrix triu-packed: H_cc and the
            Schur correction are the step's big collectives — packing
            moves (C+1)/(2C) of the bytes (VERDICT r3 item 7)."""
            assert m.ndim == 2, "allsum_sym packs a single (C, C) matrix"
            n = m.shape[-1]
            iu = np.triu_indices(n)
            packed = jax.lax.psum(m[iu[0], iu[1]], axis)
            # build from fresh zeros (not zeros_like(m)): the unreduced
            # operand is axis-varying under shard_map and would taint the
            # reduced result's invariance
            out = jnp.zeros((n, n), m.dtype).at[iu[0], iu[1]].set(packed)
            diag = out * jnp.eye(n, dtype=m.dtype)
            return out + jnp.swapaxes(out, -1, -2) - diag

    # banded solve with frozen intrinsics: E comes back EXT-ONLY (N,3,6R)
    # — the intrinsic columns are identically zero and never materialized
    ext_only = (impl == "planes" and band_intr_frozen
                and bool(band_widths[0]))

    def _layout(grid):
        """(to_flat, to_e): maps between E's columns and the flat camera
        vector. An ext-only E holds the first 6R flat columns: C-sized
        pieces are embedded into / cut from the full vector, never E."""
        if not ext_only:
            return (lambda v: v), (lambda v: v)
        C_full = 6 * (grid.onehot_outer.shape[1] + grid.onehot_intr.shape[1])
        ce = 6 * grid.onehot_outer.shape[1]

        def to_flat(v):
            if v.ndim == 1:
                return jnp.zeros((C_full,), v.dtype).at[:ce].set(v)
            return jnp.zeros((C_full, C_full), v.dtype).at[:ce, :ce].set(v)

        return to_flat, lambda v: v[:ce]

    def linearize_at(points, cam_vec, grid, cam_free, point_free):
        params = _params_from(cam_vec, points, template)
        sp = slot_params(params, grid)
        sys = assemble_grid_system(
            points, sp, grid, cam_free, point_free, chunk_size,
            options.loss, options.loss_scale, impl=impl,
            band_width=band_widths[0], band_block=band_blocks[0],
            band_intr_frozen=band_intr_frozen,
        )
        return sys._replace(g_c=allsum(sys.g_c), hcc=allsum_sym(sys.hcc),
                            cost=allsum(sys.cost))

    def _solve_and_decide(sys, state, grid, cam_free, point_free,
                          trial_eval):
        """Shared LM core: solve the augmented system from ``sys``, build
        the trial point, evaluate it with ``trial_eval(points, cam) ->
        (cost, payload)``, and make the Ceres accept/radius decision.
        Returns everything the two step variants need."""
        to_flat, to_e = _layout(grid)
        # augmented per-point blocks
        diag = jnp.diagonal(sys.hpp, axis1=-2, axis2=-1)
        d2p = lm_diagonal(diag, options.min_lm_diagonal, options.max_lm_diagonal)
        eye3 = jnp.eye(3, dtype=state.points.dtype)
        aug = sys.hpp + eye3 * d2p[:, :, None] / state.tr.radius
        aug = aug + (1.0 - point_free)[:, :, None] * eye3
        binv = inv3x3(aug)

        d2c = lm_diagonal(
            jnp.diagonal(sys.hcc), options.min_lm_diagonal,
            options.max_lm_diagonal,
        )
        cam_aug = d2c / state.tr.radius

        rhs = (
            -sys.g_c
            + to_flat(allsum(jnp.einsum("pic,pij,pj->c", sys.E, binv,
                                        sys.g_p, precision=HIGHEST)))
        ) * cam_free
        corr = to_flat(
            allsum_sym(jnp.einsum("pic,pij,pjd->cd", sys.E, binv, sys.E,
                                  precision=HIGHEST)))
        S = sys.hcc + jnp.diag(cam_aug) - corr
        dc = masked_spd_solve(S, rhs, cam_free)

        e_dc = jnp.einsum("pic,c->pi", sys.E, to_e(dc), precision=HIGHEST)
        dp = -jnp.einsum("pij,pj->pi", binv, sys.g_p + e_dc,
                         precision=HIGHEST) * point_free

        # model cost change from stored quadratic pieces:
        # mcc = -(d^T g + 0.5 d^T (J^T J) d)
        dtg = (allsum(jnp.vdot(dp, sys.g_p, precision=HIGHEST))
               + jnp.vdot(dc, sys.g_c, precision=HIGHEST))
        dhd = (
            allsum(
                jnp.einsum("pi,pij,pj->", dp, sys.hpp, dp, precision=HIGHEST)
                + 2.0 * jnp.vdot(dp.reshape(-1), e_dc.reshape(-1),
                                 precision=HIGHEST)
            )
            + jnp.dot(dc, jnp.dot(sys.hcc, dc, precision=HIGHEST),
                      precision=HIGHEST)
        )
        mcc = -(dtg + 0.5 * dhd)

        new_points = state.points + dp
        new_cam = state.cam_vec + dc
        new_cost, payload = trial_eval(new_points, new_cam)

        rho = (state.cost - new_cost) / jnp.maximum(mcc, 1e-300)
        accept = (mcc > 0) & (rho > options.min_relative_decrease)

        tr_next = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b),
            tr_mod.step_accepted(state.tr, rho, options.max_radius),
            tr_mod.step_rejected(state.tr),
        )
        points_next = jnp.where(accept, new_points, state.points)
        cam_next = jnp.where(accept, new_cam, state.cam_vec)
        cost_next = jnp.where(accept, new_cost, state.cost)

        grad_max = jnp.maximum(
            jnp.max(jnp.abs(sys.g_c)), allmax(jnp.max(jnp.abs(sys.g_p)))
        )
        step_norm = jnp.sqrt(allsum(jnp.vdot(dp, dp, precision=HIGHEST))
                             + jnp.vdot(dc, dc, precision=HIGHEST))
        x_norm = jnp.sqrt(
            allsum(jnp.vdot(state.points, state.points, precision=HIGHEST))
            + jnp.vdot(state.cam_vec, state.cam_vec, precision=HIGHEST)
        )
        cost_change = state.cost - new_cost
        ftol = accept & (
            jnp.abs(cost_change) <= options.function_tolerance * state.cost
        )
        ptol = accept & (
            step_norm <= options.parameter_tolerance
            * (x_norm + options.parameter_tolerance)
        )
        gtol = grad_max <= options.gradient_tolerance
        radius_min = tr_next.radius <= options.min_radius
        status = jnp.where(
            gtol, 3,
            jnp.where(ftol, 2, jnp.where(ptol, 4, jnp.where(radius_min, 5, 0))),
        )
        info = StepInfo(
            cost=cost_next, cost_change=cost_change, grad_max=grad_max,
            step_norm=step_norm, radius=state.tr.radius, rho=rho,
            accepted=accept,
        )
        return (points_next, cam_next, cost_next, tr_next,
                jnp.asarray(status), accept, payload, info)

    def step(state: GridState, grid: GridIndex, cam_free, point_free):
        sys = linearize_at(state.points, state.cam_vec, grid, cam_free,
                           point_free)

        def trial_eval(new_points, new_cam):
            trial_params = _params_from(new_cam, new_points, template)
            new_cost = allsum(grid_cost(
                new_points, slot_params(trial_params, grid), grid,
                loss=options.loss, loss_scale=options.loss_scale, impl=impl,
                band_width=band_widths[1], band_block=band_blocks[1],
            ))
            return new_cost, None

        (points_next, cam_next, cost_next, tr_next, status, accept, _,
         info) = _solve_and_decide(sys, state, grid, cam_free, point_free,
                                   trial_eval)
        next_state = GridState(
            points=points_next, cam_vec=cam_next, cost=cost_next,
            tr=tr_next, k=state.k + 1, status=status,
        )
        return next_state, info

    def step_fused(state: "GridStateF", grid: GridIndex, cam_free,
                   point_free):
        """Fused-trial LM step: the state CARRIES the linearization at its
        current iterate, and the trial evaluation IS the next
        linearization (which returns the cost with the system).
        One heavy pass per iteration instead of linearize + cost-pass;
        rejected steps reuse the stored system and re-solve with the
        shrunk radius (the cost pass is redundant whenever the step is
        accepted, which near-converged LM almost always is)."""
        sys = state.sys

        def trial_eval(new_points, new_cam):
            sys_trial = linearize_at(new_points, new_cam, grid, cam_free,
                                     point_free)
            return sys_trial.cost, sys_trial

        (points_next, cam_next, cost_next, tr_next, status, accept,
         sys_trial, info) = _solve_and_decide(
            sys, state, grid, cam_free, point_free, trial_eval)
        sys_next = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), sys_trial, sys)
        next_state = GridStateF(
            points=points_next, cam_vec=cam_next, cost=cost_next,
            sys=sys_next, tr=tr_next, k=state.k + 1, status=status,
        )
        return next_state, info

    return step_fused if fuse_trial else step


def init_grid_state(
    params: BAParams, grid: GridIndex, options: SolverOptions,
    axis: str | None = None, impl: str = "planes",
    band_widths: tuple = (0, 0), band_blocks: tuple = (0, 0),
) -> GridState:
    """``impl`` must match the evaluator the solve runs with: state.cost and
    every trial cost have to come from the SAME (f32-rounding) kernel, or a
    borderline first-step rho can flip accept/reject."""
    dtype = params.points.dtype
    sp = slot_params(params, grid)
    cost0 = grid_cost(params.points, sp, grid,
                      loss=options.loss, loss_scale=options.loss_scale,
                      impl=impl, band_width=band_widths[1],
                      band_block=band_blocks[1])
    if axis is not None:
        cost0 = jax.lax.psum(cost0, axis)
    return GridState(
        points=params.points,
        cam_vec=flatten_cam_tables(params),
        cost=cost0,
        tr=tr_mod.init_tr(options.initial_radius, dtype),
        k=jnp.asarray(0),
        status=jnp.asarray(0),
    )


def init_grid_state_fused(
    params: BAParams, grid: GridIndex, options: SolverOptions,
    cam_free, point_free,
    axis: str | None = None, impl: str = "planes",
    band_widths: tuple = (0, 0), band_blocks: tuple = (0, 0),
    band_intr_frozen: bool = False, chunk_size: int = 8192,
) -> GridStateF:
    """State for make_grid_step(fuse_trial=True): one full linearization
    at the start iterate (its cost doubles as cost0)."""
    dtype = params.points.dtype
    sp = slot_params(params, grid)
    sys0 = assemble_grid_system(
        params.points, sp, grid, cam_free, point_free, chunk_size,
        options.loss, options.loss_scale, impl=impl,
        band_width=band_widths[0], band_block=band_blocks[0],
        band_intr_frozen=band_intr_frozen,
    )
    if axis is not None:
        sys0 = sys0._replace(
            g_c=jax.lax.psum(sys0.g_c, axis),
            hcc=jax.lax.psum(sys0.hcc, axis),
            cost=jax.lax.psum(sys0.cost, axis),
        )
    return GridStateF(
        points=params.points,
        cam_vec=flatten_cam_tables(params),
        # distinct buffer from sys.cost: donated state must not alias
        cost=sys0.cost + jnp.zeros((), dtype),
        sys=sys0,
        tr=tr_mod.init_tr(options.initial_radius, dtype),
        k=jnp.asarray(0),
        status=jnp.asarray(0),
    )


def resolve_grid_impl(impl: str) -> str:
    """The grid engine's linearization for a requested ``impl``.

    'auto' and 'xla' name the plane path ('planes': plain XLA over (N, T)
    planes, or over each point tile's live band when the visibility has
    locality); 'einsum' is the reference formulation. There is no
    hand-written kernel: a fused Pallas/Triton banded linearize ran its
    linearize 3.6x faster than the plane path on an H100 but lost end to
    end, its compile and executable load outweighing the solve (PERF.md),
    so any other name raises."""
    if impl in ("auto", "xla", "planes"):
        return "planes"
    if impl == "einsum":
        return impl
    raise ValueError(f"unknown grid impl {impl!r}: use 'auto', 'planes', "
                     "'xla' or 'einsum'")


def solve_ba_grid(
    params: BAParams,
    grid: GridIndex,
    free: BAParams,
    options: SolverOptions = SolverOptions(),
    driver: str = "python",
    chunk_size: int = 8192,
    impl: str = "planes",
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
    resume: bool = False,
    logger=None,
    while_block: int = 10,
    band: str = "auto",
    fuse_trial: bool | None = None,
    band_reuse: dict | None = None,
):
    """LM to convergence on the grid engine. Returns a solver.ba.BAResult.

    Operational features match the indexed engine's driver (solver/ba.py):

    driver='python': step-per-dispatch with Ceres-style progress printing,
      the wall-clock cap (sfm.cc:71), periodic ``.npz`` solver-state
      checkpoints (``resume=True`` restarts from checkpoint_path with the
      saved trust-region state), and a JsonlLogger.
    driver='while_loop': mostly-on-device — iterations run in
      ``while_block``-sized ``lax.while_loop`` dispatches with the
      wall-clock budget (and optional checkpointing) enforced on the host
      between blocks.

    ``band='auto'`` (planes impl) runs the live-band prep
    (solver/rig_band.py) on the visibility mask and solves over the live
    bands when it finds locality — the pipeline's solve/filter loop gets
    the banded speedup transparently (points are permuted internally and
    un-permuted on every exit surface incl. checkpoints); ``band='none'``
    disables.
    """
    import time as _time

    from deeparc_tpu.residuals.reprojection import flatten_camera
    from deeparc_tpu.solver.ba import BAResult

    impl = resolve_grid_impl(impl)
    band_widths = band_blocks = (0, 0)
    band_prep = None
    intr_frozen = False
    if band == "auto" and impl == "planes":
        from deeparc_tpu.solver.rig_band import band_grid, band_grid_update

        # ``band_reuse``: a caller-held dict carrying the prep across the
        # pipeline's solve/filter rounds — the filter only removes
        # observations, so the stored covers stay valid and every round
        # shares ONE compiled step (re-prep + re-compile dominated the
        # pipeline row's wall clock)
        if band_reuse is not None and "prep" in band_reuse:
            prep = (band_grid_update(band_reuse["prep"], grid)
                    if band_reuse["prep"] is not None else None)
        else:
            prep = band_grid(grid)
            if band_reuse is not None:
                band_reuse["prep"] = prep
        if prep is not None:
            band_prep = prep
            if options.progress_to_stdout:
                print(f"[grid] live-band solve: w_band<={prep.w_band} of "
                      f"{grid.mask.shape[1]} cells, lin groups "
                      f"{[g[0] for g in prep.lin_groups]} "
                      f"(cost pass <={prep.w_band_cost}, groups "
                      f"{[g[0] for g in prep.cost_groups]})")
            grid = prep.grid
            params = dataclasses.replace(
                params, points=params.points[prep.perm])
            free = dataclasses.replace(
                free, points=free.points[prep.perm])
            band_widths, band_blocks = prep.widths
            # all intrinsic columns frozen -> ext-only E (sfm.cc:60-62 is
            # the reference's standard BA mode)
            n_ext_rows = params.ext_rot.shape[0]
            intr_frozen = not bool(np.any(np.asarray(
                flatten_camera(free))[6 * n_ext_rows:]))
    unperm = ((lambda pts: pts) if band_prep is None
              else (lambda pts: pts[band_prep.inv]))

    if fuse_trial is None:
        # the fused step selects the whole system (E included) every
        # iteration to save one cost pass; that pays only where the cost
        # pass is expensive: the unbanded plane path on (N, T) planes
        fuse_trial = impl == "planes" and band_prep is None
    cam_free = flatten_camera(free)
    point_free = free.points
    step = make_grid_step(options, params, chunk_size, impl=impl,
                          band_widths=band_widths, band_blocks=band_blocks,
                          band_intr_frozen=intr_frozen,
                          fuse_trial=fuse_trial)

    def _make_state(p):
        if fuse_trial:
            return init_grid_state_fused(
                p, grid, options, cam_free, point_free, impl=impl,
                band_widths=band_widths, band_blocks=band_blocks,
                band_intr_frozen=intr_frozen, chunk_size=chunk_size)
        return init_grid_state(p, grid, options, impl=impl,
                               band_widths=band_widths,
                               band_blocks=band_blocks)

    state = _make_state(params)
    start_iter = 0
    if resume and checkpoint_path:
        import os as _os

        if _os.path.exists(checkpoint_path):
            from deeparc_tpu.utils.checkpoint import load_solver_state

            ck_params, scal = load_solver_state(
                checkpoint_path, dtype=params.points.dtype)
            if band_prep is not None:
                # checkpoints live in ORIGINAL point order
                ck_params = dataclasses.replace(
                    ck_params, points=ck_params.points[band_prep.perm])
            state = _make_state(ck_params)._replace(
                tr=tr_mod.TRState(
                    radius=jnp.asarray(scal["radius"], params.points.dtype),
                    decrease_factor=jnp.asarray(
                        scal["decrease_factor"], params.points.dtype),
                ),
                k=jnp.asarray(scal["iteration"]),
            )
            start_iter = scal["iteration"]

    def _save(state, k):
        from deeparc_tpu.utils.checkpoint import save_solver_state

        save_solver_state(
            checkpoint_path,
            _params_from(state.cam_vec, unperm(state.points), params),
            float(state.tr.radius), float(state.tr.decrease_factor),
            k, float(state.cost),
        )

    if driver == "while_loop":
        jit_block = jax.jit(
            lambda s, g, cf, pf, k_stop: jax.lax.while_loop(
                lambda st: (st.status == 0) & (st.k < k_stop),
                lambda st: step(st, g, cf, pf)[0],
                s,
            ),
            static_argnames=(),
        )
        t0 = _time.time()
        k = start_iter
        while int(state.status) == 0 and k < options.max_iterations:
            if _time.time() - t0 > options.max_seconds:
                break
            k_stop = min(k + while_block, options.max_iterations)
            state = jit_block(state, grid, cam_free, point_free,
                              jnp.asarray(k_stop))
            k = int(state.k)
            if checkpoint_path:
                _save(state, k)
        out_params = _params_from(state.cam_vec, unperm(state.points),
                                  params)
        return BAResult(
            params=out_params, cost=float(state.cost),
            iterations=int(state.k), status=int(state.status),
        )

    jit_step = jax.jit(step)
    t0 = _time.time()
    k = start_iter
    if options.progress_to_stdout:
        print(f"{'iter':>4} {'cost':>14} {'cost_change':>12} {'|gradient|':>11}"
              f" {'tr_radius':>10} {'rho':>9} {'accept':>6}")
        print(f"{k:>4} {float(state.cost):>14.6e}")
    while int(state.status) == 0 and k < options.max_iterations:
        if _time.time() - t0 > options.max_seconds:
            break
        state, info = jit_step(state, grid, cam_free, point_free)
        k += 1
        if options.progress_to_stdout:
            print(f"{k:>4} {float(info.cost):>14.6e}"
                  f" {float(info.cost_change):>12.4e}"
                  f" {float(info.grad_max):>11.4e}"
                  f" {float(info.radius):>10.3e} {float(info.rho):>9.3f}"
                  f" {bool(info.accepted)!s:>6}")
        if logger is not None:
            logger.log(
                "lm_iteration", iter=k, cost=float(info.cost),
                cost_change=float(info.cost_change),
                grad_max=float(info.grad_max),
                step_norm=float(info.step_norm),
                radius=float(info.radius), rho=float(info.rho),
                accepted=bool(info.accepted),
            )
        if checkpoint_path and k % checkpoint_every == 0:
            _save(state, k)
    out_params = _params_from(state.cam_vec, unperm(state.points), params)
    return BAResult(
        params=out_params, cost=float(state.cost),
        iterations=k, status=int(state.status),
    )
